"""Keyframes the tracker wanted but a busy mapper refused, over those it
wanted, in percent (the program's ``keyframes.refused`` and
``keyframes.wanted`` counters)."""
from benchmark import program_records as pr


def read(run):
    recs = pr.window(run)
    if recs is None:
        return None
    wanted = pr.total(recs, "keyframes.wanted")
    return 100.0 * pr.total(recs, "keyframes.refused") / wanted if wanted else None
