"""Frames not tracked OK after the initialization, over the frames fed
after it, in percent (the program's ``tracking.lost`` and ``init.frames``
counters).  A program without the counters reads None: every session's
first frame counts in ``init.frames``."""
from benchmark import program_records as pr


def read(run):
    recs = pr.window(run)
    if recs is None:
        return None
    before = pr.total(recs, "init.frames")
    after = len(run.fed) - before
    if not before or after <= 0:
        return None
    return 100.0 * pr.total(recs, "tracking.lost") / after
