"""Ms per frame fed that the tracking thread spent off a CPU inside its
``track_*`` calls outside the named waits: wall less thread CPU time of
``slice.track``, less the same of ``slice.map_lock_wait`` and
``slice.pull``.  Mostly the wait for the interpreter lock beside the
mapping worker's Python."""
from benchmark import program_records as pr


def read(run):
    recs = pr.tracked(run)
    if recs is None:
        return None
    waits = pr.spans(recs, "slice.map_lock_wait") + pr.spans(recs, "slice.pull")
    return pr.per_frame(run, pr.off_cpu_ms(pr.spans(recs, "slice.track"))
                        - pr.off_cpu_ms(waits))
