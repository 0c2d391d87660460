"""Frames fed in the window's session before the tracker was initialized
(the program's ``init.frames`` counter: frames fed while the tracker was
not initialized).  A session starts as the window opens."""
from benchmark import program_records as pr


def read(run):
    recs = pr.window(run)
    if recs is None:
        return None
    n = pr.total(recs, "init.frames")
    return float(n) if n else None
