"""Wall ms the tracking thread waited for the map lock (the program's
``slice.map_lock_wait`` spans: acquisitions that blocked), per frame fed."""
from benchmark import program_records as pr


def read(run):
    recs = pr.tracked(run)
    if recs is None:
        return None
    return pr.per_frame(run, pr.wall_ms(pr.spans(recs, "slice.map_lock_wait")))
