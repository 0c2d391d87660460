"""Wall ms a keyframe waited in the async worker's queue, from the
tracker's insert to the worker's pop (the program's ``mapping.queue_wait``
spans), per keyframe inserted in the window."""
from benchmark import program_records as pr


def read(run):
    recs = pr.window(run)
    if recs is None:
        return None
    waits = pr.spans(recs, "mapping.queue_wait")
    return pr.wall_ms(waits) / len(waits) if waits else None
