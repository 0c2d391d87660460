"""Wall ms of the mapper's fuse (the program's ``mapping.fuse`` spans:
SearchInNeighbors, its searches, commits and the refresh of the keyframe's
points) in the window, per keyframe mapped in it (``mapping.keyframe``
spans)."""
from benchmark import program_records as pr


def read(run):
    recs = pr.window(run)
    if recs is None:
        return None
    mapped = pr.spans(recs, "mapping.keyframe")
    return pr.wall_ms(pr.spans(recs, "mapping.fuse")) / len(mapped) if mapped else None
