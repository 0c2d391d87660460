"""Map points whose descriptor, normal and depth bounds the mapper
refreshed in one batch (the program's ``mapping.points_refreshed``
counter), per keyframe mapped in the window (``mapping.keyframe`` spans).
None for a program that keeps no such counter."""
from benchmark import program_records as pr


def read(run):
    recs = pr.window(run)
    if recs is None:
        return None
    mapped = pr.spans(recs, "mapping.keyframe")
    if not mapped or not any(r.kind == "count" and r.name == "mapping.points_refreshed"
                             for r in recs):
        return None
    return pr.total(recs, "mapping.points_refreshed") / len(mapped)
