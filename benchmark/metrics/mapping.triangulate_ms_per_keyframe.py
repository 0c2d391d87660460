"""Wall ms of the mapper's triangulation (the program's
``mapping.triangulate`` spans: CreateNewMapPoints, its matches and
triangulations on the device and the registration of the new points) in
the window, per keyframe mapped in it (``mapping.keyframe`` spans)."""
from benchmark import program_records as pr


def read(run):
    recs = pr.window(run)
    if recs is None:
        return None
    mapped = pr.spans(recs, "mapping.keyframe")
    return pr.wall_ms(pr.spans(recs, "mapping.triangulate")) / len(mapped) if mapped else None
