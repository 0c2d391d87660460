"""Wall ms the tracker waited for fused steps' results (the program's
``slice.pull`` spans: the one wait on each step's event), per frame fed."""
from benchmark import program_records as pr


def read(run):
    recs = pr.tracked(run)
    if recs is None:
        return None
    return pr.per_frame(run, pr.wall_ms(pr.spans(recs, "slice.pull")))
