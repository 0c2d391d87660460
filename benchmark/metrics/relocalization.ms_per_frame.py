"""Wall ms of relocalization (the program's ``slice.relocalize`` spans) per
frame fed in the window; 0 where none ran.  A program without the
``init.frames`` counter, which counts every session's first frame, keeps
no relocalization span either and reads None."""
from benchmark import program_records as pr


def read(run):
    recs = pr.window(run)
    if recs is None or not pr.total(recs, "init.frames"):
        return None
    return pr.per_frame(run, pr.wall_ms(pr.spans(recs, "slice.relocalize")))
