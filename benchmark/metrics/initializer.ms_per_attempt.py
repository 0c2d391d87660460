"""Wall ms of one attempt of the mono two-view initializer (the program's
``init.attempt`` spans: the brute-force match to the reference frame and
``MonoInitializer.initialize``), mean over the window's attempts."""
from benchmark import program_records as pr


def read(run):
    recs = pr.window(run)
    if recs is None:
        return None
    attempts = pr.spans(recs, "init.attempt")
    return pr.wall_ms(attempts) / len(attempts) if attempts else None
