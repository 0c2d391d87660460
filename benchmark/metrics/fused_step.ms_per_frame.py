"""Host ms of the graph layer per fused frame: staging and launching the
step (FusedStep.dispatch) plus waiting for and unpacking its results
(Tracker._finish_fused)."""


def read(run):
    n = run.window_counts.get("fused.dispatch", 0)
    if not n:
        return None
    return (run.window_spans["fused.dispatch"] + run.window_spans["fused.finish"]) / n
