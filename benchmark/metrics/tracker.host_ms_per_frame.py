"""Host ms in the tracker's track_* calls, less the fused step's dispatch
and the wait for its results, per frame fed."""


def read(run):
    if not run.window_counts.get("tracker"):
        return None
    ms = run.window_spans["tracker"] - run.window_spans["fused.dispatch"] - run.window_spans["fused.finish"]
    return ms / len(run.fed)
