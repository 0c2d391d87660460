"""Host ms of LoopCloser.process_keyframe (detection, and a closure where
one is found) per keyframe it was handed in the window."""


def read(run):
    n = run.window_counts.get("loop_closing", 0)
    return run.window_spans["loop_closing"] / n if n else None
