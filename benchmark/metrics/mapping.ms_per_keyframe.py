"""Host ms of LocalMapper.process_keyframe (every stage of one keyframe,
ending in blocking pulls) per keyframe mapped in the window."""


def read(run):
    n = run.window_counts.get("mapping", 0)
    return run.window_spans["mapping"] / n if n else None
