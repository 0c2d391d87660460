"""Graph replays over frames fed, in percent: the rest are the eager
initialisation and fallback frames and first-use captures."""


def read(run):
    if not run.fed:
        return None
    return 100.0 * run.window_counts["replays"] / len(run.fed)
