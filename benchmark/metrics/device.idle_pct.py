"""Share of the traced sub-window in which no kernel or copy ran on the
card, in percent."""


def read(run):
    t = run.device_trace
    if not t or t["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
