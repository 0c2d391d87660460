"""95th percentile over every frame fed in the window of the time from the
start of the facade call that fed it to the return of the call that handed
back its pose (with frames in flight, a later call; the frames still in
flight at the close come back in the flush after it)."""
import numpy as np


def read(run):
    lat = run.latencies_ms()
    return float(np.percentile(lat, 95)) if lat else None
