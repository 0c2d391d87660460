"""Median over the window's fused frames of the device time of the front end
(ORB extraction, and the stereo match or the depth lookup) inside the
fused step: the difference of the card's timer stamped into the captured
graph at the stage's two ends (the program's ``stage.frontend`` records)."""
from benchmark import program_records as pr


def read(run):
    return pr.device_median_ms(run, "stage.frontend")
