"""Median over the window's fused frames of the device time of the local-map
frustum check, search and pose LM inside the fused step: the difference of
the card's timer stamped into the captured graph at the stage's two ends
(the program's ``stage.local_map`` records)."""
from benchmark import program_records as pr


def read(run):
    return pr.device_median_ms(run, "stage.local_map")
