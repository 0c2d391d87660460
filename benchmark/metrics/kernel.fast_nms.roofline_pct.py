"""The FAST + NMS-L stage's least time at the frame's shapes over the
kernel's median device time in the trace, in percent."""
from benchmark import rooflines


def read(run):
    return rooflines.share(run, "fast_nms")
