"""The descriptor stage's least time for the valid slots of the traced
frames over the kernel's median device time, in percent."""
from benchmark import rooflines


def read(run):
    return rooflines.share(run, "orb_descriptor")
