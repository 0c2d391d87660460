"""The ate_m arithmetic in the cells whose mapping runs on the async worker,
where thread timing decides which keyframes a busy worker refuses."""
from benchmark import harness


def read(run):
    return harness.load_module("metrics", "ate_m").read(run)
