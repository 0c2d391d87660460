"""Process start to the first frame of the window: imports and CUDA start,
nvcc (or its cache), the vocabulary, rendering, the system, the prewarm
captures and the warm session."""


def read(run):
    return run.setup_s
