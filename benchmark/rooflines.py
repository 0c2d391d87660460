"""A kernel's share of its roofline: the least time the card could take for
the work its stage needs at the traced frames' shapes (``roofline/<kernel>.py``
counts the operations and bytes), over the kernel's median device time in
the trace.  The least time is the larger of operations over the peak rate
and bytes over the peak bandwidth (``peaks.json``).

The valid slots of the traced frames, which the descriptor stage's work
depends on, are counted by the reference front end on the frames' images
(both eyes of a stereo frame)."""
from __future__ import annotations

import numpy as np

from benchmark import harness


def traced_valid_slots(run) -> float:
    """Median over the traced frames of the valid slots of one launch."""
    fe = run.judge.fe
    counts = []
    for i in run.device_trace_feeds:
        imgs = [run.frames.lefts[i]]
        if run.frames.rights is not None:
            imgs.append(run.frames.rights[i])
        res, _ = fe.extract_batch(np.stack(imgs))
        counts.append(int(res["valid"].sum()))
    return float(np.median(counts))


def share(run, kernel: str):
    t = run.device_trace
    if not t:
        return None
    mod = harness.load_module("roofline", kernel)
    times = [d for name, ds in t["kernels"].items() if mod.KERNEL in name for d in ds]
    if not times:
        return None
    peaks = harness.load_json(harness.BENCH / "peaks.json")
    kind = run.device_kind
    if kind not in peaks:
        return None
    n_images = 2 if run.frames.rights is not None else 1
    ops, nbytes = mod.work(run.judge.fe.g, n_images, traced_valid_slots(run))
    p = peaks[kind]
    least = max(ops / p["ops_per_s"], nbytes / p["bytes_per_s"])
    return 100.0 * least / float(np.median(times))
