"""Wall-clock and device tracing utilities.

Port of ``jetson_slam_tpu/utils/profiling.py``; replaces the reference's
``tictoc`` (include/tictoc.hpp:7-43) and its CUDA-event twin
(include/tictoc_cuda.hpp):

- ``TicToc``: a steady-clock stopwatch with named scopes and aggregate
  statistics (count / total / mean / median ms).  ``scope(name, sync=...)``
  synchronises the current CUDA stream of each given tensor's device before
  it stops the clock: kernel launches return before the card finishes.
- ``trace``: ``torch.profiler`` around a block (CPU, and CUDA when the
  card is there), written as a Chrome trace into a directory.
"""
from __future__ import annotations

import contextlib
import os
import statistics
import time
from collections import defaultdict

import torch


def _sync(tensors) -> None:
    if isinstance(tensors, torch.Tensor):
        tensors = (tensors,)
    for dev in {t.device for t in tensors if t.device.type == "cuda"}:
        torch.cuda.current_stream(dev).synchronize()


class TicToc:
    """Named stopwatch registry with aggregate statistics."""

    def __init__(self):
        self._samples = defaultdict(list)
        self._open = {}

    def tic(self, name: str = "default"):
        self._open[name] = time.perf_counter()

    def toc(self, name: str = "default") -> float:
        """Returns elapsed ms since tic(name) and records the sample."""
        dt = (time.perf_counter() - self._open.pop(name)) * 1e3
        self._samples[name].append(dt)
        return dt

    @contextlib.contextmanager
    def scope(self, name: str, sync=None):
        """Time a block; with ``sync`` (a tensor or a sequence of tensors),
        the work queued on their devices' current CUDA streams is finished
        before the clock stops."""
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if sync is not None:
                _sync(sync)
            self._samples[name].append((time.perf_counter() - t0) * 1e3)

    def stats(self, name: str) -> dict:
        s = self._samples[name]
        if not s:
            return {"count": 0}
        return {
            "count": len(s),
            "total_ms": sum(s),
            "mean_ms": sum(s) / len(s),
            "median_ms": statistics.median(s),
            "min_ms": min(s),
            "max_ms": max(s),
        }

    def report(self) -> str:
        lines = []
        for name in sorted(self._samples):
            st = self.stats(name)
            lines.append(
                f"{name:32s} n={st['count']:6d}  mean={st['mean_ms']:8.3f} ms"
                f"  median={st['median_ms']:8.3f} ms  total={st['total_ms']:10.1f} ms")
        return "\n".join(lines)

    def reset(self):
        self._samples.clear()
        self._open.clear()


@contextlib.contextmanager
def trace(log_dir: str):
    """``torch.profiler`` over a block, CPU and (with a card) CUDA
    activity; on exit the Chrome trace is written to
    ``log_dir/trace.json`` (view it in Perfetto or chrome://tracing).
    Yields the profiler, whose ``key_averages()`` tabulate the block."""
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
