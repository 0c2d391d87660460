"""Device timestamps inside the fused step.

``stamp(buf, i)`` writes the time into ``buf[i]`` (an int64 tensor) in
nanoseconds.  For a CUDA tensor it launches ``csrc/stamp.cu``, one thread
that reads the card's global timer behind the work queued before it on the
current stream; inside a graph capture it is recorded and writes on every
replay.  For a CPU tensor, where the step runs eagerly on the host, it
writes ``time.perf_counter_ns()`` now.  A stamp is no kernel of the step's
work: it counts no launch (``cuda_build.count_launch``).
"""
from __future__ import annotations

import ctypes
import time

import torch

from . import cuda_build


def stamp(buf: torch.Tensor, i: int) -> None:
    if buf.dtype != torch.int64 or buf.dim() != 1 or not 0 <= i < buf.shape[0]:
        raise ValueError(f"stamp takes an int64 vector and a slot in it, got "
                         f"{buf.dtype} {tuple(buf.shape)} and {i}")
    if buf.device.type == "cpu":
        buf[i] = time.perf_counter_ns()
        return
    if buf.device.type != "cuda":
        raise ValueError(f"stamp: unsupported device {buf.device}")
    status = _lib().stamp_launch(buf.data_ptr(), i,
                                 torch.cuda.current_stream(buf.device).cuda_stream)
    cuda_build.check(status, "stamp")


def _lib():
    lib = cuda_build.load("stamp")
    fn = lib.stamp_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib
