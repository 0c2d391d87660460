"""Build and load the hand-written CUDA kernels.

Each source under ``jetson_slam_tpu_torch/csrc/`` is compiled by ``nvcc``
for ``sm_90a`` into its own shared library with a plain C entry point, and
loaded with ``ctypes``.  Libraries go to ``build/kernels/`` at the root of
the checkout, named by a hash of the source and the flags, so an edited
source rebuilds and an unchanged one is loaded as is.  Nothing is built when
a module is imported: the first ``load`` builds every source that is not
built yet, one ``nvcc`` per source, all started together.

``count_launch`` keeps each wrapper's count of launches; a kernel recorded
into a CUDA graph counts once per replay of that graph instead.
"""
from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR.parent / "build" / "kernels"
SOURCES = ("fast_nms", "orb_descriptor", "stereo_costs", "stamp")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_libs: dict = {}
_lock = threading.Lock()
_capture = threading.local()   # .tally: this thread's tally_captures dict
LOGS: dict = {}     # {name: nvcc output} of the sources built by this process


def nvcc_path() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and (Path(cand) / "bin" / "nvcc").exists():
            return str(Path(cand) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels can only be built "
                           "on a machine with the CUDA toolkit")
    return found


def _lib_path(name: str) -> Path:
    src = (CSRC_DIR / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"{name}-{digest}.so"


def _start(name: str):
    """Start nvcc for one source; returns (Popen, tmp path, final path) or
    None when the library is already built."""
    out = _lib_path(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp.so")
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)
    return proc, tmp, out


def _finish(name: str, started) -> str | None:
    """Wait for one nvcc; returns its error report, or None on success."""
    proc, tmp, out = started
    log, _ = proc.communicate()
    if proc.returncode != 0:
        return f"nvcc failed for {name}.cu:\n{log}"
    os.replace(tmp, out)
    LOGS[name] = log
    return None


def load(name: str) -> ctypes.CDLL:
    """The loaded library of one kernel.  The first call builds every
    kernel source that is not built yet, in parallel."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            started = {n: _start(n) for n in SOURCES}
            errors = [_finish(n, st) for n, st in started.items() if st is not None]
            if any(errors):
                raise RuntimeError("\n".join(e for e in errors if e))
            lib = ctypes.CDLL(str(_lib_path(name)))
            _libs[name] = lib
        return lib


def check(status: int, name: str) -> None:
    """Raise if a launch returned a CUDA error code."""
    if status != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: cudaError {status}")


def count_launch(wrapper) -> None:
    """Add one to ``wrapper.launches`` for a kernel launched now.  While
    the calling thread captures a CUDA graph the kernel is recorded, not
    launched: under ``tally_captures`` it goes to that tally, which the
    graph's owner adds once per replay (``core/fused_track.FusedStep``)."""
    if torch.cuda.is_current_stream_capturing():
        tally = getattr(_capture, "tally", None)
        if tally is not None:
            tally[wrapper] = tally.get(wrapper, 0) + 1
        return
    wrapper.launches += 1


@contextlib.contextmanager
def tally_captures():
    """For a with block around one graph capture on this thread: yields
    a dict {wrapper: kernels recorded}, the launches of one replay."""
    tally: dict = {}
    _capture.tally = tally
    try:
        yield tally
    finally:
        _capture.tally = None
