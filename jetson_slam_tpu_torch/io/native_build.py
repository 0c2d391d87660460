"""Build and load the port's host-side C and C++ sources.

Each source is compiled by the host's C or C++ compiler into its own shared
library in ``build/native/`` at the root of the checkout, named by a hash of
the source and the flags (as ``ops/cuda_build.py`` names the kernels), and
loaded with ``ctypes``.  Nothing is built when a module is imported: the
first ``load`` of a source builds it.  A missing compiler or a failed build
raises.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"

_libs: dict = {}
_lock = threading.Lock()


def _lib_path(source: Path, compiler: str, flags: tuple) -> Path:
    digest = hashlib.sha256(source.read_bytes() + " ".join((compiler, *flags)).encode())
    return BUILD_DIR / f"{source.stem}-{digest.hexdigest()[:16]}.so"


def load(source, compiler: str, flags: tuple) -> ctypes.CDLL:
    """The loaded library of ``source``, built with ``compiler`` (``cc`` or
    ``c++``, looked up on PATH) and ``flags`` unless already built."""
    source = Path(source)
    with _lock:
        out = _lib_path(source, compiler, flags)
        lib = _libs.get(out)
        if lib is not None:
            return lib
        if not out.exists():
            exe = shutil.which(compiler)
            if exe is None:
                raise RuntimeError(f"no host compiler {compiler!r} on PATH: "
                                   f"{source.name} cannot be built")
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = out.with_suffix(f".{os.getpid()}.tmp.so")
            r = subprocess.run([exe, *flags, "-o", str(tmp), str(source)],
                               capture_output=True, text=True)
            if r.returncode != 0:
                raise RuntimeError(f"{compiler} failed for {source.name}:\n"
                                   f"{r.stdout}{r.stderr}")
            os.replace(tmp, out)   # atomic: a concurrent build loses nothing
        lib = ctypes.CDLL(str(out))
        _libs[out] = lib
        return lib
