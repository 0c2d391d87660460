"""ctypes bindings to the native prefetching image loader.

``native/loader.cpp`` runs a pthread worker pool that decodes frames ahead
of the tracker into a ring buffer (the reference's example mains feed
frames synchronously).  The port builds it from that source at first use,
with the flags of ``native/Makefile``, into ``build/native/``
(``io/native_build.py``); it never loads a prebuilt library.  A build or
load failure raises.  The loader reads 8-bit binary PGM (P5) and raw
row-major uint8 (``.raw``, of a given size); ``io/datasets.ImageSource``
sends every other format to a thread pool.
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import numpy as np

from . import native_build

SOURCE = Path(__file__).resolve().parents[2] / "native" / "loader.cpp"
FLAGS = ("-O3", "-std=c++17", "-fPIC", "-shared", "-pthread")
FORMATS = (".pgm", ".raw")


@functools.cache
def load_lib() -> ctypes.CDLL:
    """The native library, built on first use, its functions declared."""
    lib = native_build.load(SOURCE, "c++", FLAGS)
    lib.loader_create.restype = ctypes.c_void_p
    lib.loader_create.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int]
    lib.loader_get.restype = ctypes.c_int
    lib.loader_get.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.POINTER(ctypes.c_uint8),
        ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int)]
    lib.loader_destroy.restype = None
    lib.loader_destroy.argtypes = [ctypes.c_void_p]
    lib.fast_lut_build.restype = None
    lib.fast_lut_build.argtypes = [ctypes.c_int, ctypes.c_int,
                                   ctypes.POINTER(ctypes.c_uint8)]
    return lib


def pgm_header(data: bytes, path: str) -> tuple[int, int, int, int]:
    """(height, width, maxval, offset of the pixels) of a binary PGM (P5)
    file that starts with ``data``."""
    fields, pos = [], 0
    while len(fields) < 4:
        while data[pos:pos + 1].isspace():
            pos += 1
        if data[pos:pos + 1] == b"#":
            end = data.find(b"\n", pos)
            if end < 0:
                raise ValueError(f"{path}: truncated PGM header")
            pos = end + 1
            continue
        end = pos
        while end < len(data) and not data[end:end + 1].isspace():
            end += 1
        if end == pos:
            raise ValueError(f"{path}: truncated PGM header")
        fields.append(data[pos:end])
        pos = end
    if fields[0] != b"P5" or not all(f.isdigit() for f in fields[1:]):
        raise ValueError(f"{path}: not a binary PGM (P5)")
    return int(fields[2]), int(fields[1]), int(fields[3]), pos + 1


class PrefetchLoader:
    """Decodes a column of .pgm or .raw images ahead of the reader on
    native threads.  Frames are read in increasing order: the ring buffer
    frees a frame once it is read, so an index already read (or passed)
    raises.  ``height`` and ``width`` give the size of .raw frames."""

    def __init__(self, paths, height=0, width=0, n_threads=2, capacity=8):
        self.paths = [str(p) for p in paths]
        bad = [p for p in self.paths if not p.endswith(FORMATS)]
        if bad:
            raise ValueError(f"the native loader reads {FORMATS} only, not {bad[0]}")
        if any(p.endswith(".raw") for p in self.paths) and not (height > 0 and width > 0):
            raise ValueError(".raw frames need their height and width")
        self.height, self.width = int(height), int(width)
        self._lib = load_lib()
        # the worker threads read this array: it lives as long as the loader
        self._paths_arr = (ctypes.c_char_p * len(self.paths))(
            *[p.encode() for p in self.paths])
        self._handle = self._lib.loader_create(
            self._paths_arr, len(self.paths), self.height, self.width,
            int(n_threads), int(capacity))
        self._next = 0

    def __len__(self):
        return len(self.paths)

    def get(self, index: int) -> np.ndarray:
        if self._handle is None:
            raise RuntimeError("the loader is closed")
        if not self._next <= index < len(self.paths):
            raise IndexError(f"frame {index}: the native loader reads forward only, "
                             f"from frame {self._next} of {len(self.paths)}")
        path = self.paths[index]
        # loader_get copies the frame without a bound: size the buffer first
        hw = self._pgm_shape(path) if path.endswith(".pgm") else (self.height, self.width)
        buf = np.empty(hw, np.uint8)
        h, w = ctypes.c_int(), ctypes.c_int()
        r = self._lib.loader_get(self._handle, index,
                                 buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                                 ctypes.byref(h), ctypes.byref(w))
        self._next = index + 1
        if r != 1 or (h.value, w.value) != hw:
            raise IOError(f"native decode failed for {path}")
        return buf

    @staticmethod
    def _pgm_shape(path: str) -> tuple[int, int]:
        with open(path, "rb") as f:
            h, w, maxval, _ = pgm_header(f.read(512), path)
        if maxval > 255:
            raise ValueError(f"{path}: a 16-bit PGM; the native loader reads 8-bit ones")
        return h, w

    def close(self):
        if self._handle is not None:
            self._lib.loader_destroy(self._handle)
            self._handle = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def fast_lut_native(n_min: int, n_max: int) -> np.ndarray:
    """The FAST segment-test LUT built natively (orb_gpu.cpp:366-436
    semantics; equal to ``ops.tables.fast_lut``)."""
    out = np.zeros(1 << 16, np.uint8)
    load_lib().fast_lut_build(n_min, n_max,
                              out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
    return out
