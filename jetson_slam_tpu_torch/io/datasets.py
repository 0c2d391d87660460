"""Datasets: EuRoC / KITTI / TUM image-list loaders and decoding.

Port of ``jetson_slam_tpu/io/datasets.py``.  The six loaders replace the
reference's Examples/ mains (stereo_euroc.cpp LoadImages :216-254,
stereo_kitti.cpp, rgbd_tum.cpp, mono_*.cpp) and return the same entries,
(timestamp, path, ...) tuples.  Images are decoded by ``imread``: ``.npy``,
binary ``.pgm`` and ``.png`` (``io/png.py``, the one PNG decoder, on every
machine), 16-bit kept, so TUM depth reaches the caller whole.
"""
from __future__ import annotations

import glob
import os
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from . import png
from .native_loader import FORMATS as NATIVE_FORMATS
from .native_loader import PrefetchLoader, pgm_header


def load_euroc_stereo(seq_dir: str, timestamp_file: str | None = None):
    """EuRoC MAV layout: mav0/cam{0,1}/data/<ns>.png (stereo_euroc.cpp:216-254).

    Returns (t_seconds, left_path, right_path); images must be rectified by
    the caller (``io.rectify.StereoRectifier`` from the YAML's LEFT.*/RIGHT.*
    blocks)."""
    cam0 = os.path.join(seq_dir, "mav0", "cam0", "data")
    cam1 = os.path.join(seq_dir, "mav0", "cam1", "data")
    lefts = sorted(glob.glob(os.path.join(cam0, "*.png")))
    entries = []
    for lp in lefts:
        ns = os.path.splitext(os.path.basename(lp))[0]
        rp = os.path.join(cam1, ns + ".png")
        if os.path.exists(rp):
            entries.append((int(ns) * 1e-9, lp, rp))
    return entries


def load_kitti_stereo(seq_dir: str):
    """KITTI odometry layout: image_0/ image_1/ + times.txt (stereo_kitti.cpp)."""
    with open(os.path.join(seq_dir, "times.txt")) as f:
        times = [float(x) for x in f.read().split()]
    return [(t, os.path.join(seq_dir, "image_0", f"{i:06d}.png"),
             os.path.join(seq_dir, "image_1", f"{i:06d}.png"))
            for i, t in enumerate(times)]


def load_tum_rgbd(seq_dir: str, association_file: str):
    """TUM RGB-D with an association file: `t rgb t depth` (rgbd_tum.cpp)."""
    entries = []
    with open(association_file) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            vals = line.split()
            entries.append((float(vals[0]), os.path.join(seq_dir, vals[1]),
                            os.path.join(seq_dir, vals[3])))
    return entries


def load_tum_mono(seq_dir: str):
    """TUM monocular: rgb.txt listing `t filename` (mono_tum.cpp LoadImages)."""
    entries = []
    with open(os.path.join(seq_dir, "rgb.txt")) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            t, name = line.split()[:2]
            entries.append((float(t), os.path.join(seq_dir, name)))
    return entries


def load_kitti_mono(seq_dir: str):
    """KITTI monocular: image_0/ + times.txt (mono_kitti.cpp)."""
    with open(os.path.join(seq_dir, "times.txt")) as f:
        times = [float(x) for x in f.read().split()]
    return [(t, os.path.join(seq_dir, "image_0", f"{i:06d}.png"))
            for i, t in enumerate(times)]


def load_euroc_mono(seq_dir: str):
    """EuRoC monocular: cam0 only (mono_euroc.cpp)."""
    cam0 = os.path.join(seq_dir, "mav0", "cam0", "data")
    entries = []
    for lp in sorted(glob.glob(os.path.join(cam0, "*.png"))):
        ns = os.path.splitext(os.path.basename(lp))[0]
        entries.append((int(ns) * 1e-9, lp))
    return entries


def _read_pgm(path: str) -> np.ndarray:
    """Binary PGM (P5), 8-bit or 16-bit big-endian (maxval > 255)."""
    with open(path, "rb") as f:
        data = f.read()
    h, w, maxval, pos = pgm_header(data, path)
    dt = np.dtype(np.uint8) if maxval <= 255 else np.dtype(">u2")
    body = data[pos:pos + h * w * dt.itemsize]
    if len(body) != h * w * dt.itemsize:
        raise ValueError(f"{path}: truncated PGM data")
    return np.frombuffer(body, dt).reshape(h, w).astype(dt.newbyteorder("="))


def imread(path: str) -> np.ndarray:
    """An image file as a numpy array: ``.npy`` as saved, ``.pgm`` and
    ``.png`` as grey uint8, or uint16 for 16-bit files (TUM depth)."""
    path = str(path)
    if path.endswith(".npy"):
        return np.load(path)
    if path.endswith(".pgm"):
        return _read_pgm(path)
    if path.endswith(".png"):
        return png.read(path)
    raise ValueError(f"{path}: unsupported image format (.png, .pgm or .npy)")


def imread_gray(path: str) -> np.ndarray:
    """An 8-bit grey image (H, W) uint8; a 16-bit or colour array raises."""
    img = imread(path)
    if img.dtype != np.uint8 or img.ndim != 2:
        raise ValueError(f"{path}: a {img.dtype} image of shape {img.shape} is "
                         "not 8-bit grey")
    return img


def _timed_imread(path: str):
    t0 = time.perf_counter()
    img = imread(path)
    return img, (time.perf_counter() - t0) * 1e3


class ImageSource:
    """Decode-ahead image column for dataset replay.

    The reference decodes each frame on the tracking thread; here decoding
    runs ahead of the tracker, dispatched by format: a column of .pgm / .raw
    files rides the native ring buffer (``io/native_loader.py``), which
    reads forward only; every other column a thread pool with a sliding
    window of ``ahead`` frames, where an index out of order is decoded on
    the spot.  ``wait_ms`` holds the host time each ``get`` waited for its
    frame and, on the thread pool, ``decode_ms`` each frame's decode time."""

    def __init__(self, paths, height=0, width=0, ahead=6, workers=2):
        self.paths = [str(p) for p in paths]
        self.wait_ms: list[float] = []
        self.decode_ms: list[float] = []
        self._native = None
        self._ex = None
        if self.paths and all(p.endswith(NATIVE_FORMATS) for p in self.paths):
            self._native = PrefetchLoader(self.paths, height, width,
                                          n_threads=workers, capacity=max(ahead, 2))
        else:
            self._ex = ThreadPoolExecutor(max_workers=workers)
            self._futs = {}
            self._ahead = int(ahead)

    def __len__(self):
        return len(self.paths)

    def get(self, i: int) -> np.ndarray:
        t0 = time.perf_counter()
        if self._native is not None:
            img = self._native.get(i)
        else:
            for j in range(i, min(i + self._ahead, len(self.paths))):
                if j not in self._futs:
                    self._futs[j] = self._ex.submit(_timed_imread, self.paths[j])
            img, ms = self._futs.pop(i).result()
            self.decode_ms.append(ms)
            for j in [j for j in self._futs if j < i]:
                self._futs.pop(j).cancel()
        self.wait_ms.append((time.perf_counter() - t0) * 1e3)
        return img

    def close(self):
        if self._ex is not None:
            self._ex.shutdown(wait=False, cancel_futures=True)
            self._ex = None
        if self._native is not None:
            self._native.close()
            self._native = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
