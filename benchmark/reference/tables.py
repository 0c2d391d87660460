"""Precomputed tables for the ORB front-end (frozen copy of the port's
``ops/tables.py``, kept as the benchmark's yardstick).

Host-side equivalents of the reference's setup
(reference: src/cuda/orb_gpu.cpp:94-441): FAST segment-test lookup table,
circular-patch `umax` table for the intensity-centroid orientation, the 7x7
sigma=10 Gaussian weights, the 256-pair rBRIEF pattern (public OpenCV/ORB
constants, stored beside this file as orb_pattern.npy), and the
per-level pyramid/tile geometry.
"""
from __future__ import annotations

import dataclasses
import math
import os
from functools import lru_cache

import numpy as np

BORDER_SKIP = 20  # reference: include/cuda/orb_gpu.hpp:17
PATCH_SIZE = 31
HALF_PATCH_SIZE = 15  # reference CIRCULAR_HALF_PATCH_SIZE
RING_N = 16

# FAST ring offsets (dy, dx), index order matching the reference kernel
# (orb_FAST_compute_score.cu:1470-1500: ptr_0 = +3 rows ... ptr_4 = +3 cols).
FAST_RING = np.array(
    [
        (3, 0), (3, 1), (2, 2), (1, 3),
        (0, 3), (-1, 3), (-2, 2), (-3, 1),
        (-3, 0), (-3, -1), (-2, -2), (-1, -3),
        (0, -3), (1, -3), (2, -2), (3, -1),
    ],
    dtype=np.int32,
)


@lru_cache(maxsize=None)
def fast_lut(n_min: int, n_max: int) -> np.ndarray:
    """FAST contiguous-arc lookup table over 16-bit ring masks.

    Replicates the reference's quirky scan semantics exactly
    (orb_gpu.cpp:366-436): scan bits MSB->LSB; accept the FIRST maximal run
    (terminated by a zero bit) whose length lies in [n_min, n_max]; if the
    scan falls off the end (the trailing run reaches bit 0), wrap around and
    keep counting leading bits from the MSB, then test the combined length.
    Note entry 0xFFFF is never written by the reference loop (j < 0xFFFF) —
    it stays 0, which we reproduce.
    """
    lut = np.zeros(1 << 16, dtype=np.uint8)
    for j in range(0xFFFF):  # intentionally excludes 0xFFFF, like the reference
        n_valid = 0
        accepted = False
        fell_off = True
        for k in range(15, -1, -1):  # MSB -> LSB
            if (j >> k) & 1:
                n_valid += 1
            else:
                if n_min <= n_valid <= n_max:
                    accepted = True
                    fell_off = False
                    break
                n_valid = 0
        else:
            fell_off = True
        if not accepted and fell_off:
            # wraparound: continue counting from the MSB
            for k in range(15, -1, -1):
                if (j >> k) & 1:
                    n_valid += 1
                else:
                    break
            accepted = n_min <= n_valid <= n_max
        lut[j] = 1 if accepted else 0
    return lut


@lru_cache(maxsize=None)
def umax_table() -> np.ndarray:
    """Circular patch row extents for the IC-angle (reference orb_gpu.cpp:161-182)."""
    hp = HALF_PATCH_SIZE
    umax = np.zeros(hp + 2, dtype=np.int32)
    vmax = int(math.floor(hp * math.sqrt(2.0) / 2 + 1))
    vmin = int(math.ceil(hp * math.sqrt(2.0) / 2))
    hp2 = hp * hp
    for v in range(vmax + 1):
        umax[v] = int(round(math.sqrt(hp2 - v * v)))
    v0 = 0
    for v in range(hp, vmin - 1, -1):
        while umax[v0] == umax[v0 + 1]:
            v0 += 1
        umax[v] = v0
        v0 += 1
    return umax[: hp + 1]


@lru_cache(maxsize=None)
def gaussian_weights() -> np.ndarray:
    """7x7 sigma=10 normalized weights (reference orb_gpu.cpp:196-220)."""
    sigma2 = 100.0
    w = np.zeros((7, 7), dtype=np.float32)
    for j in range(-3, 4):
        for k in range(-3, 4):
            w[j + 3, k + 3] = math.exp(-(j * j + k * k) / (2 * sigma2))
    return (w / w.sum()).astype(np.float32)


@lru_cache(maxsize=None)
def orb_pattern() -> np.ndarray:
    """512 rBRIEF sample points (x, y), int8.  Pair p compares points (2p, 2p+1)."""
    path = os.path.join(os.path.dirname(__file__), "orb_pattern.npy")
    return np.load(path)


@lru_cache(maxsize=None)
def ic_angle_masks() -> tuple:
    """Dense (31,31) masks for the vectorized intensity-centroid moments.

    Encodes the reference's loop structure exactly
    (orb_FAST_orientation.cu:41-60): m_10 sums u*I over the circular patch
    (middle row included), m_01 sums v*(I(v) - I(-v)) for v in [1, hp] with
    per-row extent umax[v].
    """
    hp = HALF_PATCH_SIZE
    umax = umax_table()
    size = 2 * hp + 1
    wu = np.zeros((size, size), dtype=np.float32)  # weight for m_10: u
    wv = np.zeros((size, size), dtype=np.float32)  # weight for m_01: v (image row offset)
    # middle row: u in [-hp, hp]
    for u in range(-hp, hp + 1):
        wu[hp, hp + u] = u
    for v in range(1, hp + 1):
        d = int(umax[v])
        for u in range(-d, d + 1):
            # val_plus = I[y + v], val_minus = I[y - v]; row index = hp + v etc.
            wu[hp + v, hp + u] += u
            wu[hp - v, hp + u] += u
            wv[hp + v, hp + u] += v
            wv[hp - v, hp + u] -= v
    return wu, wv


@dataclasses.dataclass(frozen=True)
class PyramidGeometry:
    """Static per-level geometry (shapes must be Python ints for jit)."""
    n_levels: int
    scale_factor: float
    heights: tuple
    widths: tuple
    scales: tuple       # scale_[i] = scale_factor**i  (level -> level0 multiplier)
    inv_scales: tuple   # 1 / scales[i]
    tile_h: tuple
    tile_w: tuple
    n_tiles_h: tuple
    n_tiles_w: tuple
    level_offsets: tuple  # start slot of each level in the packed keypoint arrays
    total_slots: int

    @property
    def slots_per_level(self):
        return tuple(h * w for h, w in zip(self.n_tiles_h, self.n_tiles_w))


def pyramid_geometry(
    height: int,
    width: int,
    n_levels: int,
    scale_factor: float,
    tile_h: int,
    tile_w: int,
    fixed_multi_scale_tile_size: bool = False,
) -> PyramidGeometry:
    """Replicates reference geometry (orb_gpu.cpp:49-61, 244-258).

    Heights/widths truncate (int cast of float product); per-level tile sizes
    shrink with inv_scale unless fixed, so every level contributes roughly the
    same number of tiles — the paper's pyramidal culling keypoint budget.
    """
    # float32 accumulation to match the reference's float chain exactly
    scales = [np.float32(1.0)]
    inv_scales = [np.float32(1.0)]
    heights = [height]
    widths = [width]
    for i in range(1, n_levels):
        scales.append(np.float32(scale_factor) * scales[i - 1])
        inv_scales.append(np.float32(1.0) / scales[i])
        heights.append(int(height * inv_scales[i]))
        widths.append(int(width * inv_scales[i]))

    th, tw, nth, ntw = [], [], [], []
    for i in range(n_levels):
        if fixed_multi_scale_tile_size:
            th_i, tw_i = tile_h, tile_w
        else:
            th_i = int(tile_h * inv_scales[i])
            tw_i = int(tile_w * inv_scales[i])
        th_i = max(th_i, 1)
        tw_i = max(tw_i, 1)
        th.append(th_i)
        tw.append(tw_i)
        nth.append((heights[i] - 1) // th_i + 1)
        ntw.append((widths[i] - 1) // tw_i + 1)

    offsets = []
    total = 0
    for i in range(n_levels):
        offsets.append(total)
        total += nth[i] * ntw[i]

    return PyramidGeometry(
        n_levels=n_levels,
        scale_factor=scale_factor,
        heights=tuple(heights),
        widths=tuple(widths),
        scales=tuple(float(s) for s in scales),
        inv_scales=tuple(float(s) for s in inv_scales),
        tile_h=tuple(th),
        tile_w=tuple(tw),
        n_tiles_h=tuple(nth),
        n_tiles_w=tuple(ntw),
        level_offsets=tuple(offsets),
        total_slots=total,
    )
