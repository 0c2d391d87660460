"""Kernel 3: stereo window correlation, 11 centre-subtracted L1 costs.

Replaces ``jetson_slam_tpu/ops/pallas_stereo.py::stereo_costs_pallas``
(kernel body ``_kernel``) with the hand-written CUDA kernel
``csrc/stereo_costs.cu``.

For every matched left slot, at the left slot's octave: the 11x11 left
patch centred at (yy, xl) and the 11x21 right strip centred at (yy, xr)
give cost[o] = sum |(L - L_c) - (R_o - R_o,c)| for the 11 disparity offsets
o, R_o being the 11x11 window of the strip starting at column o.  The TPU
kernel selects tile-anchored bands with one-hot matmuls; here the kernel
and its plain version read the zero-padded pyramid stacks directly, which
gives the same windows for every matched slot (the stereo bounds check
keeps the 21-wide strip inside the level).  Costs are exact integers
(int32); unmatched slots get 0, which the port defines for them.

What bounds it on an H100: launch latency plus the L2 round trips of one
warp, not bytes.  At the EuRoC slice the ~1800 matched slots read 0.9 MB
of windows and all 3584 slots write 0.16 MB of costs, a quarter of a
microsecond at 3.35 TB/s; the grid is one resident wave, so the kernel
takes the launch plus its slowest warp's chain of dependent loads.  The
design keeps that chain at two round trips: a warp takes two slots, one
lane per patch row; the per-slot inputs are loaded at once before any
branch; each row lane issues the aligned 32-bit words that cover its left
and right rows together and realigns them with funnel shifts (windows past
the canvas's left or right edge read clamped bytes instead); the centre
values come from lane 5 by shuffles; the costs are summed in exact f32
and reduced by a transposing xor-shuffle, so lane o stores cost o.
"""
from __future__ import annotations

import ctypes

import torch

from . import cuda_build

PATCH_HALF = 5
NBRHOOD = 11
NBR_HALF = 5


def stereo_costs_plain(pyr_l, pyr_r, lvl, yy, xl, xr, matched):
    """Plain PyTorch version of ``stereo_costs`` (same integer arithmetic).

    pyr_l, pyr_r: (B, L, H0, W0) uint8 zero-padded pyramid stacks.  lvl, yy,
    xl, xr: (B, K) int32 left octave, window row and left/right centre
    columns at that octave.  matched: (B, K) bool.
    Returns costs (B, K, 11) int32, zero where not matched.
    """
    B, L, H0, W0 = pyr_l.shape
    dev = pyr_l.device
    b = torch.arange(B, device=dev)[:, None, None, None]
    lv = lvl.long().clamp(0, L - 1)[..., None, None]
    u = torch.arange(-PATCH_HALF, PATCH_HALF + 1, device=dev)
    s = torch.arange(-PATCH_HALF - NBR_HALF, PATCH_HALF + NBR_HALF + 1, device=dev)
    rows = (yy.long()[..., None] + u).clamp(0, H0 - 1)[..., :, None]
    lcols = (xl.long()[..., None] + u).clamp(0, W0 - 1)[..., None, :]
    rcols = (xr.long()[..., None] + s).clamp(0, W0 - 1)[..., None, :]
    lp = pyr_l[b, lv, rows, lcols].to(torch.int32)            # (B, K, 11, 11)
    rs = pyr_r[b, lv, rows, rcols].to(torch.int32)            # (B, K, 11, 21)
    ld = lp - lp[..., PATCH_HALF:PATCH_HALF + 1, PATCH_HALF:PATCH_HALF + 1]
    costs = []
    for o in range(NBRHOOD):
        w = rs[..., o:o + 2 * PATCH_HALF + 1]
        rd = w - rs[..., PATCH_HALF:PATCH_HALF + 1, o + PATCH_HALF:o + PATCH_HALF + 1]
        costs.append((ld - rd).abs().sum((-2, -1), dtype=torch.int32))
    costs = torch.stack(costs, -1)
    return torch.where(matched[..., None], costs, torch.zeros_like(costs))


def _check(pyr_l, pyr_r, lvl, yy, xl, xr, matched):
    if pyr_l.dtype != torch.uint8 or pyr_l.dim() != 4 or pyr_r.shape != pyr_l.shape \
            or pyr_r.dtype != torch.uint8:
        raise ValueError("pyr_l, pyr_r must be (B, L, H0, W0) uint8 of one shape")
    B = pyr_l.shape[0]
    for name, t in (("lvl", lvl), ("yy", yy), ("xl", xl), ("xr", xr)):
        if t.dtype != torch.int32 or t.dim() != 2 or t.shape[0] != B \
                or t.shape != lvl.shape:
            raise ValueError(f"{name} must be (B, K) int32")
    if matched.dtype != torch.bool or matched.shape != lvl.shape:
        raise ValueError("matched must be (B, K) bool")
    devs = {t.device for t in (pyr_l, pyr_r, lvl, yy, xl, xr, matched)}
    if len(devs) != 1:
        raise ValueError(f"all inputs must be on one device, got {devs}")
    if not all(t.is_contiguous() for t in (pyr_l, pyr_r, lvl, yy, xl, xr, matched)):
        raise ValueError("stereo_costs takes contiguous tensors")


def stereo_costs(pyr_l, pyr_r, lvl, yy, xl, xr, matched):
    """Window L1 costs (see ``stereo_costs_plain``).

    A CPU tensor takes the plain version; a CUDA tensor launches
    ``csrc/stereo_costs.cu`` and adds one to ``stereo_costs.launches``
    (``cuda_build.count_launch``: once per replay inside a CUDA graph).
    """
    args = (pyr_l, pyr_r, lvl, yy, xl, xr, matched)
    _check(*args)
    if pyr_l.device.type == "cpu":
        return stereo_costs_plain(*args)
    if pyr_l.device.type != "cuda":
        raise ValueError(f"stereo_costs: unsupported device {pyr_l.device}")
    B, L, H0, W0 = pyr_l.shape
    K = lvl.shape[1]
    costs = torch.empty((B, K, NBRHOOD), dtype=torch.int32, device=pyr_l.device)
    status = _lib().stereo_costs_launch(
        *[a.data_ptr() for a in args], B, K, L, H0, W0, costs.data_ptr(),
        torch.cuda.current_stream(pyr_l.device).cuda_stream)
    cuda_build.check(status, "stereo_costs")
    cuda_build.count_launch(stereo_costs)
    return costs


stereo_costs.launches = 0


def _lib():
    lib = cuda_build.load("stereo_costs")
    fn = lib.stereo_costs_launch
    if fn.argtypes is None:
        P, I = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [P] * 7 + [I] * 5 + [P, P]
        fn.restype = ctypes.c_int
    return lib
