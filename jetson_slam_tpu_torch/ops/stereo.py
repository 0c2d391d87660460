"""Stereo keypoint matching: Hamming coarse match + window-L1 subpixel refine.

Port of ``jetson_slam_tpu/ops/stereo.py`` (spec: the reference's
``orb_stereo_match.cu``).  All functions take a leading batch axis of
frames: ``left``/``right`` are ``FrontendResult`` with (B, K) fields.

- candidate gating is a (B, K, K) mask (row band, disparity window,
  |octave difference| <= 1) and the Hamming argmin takes the first minimum;
- the window correlation is kernel 3 (``ops/cuda_stereo.py``), reading the
  zero-padded pyramid stacks at the left slot's octave;
- the parabola refinement and median prune follow the reference.

Outputs are (B, K) u_right / depth with -1 for unmatched slots.
"""
from __future__ import annotations

import numpy as np
import torch

from .cuda_stereo import NBR_HALF, NBRHOOD, PATCH_HALF, stereo_costs
from .hamming import hamming_matrix

TH_HIGH = 100  # reference ORBmatcher.cpp:24-25
TH_LOW = 50
NO_MATCH = 29952  # the reference's 30000 as its bfloat16 distance table holds it


def _take(table, idx):
    return table[idx.long()]


def _f32(x):
    """A scalar as float32: a Python float rounded to float32, or a 0-dim
    float32 tensor as it is (the fused step's camera tensors)."""
    return x if isinstance(x, torch.Tensor) else float(np.float32(x))


def coarse_match(left, right, scales, inv_scales, level_widths, mbf: float,
                 min_z: float):
    """Row/disparity/octave gating, Hamming argmin, the (TH_HIGH+TH_LOW)/2
    acceptance and the window bounds check (orb_stereo_match.cu:119-290).

    scales, inv_scales: (L,) float32 tensors; level_widths: (L,) int32;
    mbf, min_z: Python floats or 0-dim float32 tensors."""
    vL, uL = left.ys, left.xs
    vR, uR = right.ys, right.xs
    r_right = 2.0 * _take(scales, right.octave)
    row_lo = torch.floor(vR - r_right)
    row_hi = torch.ceil(vR + r_right)
    t_row = torch.floor(vL)
    max_d = (mbf / min_z if isinstance(mbf, torch.Tensor)
             else float(np.float32(mbf) / np.float32(min_z)))
    ok = (left.valid[..., :, None] & right.valid[..., None, :]
          & (t_row[..., :, None] >= row_lo[..., None, :])
          & (t_row[..., :, None] <= row_hi[..., None, :])
          & ((left.octave[..., :, None] - right.octave[..., None, :]).abs() <= 1)
          & (uR[..., None, :] >= uL[..., :, None] - max_d)
          & (uR[..., None, :] <= uL[..., :, None]))
    dist = hamming_matrix(left.desc, right.desc)
    dist = torch.where(ok, dist, torch.full_like(dist, NO_MATCH))
    best_idx = torch.argmin(dist, dim=-1)
    best_dist = torch.gather(dist, -1, best_idx[..., None])[..., 0]
    matched = best_dist < (TH_HIGH + TH_LOW) // 2

    octave = left.octave
    inv_s = _take(inv_scales, octave)
    s = _take(scales, octave)
    uR0 = torch.gather(uR, -1, best_idx)
    scaled_uR0 = torch.round(uR0 * inv_s)
    scaled_uL0 = torch.round(uL * inv_s)
    scaled_vL0 = torch.round(vL * inv_s)
    w_lvl = _take(level_widths, octave).to(torch.float32)
    in_bounds = (scaled_uR0 - (PATCH_HALF + NBR_HALF) >= 0) & (
        scaled_uR0 + (PATCH_HALF + NBR_HALF) < w_lvl)
    matched = matched & in_bounds
    return dict(best_idx=best_idx, best_dist=best_dist, matched=matched,
                xl=scaled_uL0.to(torch.int32), xr=scaled_uR0.to(torch.int32),
                yy=scaled_vL0.to(torch.int32), s=s, max_d=max_d, uL=uL,
                scaled_uR0=scaled_uR0)


def refine_and_prune(costs, c, mbf: float):
    """Parabola subpixel, disparity/depth and median prune
    (orb_stereo_match.cu:1092-1175).  costs: (B, K, 11) float32."""
    matched, uL, s = c["matched"], c["uL"], c["s"]
    K = uL.shape[-1]
    best_r = torch.argmin(costs, dim=-1)
    best_cost = torch.gather(costs, -1, best_r[..., None])[..., 0]
    interior = (best_r > 0) & (best_r < NBRHOOD - 1)
    br = best_r.clamp(1, NBRHOOD - 2)
    d1 = torch.gather(costs, -1, (br - 1)[..., None])[..., 0]
    d2 = torch.gather(costs, -1, br[..., None])[..., 0]
    d3 = torch.gather(costs, -1, (br + 1)[..., None])[..., 0]
    denom = 2.0 * (d1 + d3 - 2.0 * d2)
    delta = torch.where(denom.abs() > 0, (d1 - d3) / denom,
                        torch.full_like(denom, 2.0))
    good_delta = (delta >= -1.0) & (delta <= 1.0)

    best_u_r = s * (c["scaled_uR0"] + br.to(torch.float32) - NBR_HALF + delta)
    disparity = uL - best_u_r
    in_disp = (disparity >= 0.0) & (disparity < c["max_d"])
    clamped = disparity <= 0.0
    disparity = torch.where(clamped, torch.full_like(disparity, 0.01), disparity)
    best_u_r = torch.where(clamped, uL - 0.01, best_u_r)

    accept = matched & interior & good_delta & in_disp
    neg = torch.full_like(uL, -1.0)
    # reciprocal times mbf: the rounding of ``float / tensor`` in torch
    depth = torch.where(accept, disparity.reciprocal() * _f32(mbf), neg)
    u_right = torch.where(accept, best_u_r, neg)

    # median-distance outlier pruning (orb_stereo_match.cu:565-580)
    n_acc = accept.sum(-1, keepdim=True)
    sort_costs = torch.sort(torch.where(accept, best_cost,
                                        torch.full_like(best_cost, float("inf"))),
                            dim=-1).values
    median = torch.gather(sort_costs, -1, (n_acc // 2).clamp(0, K - 1))
    th_dist = 1.5 * 1.4 * median
    keep = accept & (best_cost < th_dist)
    return torch.where(keep, u_right, neg), torch.where(keep, depth, neg)


def stereo_match(left, right, pyr_l, pyr_r, scales, inv_scales, level_widths,
                 mbf: float, min_z: float):
    """Dense stereo matching for a batch of frames.

    pyr_l, pyr_r: (B, L, H0, W0) uint8 zero-padded pyramid stacks.
    Returns (u_right, depth, best_dist), each (B, K)."""
    c = coarse_match(left, right, scales, inv_scales, level_widths, mbf, min_z)
    costs = stereo_costs(pyr_l, pyr_r, left.octave.to(torch.int32), c["yy"],
                         c["xl"], c["xr"], c["matched"])
    u_right, depth = refine_and_prune(costs.to(torch.float32), c, mbf)
    return u_right, depth, c["best_dist"]
