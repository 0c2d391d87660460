"""Sim(3) estimation: Horn's closed form and a batched RANSAC.

Port of ``jetson_slam_tpu/core/sim3_solver.py``, the replacement of
src/Sim3Solver.cpp: the closed-form similarity of 3-point samples (Horn
1987, in the SVD form of Umeyama), every hypothesis of the batch scored at
once, and the scale fixed to 1 for stereo (Sim3Solver.h:39-61).  As in
``core/pnp_solver.py`` the minimal samples are an explicit input:
positions into the valid pool, taken modulo its size.
"""
from __future__ import annotations

import torch

from .pnp_solver import pool_take, valid_pool


def horn_sim3(p1, p2, fix_scale: bool = False):
    """Closed-form S21 aligning p1 -> p2, both (..., N, 3): returns (s, R,
    t) with p2 ~= s R p1 + t."""
    c1 = p1.mean(-2)
    c2 = p2.mean(-2)
    x1 = p1 - c1[..., None, :]
    x2 = p2 - c2[..., None, :]
    cov = x2.transpose(-1, -2) @ x1
    U, _, Vt = torch.linalg.svd(cov)
    d = torch.sign(torch.linalg.det(U) * torch.linalg.det(Vt))
    ones = torch.ones_like(d)
    R = U @ torch.diag_embed(torch.stack([ones, ones, d], -1)) @ Vt
    rot1 = x1 @ R.transpose(-1, -2)
    if fix_scale:
        s = torch.ones_like(d)
    else:
        s = (x2 * rot1).sum((-1, -2)) / torch.clamp((rot1 * rot1).sum((-1, -2)),
                                                    min=1e-12)
    t = c2 - s[..., None] * (R @ c1[..., None])[..., 0]
    return s, R, t


def _project(p, cam):
    fx, fy, cx, cy = cam
    z = torch.clamp(p[..., 2], min=1e-9)
    return torch.stack([fx * p[..., 0] / z + cx, fy * p[..., 1] / z + cy], -1)


def _errors(s, R, t, p1, p2, obs1, obs2, cam1, cam2):
    """Squared reprojection errors of p1 into camera 2 and of p2 into
    camera 1 under S21 = (s, R, t) of shape (...,)."""
    p1_in2 = s[..., None, None] * (p1 @ R.transpose(-1, -2)) + t[..., None, :]
    si = 1.0 / s
    Ri = R.transpose(-1, -2)
    ti = -(Ri @ t[..., None])[..., 0] / s[..., None]
    p2_in1 = si[..., None, None] * (p2 @ Ri.transpose(-1, -2)) + ti[..., None, :]
    e2 = ((_project(p1_in2, cam2) - obs2) ** 2).sum(-1)
    e1 = ((_project(p2_in1, cam1) - obs1) ** 2).sum(-1)
    return e1, e2


def sim3_ransac(p1, p2, valid, cam1_proj, cam2_proj, th1, th2, sample,
                fix_scale: bool = False):
    """Batched Sim(3) RANSAC.

    p1, p2 (N, 3): matched points in the cameras of keyframes 1 and 2;
    valid (N,) bool; cam*_proj = (fx, fy, cx, cy); th1, th2 (N,) per-point
    chi2 thresholds (9.21 sigma^2, Sim3Solver.cpp mvnMaxError); sample
    (H, 3) int64 minimal-sample positions into the valid pool.  Returns (s,
    R, t, inliers, best_count): the S21 mapping p1 into camera 2 of the
    first hypothesis with the most inliers."""
    obs1 = _project(p1, cam1_proj)
    obs2 = _project(p2, cam2_proj)
    pool, n_valid = valid_pool(valid)
    sel = pool_take(pool, n_valid, sample)                        # (H, 3)
    sh, Rh, th = horn_sim3(p1[sel], p2[sel], fix_scale)
    e1, e2 = _errors(sh, Rh, th, p1, p2, obs1, obs2, cam1_proj, cam2_proj)
    counts = (valid & (e1 < th1) & (e2 < th2)).sum(-1)
    best = torch.argmax(counts)                                   # first max
    s, R, t = sh[best], Rh[best], th[best]
    e1, e2 = _errors(s, R, t, p1, p2, obs1, obs2, cam1_proj, cam2_proj)
    inliers = valid & (e1 < th1) & (e2 < th2)
    return s, R, t, inliers, counts[best]
