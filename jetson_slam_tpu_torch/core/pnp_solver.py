"""Batched PnP RANSAC for relocalization.

Port of ``jetson_slam_tpu/core/pnp_solver.py``, the replacement of
src/PnPsolver.cpp (EPnP + RANSAC): a batch of 4-point minimal samples, each
solved by alternating ray depths with a rigid (Kabsch) fit, scored by
reprojection chi2; the best hypothesis is refined by the pose optimizer in
the caller.

The minimal samples are an explicit input, ``sample``: positions into the
pool of valid correspondences (the valid indices in increasing order),
taken modulo the pool's size, drawn with replacement.  The tracker draws
them from a ``torch.Generator`` on the device (``draw_samples``); the
parity tests pass the positions that ``jax.random`` gives the JAX package.
Every function takes leading batch dimensions (candidates, hypotheses) and
none reads a value back to the host.
"""
from __future__ import annotations

import torch


def draw_samples(generator, shape, device):
    """Raw minimal-sample positions, uniform in [0, 2^31 - 1); a solver
    reduces them modulo its pool size."""
    return torch.randint(0, (1 << 31) - 1, shape, generator=generator,
                         device=device, dtype=torch.int64)


def valid_pool(valid):
    """(..., N) bool -> (..., N) int64: the valid indices in increasing
    order, then the others (``jnp.flatnonzero(valid, size=N)`` on its first
    sum(valid) entries, and index 0 first when none is valid), and the pool
    sizes (...,)."""
    order = torch.argsort((~valid).to(torch.int8), dim=-1, stable=True)
    return order, valid.sum(-1)


def pool_take(pool, n_valid, sample):
    """Indices of the minimal samples: sample (..., H, k) positions taken
    modulo max(n_valid, 1) into pool (..., N)."""
    pos = sample % torch.clamp(n_valid, min=1)[..., None, None]
    flat = pos.reshape(*pos.shape[:-2], -1)
    return torch.gather(pool, -1, flat).reshape(pos.shape)


def _kabsch(P_world, P_cam):
    """Rigid alignment world -> camera from paired point sets (..., n, 3).
    The reflection guard multiplies by sign(det), which is 0 for a
    degenerate fit, as in the JAX package."""
    cw = P_world.mean(-2)
    cc = P_cam.mean(-2)
    H = (P_world - cw[..., None, :]).transpose(-1, -2) @ (P_cam - cc[..., None, :])
    U, _, Vt = torch.linalg.svd(H)
    V = Vt.transpose(-1, -2)
    Ut = U.transpose(-1, -2)
    d = torch.sign(torch.linalg.det(V @ Ut))
    ones = torch.ones_like(d)
    D = torch.diag_embed(torch.stack([ones, ones, d], -1))
    R = V @ D @ Ut
    t = cc - (R @ cw[..., None])[..., 0]
    return R, t


def _p4p_depths(pw, uv, fx, fy, cx, cy, iters: int = 80):
    """Pose of 4-point samples (..., 4, 3) / (..., 4, 2) by alternating
    depths <- rigid fit, from depths at the sample's mean radius."""
    rays = torch.stack([(uv[..., 0] - cx) / fx, (uv[..., 1] - cy) / fy,
                        torch.ones_like(uv[..., 0])], -1)
    rays = rays / torch.linalg.norm(rays, dim=-1, keepdim=True)
    d0 = torch.linalg.norm(pw - pw.mean(-2, keepdim=True), dim=-1).mean(-1)
    depth = torch.clamp(d0, min=1e-3)[..., None].expand(rays.shape[:-1])
    R = t = None
    for _ in range(iters):
        R, t = _kabsch(pw, rays * depth[..., None])
        pc = pw @ R.transpose(-1, -2) + t[..., None, :]
        depth = torch.clamp((pc * rays).sum(-1), min=1e-3)
    return R, t


def _reproj_chi2(R, t, pw, uv, inv_sigma2, fx, fy, cx, cy):
    """chi2 and depth of every correspondence (..., N) under poses (..., 3, 3)."""
    pc = pw @ R.transpose(-1, -2) + t[..., None, :]
    z = torch.clamp(pc[..., 2], min=1e-9)
    u = fx * pc[..., 0] / z + cx
    v = fy * pc[..., 1] / z + cy
    e = (u - uv[..., 0]) ** 2 + (v - uv[..., 1]) ** 2
    return e * inv_sigma2, pc[..., 2]


def pnp_ransac(pw, uv, inv_sigma2, valid, fx, fy, cx, cy, sample,
               chi2_th: float = 5.991):
    """Batched PnP RANSAC.

    pw (..., N, 3) world points, uv (..., N, 2) observations, inv_sigma2
    (..., N) or (N,), valid (..., N) bool; sample (..., H, 4) int64
    minimal-sample positions into the valid pool.  Returns (R (..., 3, 3),
    t (..., 3), inliers (..., N), best_count (...)) of the first hypothesis
    with the most inliers."""
    pool, n_valid = valid_pool(valid)
    sel = pool_take(pool, n_valid, sample)                       # (..., H, 4)
    flat = sel.reshape(*sel.shape[:-2], -1)
    pw_s = torch.gather(pw, -2, flat[..., None].expand(*flat.shape, 3))
    uv_s = torch.gather(uv, -2, flat[..., None].expand(*flat.shape, 2))
    Rh, th = _p4p_depths(pw_s.reshape(*sel.shape, 3), uv_s.reshape(*sel.shape, 2),
                         fx, fy, cx, cy)                          # (..., H, 3, 3)
    chi2, z = _reproj_chi2(Rh, th, pw.unsqueeze(-3), uv.unsqueeze(-3),
                           inv_sigma2.unsqueeze(-2), fx, fy, cx, cy)
    inl = valid.unsqueeze(-2) & (chi2 < chi2_th) & (z > 0)       # (..., H, N)
    counts = inl.sum(-1)
    best = torch.argmax(counts, dim=-1)                           # first max
    R = torch.gather(Rh, -3, best[..., None, None, None].expand(*best.shape, 1, 3, 3))[..., 0, :, :]
    t = torch.gather(th, -2, best[..., None, None].expand(*best.shape, 1, 3))[..., 0, :]
    chi2, z = _reproj_chi2(R, t, pw, uv, inv_sigma2, fx, fy, cx, cy)
    inliers = valid & (chi2 < chi2_th) & (z > 0)
    return R, t, inliers, torch.gather(counts, -1, best[..., None])[..., 0]
