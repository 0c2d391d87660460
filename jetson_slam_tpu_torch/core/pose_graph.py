"""Sim(3) pose-graph optimization (the essential graph).

Port of ``jetson_slam_tpu/core/pose_graph.py``, the replacement of
Optimizer::OptimizeEssentialGraph (src/Optimizer.cpp:786-1049 on g2o's
Sim(3) types): the vertices are world -> camera Sim(3) poses (scale fixed
to 1 for stereo, Optimizer.cpp:823), the edges relative Sim(3)
measurements with identity information, solved by LM on dense normal
equations over 7K unknowns.  The edge Jacobians come from forward mode
(``torch.func.jvp``), taken in float64 (see ``core/optimizer.py``); the
rest runs in the poses' dtype, with no host synchronisation.
"""
from __future__ import annotations

import torch

from ..utils.lie import exp_sim3, log_sim3, sim3_compose, sim3_inverse


def _edge_error(xi_i, xi_j, si, Ri, ti, sj, Rj, tj, ms, mR, mt,
                fix_scale: bool):
    """e = log(S_ij_meas^-1 * (exp(xi_i) S_i) * (exp(xi_j) S_j)^-1)."""
    if fix_scale:
        xi_i = torch.cat([xi_i[..., :6], torch.zeros_like(xi_i[..., 6:])], -1)
        xi_j = torch.cat([xi_j[..., :6], torch.zeros_like(xi_j[..., 6:])], -1)
    a = sim3_compose(*exp_sim3(xi_i), si, Ri, ti)
    b = sim3_compose(*exp_sim3(xi_j), sj, Rj, tj)
    ji = sim3_compose(*a, *sim3_inverse(*b))
    return log_sim3(*sim3_compose(ms, mR, mt, *ji))


def pose_graph_optimize(s, R, t, fixed, e_i, e_j, meas_inv_s, meas_inv_R,
                        meas_inv_t, e_valid, n_iters: int = 20,
                        fix_scale: bool = True):
    """Optimise Sim(3) vertices against relative-pose edges.

    s (K,), R (K, 3, 3), t (K, 3): the initial world -> camera Sim(3) of
    each keyframe; fixed (K,) bool; e_i, e_j (E,) endpoint indices;
    meas_inv_* the inverse measurements S_ij^-1; e_valid (E,) bool.
    Returns the optimised (s, R, t)."""
    K = s.shape[0]
    dt_ = t.dtype
    dev = t.device
    ei = e_i.to(torch.int64)
    ej = e_j.to(torch.int64)
    E = ei.shape[0]
    free = (~fixed).to(dt_)
    w = e_valid.to(dt_)
    zeros = torch.zeros(E, 7, dtype=dt_, device=dev)
    meas = (meas_inv_s, meas_inv_R, meas_inv_t)

    def residuals(s_all, R_all, t_all):
        return _edge_error(zeros, zeros, s_all[ei], R_all[ei], t_all[ei],
                           s_all[ej], R_all[ej], t_all[ej], *meas, fix_scale)

    def jacobians(s_all, R_all, t_all):
        # every edge's error depends on its own (xi_i, xi_j) alone, so one
        # forward-mode pass per tangent basis vector, shared by all edges,
        # gives every edge's 7x7 blocks (vmap over the edges instead gives
        # non-finite tangents through log_sim3's guarded branches)
        d = torch.float64
        args = tuple(a.to(d) for a in (s_all[ei], R_all[ei], t_all[ei],
                                       s_all[ej], R_all[ej], t_all[ej], *meas))
        z = torch.zeros(E, 14, dtype=d, device=dev)

        def err(x):
            return _edge_error(x[:, :7], x[:, 7:], *args, fix_scale)

        basis = torch.eye(14, dtype=d, device=dev)[:, None, :].expand(14, E, 14)
        J = torch.func.vmap(lambda v: torch.func.jvp(err, (z,), (v,))[1])(basis)
        J = J.permute(1, 2, 0).to(dt_)                            # (E, 7, 14)
        return J[..., :7], J[..., 7:]

    def cost(s_all, R_all, t_all):
        r = residuals(s_all, R_all, t_all)
        return (w * (r * r).sum(1)).sum()

    I7 = torch.eye(7, dtype=dt_, device=dev)
    diag = torch.arange(K, device=dev)
    lam = torch.full((), 1e-6, dtype=dt_, device=dev)
    for _ in range(n_iters):
        r = residuals(s, R, t)                                    # (E, 7)
        Ji, Jj = jacobians(s, R, t)                               # (E, 7, 7)
        Ji = Ji * free[ei][:, None, None]
        Jj = Jj * free[ej][:, None, None]
        Hii = torch.einsum("eij,eik,e->ejk", Ji, Ji, w)
        Hjj = torch.einsum("eij,eik,e->ejk", Jj, Jj, w)
        Hij = torch.einsum("eij,eik,e->ejk", Ji, Jj, w)
        gi = torch.einsum("eij,ei,e->ej", Ji, r, w)
        gj = torch.einsum("eij,ei,e->ej", Jj, r, w)
        # block scatter-add of the normal equations
        Hblk = torch.zeros(K * K, 7, 7, dtype=dt_, device=dev)
        Hblk.index_add_(0, ei * K + ei, Hii)
        Hblk.index_add_(0, ej * K + ej, Hjj)
        Hblk.index_add_(0, ei * K + ej, Hij)
        Hblk.index_add_(0, ej * K + ei, Hij.transpose(-1, -2))
        Hblk = Hblk.reshape(K, K, 7, 7)
        g = torch.zeros(K, 7, dtype=dt_, device=dev)
        g.index_add_(0, ei, gi)
        g.index_add_(0, ej, gj)
        Hblk[diag, diag] += lam * I7
        # fixed vertices: identity rows and columns
        Hblk = Hblk * free[:, None, None, None] * free[None, :, None, None]
        Hblk[diag, diag] += fixed.to(dt_)[:, None, None] * I7
        g = g * free[:, None]
        Hd = Hblk.permute(0, 2, 1, 3).reshape(7 * K, 7 * K)
        dx, _ = torch.linalg.solve_ex(Hd, -g.reshape(-1))
        dx = dx.reshape(K, 7) * free[:, None]
        if fix_scale:
            dx = torch.cat([dx[:, :6], torch.zeros_like(dx[:, 6:])], 1)
        sn, Rn, tn = sim3_compose(*exp_sim3(dx), s, R, t)
        f0 = cost(s, R, t)
        f1 = cost(sn, Rn, tn)
        ok = (f1 < f0) & torch.isfinite(f1)
        s = torch.where(ok, sn, s)
        R = torch.where(ok, Rn, R)
        t = torch.where(ok, tn, t)
        lam = torch.where(ok, lam / 2.0, lam * 4.0)
    return s, R, t
