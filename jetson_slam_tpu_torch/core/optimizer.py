"""Pose and Sim(3) optimization (Levenberg-Marquardt) in PyTorch.

Port of ``jetson_slam_tpu/core/optimizer.py``.  ``pose_optimization`` is
the replacement of g2o's Optimizer::PoseOptimization (Optimizer.cpp:244-456):
4 rounds x 10 LM iterations, chi2 gates 5.991 (mono) / 7.815 (stereo), the
Huber kernel on rounds 0-2, outliers re-classified between rounds, each
round restarting from the input pose.  The Jacobian is the closed form
J = dproj/dpc @ [I | -hat(q)].

Every branch is a ``torch.where`` on device values, so the 40 iterations
queue on the card without a host synchronisation; the 6x6 solves use
``torch.linalg.solve_ex``, which does not check for errors on the host (a
failed solve gives non-finite steps, which are rejected like any other bad
step).

The LM runs in float64 whatever the inputs' dtype, as g2o's doubles do,
and returns the pose in the inputs' dtype.  A frame whose observations
hold the pose weakly (monocular points far away against a short baseline:
a sideways translation trades against a rotation) gives normal equations
with a condition number up to 1e7, where float32's rounding is of the
order of the step itself: ten float32 iterations stop anywhere along the
valley (5e-3 map units from float64 in one such frame on an H100).  The
inputs keep their values; only the arithmetic is widened.

``sim3_optimization`` is Optimizer::OptimizeSim3 (Optimizer.cpp:1051-1248)
for loop closing.  Its Jacobians come from ``torch.func.jacfwd`` of the
residual at the identity retraction, as the JAX package's from
``jax.jacfwd``; torch's forward mode through ``utils/lie.py`` needs float64
(a float32 0-dim Taylor term gets a float64 tangent), so the Jacobian is
taken in float64 and used in float32.
"""
from __future__ import annotations

import torch

from ..utils.lie import exp_se3, exp_sim3, se3_compose, sim3_compose

CHI2_MONO = 5.991
CHI2_STEREO = 7.815
CHI2_SIM3 = 10.0   # Optimizer::OptimizeSim3 deltaHuber^2 (Optimizer.cpp:1100)
LM_TAU = 1e-5


def pose_optimization(Rcw, tcw, points, obs_uv, obs_ur, inv_sigma2, valid,
                      fx, fy, cx, cy, bf):
    """Motion-only bundle adjustment.

    Rcw (3, 3), tcw (3,): initial world->camera pose.  points (N, 3): world
    positions of the matched points.  obs_uv (N, 2): undistorted keypoints.
    obs_ur (N,): right-image u, < 0 for monocular observations.
    inv_sigma2 (N,): per-octave information weight.  valid (N,) bool.
    fx .. bf: floats or 0-dim tensors.  Solved in float64; returns
    (Rcw', tcw' in tcw's dtype, inlier (N,) bool, n_inliers int32 tensor).
    """
    out_dtype = tcw.dtype
    dt_ = torch.float64
    Rcw, tcw, points, obs_uv, obs_ur, inv_sigma2 = (
        x.to(dt_) for x in (Rcw, tcw, points, obs_uv, obs_ur, inv_sigma2))
    fx, fy, cx, cy, bf = (c.to(dt_) if isinstance(c, torch.Tensor) else c
                          for c in (fx, fy, cx, cy, bf))
    N = points.shape[0]
    dev = tcw.device
    is_stereo = obs_ur >= 0
    obs = torch.cat([obs_uv, torch.where(is_stereo, obs_ur,
                                         torch.zeros_like(obs_ur))[:, None]], 1)
    ones = torch.ones(N, dtype=dt_, device=dev)
    comp_mask = torch.stack([ones, ones, is_stereo.to(dt_)], 1)
    delta2 = torch.where(is_stereo, torch.full_like(ones, CHI2_STEREO),
                         torch.full_like(ones, CHI2_MONO))
    sqrt_delta2 = torch.sqrt(delta2)
    eye6 = torch.eye(6, dtype=dt_, device=dev)

    def project(R, t):
        q = points @ R.T + t
        invz = 1.0 / torch.clamp(q[:, 2], min=1e-6)
        u = fx * q[:, 0] * invz + cx
        v = fy * q[:, 1] * invz + cy
        ur = u - bf * invz
        return torch.stack([u, v, ur], 1) - obs, q

    def jac(q):
        x, y, zraw = q[:, 0], q[:, 1], q[:, 2]
        invz = 1.0 / torch.clamp(zraw, min=1e-6)
        invz2 = invz * invz * (zraw >= 1e-6).to(dt_)
        zero = torch.zeros_like(x)
        Pj = torch.stack([
            torch.stack([fx * invz, zero, -fx * x * invz2], 1),
            torch.stack([zero, fy * invz, -fy * y * invz2], 1),
            torch.stack([fx * invz, zero, (bf - fx * x) * invz2], 1),
        ], 1)
        hatq = torch.stack([
            torch.stack([zero, -q[:, 2], q[:, 1]], 1),
            torch.stack([q[:, 2], zero, -q[:, 0]], 1),
            torch.stack([-q[:, 1], q[:, 0], zero], 1),
        ], 1)
        I3 = torch.eye(3, dtype=dt_, device=dev).expand(N, 3, 3)
        return Pj @ torch.cat([I3, -hatq], 2)

    def chi2_of(r):
        return (r * r * comp_mask).sum(1) * inv_sigma2

    def lm_solve(R0, t0, active, use_huber: bool):
        def cost_of(r):
            chi2 = chi2_of(r)
            if use_huber:
                e = torch.sqrt(torch.clamp(chi2, min=1e-12))
                chi2 = torch.where(chi2 <= delta2, chi2,
                                   2.0 * sqrt_delta2 * e - delta2)
            return torch.where(active, chi2, torch.zeros_like(chi2)).sum()

        def build(r, q):
            J = jac(q)
            w = inv_sigma2
            if use_huber:
                chi2 = chi2_of(r)
                w = torch.where(chi2 <= delta2, ones,
                                sqrt_delta2 / torch.sqrt(torch.clamp(chi2, min=1e-12))) * w
            w = torch.where(active, w, torch.zeros_like(w))
            Jm = J * comp_mask[:, :, None]
            Jw = Jm * w[:, None, None]
            Hm = torch.einsum("nij,nik->jk", Jw, Jm)
            g = torch.einsum("nij,ni->j", Jw, r * comp_mask)
            return Hm, g

        r, q = project(R0, t0)
        f0 = cost_of(r)
        H0, _ = build(r, q)
        lam = LM_TAU * torch.diagonal(H0).max()
        nu = torch.full((), 2.0, dtype=dt_, device=dev)   # no host copy
        R, t = R0, t0
        for _ in range(10):
            Hm, g = build(r, q)
            dx, info = torch.linalg.solve_ex(Hm + lam * eye6, -g)
            dR, dtr = exp_se3(dx)
            Rn, tn = se3_compose(dR, dtr, R, t)
            r1, q1 = project(Rn, tn)
            f1 = cost_of(r1)
            pred = 0.5 * torch.dot(dx, lam * dx - g)
            rho = (f0 - f1) / torch.clamp(pred, min=1e-12)
            ok = (rho > 0) & torch.isfinite(dx).all() & (info == 0)
            R = torch.where(ok, Rn, R)
            t = torch.where(ok, tn, t)
            r = torch.where(ok, r1, r)
            q = torch.where(ok, q1, q)
            f0 = torch.where(ok, f1, f0)
            lam = torch.where(
                ok, lam * torch.clamp(1.0 - (2.0 * rho - 1.0) ** 3, min=1.0 / 3.0),
                lam * nu)
            nu = torch.where(ok, torch.full_like(nu, 2.0), nu * 2.0)
        return R, t

    inlier = valid
    R_out, t_out = Rcw, tcw
    for rnd in range(4):
        R_out, t_out = lm_solve(Rcw, tcw, inlier, rnd < 3)
        r, _ = project(R_out, t_out)
        inlier = valid & (chi2_of(r) <= delta2)
    return (R_out.to(out_dtype), t_out.to(out_dtype), inlier,
            inlier.sum(dtype=torch.int32))


def sim3_optimization(P1, P2, obs1, obs2, inv_s2_1, inv_s2_2, valid,
                      s0, R0, t0, fx, fy, cx, cy, fix_scale: bool = True):
    """Sim(3) refinement between two keyframes.

    P1, P2 (N, 3): matched points in the cameras of keyframes 1 and 2;
    obs1, obs2 (N, 2): their keypoints; (s0, R0, t0): the initial S12 that
    maps camera-2 coordinates into camera 1.  Bidirectional reprojection
    residuals under Huber(sqrt(10)); after 5 iterations the edges with
    chi2 > 10 in either direction are dropped and 10 more run on the rest.
    Returns (s, R, t, inlier, n_inliers) as tensors."""
    dev = P1.device
    dt_ = P1.dtype
    s0 = torch.as_tensor(s0, dtype=dt_, device=dev)
    zero = torch.zeros(7, dtype=dt_, device=dev)
    eye7 = torch.eye(7, dtype=dt_, device=dev)
    w4 = torch.stack([inv_s2_1, inv_s2_1, inv_s2_2, inv_s2_2], 1)
    sqrt_th = CHI2_SIM3 ** 0.5

    def params_of(xi, s, R, t):
        ds, dR, dtr = exp_sim3(xi)
        return sim3_compose(ds, dR, dtr, s, R, t)

    def residuals(xi, s, R, t, P1, P2, o1, o2):
        sn, Rn, tn = params_of(xi, s, R, t)

        def proj(p):
            z = torch.clamp(p[:, 2], min=1e-6)
            return torch.stack([fx * p[:, 0] / z + cx, fy * p[:, 1] / z + cy], 1)

        q1 = sn * (P2 @ Rn.T) + tn                      # camera 2 -> 1
        q2 = ((P1 - tn) @ Rn) / sn                      # camera 1 -> 2
        return torch.cat([proj(q1) - o1, proj(q2) - o2], 1)      # (N, 4)

    def jacobian(s, R, t):
        d = torch.float64
        args = (s.to(d), R.to(d), t.to(d), P1.to(d), P2.to(d), obs1.to(d),
                obs2.to(d))
        J = torch.func.jacfwd(residuals)(zero.to(d), *args)       # (N, 4, 7)
        return J.to(dt_)

    def chi2_dir(r):
        return (r[:, :2] ** 2).sum(1) * inv_s2_1, (r[:, 2:] ** 2).sum(1) * inv_s2_2

    def huber(c):
        return torch.where(c <= CHI2_SIM3, c,
                           2 * sqrt_th * torch.sqrt(torch.clamp(c, min=1e-12)) - CHI2_SIM3)

    def hweight(c):
        return torch.where(c <= CHI2_SIM3, torch.ones_like(c),
                           sqrt_th / torch.sqrt(torch.clamp(c, min=1e-12)))

    def cost(s, R, t, active):
        e1, e2 = chi2_dir(residuals(zero, s, R, t, P1, P2, obs1, obs2))
        c = huber(e1) + huber(e2)
        return torch.where(active, c, torch.zeros_like(c)).sum()

    def build(s, R, t, active):
        r = residuals(zero, s, R, t, P1, P2, obs1, obs2)
        J = jacobian(s, R, t)
        e1, e2 = chi2_dir(r)
        wh = torch.stack([hweight(e1), hweight(e1), hweight(e2), hweight(e2)], 1)
        w = w4 * wh * active[:, None].to(dt_)
        Jw = J * w[:, :, None]
        H = torch.einsum("nij,nik->jk", Jw, J)
        g = torch.einsum("nij,ni->j", Jw, r)
        if fix_scale:   # lock the log-scale coordinate
            H = H.clone()
            H[6, :] = 0.0
            H[:, 6] = 0.0
            H[6, 6] = 1.0
            g = g.clone()
            g[6] = 0.0
        return H, g

    def lm(s, R, t, active, n_iters: int):
        H0, _ = build(s, R, t, active)
        lam = LM_TAU * torch.diagonal(H0).max()
        nu = torch.full((), 2.0, dtype=dt_, device=dev)
        for _ in range(n_iters):
            H, g = build(s, R, t, active)
            dx, info = torch.linalg.solve_ex(H + lam * eye7, -g)
            sn, Rn, tn = params_of(dx, s, R, t)
            f0 = cost(s, R, t, active)
            f1 = cost(sn, Rn, tn, active)
            ok = (f1 < f0) & torch.isfinite(dx).all() & (info == 0)
            s = torch.where(ok, sn, s)
            R = torch.where(ok, Rn, R)
            t = torch.where(ok, tn, t)
            lam = torch.where(ok, lam / 3.0, lam * nu)
            nu = torch.where(ok, torch.full_like(nu, 2.0), nu * 2.0)
        return s, R, t

    def inliers(s, R, t):
        e1, e2 = chi2_dir(residuals(zero, s, R, t, P1, P2, obs1, obs2))
        return valid & (e1 <= CHI2_SIM3) & (e2 <= CHI2_SIM3)

    s, R, t = lm(s0, R0, t0, valid, 5)
    s, R, t = lm(s, R, t, inliers(s, R, t), 10)
    inlier = inliers(s, R, t)
    return s, R, t, inlier, inlier.sum(dtype=torch.int32)
