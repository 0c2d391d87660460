"""Motion-only bundle adjustment, the plain reference of the tracker's pose.

ORB-SLAM2's ``Optimizer::PoseOptimization`` (Optimizer.cpp:244-456) as the
port states it: 4 rounds of 10 Levenberg-Marquardt iterations from the
input pose, chi2 gates 5.991 (monocular) and 7.815 (stereo), the Huber
kernel on rounds 0 to 2, the outliers classified again after each round.
Left perturbation T <- exp(dx) T with dx = (rho, phi) and the closed-form
Jacobian of the stereo projection (u, v, u_r).

Plain PyTorch on the CPU in ``dtype`` (float64 for the reference,
bfloat16 for the lower-precision control; the 6x6 solve of a bfloat16 run
is done in float32, which torch needs).  A solve that fails (no observation
left active) gives a step that is not finite, which is rejected like any
other, as the port's ``solve_ex`` gives it.
"""
from __future__ import annotations

import torch

CHI2_MONO = 5.991
CHI2_STEREO = 7.815
LM_TAU = 1e-5


def _hat(w):
    z = torch.zeros_like(w[0])
    return torch.stack([torch.stack([z, -w[2], w[1]]), torch.stack([w[2], z, -w[0]]),
                        torch.stack([-w[1], w[0], z])])


def _exp_se3(dx):
    rho, phi = dx[:3], dx[3:]
    th = torch.sqrt((phi * phi).sum())
    W = _hat(phi)
    I3 = torch.eye(3, dtype=dx.dtype)
    if float(th) < 1e-8:
        A, B, C = 1.0, 0.5, 1.0 / 6.0
    else:
        A = torch.sin(th) / th
        B = (1 - torch.cos(th)) / th ** 2
        C = (th - torch.sin(th)) / th ** 3
    R = I3 + A * W + B * (W @ W)
    V = I3 + B * W + C * (W @ W)
    return R, V @ rho


def pose_optimization(R0, t0, points, obs_uv, obs_ur, inv_sigma2, valid,
                      fx, fy, cx, cy, bf, dtype=torch.float64):
    """Returns (R, t, inlier, margin) as numpy float64 / bool / float; every
    argument numpy (N rows; obs_ur < 0 for a monocular observation).
    ``margin``: the least relative distance |chi2 - gate| / gate of a valid
    observation at any of the four classifications, where a rounding of
    the pose can move an observation across its gate."""
    T = lambda a: torch.as_tensor(a).to(dtype)  # noqa: E731
    pts, uv, ur, w0 = T(points), T(obs_uv), T(obs_ur), T(inv_sigma2)
    valid = torch.as_tensor(valid, dtype=torch.bool)
    R0, t0 = T(R0), T(t0)
    is_st = ur >= 0
    obs = torch.cat([uv, torch.where(is_st, ur, torch.zeros_like(ur))[:, None]], 1)
    mask = torch.stack([torch.ones_like(ur), torch.ones_like(ur), is_st.to(dtype)], 1)
    delta2 = torch.where(is_st, torch.full_like(ur, CHI2_STEREO),
                         torch.full_like(ur, CHI2_MONO))
    fx, fy, cx, cy, bf = (T(float(v)) for v in (fx, fy, cx, cy, bf))

    def project(R, t):
        q = pts @ R.T + t
        invz = 1.0 / torch.clamp(q[:, 2], min=1e-6)
        u = fx * q[:, 0] * invz + cx
        v = fy * q[:, 1] * invz + cy
        return torch.stack([u, v, u - bf * invz], 1) - obs, q

    def chi2_of(r):
        return (r * r * mask).sum(1) * w0

    def jac(q):
        x, y, z = q[:, 0], q[:, 1], torch.clamp(q[:, 2], min=1e-6)
        iz, iz2 = 1.0 / z, 1.0 / (z * z)
        zero = torch.zeros_like(x)
        P = torch.stack([torch.stack([fx * iz, zero, -fx * x * iz2], 1),
                         torch.stack([zero, fy * iz, -fy * y * iz2], 1),
                         torch.stack([fx * iz, zero, (bf - fx * x) * iz2], 1)], 1)
        hq = torch.stack([torch.stack([zero, -q[:, 2], q[:, 1]], 1),
                          torch.stack([q[:, 2], zero, -q[:, 0]], 1),
                          torch.stack([-q[:, 1], q[:, 0], zero], 1)], 1)
        I3 = torch.eye(3, dtype=dtype).expand(len(x), 3, 3)
        return P @ torch.cat([I3, -hq], 2)

    def lm(active, huber):
        def weights(r):
            w = w0
            if huber:
                c = chi2_of(r)
                w = torch.where(c <= delta2, torch.ones_like(c),
                                torch.sqrt(delta2) / torch.sqrt(torch.clamp(c, min=1e-12))) * w
            return torch.where(active, w, torch.zeros_like(w))

        def cost(r):
            c = chi2_of(r)
            if huber:
                e = torch.sqrt(torch.clamp(c, min=1e-12))
                c = torch.where(c <= delta2, c, 2.0 * torch.sqrt(delta2) * e - delta2)
            return torch.where(active, c, torch.zeros_like(c)).sum()

        def build(r, q):
            J = jac(q) * mask[:, :, None]
            Jw = J * weights(r)[:, None, None]
            return (torch.einsum("nij,nik->jk", Jw, J),
                    torch.einsum("nij,ni->j", Jw, r * mask))

        R, t = R0, t0
        r, q = project(R, t)
        f0 = cost(r)
        H, _ = build(r, q)
        lam = LM_TAU * torch.diagonal(H).max()
        nu = 2.0
        for _ in range(10):
            H, g = build(r, q)
            sdt = torch.float64 if dtype == torch.float64 else torch.float32
            dx = torch.linalg.solve_ex((H + lam * torch.eye(6, dtype=dtype)).to(sdt),
                                       -g.to(sdt))[0].to(dtype)
            dR, dt = _exp_se3(dx)
            Rn, tn = dR @ R, dR @ t + dt
            r1, q1 = project(Rn, tn)
            f1 = cost(r1)
            pred = 0.5 * torch.dot(dx, lam * dx - g)
            rho = (f0 - f1) / torch.clamp(pred, min=1e-12)
            if bool(rho > 0) and bool(torch.isfinite(dx).all()):
                R, t, r, q, f0 = Rn, tn, r1, q1, f1
                lam = lam * max(1.0 - (2.0 * float(rho) - 1.0) ** 3, 1.0 / 3.0)
                nu = 2.0
            else:
                lam = lam * nu
                nu *= 2.0
        return R, t

    inlier = valid
    R, t = R0, t0
    margin = float("inf")
    for rnd in range(4):
        R, t = lm(inlier, rnd < 3)
        r, _ = project(R, t)
        c = chi2_of(r)
        inlier = valid & (c <= delta2)
        if bool(valid.any()):
            margin = min(margin, float(((c - delta2).abs() / delta2)[valid].min()))
    return (R.to(torch.float64).numpy(), t.to(torch.float64).numpy(),
            inlier.numpy(), margin)
