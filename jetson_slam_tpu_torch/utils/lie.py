"""SO(3) / SE(3) / Sim(3) operations in PyTorch (and one numpy helper).

Port of ``jetson_slam_tpu/utils/lie.py``: pure functions on (R, t) and
(s, R, t) tuples of tensors.  The SE(3) tangent is ordered [rho
(translation), phi (rotation)], the g2o::SE3Quat convention; the Sim(3)
tangent appends sigma = log(s).  Every function takes leading batch
dimensions and is safe under ``torch.func.jacfwd`` at the identity (Taylor
branches, and the exact branches see clamped arguments).
"""
from __future__ import annotations

import numpy as np
import torch

_EPS = 1e-8


def hat(w):
    """so(3) hat operator: (..., 3) -> (..., 3, 3)."""
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    z = torch.zeros_like(wx)
    return torch.stack([torch.stack([z, -wz, wy], -1),
                        torch.stack([wz, z, -wx], -1),
                        torch.stack([-wy, wx, z], -1)], -2)


def vee(W):
    """Inverse of hat: (..., 3, 3) -> (..., 3)."""
    return torch.stack([W[..., 2, 1], W[..., 0, 2], W[..., 1, 0]], -1)


def _sinc(x):
    """sin(x) / x with a Taylor guard."""
    small = x.abs() < 1e-4
    safe = torch.where(small, torch.ones_like(x), x)
    return torch.where(small, 1.0 - x * x / 6.0, torch.sin(safe) / safe)


def _cosc(x):
    """(1 - cos(x)) / x^2 with a Taylor guard."""
    small = x.abs() < 1e-4
    safe = torch.where(small, torch.ones_like(x), x)
    return torch.where(small, 0.5 - x * x / 24.0,
                       (1.0 - torch.cos(safe)) / (safe * safe))


def _theta_coeffs(phi):
    """(A, B, C) = (sin t / t, (1 - cos t) / t^2, (t - sin t) / t^3) with
    Taylor branches near t = 0."""
    t2 = (phi * phi).sum(-1)
    small = t2 < 1e-8
    safe_t2 = torch.where(small, torch.ones_like(t2), t2)
    t = torch.sqrt(safe_t2)
    A = torch.where(small, 1.0 - t2 / 6.0, torch.sin(t) / t)
    B = torch.where(small, 0.5 - t2 / 24.0, (1.0 - torch.cos(t)) / safe_t2)
    C = torch.where(small, 1.0 / 6.0 - t2 / 120.0,
                    (t - torch.sin(t)) / (safe_t2 * t))
    return A, B, C


def exp_so3(phi):
    """Rodrigues: (..., 3) -> (..., 3, 3)."""
    A, B, _ = _theta_coeffs(phi)
    W = hat(phi)
    I = torch.eye(3, dtype=phi.dtype, device=phi.device).expand(W.shape)
    return I + A[..., None, None] * W + B[..., None, None] * (W @ W)


def log_so3(R):
    """(..., 3, 3) -> (..., 3) for angles in [0, pi): atan2 of the sine and
    cosine parts (finite slope at the identity), and the diagonal form of
    the axis above 3 rad."""
    trace = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    cos_theta = torch.clamp((trace - 1.0) * 0.5, -1.0, 1.0)
    w = vee(R - R.transpose(-1, -2)) * 0.5          # sin(theta) * axis
    sin_theta = torch.sqrt((w * w).sum(-1) + 1e-24)
    theta = torch.atan2(sin_theta, cos_theta)
    phi = w / torch.clamp(_sinc(theta)[..., None], min=_EPS)
    # near pi: axis_i^2 = (R_ii + 1) / 2, signs from the off-diagonals
    diag = torch.stack([R[..., 0, 0], R[..., 1, 1], R[..., 2, 2]], -1)
    axis_abs = torch.sqrt(torch.clamp((diag + 1.0) * 0.5, 0.0, 1.0))
    one = torch.ones_like(trace)
    sign_y = torch.where(R[..., 0, 1] + R[..., 1, 0] >= 0, one, -one)
    sign_z = torch.where(R[..., 0, 2] + R[..., 2, 0] >= 0, one, -one)
    axis = axis_abs * torch.stack([one, sign_y, sign_z], -1)
    axis = axis / torch.clamp(torch.linalg.norm(axis, dim=-1, keepdim=True),
                              min=_EPS)
    return torch.where((theta > 3.0)[..., None], axis * theta[..., None], phi)


def left_jacobian_so3(phi):
    """SO(3) left Jacobian J_l(phi): (..., 3) -> (..., 3, 3)."""
    _, B, C = _theta_coeffs(phi)
    W = hat(phi)
    I = torch.eye(3, dtype=phi.dtype, device=phi.device).expand(W.shape)
    return I + B[..., None, None] * W + C[..., None, None] * (W @ W)


def exp_se3(xi):
    """se(3) exp: xi = [rho(3), phi(3)] -> (R, t)."""
    rho, phi = xi[..., :3], xi[..., 3:6]
    R = exp_so3(phi)
    t = (left_jacobian_so3(phi) @ rho[..., None])[..., 0]
    return R, t


def log_se3(R, t):
    phi = log_so3(R)
    rho = torch.linalg.solve(left_jacobian_so3(phi), t[..., None])[..., 0]
    return torch.cat([rho, phi], -1)


def se3_compose(Ra, ta, Rb, tb):
    """(Ra, ta) * (Rb, tb)."""
    return Ra @ Rb, (Ra @ tb[..., None])[..., 0] + ta


def se3_inverse(R, t):
    Rt = R.transpose(-1, -2)
    return Rt, -(Rt @ t[..., None])[..., 0]


def se3_apply(R, t, p):
    """(R, t) applied to points p (..., 3)."""
    return (R @ p[..., None])[..., 0] + t


def se3_matrix(R, t):
    """(R, t) -> (..., 4, 4) homogeneous matrix."""
    bottom = torch.zeros(R.shape[:-2] + (1, 4), dtype=R.dtype, device=R.device)
    bottom[..., 0, 3] = 1.0
    return torch.cat([torch.cat([R, t[..., None]], -1), bottom], -2)


def se3_from_matrix(T):
    return T[..., :3, :3], T[..., :3, 3]


def se3_retract(R, t, xi):
    """Left-multiplicative update exp(xi) * (R, t), g2o's SE3 vertex
    convention."""
    dR, dt = exp_se3(xi)
    return se3_compose(dR, dt, R, t)


# ---------------------------------------------------------------------------
# Sim(3), for loop closing (Sim3Solver.cpp, Optimizer.cpp OptimizeSim3 and
# OptimizeEssentialGraph on g2o::Sim3).  S = (s, R, t); S * p = s R p + t.
# ---------------------------------------------------------------------------

def sim3_apply(s, R, t, p):
    return s[..., None] * (R @ p[..., None])[..., 0] + t


def sim3_compose(sa, Ra, ta, sb, Rb, tb):
    """Sa * Sb."""
    return sa * sb, Ra @ Rb, sa[..., None] * (Ra @ tb[..., None])[..., 0] + ta


def sim3_inverse(s, R, t):
    Rt = R.transpose(-1, -2)
    inv_s = 1.0 / s
    return inv_s, Rt, -inv_s[..., None] * (Rt @ t[..., None])[..., 0]


def exp_sim3(xi):
    """sim(3) exp: xi = [rho(3), phi(3), sigma(1)] -> (s, R, t), with the
    closed-form W matrix (Eade's notes, Strasdat's thesis)."""
    rho, phi, sigma = xi[..., :3], xi[..., 3:6], xi[..., 6]
    W = _sim3_W(sigma, phi)
    return torch.exp(sigma), exp_so3(phi), (W @ rho[..., None])[..., 0]


def _sim3_W(sigma, phi):
    """W matrix of the Sim(3) exponential, with Taylor branches at
    theta = 0 and sigma = 0."""
    X = hat(phi)
    X2 = X @ X
    I = torch.eye(3, dtype=phi.dtype, device=phi.device).expand(X.shape)
    s = torch.exp(sigma)
    sig = sigma
    sig2 = sig * sig
    one = torch.ones_like(sig)

    t2 = (phi * phi).sum(-1)
    small_th = t2 < 1e-10
    safe_t2 = torch.where(small_th, one, t2)
    th = torch.sqrt(safe_t2)

    small_sig = sig.abs() < 1e-5
    safe_sig = torch.where(small_sig, one, sig)
    safe_sig2 = torch.where(small_sig, one, sig2)

    # C = (e^sigma - 1) / sigma
    C = torch.where(small_sig, 1.0 + sig / 2.0 + sig2 / 6.0, (s - 1.0) / safe_sig)
    # sigma ~ 0: the SO(3) left-Jacobian coefficients
    A_s = torch.where(small_th, 0.5 - t2 / 24.0, (1.0 - torch.cos(th)) / safe_t2)
    B_s = torch.where(small_th, 1.0 / 6.0 - t2 / 120.0,
                      (th - torch.sin(th)) / (safe_t2 * th))
    # general sigma
    a = s * torch.sin(th)
    b = s * torch.cos(th)
    denom = torch.where(small_th, one, t2 + sig2)
    A_g = torch.where(small_th, ((sig - 1.0) * s + 1.0) / safe_sig2,
                      (a * sig + (1.0 - b) * th) / (th * denom))
    B_g = torch.where(small_th,
                      (s * (0.5 * sig2 - sig + 1.0) - 1.0) / (safe_sig2 * safe_sig),
                      (C - ((b - 1.0) * sig + a * th) / denom) / safe_t2)
    A = torch.where(small_sig, A_s, A_g)
    B = torch.where(small_sig, B_s, B_g)
    return C[..., None, None] * I + A[..., None, None] * X + B[..., None, None] * X2


def log_sim3(s, R, t):
    sigma = torch.log(s)
    phi = log_so3(R)
    rho = torch.linalg.solve(_sim3_W(sigma, phi), t[..., None])[..., 0]
    return torch.cat([rho, phi, sigma[..., None]], -1)


def project_so3_np(R):
    """Nearest rotation matrix (Frobenius) via SVD, det-corrected, numpy.

    Host-side hygiene for pose writebacks: chained float32 updates drift
    off SO(3)."""
    U, _, Vt = np.linalg.svd(np.asarray(R, np.float64))
    D = np.eye(3)
    D[2, 2] = np.sign(np.linalg.det(U @ Vt))
    return (U @ D @ Vt).astype(np.float32)
