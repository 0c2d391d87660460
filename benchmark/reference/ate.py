"""ATE RMSE after Umeyama alignment: a frozen copy of the port's
``io/evaluation.py``, the benchmark's yardstick for ``ate_m``.
"""
from __future__ import annotations

import numpy as np


def umeyama_alignment(src: np.ndarray, dst: np.ndarray, with_scale: bool = False):
    """Least-squares similarity transform aligning src -> dst, (N,3) each.

    Returns (s, R, t) with dst ~= s * R @ src + t.
    """
    mu_s = src.mean(axis=0)
    mu_d = dst.mean(axis=0)
    xs = src - mu_s
    xd = dst - mu_d
    cov = xd.T @ xs / len(src)
    U, D, Vt = np.linalg.svd(cov)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1
    R = U @ S @ Vt
    if with_scale:
        var_s = (xs ** 2).sum() / len(src)
        s = np.trace(np.diag(D) @ S) / var_s
    else:
        s = 1.0
    t = mu_d - s * R @ mu_s
    return s, R, t


def associate(ts_a: np.ndarray, ts_b: np.ndarray, max_dt: float = 0.02):
    """Nearest-timestamp association; returns index pairs."""
    pairs = []
    j = 0
    for i, t in enumerate(ts_a):
        j = int(np.argmin(np.abs(ts_b - t)))
        if abs(ts_b[j] - t) <= max_dt:
            pairs.append((i, j))
    return np.array(pairs, dtype=np.int64).reshape(-1, 2)


def ate_rmse(est_ts, est_poses, gt_ts, gt_poses, with_scale=False, max_dt=0.02):
    """Absolute trajectory error RMSE after Umeyama alignment (meters)."""
    pairs = associate(np.asarray(est_ts), np.asarray(gt_ts), max_dt)
    if len(pairs) < 3:
        return float("inf")
    p_est = np.asarray(est_poses)[pairs[:, 0], :3, 3]
    p_gt = np.asarray(gt_poses)[pairs[:, 1], :3, 3]
    s, R, t = umeyama_alignment(p_est, p_gt, with_scale)
    aligned = (s * (R @ p_est.T)).T + t
    err = np.linalg.norm(aligned - p_gt, axis=1)
    return float(np.sqrt((err ** 2).mean()))
