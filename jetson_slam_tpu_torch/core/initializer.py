"""Monocular map initialization: homography and fundamental RANSAC.

Port of ``jetson_slam_tpu/core/initializer.py``, the replacement of
src/Initializer.cpp: 200 minimal samples of 8 matches; each gives a
homography (DLT) and a fundamental matrix (normalised 8-point, rank 2),
scored with the reference's chi2 gates (5.991 for H, 3.841 for F, score
threshold 5.991).  H wins when RH = SH / (SH + SF) > 0.40; the winner is
refit on its inliers, decomposed into its (R, t) candidates (Faugeras for
H, the essential decomposition for F, in numpy as in the JAX package) and
each candidate is checked by two-view triangulation (CheckRT).

The minimal samples are an explicit input (``_sample``): (200, 8) positions
into the pool of valid matches, drawn from a ``torch.Generator`` on the
device seeded with 42 per initializer, as the JAX package seeds
``PRNGKey(42)``; the parity tests pass the positions ``jax.random`` draws
there.  All 200 hypotheses of a model share one batched
``torch.linalg.svd`` call (the card synchronises on each call), the
homography inverses use ``inv_ex`` (no error check), and the triangulation
of every candidate's points is one batched (C, N, 4, 4) SVD.
"""
from __future__ import annotations

import numpy as np
import torch

from .pnp_solver import draw_samples, pool_take, valid_pool

TH_H, TH_F, TH_SCORE = 5.991, 3.841, 5.991


def _normalize(pts):
    """Isotropic-per-axis normalisation (Initializer::Normalize): the
    points centred and scaled by their mean absolute deviation, and T."""
    mean = pts.mean(0)
    d = (pts - mean).abs().mean(0)
    s = 1.0 / torch.clamp(d, min=1e-9)
    zero, one = torch.zeros_like(s[0]), torch.ones_like(s[0])
    T = torch.stack([torch.stack([s[0], zero, -mean[0] * s[0]]),
                     torch.stack([zero, s[1], -mean[1] * s[1]]),
                     torch.stack([zero, zero, one])])
    return (pts - mean) * s, T


def _dlt_h(p1, p2):
    """Homographies from correspondences (..., n, 2) by DLT: the null vector
    of the (..., 2n, 9) system, (..., 3, 3)."""
    x1, y1 = p1[..., 0], p1[..., 1]
    x2, y2 = p2[..., 0], p2[..., 1]
    z = torch.zeros_like(x1)
    o = torch.ones_like(x1)
    r1 = torch.stack([z, z, z, -x1, -y1, -o, y2 * x1, y2 * y1, y2], -1)
    r2 = torch.stack([x1, y1, o, z, z, z, -x2 * x1, -x2 * y1, -x2], -1)
    A = torch.cat([r1, r2], -2)
    vt = torch.linalg.svd(A).Vh
    return vt[..., -1, :].reshape(*A.shape[:-2], 3, 3)


def _dlt_f(p1, p2):
    """Fundamental matrices from correspondences (..., n, 2), normalised
    8-point with rank 2 enforced, (..., 3, 3)."""
    x1, y1 = p1[..., 0], p1[..., 1]
    x2, y2 = p2[..., 0], p2[..., 1]
    A = torch.stack([x2 * x1, x2 * y1, x2, y2 * x1, y2 * y1, y2, x1, y1,
                     torch.ones_like(x1)], -1)
    vt = torch.linalg.svd(A).Vh
    F = vt[..., -1, :].reshape(*A.shape[:-2], 3, 3)
    U, S, Vt = torch.linalg.svd(F)
    S = torch.cat([S[..., :2], torch.zeros_like(S[..., 2:])], -1)
    return U @ torch.diag_embed(S) @ Vt


def _homog(p):
    return torch.cat([p, torch.ones_like(p[..., :1])], -1)


def _score_h(H21, p1, p2, valid, sigma2):
    """Symmetric transfer chi2 of homographies (..., 3, 3) over the matches
    (N, 2): scores (...) and inlier masks (..., N)."""
    H12 = torch.linalg.inv_ex(H21)[0]

    def transfer(H, a, b):
        proj = _homog(a) @ H.transpose(-1, -2)
        w = proj[..., 2:3]
        proj = proj[..., :2] / torch.clamp(w.abs(), min=1e-12) * torch.sign(w + 1e-30)
        return ((proj - b) ** 2).sum(-1)

    chi1 = transfer(H12, p2, p1) / sigma2
    chi2 = transfer(H21, p1, p2) / sigma2
    ok = (chi1 < TH_H) & (chi2 < TH_H) & valid
    score = torch.where(ok, (TH_H - chi1) + (TH_H - chi2), torch.zeros_like(chi1)).sum(-1)
    return score, ok


def _score_f(F21, p1, p2, valid, sigma2):
    """Symmetric epipolar chi2 of fundamental matrices (..., 3, 3) over the
    matches (N, 2): scores (...) and inlier masks (..., N)."""
    ah1, ah2 = _homog(p1), _homog(p2)
    l2 = ah1 @ F21.transpose(-1, -2)      # epipolar lines in image 2
    l1 = ah2 @ F21
    d2 = (l2 * ah2).sum(-1) ** 2 / torch.clamp(l2[..., 0] ** 2 + l2[..., 1] ** 2, min=1e-12)
    d1 = (l1 * ah1).sum(-1) ** 2 / torch.clamp(l1[..., 0] ** 2 + l1[..., 1] ** 2, min=1e-12)
    c1 = d1 / sigma2
    c2 = d2 / sigma2
    ok = (c1 < TH_F) & (c2 < TH_F) & valid
    score = torch.where(ok, (TH_SCORE - c1) + (TH_SCORE - c2), torch.zeros_like(c1)).sum(-1)
    return score, ok


def _triangulate_and_check(R, t, p1n, p2n, valid, fx, sigma2_px):
    """CheckRT (Initializer.cpp) for C candidates at once: triangulate each
    match with P1 = [I|0], P2 = [R|t] (one batched SVD over (C, N, 4, 4)),
    then count the points in front of both cameras, with parallax, and
    reprojected within 4 sigma^2.  R (C, 3, 3), t (C, 3), p*n (N, 2)
    normalised coordinates.  Returns (X (C, N, 3), good (C, N))."""
    C, N = R.shape[0], p1n.shape[0]
    P2 = torch.cat([R, t[:, :, None]], 2)                       # (C, 3, 4)
    e = torch.eye(4, dtype=R.dtype, device=R.device)
    a = p1n[None, :, :, None]                                    # (1, N, 2, 1)
    b = p2n[None, :, :, None]
    rows1 = a * e[2] - e[:2]                                     # (1, N, 2, 4)
    rows2 = b * P2[:, None, 2:3, :] - P2[:, None, :2, :]         # (C, N, 2, 4)
    A = torch.cat([rows1.expand(C, N, 2, 4), rows2], 2)
    h = torch.linalg.svd(A).Vh[..., -1, :]                       # (C, N, 4)
    w = h[..., 3:]
    X = h[..., :3] / torch.where(w.abs() > 1e-12, w, torch.ones_like(w))
    z1 = X[..., 2]
    Xc2 = X @ R.transpose(-1, -2) + t[:, None, :]
    z2 = Xc2[..., 2]
    # parallax between the rays from both centres
    c2 = -(R.transpose(-1, -2) @ t[..., None])[..., 0]
    n2 = X - c2[:, None, :]
    cosp = (X * n2).sum(-1) / torch.clamp(
        torch.linalg.norm(X, dim=-1) * torch.linalg.norm(n2, dim=-1), min=1e-12)
    e1 = ((X[..., :2] / torch.clamp(z1[..., None], min=1e-12) - p1n) ** 2).sum(-1) * fx * fx
    e2 = ((Xc2[..., :2] / torch.clamp(z2[..., None], min=1e-12) - p2n) ** 2).sum(-1) * fx * fx
    good = (valid & (z1 > 0) & (z2 > 0) & (cosp < 0.99998)
            & (e1 < 4.0 * sigma2_px) & (e2 < 4.0 * sigma2_px))
    return X, good


class MonoInitializer:
    """Two-view initializer; sigma = 1.0 like the reference default."""

    def __init__(self, fx, fy, cx, cy, device, sigma=1.0, n_hyp=200):
        self.K = np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1]], np.float32)
        self.fx, self.fy, self.cx, self.cy = fx, fy, cx, cy
        self.sigma2 = sigma * sigma
        self.n_hyp = n_hyp
        self.device = torch.device(device)
        self._gen = torch.Generator(device=self.device)
        self._gen.manual_seed(42)

    def _sample(self, n_valid: int):
        """Minimal samples of the RANSAC: (n_hyp, 8) positions into the pool
        of n_valid matches (reduced modulo n_valid)."""
        return draw_samples(self._gen, (self.n_hyp, 8), self.device)

    def hypotheses(self, p1, p2, valid, sample):
        """Both models of every minimal sample, scored over all matches.
        p1, p2 (N, 2) float32 tensors, valid (N,) bool, sample (H, 8).
        Returns (SH (H,), H21 (H, 3, 3), SF (H,), F21 (H, 3, 3))."""
        pool, n_valid = valid_pool(valid)
        sel = pool_take(pool, n_valid, sample)                   # (H, 8)
        p1n_, T1 = _normalize(p1)
        p2n_, T2 = _normalize(p2)
        T2inv = torch.linalg.inv_ex(T2)[0]
        Hn = _dlt_h(p1n_[sel], p2n_[sel])
        H21 = T2inv @ Hn @ T1
        h22 = H21[:, 2:3, 2:3]
        H21 = H21 / torch.where(h22.abs() > 1e-12, h22, torch.ones_like(h22))
        F21 = T2.T @ _dlt_f(p1n_[sel], p2n_[sel]) @ T1
        sh, _ = _score_h(H21, p1, p2, valid, self.sigma2)
        sf, _ = _score_f(F21, p1, p2, valid, self.sigma2)
        return sh, H21, sf, F21

    def initialize(self, kp1, kp2, valid):
        """kp1, kp2 (N, 2) matched pixel coordinates (numpy), valid (N,)
        bool.  Returns (ok, R21, t21, points (N, 3), good mask), the last
        four None when it fails."""
        fail = (False, None, None, None, None)
        N = len(kp1)
        if valid.sum() < 20:
            return fail
        dev = self.device
        p1 = torch.as_tensor(np.asarray(kp1, np.float32), device=dev)
        p2 = torch.as_tensor(np.asarray(kp2, np.float32), device=dev)
        vmask = torch.as_tensor(np.asarray(valid, bool), device=dev)
        sh, Hs, sf, Fs = self.hypotheses(p1, p2, vmask, self._sample(int(valid.sum())))
        bh = torch.argmax(sh)
        bf = torch.argmax(sf)
        SH, SF = (float(v) for v in torch.stack([sh[bh], sf[bf]]).cpu())
        if SH + SF <= 0:
            return fail
        use_h = SH / (SH + SF) > 0.40

        K = torch.as_tensor(self.K, device=dev)
        Kinv = torch.linalg.inv_ex(K)[0]
        ones = torch.ones((N, 1), dtype=torch.float32, device=dev)
        p1n = (torch.cat([p1, ones], 1) @ Kinv.T)[:, :2]
        p2n = (torch.cat([p2, ones], 1) @ Kinv.T)[:, :2]
        p1n_, T1 = _normalize(p1)
        p2n_, T2 = _normalize(p2)

        # refit the winning model on all its inliers before decomposition:
        # a minimal-sample F is too noisy for a clean essential decomposition
        if use_h:
            _, inl = _score_h(Hs[bh], p1, p2, vmask, self.sigma2)
            Hn = _dlt_h(p1n_[inl], p2n_[inl])
            H21 = torch.linalg.inv_ex(T2)[0] @ Hn @ T1
            H21 = H21 / H21[2, 2]
            _, inl = _score_h(H21, p1, p2, vmask, self.sigma2)
            cands = self._decompose_h(H21.cpu().numpy())
        else:
            _, inl = _score_f(Fs[bf], p1, p2, vmask, self.sigma2)
            F21 = T2.T @ _dlt_f(p1n_[inl], p2n_[inl]) @ T1
            _, inl = _score_f(F21, p1, p2, vmask, self.sigma2)
            cands = self._decompose_f(F21.cpu().numpy())

        Rs = torch.as_tensor(np.stack([R for R, _ in cands]).astype(np.float32), device=dev)
        ts = torch.as_tensor(np.stack([t for _, t in cands]).astype(np.float32), device=dev)
        X, good = _triangulate_and_check(Rs, ts, p1n, p2n, inl, self.fx, self.sigma2)
        n_good = good.sum(1)
        best = torch.argmax(n_good)          # the first candidate with the most
        X, good, n_good, n_inl = (a.cpu().numpy() for a in (
            X[best], good[best], n_good[best], inl.sum()))
        R, t = cands[int(best)]
        # the reference's acceptance: enough good points and a clear winner
        if n_good < 30 or n_good < 0.7 * n_inl:
            return fail
        return True, R.astype(np.float32), t.astype(np.float32), X, good

    # ---------------------------------------------------------------- R|t
    def _decompose_f(self, F21):
        """Essential decomposition: 4 (R, t) candidates."""
        E = self.K.T @ F21 @ self.K
        U, _, Vt = np.linalg.svd(E)
        if np.linalg.det(U) < 0:
            U = -U
        if np.linalg.det(Vt) < 0:
            Vt = -Vt
        W = np.array([[0, -1, 0], [1, 0, 0], [0, 0, 1]], np.float64)
        R1 = U @ W @ Vt
        R2 = U @ W.T @ Vt
        t = U[:, 2]
        t = t / max(np.linalg.norm(t), 1e-12)
        return [(R1, t), (R1, -t), (R2, t), (R2, -t)]

    def _decompose_h(self, H21):
        """Faugeras SVD decomposition: 8 (R, t) candidates
        (Initializer::ReconstructH)."""
        A = np.linalg.inv(self.K) @ H21 @ self.K
        U, w, Vt = np.linalg.svd(A)
        s = np.linalg.det(U) * np.linalg.det(Vt)
        d1, d2, d3 = w
        if d1 / d2 < 1.00001 or d2 / d3 < 1.00001:
            return [(np.eye(3), np.array([0, 0, 1.0]))]
        out = []
        aux1 = np.sqrt(max((d1 * d1 - d2 * d2) / (d1 * d1 - d3 * d3), 0))
        aux3 = np.sqrt(max((d2 * d2 - d3 * d3) / (d1 * d1 - d3 * d3), 0))
        x1s = [aux1, aux1, -aux1, -aux1]
        x3s = [aux3, -aux3, aux3, -aux3]
        # d' = d2
        aux_st = np.sqrt(max((d1 * d1 - d2 * d2) * (d2 * d2 - d3 * d3), 0)) / ((d1 + d3) * d2)
        ct = (d2 * d2 + d1 * d3) / ((d1 + d3) * d2)
        sts = [aux_st, -aux_st, -aux_st, aux_st]
        for i in range(4):
            Rp = np.array([[ct, 0, -sts[i]], [0, 1, 0], [sts[i], 0, ct]])
            tp = (d1 - d3) * np.array([x1s[i], 0, -x3s[i]])
            R = s * U @ Rp @ Vt
            t = U @ tp
            t = t / max(np.linalg.norm(t), 1e-12)
            out.append((R, t))
        # d' = -d2
        aux_sp = np.sqrt(max((d1 * d1 - d2 * d2) * (d2 * d2 - d3 * d3), 0)) / ((d1 - d3) * d2)
        cp = (d1 * d3 - d2 * d2) / ((d1 - d3) * d2)
        sps = [aux_sp, -aux_sp, -aux_sp, aux_sp]
        for i in range(4):
            Rp = np.array([[cp, 0, sps[i]], [0, -1, 0], [sps[i], 0, -cp]])
            tp = (d1 + d3) * np.array([x1s[i], 0, x3s[i]])
            R = s * U @ Rp @ Vt
            t = U @ tp
            t = t / max(np.linalg.norm(t), 1e-12)
            out.append((R, t))
        return out
