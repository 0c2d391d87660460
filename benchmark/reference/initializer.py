"""Two-view initialization, the plain reference of the mono initializer.

A frozen copy of the arithmetic of the port's ``core/initializer.py``
(ORB-SLAM2's Initializer.cpp): from the matches and the RANSAC's minimal
samples (positions taken modulo the number of valid matches into the
valid matches in increasing order), the 200 homographies (DLT) and
fundamental matrices (normalised 8-point, rank 2), scored over every match
with the chi2 gates 5.991 (H) and 3.841 (F) and the score threshold 5.991;
H where SH / (SH + SF) > 0.40; the winner refit on its inliers and scored
again; its (R, t) candidates (Faugeras for H, the essential decomposition
for F); each candidate's points triangulated and checked (CheckRT), and the
candidate with the most good points taken.

Plain NumPy in float64.  ``round_to`` rounds every intermediate through a
lower precision (the output check's control); the SVDs then run in float64
on the rounded values.  ``follow`` makes the chain take the program's
decisions (the best hypotheses, H or F, the inlier sets) in place of its
own, so that each later stage starts from the program's state; the chain's
own decision at each of them is returned beside it with its margin: the
relative distance of the deciding quantity from its threshold, by which
the check tells a decision that float32 rounding can flip from one it
cannot.
"""
from __future__ import annotations

import numpy as np

TH_H, TH_F, TH_SCORE = 5.991, 3.841, 5.991
RH_MIN = 0.40
COS_PARALLAX = 0.99998
SIGMA2 = 1.0


def _f64(a):
    return np.asarray(a, np.float64)


def _inv(M):
    """Inverses of (..., 3, 3), NaN where one is singular."""
    try:
        return np.linalg.inv(M)
    except np.linalg.LinAlgError:
        out = np.full_like(M, np.nan)
        flat, res = M.reshape(-1, 3, 3), out.reshape(-1, 3, 3)
        for i, m in enumerate(flat):
            try:
                res[i] = np.linalg.inv(m)
            except np.linalg.LinAlgError:
                pass
        return out


def _margin(ms, valid):
    """The margin of a conjunction of gates: ms (K, ...) signed relative
    margins, > 0 where a gate holds.  Where all hold, the least; else the
    largest of those that fail (each of them has to flip); inf where the
    match is not valid, which no rounding changes."""
    ms = np.stack(ms)
    holds = (ms > 0).all(0)
    inside = ms.min(0)
    outside = np.where(ms <= 0, -ms, 0.0).max(0)
    return np.where(valid, np.where(holds, inside, outside), np.inf)


def normalize(p, r):
    """Initializer::Normalize: centred, scaled per axis by the mean
    absolute deviation; the points and T."""
    mean = p.mean(0)
    d = np.abs(p - mean).mean(0)
    s = 1.0 / np.maximum(d, 1e-9)
    T = np.array([[s[0], 0.0, -mean[0] * s[0]], [0.0, s[1], -mean[1] * s[1]],
                  [0.0, 0.0, 1.0]])
    return r((p - mean) * s), r(T)


def dlt_h(p1, p2, r):
    x1, y1, x2, y2 = p1[..., 0], p1[..., 1], p2[..., 0], p2[..., 1]
    z, o = np.zeros_like(x1), np.ones_like(x1)
    A = np.concatenate([np.stack([z, z, z, -x1, -y1, -o, y2 * x1, y2 * y1, y2], -1),
                        np.stack([x1, y1, o, z, z, z, -x2 * x1, -x2 * y1, -x2], -1)], -2)
    vt = np.linalg.svd(r(A))[2]
    return r(vt[..., -1, :].reshape(*A.shape[:-2], 3, 3))


def dlt_f(p1, p2, r):
    x1, y1, x2, y2 = p1[..., 0], p1[..., 1], p2[..., 0], p2[..., 1]
    A = np.stack([x2 * x1, x2 * y1, x2, y2 * x1, y2 * y1, y2, x1, y1, np.ones_like(x1)], -1)
    vt = np.linalg.svd(r(A))[2]
    F = r(vt[..., -1, :].reshape(*A.shape[:-2], 3, 3))
    U, S, Vt = np.linalg.svd(F)
    S[..., 2] = 0.0
    return r(U @ (S[..., :, None] * Vt))


def _homog(p):
    return np.concatenate([p, np.ones_like(p[..., :1])], -1)


def score_h(H21, p1, p2, valid, r):
    """Symmetric transfer chi2 of homographies (..., 3, 3): scores (...),
    inlier masks and their margins (..., N)."""
    H12 = r(_inv(H21))

    def transfer(H, a, b):
        proj = r(_homog(a) @ np.swapaxes(H, -1, -2))
        w = proj[..., 2:3]
        proj = r(proj[..., :2] / np.maximum(np.abs(w), 1e-12) * np.sign(w + 1e-30))
        return r(((proj - b) ** 2).sum(-1))

    with np.errstate(invalid="ignore"):
        chi1 = transfer(H12, p2, p1) / SIGMA2
        chi2 = transfer(H21, p1, p2) / SIGMA2
        ok = (chi1 < TH_H) & (chi2 < TH_H) & valid
    score = np.where(ok, (TH_H - chi1) + (TH_H - chi2), 0.0).sum(-1)
    return score, ok, _margin([(TH_H - chi1) / TH_H, (TH_H - chi2) / TH_H], valid)


def score_f(F21, p1, p2, valid, r):
    """Symmetric epipolar chi2 of fundamental matrices (..., 3, 3): scores
    (...), inlier masks and their margins (..., N)."""
    ah1, ah2 = _homog(p1), _homog(p2)
    l2 = r(ah1 @ np.swapaxes(F21, -1, -2))
    l1 = r(ah2 @ F21)
    d2 = r((l2 * ah2).sum(-1) ** 2 / np.maximum(l2[..., 0] ** 2 + l2[..., 1] ** 2, 1e-12))
    d1 = r((l1 * ah1).sum(-1) ** 2 / np.maximum(l1[..., 0] ** 2 + l1[..., 1] ** 2, 1e-12))
    c1, c2 = d1 / SIGMA2, d2 / SIGMA2
    ok = (c1 < TH_F) & (c2 < TH_F) & valid
    score = np.where(ok, (TH_SCORE - c1) + (TH_SCORE - c2), 0.0).sum(-1)
    return score, ok, _margin([(TH_F - c1) / TH_F, (TH_F - c2) / TH_F], valid)


def hypotheses(p1, p2, valid, sample, r):
    """Both models of every minimal sample, scored over all matches:
    (SH (H,), H21 (H, 3, 3), SF (H,), F21 (H, 3, 3))."""
    pool = np.concatenate([np.flatnonzero(valid), np.flatnonzero(~valid)])
    sel = pool[np.asarray(sample, np.int64) % max(int(valid.sum()), 1)]
    p1n, T1 = normalize(p1, r)
    p2n, T2 = normalize(p2, r)
    H21 = r(_inv(T2) @ dlt_h(p1n[sel], p2n[sel], r) @ T1)
    h22 = H21[:, 2:3, 2:3]
    H21 = r(H21 / np.where(np.abs(h22) > 1e-12, h22, 1.0))
    F21 = r(T2.T @ dlt_f(p1n[sel], p2n[sel], r) @ T1)
    return score_h(H21, p1, p2, valid, r)[0], H21, score_f(F21, p1, p2, valid, r)[0], F21


def decompose_f(F21, K):
    """The essential decomposition: 4 (R, t) candidates."""
    E = K.T @ F21 @ K
    U, _, Vt = np.linalg.svd(E)
    if np.linalg.det(U) < 0:
        U = -U
    if np.linalg.det(Vt) < 0:
        Vt = -Vt
    W = np.array([[0, -1, 0], [1, 0, 0], [0, 0, 1]], np.float64)
    R1, R2 = U @ W @ Vt, U @ W.T @ Vt
    t = U[:, 2] / max(np.linalg.norm(U[:, 2]), 1e-12)
    return [(R1, t), (R1, -t), (R2, t), (R2, -t)]


def decompose_h(H21, K):
    """Faugeras' SVD decomposition (Initializer::ReconstructH): 8 (R, t)
    candidates."""
    A = np.linalg.inv(K) @ H21 @ K
    U, w, Vt = np.linalg.svd(A)
    s = np.linalg.det(U) * np.linalg.det(Vt)
    d1, d2, d3 = w
    if d1 / d2 < 1.00001 or d2 / d3 < 1.00001:
        return [(np.eye(3), np.array([0, 0, 1.0]))]
    aux1 = np.sqrt(max((d1 * d1 - d2 * d2) / (d1 * d1 - d3 * d3), 0))
    aux3 = np.sqrt(max((d2 * d2 - d3 * d3) / (d1 * d1 - d3 * d3), 0))
    x1s, x3s = [aux1, aux1, -aux1, -aux1], [aux3, -aux3, aux3, -aux3]
    out = []
    aux_st = np.sqrt(max((d1 * d1 - d2 * d2) * (d2 * d2 - d3 * d3), 0)) / ((d1 + d3) * d2)
    ct = (d2 * d2 + d1 * d3) / ((d1 + d3) * d2)
    for i, st in enumerate([aux_st, -aux_st, -aux_st, aux_st]):
        Rp = np.array([[ct, 0, -st], [0, 1, 0], [st, 0, ct]])
        t = U @ ((d1 - d3) * np.array([x1s[i], 0, -x3s[i]]))
        out.append((s * U @ Rp @ Vt, t / max(np.linalg.norm(t), 1e-12)))
    aux_sp = np.sqrt(max((d1 * d1 - d2 * d2) * (d2 * d2 - d3 * d3), 0)) / ((d1 - d3) * d2)
    cp = (d1 * d3 - d2 * d2) / ((d1 - d3) * d2)
    for i, sp in enumerate([aux_sp, -aux_sp, -aux_sp, aux_sp]):
        Rp = np.array([[cp, 0, sp], [0, -1, 0], [sp, 0, -cp]])
        t = U @ ((d1 + d3) * np.array([x1s[i], 0, x3s[i]]))
        out.append((s * U @ Rp @ Vt, t / max(np.linalg.norm(t), 1e-12)))
    return out


def triangulate_and_check(R, t, p1n, p2n, inl, fx, r):
    """CheckRT for C candidates: R (C, 3, 3), t (C, 3), p*n (N, 2)
    normalised coordinates.  Returns X (C, N, 3), good (C, N) and the good
    masks' margins (C, N)."""
    C, N = R.shape[0], p1n.shape[0]
    P2 = np.concatenate([R, t[:, :, None]], 2)
    e = np.eye(4)
    rows1 = np.broadcast_to(p1n[None, :, :, None] * e[2] - e[:2], (C, N, 2, 4))
    rows2 = p2n[None, :, :, None] * P2[:, None, 2:3, :] - P2[:, None, :2, :]
    h = np.linalg.svd(r(np.concatenate([rows1, rows2], 2)))[2][..., -1, :]
    w = h[..., 3:]
    X = r(h[..., :3] / np.where(np.abs(w) > 1e-12, w, 1.0))
    Xc2 = r(X @ np.swapaxes(R, -1, -2) + t[:, None, :])
    z1, z2 = X[..., 2], Xc2[..., 2]
    c2 = -(np.swapaxes(R, -1, -2) @ t[..., None])[..., 0]
    n2 = X - c2[:, None, :]
    nX, nn2 = np.linalg.norm(X, axis=-1), np.linalg.norm(n2, axis=-1)
    cosp = r((X * n2).sum(-1) / np.maximum(nX * nn2, 1e-12))
    e1 = r(((X[..., :2] / np.maximum(z1, 1e-12)[..., None] - p1n) ** 2).sum(-1) * fx * fx)
    e2 = r(((Xc2[..., :2] / np.maximum(z2, 1e-12)[..., None] - p2n) ** 2).sum(-1) * fx * fx)
    lim = 4.0 * SIGMA2
    ms = [z1 / np.maximum(nX, 1e-12), z2 / np.maximum(np.linalg.norm(Xc2, axis=-1), 1e-12),
          (COS_PARALLAX - cosp) / (1.0 - COS_PARALLAX), (lim - e1) / lim, (lim - e2) / lim]
    good = inl & (z1 > 0) & (z2 > 0) & (cosp < COS_PARALLAX) & (e1 < lim) & (e2 < lim)
    return X, good, _margin(ms, np.broadcast_to(inl, good.shape))


def initialize(p1, p2, valid, sample, fx, fy, cx, cy, follow=None, round_to=None):
    """The initializer from matched keypoints p1, p2 (N, 2, undistorted
    pixels), the valid mask (N,) and the minimal samples (H, 8).

    ``follow``: the program's decisions, a dict of ``bh``, ``bf`` (the
    best hypotheses' indices), ``use_h``, ``inl_pre`` and ``inl_post`` (the
    winner's inliers before and after its refit); None takes the chain's
    own.  Returns a dict: ``sh``, ``sf`` (every hypothesis's score), ``bh``,
    ``bf``, ``rh``, ``use_h`` (the chain's own choices), ``inl_pre``,
    ``inl_post`` (its own masks of the model taken) and their
    margins ``m_pre``, ``m_post``, the chosen candidate's ``R``, ``t``,
    ``X`` (N, 3), ``good`` and ``m_good``."""
    r = round_to or _f64
    p1, p2 = r(p1), r(p2)
    valid = np.asarray(valid, bool)
    sh, Hs, sf, Fs = hypotheses(p1, p2, valid, sample, r)
    out = {"sh": sh, "sf": sf, "bh": int(np.argmax(sh)), "bf": int(np.argmax(sf))}
    f = follow or {}
    bh, bf = f.get("bh", out["bh"]), f.get("bf", out["bf"])
    SH, SF = float(sh[bh]), float(sf[bf])
    out["rh"] = SH / (SH + SF) if SH + SF > 0 else float("nan")
    out["use_h"] = bool(out["rh"] > RH_MIN)
    use_h = f.get("use_h", out["use_h"])
    score, refit = (score_h, _refit_h) if use_h else (score_f, _refit_f)
    _, out["inl_pre"], out["m_pre"] = score(Hs[bh] if use_h else Fs[bf], p1, p2, valid, r)
    pre = f.get("inl_pre", out["inl_pre"])
    model = refit(p1, p2, pre, r)
    _, out["inl_post"], out["m_post"] = score(model, p1, p2, valid, r)
    inl = f.get("inl_post", out["inl_post"])
    K = np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1.0]])
    cands = decompose_h(model, K) if use_h else decompose_f(model, K)
    Kinv = np.linalg.inv(K)
    p1n = r(_homog(p1) @ Kinv.T)[:, :2]
    p2n = r(_homog(p2) @ Kinv.T)[:, :2]
    Rs = r(np.stack([c[0] for c in cands]))
    ts = r(np.stack([c[1] for c in cands]))
    X, good, m_good = triangulate_and_check(Rs, ts, p1n, p2n, inl, fx, r)
    best = int(np.argmax(good.sum(1)))
    out.update(R=Rs[best], t=ts[best], X=X[best], good=good[best], m_good=m_good[best])
    return out


def _refit_h(p1, p2, inl, r):
    p1n, T1 = normalize(p1, r)
    p2n, T2 = normalize(p2, r)
    H = r(_inv(T2) @ dlt_h(p1n[inl], p2n[inl], r) @ T1)
    return r(H / H[2, 2])


def _refit_f(p1, p2, inl, r):
    p1n, T1 = normalize(p1, r)
    p2n, T2 = normalize(p2, r)
    return r(T2.T @ dlt_f(p1n[inl], p2n[inl], r) @ T1)
