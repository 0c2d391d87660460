"""Two-view triangulation and epipolar matching in PyTorch.

Port of ``jetson_slam_tpu/core/triangulation.py``, the inner math of
LocalMapping::CreateNewMapPoints (LocalMapping.cpp:213-458) and the epipolar
gate of ORBmatcher::SearchForTriangulation (ORBmatcher.cpp:644-810): dense
candidate masks and a Hamming table in place of BoW-bucketed loops, and one
batched SVD over the pair axis in place of a cv::SVD per pair.  Neither
function synchronises with the host, apart from what ``torch.linalg.svd``
does on the card.
"""
from __future__ import annotations

import numpy as np
import torch

from ..ops.hamming import hamming_matrix
from .matcher import BIG, TH_LOW, rotation_consistency


def epipolar_match(desc1, valid1, angle1, xy1, desc2, valid2, angle2, xy2,
                   F12, sigma2_levels, oct2, ex: float, ey: float, sf2_of_oct):
    """Match the unassociated features of two keyframes under the epipolar
    gate: bestDist < TH_LOW, epipolar distance^2 < 3.84 sigma^2 of the kf2
    octave, kp2 at least 10 sigma px from the epipole (ex, ey) of kf1's
    centre in kf2, then the rotation histogram.  F12 (3, 3) maps kf1 points
    to epipolar lines in kf2.  Returns per-kf1-slot index into kf2 (-1 none).
    """
    dist = torch.where(valid1[:, None] & valid2[None, :],
                       hamming_matrix(desc1, desc2),
                       torch.full((desc1.shape[0], desc2.shape[0]), BIG,
                                  dtype=torch.int32, device=desc1.device))
    # epipolar line a, b, c of each kp1 in image 2 (CheckDistEpipolarLine)
    p1h = torch.cat([xy1, torch.ones_like(xy1[:, :1])], 1)
    lines = p1h @ F12
    a, b, c = lines[:, 0:1], lines[:, 1:2], lines[:, 2:3]
    num = a * xy2[None, :, 0] + b * xy2[None, :, 1] + c
    dsqr = num * num / torch.clamp(a * a + b * b, min=1e-12)
    epi_ok = dsqr < 3.84 * sigma2_levels[oct2.to(torch.int64)][None, :]
    de2 = (xy2[:, 0] - ex) ** 2 + (xy2[:, 1] - ey) ** 2
    far = de2 >= 100.0 * sf2_of_oct[oct2.to(torch.int64)]
    dist = torch.where(epi_ok & far[None, :], dist, torch.full_like(dist, BIG))
    best2 = torch.argmin(dist, dim=1)
    bestd = torch.gather(dist, 1, best2[:, None])[:, 0]
    matched = rotation_consistency(angle1 - angle2[best2], bestd < TH_LOW)
    return torch.where(matched, best2, torch.full_like(best2, -1)).to(torch.int32)


def _mv(R, x):
    """Batched matrix-vector product: (N, 3, 3) x (N, 3) -> (N, 3)."""
    return (R @ x[..., None])[..., 0]


def triangulate_pairs(R1, t1, R2, t2, xy1n, xy2n, ur1, ur2, z1, z2,
                      kp_xy1, kp_xy2, sigma2_1, sigma2_2,
                      fx, fy, cx, cy, bf, ratio_factor):
    """Parallax-arbitrated triangulation of N matched pairs, batched over
    the pair axis (LocalMapping.cpp:284-437): the SVD solution where the
    rays' parallax beats the stereo baseline's, else the stereo unprojection
    of the keyframe with the smaller stereo angle; then the reprojection
    chi2 gates in both views and the scale-consistency gate.

    R* (N, 3, 3), t* (N, 3): world->camera poses.  xy*n (N, 3): normalised
    rays ((u - cx)/fx, (v - cy)/fy, 1).  ur*: right-image u (< 0 mono).
    z*: stereo depth (<= 0 mono).  kp_xy* (N, 2): keypoints.  sigma2_* (N,):
    sigma^2 of each keypoint's octave.  Returns (points (N, 3), ok (N,)).
    """
    R1T, R2T = R1.transpose(1, 2), R2.transpose(1, 2)
    ray1 = _mv(R1T, xy1n)
    ray2 = _mv(R2T, xy2n)
    cosp = (ray1 * ray2).sum(1) / torch.clamp(
        torch.linalg.norm(ray1, dim=1) * torch.linalg.norm(ray2, dim=1), min=1e-12)
    two = torch.full_like(z1, 2.0)
    half_b = torch.full_like(z1, bf / fx / 2.0)
    cos_s1 = torch.where(z1 > 0, torch.cos(2.0 * torch.atan2(half_b, z1)), two)
    cos_s2 = torch.where(z2 > 0, torch.cos(2.0 * torch.atan2(half_b, z2)), two)
    cos_stereo = torch.minimum(cos_s1, cos_s2)

    # SVD path: the null vector of the stacked DLT rows; its sign cancels in
    # hp[:3] / hp[3]
    P1 = torch.cat([R1, t1[:, :, None]], 2)
    P2 = torch.cat([R2, t2[:, :, None]], 2)
    A = torch.stack([xy1n[:, 0:1] * P1[:, 2] - P1[:, 0],
                     xy1n[:, 1:2] * P1[:, 2] - P1[:, 1],
                     xy2n[:, 0:1] * P2[:, 2] - P2[:, 0],
                     xy2n[:, 1:2] * P2[:, 2] - P2[:, 1]], 1)
    hp = torch.linalg.svd(A).Vh[:, 3]
    svd_ok = hp[:, 3].abs() > 1e-12
    p_svd = hp[:, :3] / torch.where(svd_ok, hp[:, 3], torch.ones_like(hp[:, 3]))[:, None]

    # stereo fallback: camera coords = ray * z; world = R^T (pc - t)
    c1 = -_mv(R1T, t1)
    c2 = -_mv(R2T, t2)
    p_st1 = _mv(R1T, xy1n * z1[:, None] - t1)
    p_st2 = _mv(R2T, xy2n * z2[:, None] - t2)

    use_svd = (cosp < cos_stereo) & (cosp > 0) & svd_ok
    use_s1 = ~use_svd & (z1 > 0) & (cos_s1 < cos_s2)
    use_s2 = ~use_svd & ~use_s1 & (z2 > 0)
    p = torch.where(use_svd[:, None], p_svd,
                    torch.where(use_s1[:, None], p_st1, p_st2))

    def reproj_ok(R, t, kp, uur, sig2):
        pc = _mv(R, p) + t
        invz = 1.0 / torch.clamp(pc[:, 2], min=1e-9)
        u = fx * pc[:, 0] * invz + cx
        v = fy * pc[:, 1] * invz + cy
        e2 = (u - kp[:, 0]) ** 2 + (v - kp[:, 1]) ** 2
        dur = u - bf * invz - uur
        return (pc[:, 2] > 0) & torch.where(
            uur >= 0, e2 + dur * dur < 7.815 * sig2, e2 < 5.991 * sig2)

    ok1 = reproj_ok(R1, t1, kp_xy1, ur1, sigma2_1)
    ok2 = reproj_ok(R2, t2, kp_xy2, ur2, sigma2_2)
    d1 = torch.linalg.norm(p - c1, dim=1)
    d2 = torch.linalg.norm(p - c2, dim=1)
    ratio_dist = d2 / torch.clamp(d1, min=1e-12)
    ratio_oct = torch.sqrt(sigma2_1) / torch.clamp(torch.sqrt(sigma2_2), min=1e-12)
    scale_ok = (ratio_dist * ratio_factor >= ratio_oct) & \
        (ratio_dist <= ratio_oct * ratio_factor)
    ok = (use_svd | use_s1 | use_s2) & ok1 & ok2 & scale_ok & (d1 > 0) & (d2 > 0)
    return p, ok


def fundamental_matrix(R1w, t1w, R2w, t2w, K):
    """F12 = K^-T [t12]_x R12 K^-1 (ORBmatcher/LocalMapping ComputeF12)."""
    R12 = R1w @ R2w.T
    t12 = -R12 @ t2w + t1w
    tx = np.array([[0, -t12[2], t12[1]], [t12[2], 0, -t12[0]],
                   [-t12[1], t12[0], 0]], np.float32)
    Kinv = np.linalg.inv(K)
    return (Kinv.T @ tx @ R12 @ Kinv).astype(np.float32)
