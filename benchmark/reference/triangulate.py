"""Two-view triangulation, the plain reference of local mapping's new points.

LocalMapping::CreateNewMapPoints (LocalMapping.cpp:284-437) for one matched
pair: the linear (DLT) solution where the rays' parallax beats the stereo
baseline's, else the stereo unprojection of the keyframe with the smaller
stereo angle.  Plain NumPy in float64; ``round_to`` rounds every
intermediate through a lower precision (the output check's control).
"""
from __future__ import annotations

import numpy as np

# branch decisions closer than this to their threshold (in cosine) are
# left out of the comparison: there float32 and float64 may choose apart
NEAR = 1e-5


def triangulate(R1, t1, R2, t2, xy1, xy2, z1, z2, fx, fy, cx, cy, bf,
                round_to=None, mono=False):
    """Returns (point (3,), decided): decided is False where a branch
    decision lies within NEAR of its threshold.  ``mono``: neither
    keyframe has a depth, so the linear solution is the only branch and no
    choice between two stereo unprojections is made."""
    r = round_to or (lambda a: np.asarray(a, np.float64))
    R1, t1, R2, t2 = (r(a) for a in (R1, t1, R2, t2))
    x1 = r(np.array([(xy1[0] - cx) / fx, (xy1[1] - cy) / fy, 1.0]))
    x2 = r(np.array([(xy2[0] - cx) / fx, (xy2[1] - cy) / fy, 1.0]))
    ray1, ray2 = r(R1.T @ x1), r(R2.T @ x2)
    cosp = float(ray1 @ ray2 / (np.linalg.norm(ray1) * np.linalg.norm(ray2)))
    half_b = bf / fx / 2.0
    cos_s1 = np.cos(2.0 * np.arctan2(half_b, z1)) if z1 > 0 else 2.0
    cos_s2 = np.cos(2.0 * np.arctan2(half_b, z2)) if z2 > 0 else 2.0
    cos_st = min(cos_s1, cos_s2)
    P1 = np.concatenate([R1, t1[:, None]], 1)
    P2 = np.concatenate([R2, t2[:, None]], 1)
    A = r(np.stack([x1[0] * P1[2] - P1[0], x1[1] * P1[2] - P1[1],
                    x2[0] * P2[2] - P2[0], x2[1] * P2[2] - P2[1]]))
    hp = np.linalg.svd(A)[2][3]
    use_svd = cosp < cos_st and cosp > 0 and abs(hp[3]) > 1e-12
    decided = abs(cosp - cos_st) > NEAR and (mono or abs(cos_s1 - cos_s2) > NEAR)
    if use_svd:
        p = hp[:3] / hp[3]
    elif z1 > 0 and cos_s1 < cos_s2:
        p = R1.T @ (x1 * z1 - t1)
    else:
        p = R2.T @ (x2 * z2 - t2)
    return r(p), decided
