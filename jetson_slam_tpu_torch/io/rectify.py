"""Stereo rectification: undistort-rectify maps + bilinear remap.

Port of ``jetson_slam_tpu/io/rectify.py``, the same float64 numpy maps and
the same uint8 remap on the host, so both packages rectify to the same
bytes.  The reference's example mains rectify EuRoC images with
cv::initUndistortRectifyMap + cv::remap from the YAML LEFT.*/RIGHT.* blocks
(stereo_euroc.cpp:80-107) before handing them to SLAM; this is that math
(pinhole + radial-tangential distortion), with the maps computed once per
configuration.
"""
from __future__ import annotations

import numpy as np


def init_undistort_rectify_map(K, D, R, P, size_hw):
    """cv::initUndistortRectifyMap for a pinhole/radtan camera.

    K: (3,3) original intrinsics; D: distortion [k1 k2 p1 p2 (k3)];
    R: (3,3) rectifying rotation; P: (3,4) or (3,3) new projection;
    size_hw: (H, W) of the rectified output.
    Returns (map_x, map_y) float32 arrays of shape (H, W): source pixel
    coordinates for every rectified pixel.
    """
    H, W = size_hw
    D = np.zeros(5) if D is None else np.asarray(D, np.float64).ravel()
    k1, k2, p1, p2 = D[0], D[1], D[2], D[3]
    k3 = D[4] if len(D) > 4 else 0.0
    P = np.asarray(P, np.float64)
    fxp, fyp = P[0, 0], P[1, 1]
    cxp, cyp = P[0, 2], P[1, 2]
    Rinv = np.linalg.inv(np.asarray(R, np.float64)) if R is not None else np.eye(3)

    u, v = np.meshgrid(np.arange(W), np.arange(H))
    x = (u - cxp) / fxp
    y = (v - cyp) / fyp
    ones = np.ones_like(x)
    vec = np.stack([x, y, ones], axis=-1) @ Rinv.T
    x = vec[..., 0] / vec[..., 2]
    y = vec[..., 1] / vec[..., 2]

    r2 = x * x + y * y
    radial = 1 + k1 * r2 + k2 * r2 ** 2 + k3 * r2 ** 3
    xd = x * radial + 2 * p1 * x * y + p2 * (r2 + 2 * x * x)
    yd = y * radial + p1 * (r2 + 2 * y * y) + 2 * p2 * x * y

    K = np.asarray(K, np.float64)
    map_x = (K[0, 0] * xd + K[0, 2]).astype(np.float32)
    map_y = (K[1, 1] * yd + K[1, 2]).astype(np.float32)
    return map_x, map_y


def remap_bilinear(img, map_x, map_y):
    """cv::remap(..., INTER_LINEAR, BORDER_CONSTANT=0) on a uint8 image."""
    H, W = img.shape[:2]
    x0 = np.floor(map_x).astype(np.int64)
    y0 = np.floor(map_y).astype(np.int64)
    fx = map_x - x0
    fy = map_y - y0
    valid = (map_x >= 0) & (map_x <= W - 1) & (map_y >= 0) & (map_y <= H - 1)
    x0c = np.clip(x0, 0, W - 1)
    y0c = np.clip(y0, 0, H - 1)
    x1c = np.clip(x0 + 1, 0, W - 1)
    y1c = np.clip(y0 + 1, 0, H - 1)
    im = img.astype(np.float32)
    out = (im[y0c, x0c] * (1 - fx) * (1 - fy)
           + im[y0c, x1c] * fx * (1 - fy)
           + im[y1c, x0c] * (1 - fx) * fy
           + im[y1c, x1c] * fx * fy)
    out = np.where(valid, out, 0.0)
    return np.clip(out + 0.5, 0, 255).astype(np.uint8)


class StereoRectifier:
    """Precomputed rectification for both eyes from a SLAMConfig with
    LEFT.*/RIGHT.* blocks; without them (``enabled`` False) the images pass
    through unchanged."""

    def __init__(self, cfg):
        self.enabled = cfg.left_rect is not None and cfg.right_rect is not None
        if not self.enabled:
            return
        lr, rr = cfg.left_rect, cfg.right_rect
        self.lmap = init_undistort_rectify_map(
            lr["K"], lr["D"], lr["R"], lr["P"], (lr["height"], lr["width"]))
        self.rmap = init_undistort_rectify_map(
            rr["K"], rr["D"], rr["R"], rr["P"], (rr["height"], rr["width"]))

    def rectify(self, left, right):
        if not self.enabled:
            return left, right
        return (remap_bilinear(left, *self.lmap),
                remap_bilinear(right, *self.rmap))
