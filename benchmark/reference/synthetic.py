"""The benchmark's scene generator: a frozen copy of the port's
``io/synthetic.py`` renderer (textured squares ray-cast with a pinhole rig,
depth images, the lens warp), and the trajectories of the traffic mixes.

Every frame of a run is made here from the run's seed, so later changes to
the program cannot change what the benchmark feeds it.
"""
from __future__ import annotations

import dataclasses

import numpy as np



TEX_G = 4  # texels per billboard side (coarse: fine grids alias — several
           # FAST corners a few px apart with near-identical descriptors let
           # pose optimization lock onto a coherently shifted association set)


@dataclasses.dataclass
class SyntheticScene:
    points: np.ndarray       # (P, 3) world coordinates
    intensities: np.ndarray  # (P,) uint8
    sizes: np.ndarray        # (P,) world half-size of each square
    textures: np.ndarray = None  # (P, TEX_G, TEX_G) float32 in [0, 1]
    axes1: np.ndarray = None     # (P, 3) in-plane axis 1 (world, unit)
    axes2: np.ndarray = None     # (P, 3) in-plane axis 2 (world, unit)


def make_scene(rng, n_points=600, extent=10.0, depth_range=(3.0, 12.0),
               mode="wall"):
    if mode == "cloud":
        # compact central cluster (for orbit/turntable trajectories): points
        # fill a box around the origin so an inward-looking camera keeps a
        # large, depth-diverse anchor set in view for a long arc
        pts = np.stack([
            rng.uniform(-extent * 0.35, extent * 0.35, n_points),
            rng.uniform(-extent * 0.25, extent * 0.25, n_points),
            rng.uniform(-extent * 0.35, extent * 0.35, n_points),
        ], axis=1)
    elif mode == "ring":
        # panoramic annulus around the origin (for loop trajectories)
        # two shells with strong depth diversity: a single-depth annulus makes
        # yaw indistinguishable from lateral translation (and far shells make
        # forward drift invisible: 1/Z edge shift, 1/Z^2 disparity) — the
        # pose basin then has a flat valley that the velocity model walks
        # along, compounding drift exponentially
        ang = rng.uniform(0, 2 * np.pi, n_points)
        near = rng.random(n_points) < 0.5
        rad = np.where(
            near,
            rng.uniform(depth_range[0], depth_range[0] + 2.0, n_points),
            rng.uniform(depth_range[0] + 4.0, depth_range[0] + 10.0, n_points))
        pts = np.stack([
            rad * np.sin(ang),
            rng.uniform(-extent * 0.4, extent * 0.4, n_points),
            rad * np.cos(ang),
        ], axis=1)
    else:
        pts = np.stack([
            rng.uniform(-extent, extent, n_points),
            rng.uniform(-extent * 0.6, extent * 0.6, n_points),
            rng.uniform(depth_range[0], depth_range[1], n_points),
        ], axis=1)
    inten = rng.integers(140, 255, n_points).astype(np.uint8)
    sizes = rng.uniform(0.08, 0.24, n_points)
    # unique random texture per billboard: uniform squares all share the
    # same (radially trivial) rBRIEF descriptor, which collapses descriptor
    # matching into nearest-in-window dead reckoning and makes VO drift
    # compound on rotation-heavy sequences; textures restore the appearance
    # discrimination real images have
    textures = rng.uniform(0.15, 1.0, (n_points, TEX_G, TEX_G)).astype(np.float32)
    # FIXED world-space orientation per square.  Camera-facing billboards
    # are not rigid scenery: their texture features physically orbit the
    # square center as the camera rotates (~size * d_yaw world motion per
    # frame), which injects a coherent per-generation map bias that
    # compounds until tracking diverges.  Each square instead faces the
    # origin (where the cameras live) with a small random tilt, and the
    # renderer ray-casts the actual plane, so features are genuinely static
    # and foreshortening is real.
    to_origin = -pts / np.maximum(np.linalg.norm(pts, axis=1, keepdims=True), 1e-9)
    tilt = rng.uniform(-0.35, 0.35, (n_points, 3))
    normals = to_origin + tilt
    normals /= np.maximum(np.linalg.norm(normals, axis=1, keepdims=True), 1e-9)
    up = np.tile(np.array([0.0, 1.0, 0.0]), (n_points, 1))
    up[np.abs(normals[:, 1]) > 0.9] = [1.0, 0.0, 0.0]
    a1 = np.cross(up, normals)
    a1 /= np.maximum(np.linalg.norm(a1, axis=1, keepdims=True), 1e-9)
    a2 = np.cross(normals, a1)
    return SyntheticScene(pts, inten, sizes, textures,
                          a1.astype(np.float64), a2.astype(np.float64))


def _raster_square(scene, i, T_cw, fx, fy, cx, cy, h, w):
    """Ray-cast one fixed-orientation textured square.

    Returns (ys, xs, coverage, value, depth) or None if off-screen.
    Squares are genuinely static world geometry: pixel rays intersect the
    square's plane, texture coords come from the in-plane offsets, and
    anti-aliasing uses the edge distance converted to pixels.
    """
    R = T_cw[:3, :3]
    t = T_cw[:3, 3]
    c = scene.points[i]
    a1 = scene.axes1[i]
    a2 = scene.axes2[i]
    hs = scene.sizes[i]
    # cull squares behind or nearly edge-on
    cc = R @ c + t
    if cc[2] < 0.5:
        return None
    n_w = np.cross(a1, a2)
    # camera center in world
    o = -R.T @ t
    view = c - o
    if abs(np.dot(view, n_w)) / max(np.linalg.norm(view), 1e-9) < 0.15:
        return None
    # bounding box from projected corners
    corners = c[None, :] + np.array(
        [[-hs, -hs], [-hs, hs], [hs, -hs], [hs, hs]]) @ np.stack([a1, a2])
    pc = corners @ R.T + t
    if np.any(pc[:, 2] < 0.2):
        return None
    uc = fx * pc[:, 0] / pc[:, 2] + cx
    vc = fy * pc[:, 1] / pc[:, 2] + cy
    x0 = int(np.floor(uc.min())) - 1
    x1 = int(np.ceil(uc.max())) + 1
    y0 = int(np.floor(vc.min())) - 1
    y1 = int(np.ceil(vc.max())) + 1
    if x1 < 0 or y1 < 0 or x0 >= w or y0 >= h or (x1 - x0) > w * 2:
        return None
    xs = np.arange(max(x0, 0), min(x1 + 1, w))
    ys = np.arange(max(y0, 0), min(y1 + 1, h))
    if len(xs) == 0 or len(ys) == 0:
        return None
    # rays through pixel centers, world frame
    du = (xs + 0.0 - cx) / fx
    dv = (ys + 0.0 - cy) / fy
    d_cam = np.stack([np.broadcast_to(du[None, :], (len(ys), len(xs))),
                      np.broadcast_to(dv[:, None], (len(ys), len(xs))),
                      np.ones((len(ys), len(xs)))], axis=-1)
    d_w = d_cam @ R  # == R.T @ d per pixel
    denom = d_w @ n_w
    denom = np.where(np.abs(denom) < 1e-9, 1e-9, denom)
    s_t = ((c - o) @ n_w) / denom
    p = o[None, None, :] + s_t[..., None] * d_w
    rel = p - c
    alpha = rel @ a1
    beta = rel @ a2
    # camera-frame z of the intersection: cam center maps to 0 and the ray
    # direction's camera z-component is 1, so z_cam == s_t
    z_cam = s_t
    # edge anti-aliasing: world-per-pixel at this depth
    wpp = np.maximum(z_cam, 0.1) / fx
    e1 = (hs - np.abs(alpha)) / wpp
    e2 = (hs - np.abs(beta)) / wpp
    cov = np.clip(e1 + 0.5, 0.0, 1.0) * np.clip(e2 + 0.5, 0.0, 1.0)
    cov = np.where((s_t > 0.2), cov, 0.0)
    if not np.any(cov > 0):
        return None
    tex = scene.textures[i]
    G = tex.shape[0]
    txf = np.clip((alpha + hs) / (2 * hs) * G - 0.5, 0.0, G - 1.0 - 1e-6)
    tyf = np.clip((beta + hs) / (2 * hs) * G - 0.5, 0.0, G - 1.0 - 1e-6)
    tx0 = txf.astype(np.int64)
    ty0 = tyf.astype(np.int64)
    ax = txf - tx0
    ay = tyf - ty0
    tx1 = np.minimum(tx0 + 1, G - 1)
    ty1 = np.minimum(ty0 + 1, G - 1)
    val = ((tex[ty0, tx0] * (1 - ax) + tex[ty0, tx1] * ax) * (1 - ay) +
           (tex[ty1, tx0] * (1 - ax) + tex[ty1, tx1] * ax) * ay)
    val = val * float(scene.intensities[i])
    return ys, xs, cov, val, z_cam


def render(scene: SyntheticScene, T_cw: np.ndarray, fx, fy, cx, cy, h, w,
           background=25, with_depth=False):
    """Render the scene from camera pose T_cw (world->camera).

    Fixed-orientation textured squares are ray-cast (static world geometry,
    real foreshortening) with edge anti-aliasing, composited in painter's
    order far-to-near.  ``with_depth``: also the depth image in metres (0
    where no square covers half a pixel), from the same pass.
    """
    img = np.full((h, w), float(background), dtype=np.float32)
    depth = np.zeros((h, w), dtype=np.float32) if with_depth else None
    pc = (T_cw[:3, :3] @ scene.points.T).T + T_cw[:3, 3]
    order = np.argsort(-pc[:, 2])  # far to near
    for i in order:
        out = _raster_square(scene, i, T_cw, fx, fy, cx, cy, h, w)
        if out is None:
            continue
        ys, xs, cov, val, z_cam = out
        box = (slice(ys[0], ys[-1] + 1), slice(xs[0], xs[-1] + 1))
        img[box] = img[box] * (1.0 - cov) + val * cov
        if with_depth:
            depth[box] = np.where(cov > 0.5, z_cam.astype(np.float32), depth[box])
    img = np.clip(np.round(img), 0, 255).astype(np.uint8)
    return (img, depth) if with_depth else img


def undistort_points(xy, fx, fy, cx, cy, k1, k2, p1, p2, k3=0.0, iters=5):
    """The 5-iteration inverse of the radial-tangential lens, float64; a
    copy when every coefficient is 0."""
    xy = np.asarray(xy, np.float64)
    if not any((k1, k2, p1, p2, k3)):
        return xy.copy()
    x = (xy[:, 0] - cx) / fx
    y = (xy[:, 1] - cy) / fy
    x0, y0 = x.copy(), y.copy()
    for _ in range(iters):
        r2 = x * x + y * y
        radial = 1 + k1 * r2 + k2 * r2 ** 2 + k3 * r2 ** 3
        dx = 2 * p1 * x * y + p2 * (r2 + 2 * x * x)
        dy = p1 * (r2 + 2 * y * y) + 2 * p2 * x * y
        x = (x0 - dx) / radial
        y = (y0 - dy) / radial
    return np.stack([x * fx + cx, y * fy + cy], 1)


def warp_lens(img, cam, order=1):
    """A pinhole image as the camera's lens would show it: each distorted
    pixel takes the value at its own undistorted coordinate (the
    5-iteration model the tracker inverts, ``core.frame.undistort_points``),
    bilinear for a grey image (``order=1``, rounded back to uint8) or the
    nearest pixel for a depth image (``order=0``); 0 where that coordinate
    falls outside the image.  cam: a CameraConfig with the lens model."""
    img = np.asarray(img)
    h, w = img.shape
    v, u = np.mgrid[0:h, 0:w]
    xy = np.stack([u.ravel(), v.ravel()], 1).astype(np.float64)
    src = undistort_points(xy, cam.fx, cam.fy, cam.cx, cam.cy, cam.k1, cam.k2,
                           cam.p1, cam.p2, cam.k3)
    sx, sy = src[:, 0], src[:, 1]
    if order == 0:
        xi = np.floor(sx + 0.5).astype(np.int64)
        yi = np.floor(sy + 0.5).astype(np.int64)
        inside = (xi >= 0) & (xi < w) & (yi >= 0) & (yi < h)
        out = np.zeros(h * w, img.dtype)
        out[inside] = img[yi[inside], xi[inside]]
        return out.reshape(h, w)
    x0 = np.floor(sx).astype(np.int64)
    y0 = np.floor(sy).astype(np.int64)
    ax, ay = sx - x0, sy - y0
    inside = (x0 >= 0) & (x0 < w - 1) & (y0 >= 0) & (y0 < h - 1)
    x0, y0, ax, ay = x0[inside], y0[inside], ax[inside], ay[inside]
    f = img.astype(np.float64)
    val = ((1 - ay) * ((1 - ax) * f[y0, x0] + ax * f[y0, x0 + 1])
           + ay * ((1 - ax) * f[y0 + 1, x0] + ax * f[y0 + 1, x0 + 1]))
    out = np.zeros(h * w, np.float64)
    out[inside] = val
    return np.clip(np.rint(out), 0, 255).astype(np.uint8).reshape(h, w)


def trajectory(kind: str, n_frames: int):
    """(n_frames, 4, 4) camera-to-world poses of one closed lap, frame k at
    a = k / n, so the lap repeats with no duplicate frame at the wrap.
    ``circle``: radius 0.6 m looking outward, yaw 2 pi a."""
    if kind != "circle":
        raise ValueError(f"unknown trajectory {kind!r}")
    poses = []
    for k in range(n_frames):
        yaw = 2 * np.pi * k / n_frames
        T = np.eye(4)
        T[:3, 3] = [0.6 * np.sin(yaw), 0.0, 0.6 * (1.0 - np.cos(yaw))]
        c, s = np.cos(yaw), np.sin(yaw)
        T[:3, :3] = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])
        poses.append(T)
    return np.array(poses)
