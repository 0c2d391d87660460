"""Synthetic stereo/mono/RGB-D sequence generator with ground truth.

The reference validates end-to-end on public datasets (EuRoC/KITTI, SURVEY.md
§4); those images are not available in this environment, so integration tests
and benchmarks run on rendered synthetic scenes: a 3D cloud of textured
squares projected with a pinhole stereo rig.  Squares have sharp edges, which
FAST detects reliably, and genuine parallax, which exercises triangulation,
stereo depth, and pose estimation.
"""
from __future__ import annotations

import dataclasses
import os

import numpy as np

from . import png


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


def _raster_square(scene, i, T_cw, fx, fy, cx, cy, h, w, want_depth=False):
    """Ray-cast one fixed-orientation textured square.

    Returns (ys, xs, coverage, value_or_depth) or None if off-screen.
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
    if want_depth:
        return ys, xs, cov, z_cam
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
    return ys, xs, cov, val


def render(scene: SyntheticScene, T_cw: np.ndarray, fx, fy, cx, cy, h, w,
           background=25):
    """Render the scene from camera pose T_cw (world->camera).

    Fixed-orientation textured squares are ray-cast (static world geometry,
    real foreshortening) with edge anti-aliasing, composited in painter's
    order far-to-near.
    """
    img = np.full((h, w), float(background), dtype=np.float32)
    pc = (T_cw[:3, :3] @ scene.points.T).T + T_cw[:3, 3]
    order = np.argsort(-pc[:, 2])  # far to near
    for i in order:
        out = _raster_square(scene, i, T_cw, fx, fy, cx, cy, h, w)
        if out is None:
            continue
        ys, xs, cov, val = out
        region = img[ys[0]:ys[-1] + 1, xs[0]:xs[-1] + 1]
        img[ys[0]:ys[-1] + 1, xs[0]:xs[-1] + 1] = (
            region * (1.0 - cov) + val * cov)
    return np.clip(np.round(img), 0, 255).astype(np.uint8)


@dataclasses.dataclass
class StereoSequence:
    lefts: list
    rights: list
    depths: list            # (H, W) float32 per frame (RGB-D style) or None
    timestamps: np.ndarray
    poses_twc: np.ndarray   # (N, 4, 4) ground truth camera-to-world (left cam)
    fx: float
    fy: float
    cx: float
    cy: float
    baseline: float

    @property
    def bf(self):
        return self.fx * self.baseline


def make_stereo_sequence(seed=0, n_frames=30, h=240, w=320, fx=300.0,
                         baseline=0.4, trajectory="arc", with_depth=False,
                         n_points=700, laps=1):
    """Camera translates + yaws through the scene; returns images + ground
    truth.  laps: revolutions for the circle/orbit trajectories (laps > 1
    = a multi-loop soak sequence that re-visits the start repeatedly)."""
    rng = np.random.default_rng(seed)
    mode = {"circle": "ring", "orbit": "cloud"}.get(trajectory, "wall")
    scene = make_scene(rng, n_points=n_points, mode=mode)
    fy, cx, cy = fx, w / 2.0, h / 2.0
    poses = []
    for k in range(n_frames):
        a = k / max(n_frames - 1, 1)
        T = np.eye(4)
        if trajectory == "arc":
            yaw = 0.12 * np.sin(a * np.pi)
            cy_, sy_ = np.cos(yaw), np.sin(yaw)
            T[:3, :3] = np.array([[cy_, 0, sy_], [0, 1, 0], [-sy_, 0, cy_]])
            T[:3, 3] = [2.2 * a, 0.25 * np.sin(2 * np.pi * a), 1.5 * a]
        elif trajectory == "circle":
            # full revolution on a small circle, camera looking outward at
            # the ring scene; returns to the start pose (loop closure)
            yaw = 2 * np.pi * a * laps
            cy_, sy_ = np.cos(yaw), np.sin(yaw)
            T[:3, :3] = np.array([[cy_, 0, sy_], [0, 1, 0], [-sy_, 0, cy_]])
            # small loop radius: at r=1 the camera passes within ~1.4 m of
            # the near shell and per-frame optical flow exceeds the
            # projection-search windows (the translation anchors drop out)
            r = 0.6
            T[:3, 3] = [r * np.sin(yaw), 0.0, r * (1.0 - np.cos(yaw))]
        elif trajectory == "orbit":
            # turntable: camera on a circle of radius R looking inward at the
            # central cloud.  Anchor map points stay in view for a long arc
            # (well-conditioned), yet a full revolution still requires loop
            # closure: early keyframes' points leave the frustum (viewing-
            # angle gate) long before the orbit returns.
            yaw = 2 * np.pi * a * laps
            cy_, sy_ = np.cos(yaw), np.sin(yaw)
            R_orbit = 9.0
            # camera at angle yaw on the circle, optical axis toward origin
            T[:3, :3] = np.array([[cy_, 0, sy_], [0, 1, 0], [-sy_, 0, cy_]])
            T[:3, 3] = [-R_orbit * np.sin(yaw), 0.0, -R_orbit * np.cos(yaw)]
        elif trajectory == "forward":
            T[:3, 3] = [0, 0, 3.0 * a]
        else:  # lateral
            T[:3, 3] = [3.0 * a, 0, 0]
        poses.append(T)  # camera-to-world
    poses = np.array(poses)

    lefts, rights, depths = [], [], []
    T_rl = np.eye(4)
    T_rl[0, 3] = -baseline  # right camera: x_right = x_left - b
    for T_wc in poses:
        T_cw = np.linalg.inv(T_wc)
        lefts.append(render(scene, T_cw, fx, fy, cx, cy, h, w))
        rights.append(render(scene, T_rl @ T_cw, fx, fy, cx, cy, h, w))
        if with_depth:
            depths.append(_render_depth(scene, T_cw, fx, fy, cx, cy, h, w))
    ts = np.arange(n_frames) / 20.0
    return StereoSequence(lefts, rights, depths if with_depth else None,
                          ts, poses, fx, fy, cx, cy, baseline)


def _render_depth(scene, T_cw, fx, fy, cx, cy, h, w):
    depth = np.zeros((h, w), dtype=np.float32)
    pc = (T_cw[:3, :3] @ scene.points.T).T + T_cw[:3, 3]
    order = np.argsort(-pc[:, 2])
    for i in order:
        out = _raster_square(scene, i, T_cw, fx, fy, cx, cy, h, w,
                             want_depth=True)
        if out is None:
            continue
        ys, xs, cov, z_cam = out
        region = depth[ys[0]:ys[-1] + 1, xs[0]:xs[-1] + 1]
        depth[ys[0]:ys[-1] + 1, xs[0]:xs[-1] + 1] = np.where(
            cov > 0.5, z_cam.astype(np.float32), region)
    return depth


def warp_lens(img, cam, order=1):
    """A pinhole image as the camera's lens would show it: each distorted
    pixel takes the value at its own undistorted coordinate (the
    5-iteration model the tracker inverts, ``core.frame.undistort_points``),
    bilinear for a grey image (``order=1``, rounded back to uint8) or the
    nearest pixel for a depth image (``order=0``); 0 where that coordinate
    falls outside the image.  cam: a CameraConfig with the lens model."""
    from ..core.frame import undistort_points
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


EUROC_T0_NS = 1403636579763555584   # EuRoC MH_01's first stamp


def write_euroc_stereo(seq_dir, lefts, rights, timestamps) -> list[int]:
    """Write a stereo sequence as a EuRoC tree, mav0/cam{0,1}/data/<ns>.png
    (stamps: EUROC_T0_NS + t in ns), which ``io.datasets.load_euroc_stereo``
    reads back.  Returns the stamps in ns."""
    ts_ns = [int(t * 1e9) + EUROC_T0_NS for t in timestamps]
    for cam, imgs in (("cam0", lefts), ("cam1", rights)):
        d = os.path.join(seq_dir, "mav0", cam, "data")
        os.makedirs(d, exist_ok=True)
        for ns, img in zip(ts_ns, imgs):
            png.write(os.path.join(d, f"{ns}.png"), img)
    return ts_ns


def write_tum_rgbd(seq_dir, greys, depths_m, timestamps, depth_map_factor) -> str:
    """Write an RGB-D sequence as a TUM tree: rgb/<t>.png as 8-bit RGB (the
    grey image in all three channels), depth/<t>.png as 16-bit depth times
    ``depth_map_factor`` (0 where unknown), and associations.txt (`t rgb t
    depth`), which ``io.datasets.load_tum_rgbd`` reads back.  Returns the
    association file's path."""
    for sub in ("rgb", "depth"):
        os.makedirs(os.path.join(seq_dir, sub), exist_ok=True)
    lines = []
    for t, g, d in zip(timestamps, greys, depths_m):
        name = f"{t:.6f}.png"
        png.write(os.path.join(seq_dir, "rgb", name), np.repeat(g[:, :, None], 3, axis=2))
        raw = np.rint(np.clip(np.asarray(d, np.float64), 0, None) * depth_map_factor)
        png.write(os.path.join(seq_dir, "depth", name),
                  np.clip(raw, 0, 65535).astype(np.uint16))
        lines.append(f"{t:.6f} rgb/{name} {t:.6f} depth/{name}")
    path = os.path.join(seq_dir, "associations.txt")
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
    return path
