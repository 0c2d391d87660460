"""Configuration system.

Keeps the reference's OpenCV-YAML key names (SURVEY.md §5 config list;
reference: src/Tracking.cpp:106-216, Examples/Stereo/EuRoC.yaml) so the
reference's per-dataset config files port directly, while exposing a typed
dataclass for the PyTorch/CUDA pipeline.
"""
from __future__ import annotations

import dataclasses
import re
from typing import Optional

import numpy as np


@dataclasses.dataclass
class CameraConfig:
    fx: float = 458.654
    fy: float = 457.296
    cx: float = 367.215
    cy: float = 248.375
    k1: float = 0.0
    k2: float = 0.0
    p1: float = 0.0
    p2: float = 0.0
    k3: float = 0.0
    width: int = 752
    height: int = 480
    bf: float = 47.90639384423901  # baseline * fx (stereo)
    fps: float = 20.0
    rgb: int = 1
    th_depth: float = 35.0         # reference key "ThDepth" (Tracking.cpp:92)
    depth_map_factor: float = 1.0  # RGB-D only


@dataclasses.dataclass
class ORBConfig:
    """Front-end parameters (reference keys ORBextractor.*, Tracking.cpp:128-178)."""
    n_levels: int = 8
    scale_factor: float = 1.2
    th_fast_min: int = 20   # overwritten by th_fast_max in the reference (orb_gpu.cpp:42-43)
    th_fast_max: int = 20
    fast_n_min: int = 9
    fast_n_max: int = 16
    tile_h: int = 30
    tile_w: int = 30
    fixed_multi_scale_tile_size: bool = False
    apply_nms_ms: bool = False
    nms_ms_mode_gpu: bool = True
    mask_left: str = ""
    mask_right: str = ""


@dataclasses.dataclass
class ViewerConfig:
    use_viewer: bool = False
    keyframe_size: float = 0.05
    keyframe_line_width: float = 1.0
    graph_line_width: float = 0.9
    point_size: float = 2.0
    camera_size: float = 0.08
    camera_line_width: float = 3.0
    viewpoint_x: float = 0.0
    viewpoint_y: float = -0.7
    viewpoint_z: float = -1.8
    viewpoint_f: float = 500.0


@dataclasses.dataclass
class SLAMConfig:
    camera: CameraConfig = dataclasses.field(default_factory=CameraConfig)
    orb: ORBConfig = dataclasses.field(default_factory=ORBConfig)
    viewer: ViewerConfig = dataclasses.field(default_factory=ViewerConfig)
    use_gpu: bool = True       # reference key gpu.use_gpu (kept for config parity)
    is_jetson: bool = False    # reference key gpu.is_jetson (kept for config parity)
    device_id: int = 0
    # additions (not in the reference):
    kp_capacity_per_level: Optional[int] = None  # default: #tiles per level
    max_map_points: int = 65536
    max_keyframes: int = 1024
    # LEFT.*/RIGHT.* stereo rectification blocks (consumed by the reference
    # example mains, stereo_euroc.cpp:80-107); dicts of K/D/R/P numpy arrays
    left_rect: Optional[dict] = None
    right_rect: Optional[dict] = None

    @property
    def mb(self) -> float:
        """Stereo baseline in meters (bf / fx), reference Tracking.cpp mb = mbf/fx."""
        return self.camera.bf / self.camera.fx


_OPENCV_YAML_HEADER = re.compile(r"^%YAML[:\s].*$", re.M)


def _parse_opencv_yaml(text: str) -> dict:
    """Minimal OpenCV FileStorage YAML parser (flat key: value pairs).

    The reference configs are flat `Namespace.key: value` maps plus
    `opencv-matrix` blocks for the LEFT.*/RIGHT.* rectification parameters;
    we parse both without requiring the (unavailable) cv2 module.
    """
    text = _OPENCV_YAML_HEADER.sub("", text)
    lines = text.splitlines()
    out: dict = {}
    i = 0
    while i < len(lines):
        line = lines[i].split("#", 1)[0].rstrip()
        i += 1
        if not line.strip() or ":" not in line:
            continue
        if line.startswith(" ") or line.startswith("\t"):
            continue  # matrix fields handled by the block scanner below
        key, _, val = line.partition(":")
        key = key.strip()
        val = val.strip().strip('"')
        if val == "!!opencv-matrix" or val == "":
            # scan an opencv-matrix block: rows/cols/dt/data
            block: dict = {}
            while i < len(lines) and (lines[i].startswith(" ") or lines[i].startswith("\t")):
                bline = lines[i].strip()
                i += 1
                if bline.startswith("data:"):
                    data_txt = bline[len("data:"):].strip()
                    while "]" not in data_txt and i < len(lines):
                        data_txt += " " + lines[i].strip()
                        i += 1
                    nums = re.findall(r"[-+0-9.eE]+", data_txt)
                    block["data"] = [float(x) for x in nums]
                elif ":" in bline:
                    k2, _, v2 = bline.partition(":")
                    v2 = v2.strip()
                    try:
                        block[k2.strip()] = int(v2)
                    except ValueError:
                        block[k2.strip()] = v2
            out[key] = block
            continue
        try:
            out[key] = int(val)
        except ValueError:
            try:
                out[key] = float(val)
            except ValueError:
                out[key] = val
    return out


def load_config(path: str) -> SLAMConfig:
    """Load a reference-format YAML settings file into SLAMConfig."""
    with open(path) as f:
        kv = _parse_opencv_yaml(f.read())
    return config_from_dict(kv)


def config_from_dict(kv: dict) -> SLAMConfig:
    cfg = SLAMConfig()
    cam = cfg.camera
    g = kv.get
    cam.fx = float(g("Camera.fx", cam.fx))
    cam.fy = float(g("Camera.fy", cam.fy))
    cam.cx = float(g("Camera.cx", cam.cx))
    cam.cy = float(g("Camera.cy", cam.cy))
    cam.k1 = float(g("Camera.k1", cam.k1))
    cam.k2 = float(g("Camera.k2", cam.k2))
    cam.p1 = float(g("Camera.p1", cam.p1))
    cam.p2 = float(g("Camera.p2", cam.p2))
    cam.k3 = float(g("Camera.k3", cam.k3))
    cam.width = int(g("Camera.width", cam.width))
    cam.height = int(g("Camera.height", cam.height))
    cam.bf = float(g("Camera.bf", cam.bf))
    cam.fps = float(g("Camera.fps", cam.fps) or 30.0)
    cam.rgb = int(g("Camera.RGB", cam.rgb))
    cam.th_depth = float(g("ThDepth", cam.th_depth))
    cam.depth_map_factor = float(g("DepthMapFactor", cam.depth_map_factor))

    orb = cfg.orb
    orb.n_levels = int(g("ORBextractor.nLevels", orb.n_levels))
    orb.scale_factor = float(g("ORBextractor.scaleFactor", orb.scale_factor))
    orb.th_fast_min = int(g("ORBextractor.th_FAST_MIN", orb.th_fast_min))
    orb.th_fast_max = int(g("ORBextractor.th_FAST_MAX", orb.th_fast_max))
    orb.fast_n_min = int(g("ORBextractor.FAST_N_MIN", orb.fast_n_min))
    orb.fast_n_max = int(g("ORBextractor.FAST_N_MAX", orb.fast_n_max))
    orb.tile_h = int(g("ORBextractor.tile_h", orb.tile_h))
    orb.tile_w = int(g("ORBextractor.tile_w", orb.tile_w))
    orb.fixed_multi_scale_tile_size = bool(int(g("ORBextractor.fixed_multi_scale_tile_size", 0)))
    orb.apply_nms_ms = bool(int(g("ORBextractor.apply_nms_ms", 0)))
    orb.nms_ms_mode_gpu = bool(int(g("ORBextractor.nms_ms_mode_gpu", 1)))
    orb.mask_left = str(g("mask.left", ""))
    orb.mask_right = str(g("mask.right", ""))

    cfg.use_gpu = bool(int(g("gpu.use_gpu", 1)))
    cfg.is_jetson = bool(int(g("gpu.is_jetson", 0)))
    cfg.device_id = int(g("gpu.device_id", 0))
    cfg.viewer.use_viewer = bool(int(g("Viewer.UseViewer", 0)))

    # LEFT.*/RIGHT.* rectification matrices (opencv-matrix blocks)
    def _mat(side, name):
        blk = kv.get(f"{side}.{name}")
        if not isinstance(blk, dict) or "data" not in blk:
            return None
        rows = int(blk.get("rows", 1))
        cols = int(blk.get("cols", len(blk["data"]) // max(rows, 1)))
        return np.asarray(blk["data"], np.float64).reshape(rows, cols)

    for side, attr in (("LEFT", "left_rect"), ("RIGHT", "right_rect")):
        K = _mat(side, "K")
        if K is None:
            continue
        setattr(cfg, attr, {
            "K": K, "D": _mat(side, "D"), "R": _mat(side, "R"),
            "P": _mat(side, "P"),
            "height": int(kv.get(f"{side}.height", cfg.camera.height)),
            "width": int(kv.get(f"{side}.width", cfg.camera.width)),
        })
    return cfg


def _yaml_matrix(key: str, a) -> list[str]:
    a = np.atleast_2d(np.asarray(a, np.float64))
    data = ", ".join(repr(float(x)) for x in a.ravel())
    return [f"{key}: !!opencv-matrix", f"   rows: {a.shape[0]}", f"   cols: {a.shape[1]}",
            "   dt: d", f"   data: [{data}]"]


def save_config(cfg: SLAMConfig, path: str) -> None:
    """Write cfg as a reference-format YAML settings file: every key that
    load_config reads, and the LEFT.*/RIGHT.* blocks when present, so
    load_config(path) gives cfg back (but for max_map_points,
    max_keyframes and kp_capacity_per_level, which no YAML key carries)."""
    c, o = cfg.camera, cfg.orb
    keys = {
        "Camera.fx": c.fx, "Camera.fy": c.fy, "Camera.cx": c.cx, "Camera.cy": c.cy,
        "Camera.k1": c.k1, "Camera.k2": c.k2, "Camera.p1": c.p1, "Camera.p2": c.p2,
        "Camera.k3": c.k3, "Camera.width": c.width, "Camera.height": c.height,
        "Camera.bf": c.bf, "Camera.fps": c.fps, "Camera.RGB": c.rgb,
        "ThDepth": c.th_depth, "DepthMapFactor": c.depth_map_factor,
        "ORBextractor.nLevels": o.n_levels, "ORBextractor.scaleFactor": o.scale_factor,
        "ORBextractor.th_FAST_MIN": o.th_fast_min, "ORBextractor.th_FAST_MAX": o.th_fast_max,
        "ORBextractor.FAST_N_MIN": o.fast_n_min, "ORBextractor.FAST_N_MAX": o.fast_n_max,
        "ORBextractor.tile_h": o.tile_h, "ORBextractor.tile_w": o.tile_w,
        "ORBextractor.fixed_multi_scale_tile_size": int(o.fixed_multi_scale_tile_size),
        "ORBextractor.apply_nms_ms": int(o.apply_nms_ms),
        "ORBextractor.nms_ms_mode_gpu": int(o.nms_ms_mode_gpu),
        "gpu.use_gpu": int(cfg.use_gpu), "gpu.is_jetson": int(cfg.is_jetson),
        "gpu.device_id": cfg.device_id, "Viewer.UseViewer": int(cfg.viewer.use_viewer),
    }
    lines = ["%YAML:1.0"]
    lines += [f"{k}: {float(v)!r}" if isinstance(v, float) else f"{k}: {v}"
              for k, v in keys.items()]
    for k, v in (("mask.left", o.mask_left), ("mask.right", o.mask_right)):
        if v:
            lines.append(f'{k}: "{v}"')
    for side, rect in (("LEFT", cfg.left_rect), ("RIGHT", cfg.right_rect)):
        if rect is None:
            continue
        lines += [f"{side}.height: {int(rect['height'])}", f"{side}.width: {int(rect['width'])}"]
        for name in ("K", "D", "R", "P"):
            if rect[name] is not None:
                lines += _yaml_matrix(f"{side}.{name}", rect[name])
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
