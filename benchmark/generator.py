"""The one traffic generator: a traffic file's parameters give the frames a
run feeds, rendered in a pool of processes.

A traffic file (``traffic/<name>.json``) names the closed trajectory, the
scene, the frames of one lap and the camera's rate; the configuration
gives the geometry.  A run is one session that cycles the lap with rising
timestamps, from the lap's first frame.  The scene is drawn from the
file's ``scene_seed``, so every seed feeds the same frames: where the seed
drew the scene, or the lap's start and direction, the work changed with
the seed (PERF.md), and the seed now draws only the output check's sample.
"""
from __future__ import annotations

import concurrent.futures
import dataclasses
import multiprocessing
import os
import types

import numpy as np

from .reference import synthetic


@dataclasses.dataclass
class Frames:
    lefts: list             # grey images, uint8 (H, W)
    rights: list | None     # stereo: the right eye
    depths: list | None     # RGB-D: depth in metres, 0 where unknown
    poses_twc: np.ndarray   # (N, 4, 4) ground truth, left camera to world
    scene: synthetic.SyntheticScene
    period: float           # seconds between frames at the camera's rate


def lens_of(settings: dict):
    g = settings.get
    return types.SimpleNamespace(
        fx=g("Camera.fx"), fy=g("Camera.fy"), cx=g("Camera.cx"), cy=g("Camera.cy"),
        k1=g("Camera.k1", 0.0), k2=g("Camera.k2", 0.0), p1=g("Camera.p1", 0.0),
        p2=g("Camera.p2", 0.0), k3=g("Camera.k3", 0.0))


def _render_one(args):
    scene, T_wc, settings, sensor = args
    s = settings
    fx, fy, cx, cy = s["Camera.fx"], s["Camera.fy"], s["Camera.cx"], s["Camera.cy"]
    h, w = s["Camera.height"], s["Camera.width"]
    T_cw = np.linalg.inv(T_wc)
    lens = lens_of(s)
    if sensor == "stereo":
        left = synthetic.warp_lens(synthetic.render(scene, T_cw, fx, fy, cx, cy, h, w), lens, 1)
        T_rl = np.eye(4)
        T_rl[0, 3] = -s["Camera.bf"] / fx
        return left, synthetic.render(scene, T_rl @ T_cw, fx, fy, cx, cy, h, w)
    grey, depth = synthetic.render(scene, T_cw, fx, fy, cx, cy, h, w, with_depth=True)
    return synthetic.warp_lens(grey, lens, 1), synthetic.warp_lens(depth, lens, 0)


def make_frames(config: dict, traffic: dict, workers: int | None = None) -> Frames:
    """Render one lap of ``traffic`` at ``config``'s geometry.  A lens in the configuration warps the grey image (bilinear)
    and the depth image (nearest) as the camera would show them; stereo
    eyes are rectified pinhole images."""
    rng = np.random.default_rng(traffic["scene_seed"])
    scene = synthetic.make_scene(rng, n_points=traffic["scene_points"],
                                 mode=traffic["scene"])
    poses = synthetic.trajectory(traffic["trajectory"], traffic["frames"])
    sensor = config["sensor"]
    jobs = [(scene, T, config["settings"], sensor) for T in poses]
    workers = workers or min(len(jobs), os.cpu_count() or 1)
    if workers > 1:
        ctx = multiprocessing.get_context("spawn")
        with concurrent.futures.ProcessPoolExecutor(workers, mp_context=ctx) as ex:
            out = list(ex.map(_render_one, jobs, chunksize=max(1, len(jobs) // (4 * workers))))
    else:
        out = [_render_one(j) for j in jobs]
    lefts = [o[0] for o in out]
    second = [o[1] for o in out]
    return Frames(lefts, second if sensor == "stereo" else None,
                  second if sensor == "rgbd" else None, poses, scene,
                  1.0 / traffic["rate_hz"])
