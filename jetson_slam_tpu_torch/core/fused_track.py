"""Whole-frame tracking step: one call per frame, one pull of its results.

Port of ``jetson_slam_tpu/core/fused_track.py`` for its three sensor modes.
Per steady-state frame:

    front-end: stereo, both eyes + stereo matching (OrbFrontend.frame_step);
      rgbd and mono, the one image (OrbFrontend.extract)
    -> keypoint undistortion (only when the lens model is not trivial)
    -> rgbd: the depth image gathered at the raw keypoint, and the virtual
       right coordinate from the undistorted x; mono: no depth
    -> motion-model search + pose LM
    -> local-map frustum check + search + pose LM

all queued on the device with the copies of every output the host needs
to pinned memory (``fused_track_dispatch``); ``fused_track_pull`` then
waits once, on an event behind those copies, so the tracker can keep
frames in flight between the two (``pipeline_depth``).  The inputs are
uploaded before the front-end is queued; other synchronisations left on
the path are counted in PERF.md.  The
host supplies the previous frame's per-slot state and a speculated
local-map candidate set (see ``core/tracking.py``).  PyTorch runs the step
eagerly, so it is many small launches; the count per frame is in PERF.md.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch.profiler import record_function

from .frame import finish_pull, rgbd_right, start_pull
from .matcher import local_map_track, motion_model_track


@dataclasses.dataclass
class FusedTrackResult:
    """Host-side result of the fused step (numpy)."""
    # motion-model stage
    m: np.ndarray        # (S,) per-current-slot index into last slots (-1 none)
    n_match: int
    R1: np.ndarray
    t1: np.ndarray
    inl1: np.ndarray     # (S,) inliers of the motion-model pose LM
    n_map1: int          # inliers carrying real (non-temporary) map points
    # local-map stage
    ok: np.ndarray       # (C,) frustum-visible candidates
    sel: np.ndarray      # (S,) per-current-slot index into candidates (-1)
    R2: np.ndarray
    t2: np.ndarray
    inl2: np.ndarray
    n_map2: int
    # set by the tracker: snapshots taken when the inputs were captured
    last_gen: np.ndarray | None = None
    spec_gen: np.ndarray | None = None
    spec_pid: np.ndarray | None = None
    last_snap: dict | None = None


def undistort_device(xy, fx, fy, cx, cy, k1, k2, p1, p2, k3, iters=5):
    """Fixed-iteration undistortion on device (the scheme of
    ``frame.undistort_points``)."""
    x = (xy[:, 0] - cx) / fx
    y = (xy[:, 1] - cy) / fy
    x0, y0 = x, y
    for _ in range(iters):
        r2 = x * x + y * y
        radial = 1 + k1 * r2 + k2 * r2 ** 2 + k3 * r2 ** 3
        dx = 2 * p1 * x * y + p2 * (r2 + 2 * x * x)
        dy = p1 * (r2 + 2 * y * y) + 2 * p2 * x * y
        x = (x0 - dx) / radial
        y = (y0 - dy) / radial
    return torch.stack([x * fx + cx, y * fy + cy], 1)


def fused_track_device(fe, cam, imgs, mode, pred_Tcw, last_state, cand, th_mm,
                       th_lm, scale_factors, inv_level_sigma2, cam_params,
                       forward: bool, backward: bool):
    """Queue the whole tracking step on the front-end's device.

    imgs: (left, right) uint8 images for mode "stereo", (grey uint8, depth
    float32 in metres) for "rgbd", (grey,) for "mono".  pred_Tcw: 4x4
    predicted pose.
    last_state: dict of tensors pw (S, 3), has_pt, real, pid, octave, angle,
    desc.  cand: dict of tensors pos, normal, maxd, mind, desc, alive,
    pid (padded to a power of two).  scale_factors, inv_level_sigma2: (L,)
    tensors.  cam_params: (fx, fy, cx, cy, bf, mb, min_x, max_x, min_y,
    max_y, log_scale, n_levels).  Returns a tuple of device tensors."""
    (fx, fy, cx, cy, bf, mb, min_x, max_x, min_y, max_y, log_scale,
     n_levels) = cam_params
    dev = fe.device
    # uploaded while the stream is idle: a copy from pageable host memory
    # waits for the stream, which would stall the host behind the front-end
    Rcw = torch.as_tensor(np.ascontiguousarray(pred_Tcw[:3, :3]), device=dev)
    tcw = torch.as_tensor(np.ascontiguousarray(pred_Tcw[:3, 3]), device=dev)
    if mode == "rgbd":
        # float32 metres: the front-end's image path would cast it to uint8
        depth_img = torch.as_tensor(np.ascontiguousarray(imgs[1], np.float32),
                                    device=dev)
    with record_function("slice.frontend"):
        if mode == "stereo":
            cur, _right, u_r, depth, _dist = fe.frame_step(imgs[0], imgs[1], cam.bf, mb)
        else:
            cur = fe.extract(imgs[0])
        cur_xy = torch.stack([cur.xs, cur.ys], 1)
        if not (cam.k1 == 0 and cam.k2 == 0 and cam.p1 == 0 and cam.p2 == 0
                and cam.k3 == 0):
            cur_xy = undistort_device(cur_xy, fx, fy, cx, cy, cam.k1, cam.k2,
                                      cam.p1, cam.p2, cam.k3)
        if mode == "rgbd":
            u_r, depth = rgbd_right(depth_img, cur.xs, cur.ys, cur_xy[:, 0],
                                    cur.valid, bf)
        elif mode == "mono":    # no depth
            u_r = torch.full_like(cur.xs, -1.0)
            depth = torch.full_like(cur.xs, -1.0)
    ls = last_state

    # ---- motion-model stage (TrackWithMotionModel semantics)
    with record_function("slice.motion_model"):
        m, n_match, R1, t1, inl1, n_map1 = motion_model_track(
            Rcw, tcw, ls["pw"], ls["has_pt"], ls["real"], ls["octave"],
            ls["angle"], ls["desc"], cur_xy, cur.octave, cur.angle, cur.desc,
            cur.valid, u_r, th_mm, scale_factors, inv_level_sigma2, n_levels,
            fx, fy, cx, cy, bf, min_x, max_x, min_y, max_y, forward, backward)
    with record_function("slice.local_map"):
        ok, sel, R2, t2, inl2, n_map2 = _local_map_stage(
            cur, cur_xy, u_r, m, R1, t1, ls, cand, th_lm, scale_factors,
            inv_level_sigma2, cam_params)
    return (cur, u_r, depth, m, n_match, R1, t1, inl1, n_map1,
            ok, sel, R2, t2, inl2, n_map2)


def _local_map_stage(cur, cur_xy, u_r, m, R1, t1, ls, cand, th_lm,
                     scale_factors, inv_level_sigma2, cam_params):
    """The local-map half of the fused step, from the motion-model pose."""
    (fx, fy, cx, cy, bf, _mb, min_x, max_x, min_y, max_y, log_scale,
     n_levels) = cam_params

    # ---- the local-map stage keeps REAL map points only (temporary VO
    # points drop at TrackLocalMap, Tracking.cpp:1130)
    has_m = m >= 0
    midx = torch.where(has_m, m, torch.zeros_like(m)).to(torch.int64)
    exist_real = has_m & ls["real"][midx]
    exist_pts = torch.where(exist_real[:, None], ls["pw"][midx],
                            torch.zeros_like(ls["pw"][midx]))
    pid_cur = torch.where(exist_real, ls["pid"][midx], torch.full_like(m, -1))
    # candidates already matched in this frame are excluded
    in_frame = ((cand["pid"][:, None] == pid_cur[None, :])
                & (pid_cur >= 0)[None, :]).any(1)
    ok, sel, R2, t2, inl2, n_map2 = local_map_track(
        cand["pos"], cand["normal"], cand["maxd"], cand["mind"], cand["desc"],
        cand["alive"] & ~in_frame, R1, t1, -R1.T @ t1,
        cur_xy, cur.octave, cur.desc, cur.valid, u_r, ~exist_real,
        exist_pts, exist_real, exist_real,
        th_lm, scale_factors, inv_level_sigma2, n_levels,
        fx, fy, cx, cy, bf, min_x, max_x, min_y, max_y, log_scale)
    return ok, sel, R2, t2, inl2, n_map2


def fused_track_dispatch(fe, cam, imgs, mode, pred_Tcw, last_state, cand,
                         th_mm, th_lm, scale_factors, inv_level_sigma2,
                         cam_params, forward, backward):
    """Queue the fused step and the copies of its outputs to pinned host
    memory; waits for nothing on the card.  Same inputs as fused_track.
    Returns (pending copies, dev_cache of the still-resident front-end
    tensors) for fused_track_pull: the split lets the tracker keep frames
    in flight while it finishes the host bookkeeping of an older one."""
    (cur, u_r, depth, m, n_match, R1, t1, inl1, n_map1,
     ok, sel, R2, t2, inl2, n_map2) = fused_track_device(
        fe, cam, imgs, mode, pred_Tcw, last_state, cand, th_mm, th_lm,
        scale_factors, inv_level_sigma2, cam_params, forward, backward)
    pending = start_pull((cur.valid, cur.xs, cur.ys, cur.octave, cur.angle,
                          cur.desc, u_r, depth, m, n_match, R1, t1, inl1,
                          n_map1, ok, sel, R2, t2, inl2, n_map2, cur.response))
    dev_cache = {"valid": cur.valid, "desc": cur.desc, "octave": cur.octave,
                 "angle": cur.angle, "u_right": u_r}
    return pending, dev_cache


def fused_track_pull(pending, dev_cache):
    """Wait for a fused_track_dispatch (one synchronisation) and build the
    host result.  Returns (pulled front-end arrays (valid, xs, ys, octave,
    angle, desc, u_right, depth, response), dev_cache, FusedTrackResult)."""
    with record_function("slice.pull"):
        h = finish_pull(pending)
    fz = FusedTrackResult(
        m=h[8], n_match=int(h[9]), R1=h[10], t1=h[11], inl1=h[12],
        n_map1=int(h[13]), ok=h[14], sel=h[15], R2=h[16], t2=h[17],
        inl2=h[18], n_map2=int(h[19]))
    return tuple(h[:8]) + (h[20],), dev_cache, fz


def fused_track(fe, cam, imgs, mode, pred_Tcw, last_state, cand, th_mm, th_lm,
                scale_factors, inv_level_sigma2, cam_params, forward,
                backward):
    """fused_track_dispatch followed by fused_track_pull: the whole step
    with one copy and one synchronisation."""
    return fused_track_pull(*fused_track_dispatch(
        fe, cam, imgs, mode, pred_Tcw, last_state, cand, th_mm, th_lm,
        scale_factors, inv_level_sigma2, cam_params, forward, backward))
