"""Frame: per-image container tying the front-end to the tracker.

Port of ``jetson_slam_tpu/core/frame.py``: ORB on both eyes plus stereo
matching in one ``OrbFrontend.frame_step`` (stereo), or ORB on the one
image (RGB-D and mono), then ONE pull of every per-slot array to the host
(``pull``), keypoint undistortion (Frame.cpp:718-748), the RGB-D virtual
right coordinate (Frame.cpp:996-1017) and the dense slot arrays the
tracker keeps.
``Frame.dev`` returns the immutable per-frame arrays as tensors on the
front-end's device, uploaded at most once.
"""
from __future__ import annotations

import numpy as np
import torch

from ..utils.lie import project_so3_np


def start_pull(tensors):
    """Queue copies of tensors to host memory without waiting: every device
    tensor goes to pinned memory with a non-blocking copy on the current
    stream, and an event is recorded behind them.  None entries stay None.
    Returns the handle that ``finish_pull`` completes."""
    host = []
    dev = None
    for t in tensors:
        if t is None:
            host.append(None)
        elif t.device.type == "cuda":
            h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            h.copy_(t, non_blocking=True)
            host.append(h)
            dev = t.device
        else:
            host.append(t.detach().clone())
    event = None
    if dev is not None:
        event = torch.cuda.Event()
        event.record(torch.cuda.current_stream(dev))
    return host, event


def finish_pull(handle):
    """Wait for the copies of ``start_pull`` (one synchronisation, on its
    event) and return the host numpy arrays."""
    host, event = handle
    if event is not None:
        event.synchronize()
    return [None if h is None else h.numpy() for h in host]


def pull(tensors):
    """Copy tensors to host numpy arrays with one synchronisation, which
    waits on the current stream's work alone."""
    return finish_pull(start_pull(tensors))


def undistort_points(xy, fx, fy, cx, cy, k1, k2, p1, p2, k3=0.0, iters=5):
    """Iterative undistortion (cv::undistortPoints semantics); a copy when
    every coefficient is zero (pre-rectified stereo, Frame.cpp:718-721)."""
    if k1 == 0 and k2 == 0 and p1 == 0 and p2 == 0 and k3 == 0:
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
    return np.stack([x * fx + cx, y * fy + cy], axis=1)


def rgbd_right(depth_img, xs, ys, x_undist, valid, bf):
    """Depth and virtual right coordinate of each slot (Frame.cpp:996-1017):
    the depth image sampled at the RAW keypoint (coordinates truncated and
    clipped), the right coordinate from the UNDISTORTED x, x - bf / z; both
    -1 where z <= 0 or the slot is empty."""
    H0, W0 = depth_img.shape
    xi = xs.to(torch.int64).clamp(0, W0 - 1)
    yi = ys.to(torch.int64).clamp(0, H0 - 1)
    z = depth_img.reshape(-1)[yi * W0 + xi]
    pos = (z > 0) & valid
    none = torch.full_like(z, -1.0)
    depth = torch.where(pos, z, none)
    # reciprocal times bf: a float bf rounds as a 0-dim tensor bf does
    u_r = torch.where(pos, x_undist - torch.clamp(z, min=1e-6).reciprocal() * bf,
                      none)
    return u_r, depth


class Frame:
    # a class counter, as in the reference package: the fused step's
    # preconditions read it, and trackers in one process share it
    _next_id = 0

    def __init__(self, frontend, cam, timestamp, left_img, right_img=None,
                 depth_img=None):
        """frontend: OrbFrontend (shared); cam: CameraConfig; depth_img
        (RGB-D): depth in metres, <= 0 where unknown."""
        if right_img is not None:
            left, _right, u_r, dep, _ = frontend.frame_step(
                left_img, right_img, cam.bf, cam.bf / cam.fx)
        else:
            left = frontend.extract(left_img)
            u_r = dep = None
        (valid, xs, ys, octave, angle, desc, u_r_h, dep_h, response) = pull(
            (left.valid, left.xs, left.ys, left.octave, left.angle,
             left.desc, u_r, dep, left.response))
        cache = {"valid": left.valid, "desc": left.desc,
                 "octave": left.octave, "angle": left.angle}
        if u_r is None:
            u_r_h = np.full(frontend.n_slots_padded, -1.0, np.float32)
            dep_h = u_r_h.copy()
        else:
            cache["u_right"] = u_r
        self._init(frontend, cam, timestamp, valid, xs, ys, octave, angle,
                   desc, u_r_h, dep_h, cache, response)
        if right_img is None and depth_img is not None:
            # RGB-D: the depth at the RAW keypoint, the virtual right
            # coordinate from the UNDISTORTED x (ComputeStereoFromRGBD)
            t = torch.as_tensor
            u_r, dep = rgbd_right(t(np.asarray(depth_img, np.float32)), t(xs), t(ys),
                                  t(self.kp_xy[:, 0]), t(valid), cam.bf)
            self.u_right, self.depth = u_r.numpy(), dep.numpy()

    @classmethod
    def from_arrays(cls, frontend, cam, timestamp, valid, xs, ys, octave,
                    angle, desc, u_right, depth, dev_cache=None, response=None):
        """A Frame from already-pulled front-end arrays (the fused tracking
        step runs the front-end itself).  ``response``: the keypoints' FAST
        scores, zeros where not given."""
        self = cls.__new__(cls)
        self._init(frontend, cam, timestamp, valid, xs, ys, octave, angle,
                   desc, u_right, depth, dev_cache or {}, response)
        return self

    def _init(self, frontend, cam, timestamp, valid, xs, ys, octave, angle,
              desc, u_right, depth, dev_cache, response):
        self.timestamp = float(timestamp)
        self.frame_id = Frame._next_id
        Frame._next_id += 1
        self.cam = cam
        self.device = frontend.device
        self.n_slots = frontend.n_slots_padded
        self.valid = valid
        self.octave = octave
        self.angle = angle
        self.desc = desc
        self.response = (np.zeros(len(valid), np.int32) if response is None
                         else np.asarray(response))
        self.u_right = u_right
        self.depth = depth
        self._dev = dict(dev_cache)
        # the raw keypoints (the viewers draw them on the raw image) and
        # their undistorted coordinates, which the tracker uses
        self.kp_xy_raw = np.stack([xs, ys], axis=1)
        self.kp_xy = undistort_points(
            self.kp_xy_raw, cam.fx, cam.fy, cam.cx, cam.cy,
            cam.k1, cam.k2, cam.p1, cam.p2, cam.k3).astype(np.float32)
        self.Tcw = np.eye(4, dtype=np.float32)   # world -> camera
        self.pose_set = False
        # per-slot associated map point id (-1 = none) and outlier flag
        self.map_points = np.full(self.n_slots, -1, np.int32)
        self.outlier = np.zeros(self.n_slots, bool)
        self.ref_kf = -1

    def dev(self, name: str):
        """Device copy of an immutable per-frame array (kp_xy, octave,
        angle, desc, valid, u_right), uploaded once."""
        a = self._dev.get(name)
        if a is None:
            a = torch.as_tensor(getattr(self, name), device=self.device)
            self._dev[name] = a
        return a

    def set_pose(self, Tcw):
        T = np.asarray(Tcw, np.float32).copy()
        # keep R on SO(3): float32 update chains accumulate skew
        T[:3, :3] = project_so3_np(T[:3, :3])
        self.Tcw = T
        self.pose_set = True

    @property
    def Rcw(self):
        return self.Tcw[:3, :3]

    @property
    def tcw(self):
        return self.Tcw[:3, 3]

    @property
    def camera_center(self):
        return -self.Rcw.T @ self.tcw

    @property
    def Twc(self):
        T = np.eye(4, dtype=np.float32)
        T[:3, :3] = self.Rcw.T
        T[:3, 3] = self.camera_center
        return T

    def unproject_stereo(self, slot):
        """Frame::UnprojectStereo of one slot: its world point (3,), or None
        where the slot has no depth."""
        if self.depth[slot] <= 0:
            return None
        return self.unproject_stereo_batch(np.array([slot]))[0]

    def unproject_stereo_batch(self, slots):
        """Frame::UnprojectStereo for many slots: (n, 3) world points."""
        z = self.depth[slots]
        u = self.kp_xy[slots, 0]
        v = self.kp_xy[slots, 1]
        x = (u - self.cam.cx) * z / self.cam.fx
        y = (v - self.cam.cy) * z / self.cam.fy
        pc = np.stack([x, y, z], axis=1)
        return (self.Rcw.T @ (pc - self.tcw).T).T
