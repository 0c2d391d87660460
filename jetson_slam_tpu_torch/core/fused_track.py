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

``fused_track_device`` is the step itself, eager PyTorch on device tensors
only: the images, the pose, the previous frame's per-slot state, the
speculated local-map candidates (padded to a power-of-two bucket, see
``core/tracking.py``), the thresholds, the camera's intrinsics, bounds and
lens as 0-dim tensors and the motion flags as 0-dim bool tensors.  Only
``mode``, ``n_levels``, ``undistort`` and the shapes are Python values,
as in the JAX package's ``_fused_track_jit``.

``FusedStep`` is what the tracker runs.  It stages each frame's inputs into
a static block of device memory per candidate bucket (one pinned host block
and one copy, then the device-resident inputs copied on the card) and, on
the card, runs the step as one replay of a CUDA graph captured once for
that bucket: JAX compiles one program per bucket, PyTorch captures one
graph.  ``prewarm_fused`` captures the buckets ahead of use; a bucket
outside them is captured when a frame first needs it.  On the CPU, which
only the tests ask for, the same staging runs and the step is called on
the staged block without a capture.  A capture or replay that fails
raises; nothing drops to the eager step.

The results are copied to pinned host memory behind the step, with an
event, and ``fused_track_pull`` waits once on that event, so the tracker
can keep frames in flight between the two (``pipeline_depth``).

The step stamps the time at its entry and after each of its three stages
(``STAGES``) into a small int64 buffer of its own (``ops/cuda_stamp.py``:
the card's timer, written on every replay; the host clock on the CPU).
The stamps travel with the results, so each frame's are its own even with
frames in flight; the tracker records the three stage times of each frame
(``FusedTrackResult.stamps``).
"""
from __future__ import annotations

import dataclasses
import gc
import threading
import time
import warnings

import numpy as np
import torch

from ..ops import cuda_build
from ..ops.cuda_stamp import stamp
from ..utils.profiling import RECORDER, span
from .frame import finish_pull, rgbd_right, start_pull
from .matcher import local_map_track, motion_model_track

# the step's float scalars after the pose (Rcw row-major, then tcw)
SCALARS = ("th_mm", "th_lm", "fx", "fy", "cx", "cy", "bf", "mb", "min_x",
           "max_x", "min_y", "max_y", "log_scale", "k1", "k2", "p1", "p2", "k3")
_POSE = 12
# per-slot state of the previous frame and the local-map candidates:
# (dtype, trailing shape)
LAST_FIELDS = {"pw": (torch.float32, (3,)), "has_pt": (torch.bool, ()),
               "real": (torch.bool, ()), "pid": (torch.int32, ()),
               "octave": (torch.int32, ()), "angle": (torch.float32, ()),
               "desc": (torch.uint8, (32,))}
CAND_FIELDS = {"pos": (torch.float32, (3,)), "normal": (torch.float32, (3,)),
               "maxd": (torch.float32, ()), "mind": (torch.float32, ()),
               "desc": (torch.uint8, (32,)), "alive": (torch.bool, ()),
               "pid": (torch.int32, ())}
MIN_BUCKET = 128
# the stages between the step's stamps, in order: the stamp at entry, then
# one after each
STAGES = ("stage.frontend", "stage.motion_model", "stage.local_map")
# CUDA admits one graph capture at a time in a process (torch.cuda.graph)
_CAPTURE_LOCK = threading.Lock()


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
    # the step's stamps (ns): at entry and after each of STAGES
    stamps: np.ndarray | None = None


def undistort_device(xy, fx, fy, cx, cy, k1, k2, p1, p2, k3, iters=5):
    """Fixed-iteration undistortion on device (the scheme of
    ``frame.undistort_points``).  The coefficients are floats or 0-dim
    tensors."""
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


def fused_track_device(fe, imgs, mode, Rcw, tcw, last_state, cand, th_mm,
                       th_lm, scale_factors, inv_level_sigma2, cam_params,
                       lens, forward, backward, undistort: bool, stamps=None):
    """The whole tracking step on the front-end's device; synchronises
    with nothing, uploads nothing.

    imgs: (left, right) uint8 images for mode "stereo", (grey uint8, depth
    float32 in metres) for "rgbd", (grey,) for "mono".  Rcw (3, 3), tcw
    (3,): the predicted pose.  last_state: dict of tensors pw (S, 3),
    has_pt, real, pid, octave, angle, desc.  cand: dict of tensors pos,
    normal, maxd, mind, desc, alive, pid (padded to a power of two).
    th_mm, th_lm: the two search radii; scale_factors, inv_level_sigma2:
    (L,) tensors.  cam_params: (fx, fy, cx, cy, bf, mb, min_x, max_x,
    min_y, max_y, log_scale, n_levels), floats or 0-dim float32 tensors
    but n_levels, an int.  lens: (k1, k2, p1, p2, k3), read only when
    ``undistort``.  forward, backward: 0-dim bool tensors (or bools).
    stamps: None, or an int64 (4,) tensor on the device that takes the
    time at entry and after each of ``STAGES``.
    Returns a tuple of device tensors."""
    fx, fy, cx, cy, bf, mb = cam_params[:6]
    n_levels = cam_params[11]
    _stamp(stamps, 0)
    if mode == "stereo":
        cur, _right, u_r, depth, _dist = fe.frame_step(imgs[0], imgs[1], bf, mb)
    else:
        cur = fe.extract(imgs[0])
    cur_xy = torch.stack([cur.xs, cur.ys], 1)
    if undistort:
        cur_xy = undistort_device(cur_xy, fx, fy, cx, cy, *lens)
    if mode == "rgbd":
        u_r, depth = rgbd_right(imgs[1], cur.xs, cur.ys, cur_xy[:, 0],
                                cur.valid, bf)
    elif mode == "mono":    # no depth
        u_r = torch.full_like(cur.xs, -1.0)
        depth = torch.full_like(cur.xs, -1.0)
    ls = last_state
    _stamp(stamps, 1)

    # ---- motion-model stage (TrackWithMotionModel semantics)
    m, n_match, R1, t1, inl1, n_map1 = motion_model_track(
        Rcw, tcw, ls["pw"], ls["has_pt"], ls["real"], ls["octave"],
        ls["angle"], ls["desc"], cur_xy, cur.octave, cur.angle, cur.desc,
        cur.valid, u_r, th_mm, scale_factors, inv_level_sigma2, n_levels,
        fx, fy, cx, cy, bf, *cam_params[6:10], forward, backward)
    _stamp(stamps, 2)
    ok, sel, R2, t2, inl2, n_map2 = _local_map_stage(
        cur, cur_xy, u_r, m, R1, t1, ls, cand, th_lm, scale_factors,
        inv_level_sigma2, cam_params)
    _stamp(stamps, 3)
    return (cur, u_r, depth, m, n_match, R1, t1, inl1, n_map1,
            ok, sel, R2, t2, inl2, n_map2)


def _stamp(stamps, i: int):
    if stamps is not None:
        stamp(stamps, i)


def new_stamps(device) -> torch.Tensor:
    """The buffer of one step's stamps: at entry and after each stage."""
    return torch.zeros(len(STAGES) + 1, dtype=torch.int64, device=device)


def record_stages(stamps) -> None:
    """Record the device time of each of ``STAGES`` from one frame's
    pulled stamps (``profiling.RECORDER.device``)."""
    for name, a, b in zip(STAGES, stamps[:-1], stamps[1:]):
        RECORDER.device(name, int(b) - int(a))


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


def _start_pull(outs, stamps=None):
    """Queue the copies of a step's outputs (and of its stamps, when it
    took them) to pinned host memory, and copies on the card of the
    front-end tensors the next frame reads (``dev_cache``): a graph's
    outputs are rewritten by its next replay."""
    (cur, u_r, depth, m, n_match, R1, t1, inl1, n_map1,
     ok, sel, R2, t2, inl2, n_map2) = outs
    pending = start_pull((cur.valid, cur.xs, cur.ys, cur.octave, cur.angle,
                          cur.desc, u_r, depth, m, n_match, R1, t1, inl1,
                          n_map1, ok, sel, R2, t2, inl2, n_map2, cur.response)
                         + (() if stamps is None else (stamps,)))
    dev_cache = {"valid": cur.valid.clone(), "desc": cur.desc.clone(),
                 "octave": cur.octave.clone(), "angle": cur.angle.clone(),
                 "u_right": u_r.clone()}
    return pending, dev_cache


def _layout(fe, mode: str, C: int):
    """Byte offsets of a bucket's inputs in its block: {name: (dtype,
    shape, offset, nbytes)} and the block's size.  Each field starts on a
    256-byte boundary."""
    S = fe.n_slots_padded
    H, W = fe._h0w0
    fields = [("img0", torch.uint8, (H, W))]
    if mode != "mono":     # the right eye, or the depth image in metres
        fields.append(("img1", torch.uint8 if mode == "stereo" else torch.float32,
                       (H, W)))
    fields += [("scal", torch.float32, (_POSE + len(SCALARS),)),
               ("flags", torch.bool, (2,))]
    fields += [("last." + k, dt, (S, *tail)) for k, (dt, tail) in LAST_FIELDS.items()]
    fields += [("cand." + k, dt, (C, *tail)) for k, (dt, tail) in CAND_FIELDS.items()]
    out, off = {}, 0
    for name, dt, shape in fields:
        n = int(np.prod(shape)) * dt.itemsize
        out[name] = (dt, shape, off, n)
        off += -(-n // 256) * 256
    return out, off


def _views(block, layout):
    return {name: block[off:off + n].view(dt).view(shape)
            for name, (dt, shape, off, n) in layout.items()}


@dataclasses.dataclass
class _Bucket:
    """One candidate bucket: its input block, its stamps and, on the card,
    its graph, the graph's outputs and the kernels one replay launches."""
    layout: dict
    block: torch.Tensor
    views: dict
    stamps: torch.Tensor
    graph: object = None
    outputs: tuple | None = None
    launches: dict = dataclasses.field(default_factory=dict)


class FusedStep:
    """The fused step of one tracker: one input block per candidate bucket
    and, on the card, one CUDA graph of ``fused_track_device`` per bucket,
    captured once and replayed every frame.

    fe: the OrbFrontend; cam: the CameraConfig, whose lens is read at every
    dispatch (a lens that switches undistortion on or off drops the
    graphs); mode: "stereo" | "rgbd" | "mono"; scale_factors,
    inv_level_sigma2: (L,) tensors on fe's device.

    ``graphs_captured`` counts the buckets set up (on the CPU, without a
    graph); ``capture_ms[C]``, ``pool_bytes[C]`` (the growth of the
    buckets' one graph pool in that capture) and ``launches_per_replay[C]``
    ({kernel: launches}) describe each; ``replays`` counts the replays."""

    def __init__(self, fe, cam, mode: str, scale_factors, inv_level_sigma2):
        if mode not in ("stereo", "rgbd", "mono"):
            raise ValueError(f"unknown mode {mode!r}")
        self.fe, self.cam, self.mode = fe, cam, mode
        self.device = fe.device
        self.n_levels = fe.geom.n_levels
        self._sf, self._inv_s2 = scale_factors, inv_level_sigma2
        self._buckets: dict = {}
        self._undistort = None
        self._lock = threading.Lock()     # bucket set-up and capture
        self._stream = self._pool = None
        self._error = None
        self.prewarmed: set = set()
        self.graphs_captured = 0
        self.capture_ms: dict = {}
        self.pool_bytes: dict = {}
        self.launches_per_replay: dict = {}
        self.replays = 0

    # ------------------------------------------------------------- staging
    def _lens(self):
        c = self.cam
        return (c.k1, c.k2, c.p1, c.p2, c.k3)

    def _host_values(self, imgs, pred_Tcw, last_state, cand, th_mm, th_lm,
                     cam_params, forward, backward):
        """{field: value} of one frame; values are numpy arrays or tensors."""
        if int(cam_params[11]) != self.n_levels:
            raise ValueError(f"cam_params n_levels {cam_params[11]} differs from "
                             f"the front-end's {self.n_levels}")
        pred = np.asarray(pred_Tcw)
        scal = np.concatenate([pred[:3, :3].ravel(), pred[:3, 3],
                               [th_mm, th_lm], np.asarray(cam_params[:11], np.float64),
                               self._lens()]).astype(np.float32)
        vals = {f"img{i}": im for i, im in enumerate(imgs)}
        vals.update(scal=scal, flags=np.array([bool(forward), bool(backward)]))
        vals.update({"last." + k: last_state[k] for k in LAST_FIELDS})
        vals.update({"cand." + k: cand[k] for k in CAND_FIELDS})
        return vals

    def _stage(self, layout, block, views, vals):
        """Copy one frame's inputs into a block: every host value through
        one pinned block and one copy, then the values already on the card
        copied there.  The pinned block goes back to PyTorch's caching host
        allocator, which reuses it only after the event its copy recorded,
        so a frame in flight keeps its staging."""
        nbytes = block.shape[0]
        host = torch.empty(nbytes, dtype=torch.uint8,
                           pin_memory=self.device.type == "cuda")
        hv = _views(host, layout)
        on_card = []
        for name, v in vals.items():
            if isinstance(v, torch.Tensor) and v.device.type != "cpu":
                on_card.append((name, v))
            else:
                hv[name].copy_(torch.as_tensor(v))
        block.copy_(host, non_blocking=True)
        for name, v in on_card:
            views[name].copy_(v, non_blocking=True)

    def _new_bucket(self, C: int) -> _Bucket:
        layout, nbytes = _layout(self.fe, self.mode, C)
        block = torch.zeros(nbytes, dtype=torch.uint8, device=self.device)
        return _Bucket(layout, block, _views(block, layout), new_stamps(self.device))

    def _call(self, v, stamps=None):
        """fused_track_device on the tensors of a staged block, stamping
        into ``stamps``."""
        s = v["scal"]
        sc = {k: s[_POSE + i] for i, k in enumerate(SCALARS)}
        cam_params = tuple(sc[k] for k in SCALARS[2:13]) + (self.n_levels,)
        lens = tuple(sc[k] for k in SCALARS[13:])
        imgs = (v["img0"],) if self.mode == "mono" else (v["img0"], v["img1"])
        last = {k: v["last." + k] for k in LAST_FIELDS}
        cand = {k: v["cand." + k] for k in CAND_FIELDS}
        return fused_track_device(
            self.fe, imgs, self.mode, s[:9].view(3, 3), s[9:12], last, cand,
            sc["th_mm"], sc["th_lm"], self._sf, self._inv_s2, cam_params, lens,
            v["flags"][0], v["flags"][1], self._undistort, stamps)

    # ------------------------------------------------------------- capture
    def _set_lens(self):
        """Drop every bucket when the lens switches undistortion on or off
        (a static of the captured step)."""
        undistort = any(k != 0 for k in self._lens())
        if undistort != self._undistort:
            with self._lock:
                if undistort != self._undistort:
                    self._buckets.clear()
                    self._undistort = undistort

    def _bucket(self, C: int) -> _Bucket:
        """The bucket of C candidates, set up (and on the card captured,
        on the zeros of its new block) at first use.  The lock covers set-up
        and capture only: frames of buckets already captured replay while
        another thread (a background prewarm) captures."""
        b = self._buckets.get(C)
        if b is None:
            with self._lock:
                b = self._buckets.get(C)
                if b is None:
                    b = self._set_up(C)
        return b

    def _set_up(self, C: int) -> _Bucket:
        t0 = time.perf_counter()
        b = self._new_bucket(C)
        if self.device.type == "cuda":
            self._capture(b, C)
        self._buckets[C] = b
        self.graphs_captured += 1
        self.capture_ms[C] = (time.perf_counter() - t0) * 1e3
        if self.prewarmed and C not in self.prewarmed:
            warnings.warn(f"fused step: candidate bucket {C} set up at its first "
                          f"use, outside the prewarmed {sorted(self.prewarmed)}",
                          stacklevel=4)
        return b

    def _capture(self, b: _Bucket, C: int):
        """Warm the step up on a side stream (kernel builds, the FAST
        table's bitset, library handles), then capture it there.  Other
        threads may use the card meanwhile (mapping, the async GBA, the
        tracker replaying): ``thread_local`` forbids unsafe calls on this
        thread only.  The buckets' graphs share one memory pool: every
        replay's outputs are copied out (``_start_pull``) on the tracker's
        stream before the next replay of any bucket, so a graph may reuse
        what another's intermediates occupy.  ``pool_bytes[C]`` is the
        pool's growth in this capture."""
        dev = self.device
        if self._stream is None:
            self._stream = torch.cuda.Stream(dev)
            self._pool = torch.cuda.graph_pool_handle()
        with _CAPTURE_LOCK:
            self._stream.wait_stream(torch.cuda.current_stream(dev))
            with torch.cuda.stream(self._stream):
                self._call(b.views, b.stamps)
            # a graph freed on this thread during the capture (a finished
            # session's, left in a reference cycle) invalidates it: collect
            # now, and keep the collector off until the capture ends
            gc.collect()
            torch.cuda.synchronize(dev)
            torch.cuda.empty_cache()
            reserved = torch.cuda.memory_reserved(dev)
            g = torch.cuda.CUDAGraph()
            collecting = gc.isenabled()
            gc.disable()
            try:
                with cuda_build.tally_captures() as tally, \
                        torch.cuda.graph(g, pool=self._pool, stream=self._stream,
                                         capture_error_mode="thread_local"):
                    outs = self._call(b.views, b.stamps)
            finally:
                if collecting:
                    gc.enable()
            torch.cuda.synchronize(dev)
            self.pool_bytes[C] = torch.cuda.memory_reserved(dev) - reserved
        b.graph, b.outputs, b.launches = g, outs, tally
        self.launches_per_replay[C] = {k.__name__: n for k, n in tally.items()}

    def prewarm(self, caps):
        """Set up (on the card: capture) the bucket of each cap.  Raises
        ValueError for a cap that is not a power of two >= 128."""
        caps = [int(c) for c in caps]
        for C in caps:
            if C < MIN_BUCKET or C & (C - 1):
                raise ValueError(f"prewarm cap {C} is not a power of two >= {MIN_BUCKET}")
        self.prewarmed.update(caps)
        self._set_lens()
        for C in caps:
            self._bucket(C)

    def fail(self, exc: BaseException):
        """Keep a background prewarm's exception for the next ``check``."""
        self._error = exc

    def check(self):
        """Raise the exception a background prewarm left, once."""
        exc, self._error = self._error, None
        if exc is not None:
            raise RuntimeError("the background prewarm of the fused step failed") from exc

    # ------------------------------------------------------------ dispatch
    def dispatch(self, imgs, pred_Tcw, last_state, cand, th_mm, th_lm,
                 cam_params, forward, backward, eager: bool = False):
        """Queue one frame's step and the copies of its outputs; waits for
        nothing on the card.  imgs, last_state, cand as
        ``fused_track_device`` takes them, as numpy arrays or tensors;
        pred_Tcw: 4x4 predicted pose; cam_params: the 12-tuple of Python
        numbers (``Tracker._cam_params``); forward, backward: bools.  On
        the card the bucket's graph replays; ``eager=True`` stages into a
        block of its own and calls the step eagerly (the reference the
        graphs are held against).  Returns (pending, dev_cache) for
        ``fused_track_pull``."""
        vals = self._host_values(imgs, pred_Tcw, last_state, cand, th_mm,
                                 th_lm, cam_params, forward, backward)
        C = int(cand["pos"].shape[0])
        self._set_lens()
        if eager:
            layout, nbytes = _layout(self.fe, self.mode, C)
            block = torch.empty(nbytes, dtype=torch.uint8, device=self.device)
            views = _views(block, layout)
            with span("slice.stage"):
                self._stage(layout, block, views, vals)
            stamps = new_stamps(self.device)
            return _start_pull(self._call(views, stamps), stamps)
        b = self._bucket(C)
        with span("slice.stage"):
            self._stage(b.layout, b.block, b.views, vals)
        if b.graph is None:
            outs = self._call(b.views, b.stamps)
        else:
            with span("slice.replay"):
                b.graph.replay()
            self.replays += 1
            for k, n in b.launches.items():
                k.launches += n
            outs = b.outputs
        return _start_pull(outs, b.stamps)


def prewarm_fused(step: FusedStep, caps=(128, 256, 512, 1024, 2048)):
    """Capture the fused step of every candidate bucket in ``caps`` before
    the map grows into it, as the JAX package compiles one program per
    bucket (``step`` carries the front-end, camera, mode and tables that
    JAX's call takes).  A bucket outside caps is captured at its first use,
    counted in ``step.graphs_captured``, timed in ``step.capture_ms`` and
    warned about.  Raises on any failure."""
    step.prewarm(caps)


def fused_track_dispatch(fe, cam, imgs, mode, pred_Tcw, last_state, cand,
                         th_mm, th_lm, scale_factors, inv_level_sigma2,
                         cam_params, forward, backward):
    """The eager step with its inputs staged as ``FusedStep`` stages them,
    and the copies of its outputs; waits for nothing on the card.
    cam_params: (fx, fy, cx, cy, bf, mb, min_x, max_x, min_y, max_y,
    log_scale, n_levels); the lens is cam's.  Returns (pending, dev_cache)
    for fused_track_pull."""
    step = FusedStep(fe, cam, mode, scale_factors, inv_level_sigma2)
    return step.dispatch(imgs, pred_Tcw, last_state, cand, th_mm, th_lm,
                         cam_params, forward, backward, eager=True)


def fused_track_pull(pending, dev_cache):
    """Wait for a dispatch (one synchronisation) and build the host result.
    Returns (pulled front-end arrays (valid, xs, ys, octave, angle, desc,
    u_right, depth, response), dev_cache, FusedTrackResult)."""
    with span("slice.pull", cpu=True):
        h = finish_pull(pending)
    fz = FusedTrackResult(
        m=h[8], n_match=int(h[9]), R1=h[10], t1=h[11], inl1=h[12],
        n_map1=int(h[13]), ok=h[14], sel=h[15], R2=h[16], t2=h[17],
        inl2=h[18], n_map2=int(h[19]), stamps=h[21] if len(h) > 21 else None)
    return tuple(h[:8]) + (h[20],), dev_cache, fz


def fused_track(fe, cam, imgs, mode, pred_Tcw, last_state, cand, th_mm, th_lm,
                scale_factors, inv_level_sigma2, cam_params, forward,
                backward):
    """fused_track_dispatch followed by fused_track_pull: the whole step
    with one copy and one synchronisation."""
    return fused_track_pull(*fused_track_dispatch(
        fe, cam, imgs, mode, pred_Tcw, last_state, cand, th_mm, th_lm,
        scale_factors, inv_level_sigma2, cam_params, forward, backward))
