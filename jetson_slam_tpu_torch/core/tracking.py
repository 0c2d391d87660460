"""Tracking: the state machine of the port, for stereo, RGB-D and mono.

Port of ``jetson_slam_tpu/core/tracking.py`` (spec src/Tracking.cpp):
NO_IMAGES_YET / NOT_INITIALIZED / OK / LOST, stereo and RGB-D
initialization (:663-722), monocular initialization with the two-view
initializer (:724-917), motion-model tracking (:1030-1115), the
reference-keyframe fallback (:919-961), local-map tracking (:1117-1177),
the keyframe decision (:1180-1264) and creation (:1266-1344), and the fused
whole-frame step (``core/fused_track.py``) for steady-state frames
(``Tracker(fused=False)``, or ``tracker.fused = False`` between frames,
takes the staged path on every frame).  The
heavy math runs on the front-end's device (``core/matcher.py``,
``core/optimizer.py``); graph bookkeeping stays on the host, in numpy, on
the MapStore.  The fused step runs through the tracker's ``FusedStep``:
on the card one replay of a CUDA graph per frame, captured once per
candidate bucket at first use or ahead of it (``Tracker.prewarm``).

With a local mapper (``core/local_mapping.py``, or the async worker of
``core/pipeline.py`` behind the same protocol) every new keyframe is handed
to it, and the keyframe decision asks it whether it accepts one.  The map
lock (Map::mMutexMapUpdate) is held for the map part of each frame; the
device work of the fused step runs outside it.  With ``pipeline_depth`` > 0
up to that many fused steps stay in flight and are finished oldest first.

Relocalization (Tracking.cpp:1954-2115) takes its candidates from the BoW
keyframe database when there is one and fills up to eight by rotating a
window over every keyframe, then runs every candidate through one batched
call, ``_batched_reloc``: brute-force matching, PnP RANSAC on minimal
samples drawn from a generator seeded with the frame id, pose LM, and two
projection searches each followed by LM.
"""
from __future__ import annotations

import contextlib
import enum
import threading

import numpy as np
import torch

from ..utils.profiling import count, span
from . import matcher
from .frame import Frame, pull
from .fused_track import FusedStep, fused_track_pull, prewarm_fused, record_stages
from .initializer import MonoInitializer
from .map import MapStore
from .optimizer import pose_optimization
from .pnp_solver import draw_samples, pnp_ransac


class TrackingState(enum.Enum):
    NO_IMAGES_YET = 0
    NOT_INITIALIZED = 1
    OK = 2
    LOST = 3


def check_tracker_options(fused, min_frames, max_frames):
    """Raise TypeError, naming the option, for a ``fused`` that is not a
    bool or keyframe spacing bounds that are not integers (``max_frames``
    may be None: the camera's fps)."""
    if not isinstance(fused, (bool, np.bool_)):
        raise TypeError(f"fused must be a bool, not {type(fused).__name__}")
    for name, v in (("min_frames", min_frames), ("max_frames", max_frames)):
        if v is None and name == "max_frames":
            continue
        if isinstance(v, bool) or not isinstance(v, (int, np.integer)):
            raise TypeError(f"{name} must be an int, not {type(v).__name__}")


class Tracker:
    def __init__(self, frontend, cam, map_store: MapStore, sensor="stereo",
                 local_mapper=None, map_lock=None, pipeline_depth: int = 0,
                 database=None, fused: bool = True, min_frames: int = 0,
                 max_frames=None, fused_step=None):
        """fused_step: the FusedStep (its captured graphs) to run the fused
        step through, shared with an earlier tracker on the same front end,
        camera and sensor; by default a new one."""
        check_tracker_options(fused, min_frames, max_frames)
        self.frontend = frontend
        self.cam = cam
        self.map = map_store
        self.sensor = sensor
        # monocular initialization's reference frame (mInitialFrame)
        self._mono_init_ref = None
        self.device = frontend.device
        self.local_mapper = local_mapper
        self.database = database  # BoW KeyFrameDatabase for relocalization
        # no-vocabulary relocalization: the candidate window's offset, so
        # successive LOST frames sweep every keyframe (reset on success)
        self._reloc_rr = 0
        # Map::mMutexMapUpdate of the async pipeline (Tracking.cpp:385 holds
        # it for the whole Track()); None -> no lock.  A TracedLock records
        # this thread's waits for it as slice.map_lock_wait
        if map_lock is None:
            map_lock = contextlib.nullcontext()
        elif hasattr(map_lock, "waiting_as"):
            map_lock = map_lock.waiting_as("slice.map_lock_wait")
        self._map_lock = map_lock
        # localization only: no keyframes, so the map never changes
        # (System::ActivateLocalizationMode)
        self.only_tracking = False
        # the fused whole-frame step for steady-state frames; False takes
        # the reference's staged path on every frame (motion model or
        # reference keyframe, then the local map), with no speculated
        # candidates.  Read on every frame, so it may be switched between
        # frames
        self.fused = fused
        # fused steps kept in flight, finished oldest first; a step in flight
        # is dispatched against the newest FINISHED frame, so the velocity is
        # applied once per frame between them and the motion-model window
        # widens with it.  0 = one frame at a time, the reference's
        # semantics; no effect when fused is False
        self.pipeline_depth = int(pipeline_depth)
        self._inflight = []
        self.state = TrackingState.NO_IMAGES_YET
        self.velocity = None          # 4x4 Tcl (current-from-last motion)
        self.last_frame: Frame | None = None
        self.ref_kf = -1
        self.last_kf_frame_id = -1
        self.last_reloc_frame_id = -1000000
        # keyframe spacing bounds (mMinFrames, mMaxFrames); the reference
        # sets 0 and fps
        self.min_frames = int(min_frames)
        self.max_frames = int(max_frames if max_frames is not None else cam.fps)
        self.th_depth = cam.th_depth * cam.bf / cam.fx  # ThDepth * baseline
        g = frontend.geom
        self.scale_factors = np.asarray(g.scales, np.float32)
        self.log_scale = float(np.log(g.scale_factor))
        self.n_levels = g.n_levels
        self.inv_level_sigma2 = (1.0 / self.scale_factors ** 2).astype(np.float32)
        self._sf_dev = self._t(self.scale_factors)
        self._inv_s2_dev = self._t(self.inv_level_sigma2)
        self.min_x, self.max_x = 0.0, float(g.widths[0])
        self.min_y, self.max_y = 0.0, float(g.heights[0])
        self.trajectory = []  # (ts, Tcw, ref_kf, is_lost, Tcr, ref_kf_gen)
        self.matches_inliers = 0
        # temporary visual-odometry points attached to the last frame
        self._last_temp_world = None
        self._last_temp_flag = None
        self._last_rel_pose = None
        self._spec = None          # speculated local-map candidates (numpy)
        self._spec_pid = None      # the candidate pids
        self._spec_gen = None      # pt_gen snapshot paired with _spec
        self.fused_frames = 0      # frames tracked through the fused step
        self.fused_step = fused_step if fused_step is not None else FusedStep(
            frontend, cam, sensor, self._sf_dev, self._inv_s2_dev)
        map_store.erase_hooks.append(self._on_kf_erased)

    def _t(self, a):
        """A host array as a tensor on the tracker's device."""
        return torch.as_tensor(np.ascontiguousarray(a), device=self.device)

    def _cam_params(self):
        c = self.cam
        return (c.fx, c.fy, c.cx, c.cy, c.bf, c.bf / c.fx, self.min_x,
                self.max_x, self.min_y, self.max_y, self.log_scale,
                self.n_levels)

    def prewarm(self, background=True, caps=(128, 256, 512, 1024, 2048)):
        """Capture the fused step of every candidate bucket in caps before
        the map grows into it (on the CPU: set up its buffers), so no frame
        waits for a capture.  With ``background`` on a daemon thread, which
        is returned; its exception is raised by the next track_* call.  A
        bucket outside caps is captured at its first use and counted
        (``fused_step.graphs_captured``)."""
        step = self.fused_step
        if not background:
            prewarm_fused(step, caps)
            return None

        def run():
            try:
                prewarm_fused(step, caps)
            except Exception as exc:   # the thread's boundary: kept, raised later
                step.fail(exc)

        t = threading.Thread(target=run, daemon=True, name="fused-prewarm")
        t.start()
        return t

    def _on_kf_erased(self, kid: int):
        if kid == self.ref_kf:
            parent = int(self.map.kf_parent[kid])
            self.ref_kf = parent if parent >= 0 and \
                self.map.kf_alive[parent] else -1

    # ================================================================ api
    @span("slice.track")
    def track_stereo(self, left, right, timestamp):
        """Track one stereo pair; returns (state, Frame).  With frames in
        flight the Frame is the newest finished one, None while the
        pipeline fills."""
        self._expect("stereo")
        return self._track_images((left, right), timestamp)

    @span("slice.track")
    def track_rgbd(self, rgb, depth, timestamp):
        """Track one grey image with its registered depth image in metres;
        returns (state, Frame) as track_stereo does."""
        self._expect("rgbd")
        return self._track_images((rgb, np.asarray(depth, np.float32)), timestamp)

    @span("slice.track")
    def track_monocular(self, img, timestamp):
        """Track one grey image; returns (state, Frame) as track_stereo
        does."""
        self._expect("mono")
        return self._track_images((img,), timestamp)

    def _expect(self, sensor):
        if sensor != self.sensor:
            raise ValueError(f"a {self.sensor} tracker got {sensor} images")

    def _track_images(self, imgs, timestamp):
        self.fused_step.check()
        if not self.fused:
            # switched off between frames: finish the frames in flight first
            self.flush_pipeline()
        elif self.pipeline_depth > 0:
            out = self._track_pipelined(imgs, timestamp)
            if out is not None:
                return out
        else:
            pending = self._begin_fused(imgs, timestamp)
            if pending is not None:
                frame, fz = self._finish_fused(pending)
                with self._map_lock, span("slice.host_bookkeeping"):
                    return self._track_locked(frame, fz)
        if self.sensor == "stereo":
            frame = Frame(self.frontend, self.cam, timestamp, imgs[0], imgs[1])
        elif self.sensor == "rgbd":
            frame = Frame(self.frontend, self.cam, timestamp, imgs[0],
                          depth_img=imgs[1])
        else:
            frame = Frame(self.frontend, self.cam, timestamp, imgs[0])
        return self._track(frame)

    # ------------------------------------------- pipelined fused tracking
    def _track_pipelined(self, imgs, timestamp):
        """Dispatch the current frame against the newest finished state,
        then finish the oldest frames in flight beyond pipeline_depth.
        Returns (state, frame) of the newest finished frame, (state, None)
        while the pipeline fills, or None to take the classic path for this
        frame (after flushing the pipeline)."""
        pending = self._begin_fused(imgs, timestamp)
        if pending is None:
            self.flush_pipeline()
            return None
        self._inflight.append(pending)
        ret = None
        while len(self._inflight) > self.pipeline_depth:
            ret = self._finish_oldest()
        return ret if ret is not None else (self.state, None)

    def _finish_oldest(self):
        frame, fz = self._finish_fused(self._inflight.pop(0))
        with self._map_lock, span("slice.host_bookkeeping"):
            return self._track_locked(frame, fz)

    def flush_pipeline(self):
        """Finish every fused step in flight, oldest first.  Returns the
        last (state, frame) finished, or None when none was in flight."""
        ret = None
        while self._inflight:
            ret = self._finish_oldest()
        return ret

    # =============================================================== core
    def _track(self, frame: Frame):
        # the frame was built outside the lock; the map part runs inside it
        with self._map_lock:
            return self._track_locked(frame)

    def _track_locked(self, frame: Frame, fused=None):
        if self.local_mapper is not None:
            self.local_mapper.tick()
        if self.state == TrackingState.NO_IMAGES_YET:
            self.state = TrackingState.NOT_INITIALIZED

        if self.state == TrackingState.NOT_INITIALIZED:
            count("init.frames")
            if self.sensor == "mono":
                self._monocular_initialization(frame)
            else:
                self._stereo_initialization(frame)
        else:
            ok = False
            if self.state == TrackingState.OK and fused is not None and \
                    fused.n_match >= 20 and fused.n_map1 >= 10:
                # the fused step succeeded on device: apply both stages
                self._apply_last_matches(frame, fused.m, snapshot=fused.last_snap)
                T = np.eye(4, dtype=np.float32)
                T[:3, :3] = fused.R1
                T[:3, 3] = fused.t1
                frame.set_pose(T)
                frame.outlier = (fused.m >= 0) & ~fused.inl1
                frame.ref_kf = self.ref_kf
                ok = self._consume_fused_local(frame, fused)
            else:
                if self.state == TrackingState.OK:
                    if self.velocity is None or \
                            frame.frame_id < self.last_reloc_frame_id + 2:
                        ok = self._track_reference_keyframe(frame)
                    else:
                        ok = (fused is None and
                              self._track_with_motion_model(frame))
                        if not ok:
                            ok = self._track_reference_keyframe(frame)
                else:
                    ok = self._relocalization(frame)
                    if ok:
                        count("reloc.succeeded")
                frame.ref_kf = self.ref_kf
                if ok:
                    ok = self._track_local_map(frame)
            self.state = TrackingState.OK if ok else TrackingState.LOST
            if not ok:
                count("tracking.lost")

            if ok:
                if self.last_frame is not None and self.last_frame.pose_set:
                    self.velocity = frame.Tcw @ self.last_frame.Twc
                else:
                    self.velocity = None
                # drop outlier associations (Tracking.cpp:608-618)
                out = frame.outlier & (frame.map_points >= 0)
                frame.map_points[out] = -1
                frame.outlier[:] = False
                if self._need_new_keyframe(frame):
                    self._create_new_keyframe(frame)

        # relative pose to the reference KF (mlRelativeFramePoses)
        ref = getattr(frame, "ref_kf", -1)
        if frame.pose_set and ref is not None and ref >= 0:
            self._last_rel_pose = (
                frame.Tcw @ np.linalg.inv(self.map.kf_pose[ref])).astype(np.float32)
        else:
            self._last_rel_pose = None
        if frame.pose_set:
            ref_gen = int(self.map.kf_gen[ref]) if ref is not None and \
                ref >= 0 else -1
            self.trajectory.append(
                (frame.timestamp, frame.Tcw.copy(), frame.ref_kf,
                 self.state == TrackingState.LOST, self._last_rel_pose,
                 ref_gen))
        self.last_frame = frame
        if self.fused and self.state == TrackingState.OK:
            self._speculate_candidates(frame)
        else:
            self._spec = None
        return self.state, frame

    # ============================================== fused whole-frame step
    def _fused_preconditions(self):
        return (self.state == TrackingState.OK
                and self.velocity is not None
                and self.last_frame is not None
                and self.last_frame.pose_set
                and self._spec is not None
                and Frame._next_id >= self.last_reloc_frame_id + 2)

    def _begin_fused(self, imgs, timestamp):
        """Prepare the inputs under the map lock, then queue the fused step
        outside it without waiting.  Returns the pending dict of
        _finish_fused, or None when the preconditions fail."""
        with self._map_lock:
            if not self._fused_preconditions():
                return None
            # with frames in flight the newest finished frame is `steps`
            # frames back: the velocity is applied that many times
            steps = 1 + len(self._inflight)
            with span("slice.host_prep"):
                lf, pred, last_state, last_gen = self._fused_inputs(steps)
            spec, spec_gen, spec_pid = self._spec, self._spec_gen, self._spec_pid
        mb = self.cam.bf / self.cam.fx
        tz = float((pred @ lf.Twc)[2, 3])
        mono = self.sensor == "mono"
        # the motion-model window widens with the prediction horizon
        th = (15.0 if mono else 7.0) * steps
        arrays, dev_cache = self.fused_step.dispatch(
            imgs, pred, last_state, spec, min(th, 21.0), 1.0, self._cam_params(),
            forward=not mono and tz > mb, backward=not mono and -tz > mb)
        # the dispatch-time last frame's associations: the step's matches
        # index ITS slots, and with frames in flight the finish runs after
        # self.last_frame and the temporary points have moved on
        last_snap = dict(
            map_points=lf.map_points.copy(),
            temp_flag=(None if self._last_temp_flag is None
                       else self._last_temp_flag.copy()),
            temp_world=(None if self._last_temp_world is None
                        else self._last_temp_world.copy()))
        return dict(arrays=arrays, dev_cache=dev_cache, timestamp=timestamp,
                    last_gen=last_gen, spec_gen=spec_gen, spec_pid=spec_pid,
                    last_snap=last_snap)

    def _finish_fused(self, pending):
        """Wait for a _begin_fused step and record its stages' device
        times; returns (Frame, FusedTrackResult)."""
        pulled, dev_cache, fz = fused_track_pull(pending["arrays"],
                                                 pending["dev_cache"])
        if fz.stamps is not None:
            record_stages(fz.stamps)
        frame = Frame.from_arrays(self.frontend, self.cam, pending["timestamp"],
                                  *pulled[:8], dev_cache=dev_cache,
                                  response=pulled[8])
        fz.last_gen = pending["last_gen"]
        fz.spec_gen = pending["spec_gen"]
        fz.spec_pid = pending["spec_pid"]
        fz.last_snap = pending["last_snap"]
        return frame, fz

    def _fused_inputs(self, steps: int):
        """The pose predicted `steps` frames ahead of the last frame, the
        last frame's state (numpy, and its front-end tensors on the card)
        and its generation snapshot; refreshes the speculated candidates
        when the map moved since speculation."""
        self._update_last_frame()
        lf = self.last_frame
        m = self.map
        pred = lf.Tcw
        for _ in range(steps):
            pred = self.velocity @ pred
        pred = pred.astype(np.float32)
        pw, has_pt, alive = self._last_frame_points()
        last_state = {
            "pw": pw, "has_pt": has_pt, "real": alive,
            "pid": np.where(alive, lf.map_points, -1).astype(np.int32),
            "octave": lf.dev("octave"), "angle": lf.dev("angle"),
            "desc": lf.dev("desc"),
        }
        last_gen = m.pt_gen[np.maximum(lf.map_points, 0)].copy()
        if m.version != self._spec_version:
            self._spec_version = m.version
            sidx = self._spec_pid
            fresh = (self._spec_alive & m.pt_alive[sidx]
                     & (m.pt_gen[sidx] == self._spec_gen))
            self._spec_alive = fresh
            self._spec_gen = m.pt_gen[sidx].copy()
            self._spec = self._candidate_arrays(sidx, fresh)
        return lf, pred, last_state, last_gen

    def _candidate_arrays(self, idx, alive):
        m = self.map
        return {
            "pos": m.pt_pos[idx], "normal": m.pt_normal[idx],
            "maxd": m.pt_max_dist[idx], "mind": m.pt_min_dist[idx],
            "desc": m.pt_desc[idx], "alive": alive,
            "pid": np.where(alive, idx, -1).astype(np.int32),
        }

    def _consume_fused_local(self, frame: Frame, fz):
        """Apply the fused step's local-map stage: the host half of
        _track_local_map with the device outputs in hand."""
        m = self.map
        # drop associations whose point was culled or recycled since its
        # data was captured (generation snapshots)
        exp_gen = np.full(frame.n_slots, -1, np.int64)
        cur_m = np.flatnonzero(fz.m >= 0)
        exp_gen[cur_m] = fz.last_gen[fz.m[cur_m]]
        mp = frame.map_points
        stale = (mp >= 0) & (~m.pt_alive[np.maximum(mp, 0)] |
                             (m.pt_gen[np.maximum(mp, 0)] != exp_gen))
        mp[stale] = -1
        local_kfs = self._local_keyframes(frame)
        if len(local_kfs) == 0:
            return False
        cur_pids = frame.map_points[frame.map_points >= 0]
        m.pt_visible[cur_pids] += 1
        frame.temp_flag = np.zeros(frame.n_slots, bool)
        cand_pid = fz.spec_pid
        ok_pid = cand_pid[fz.ok]
        ok_fresh = m.pt_alive[ok_pid] & (m.pt_gen[ok_pid] == fz.spec_gen[fz.ok])
        m.pt_visible[ok_pid[ok_fresh]] += 1
        cur = np.flatnonzero(fz.sel >= 0)
        sel_pid = cand_pid[fz.sel[cur]]
        sel_fresh = m.pt_alive[sel_pid] & \
            (m.pt_gen[sel_pid] == fz.spec_gen[fz.sel[cur]])
        frame.map_points[cur[sel_fresh]] = sel_pid[sel_fresh]
        T = np.eye(4, dtype=np.float32)
        T[:3, :3] = fz.R2
        T[:3, 3] = fz.t2
        frame.set_pose(T)
        frame.outlier = (frame.map_points >= 0) & ~fz.inl2
        self.fused_frames += 1
        return self._local_map_tail(frame)

    def _speculate_candidates(self, frame: Frame):
        """Gather the next frame's local-map candidates: the points observed
        by the keyframes covisible with this frame's final associations,
        padded to a power-of-two bucket of at least 128."""
        m = self.map
        local_kfs = self._vote_local_kfs(frame)
        if len(local_kfs) == 0:
            self._spec = None
            return
        obs = m.kf_obs[local_kfs]
        cand = np.unique(obs[obs >= 0])
        cand = cand[m.pt_alive[cand]]
        if len(cand) == 0:
            self._spec = None
            return
        # identical candidate set and unchanged map: the device copies hold
        if (self._spec is not None and m.version == self._spec_version
                and len(cand) <= len(self._spec_pid)
                and np.array_equal(cand, self._spec_pid[self._spec_alive])):
            return
        cap = 1 << max(int(np.ceil(np.log2(max(len(cand), 128)))), 7)
        pad = cap - len(cand)
        idx = np.concatenate([cand, np.zeros(pad, np.int64)])
        alive = np.concatenate([np.ones(len(cand), bool), np.zeros(pad, bool)])
        self._spec_pid = idx.astype(np.int32)
        self._spec_gen = m.pt_gen[idx].copy()
        self._spec_alive = alive
        self._spec_version = m.version
        self._spec = self._candidate_arrays(idx, alive)

    # ==================================================== initialization
    def _stereo_initialization(self, frame: Frame):
        """Tracking::StereoInitialization (Tracking.cpp:663-722)."""
        if frame.valid.sum() < max(50, 0.02 * frame.n_slots):
            return
        frame.set_pose(np.eye(4, dtype=np.float32))
        kid = self.map.add_keyframe(frame)
        slots = np.flatnonzero((frame.depth > 0) & frame.valid)
        if len(slots) < 20:
            self.map.erase_keyframe(kid, force=True)  # roll back
            return
        pw = frame.unproject_stereo_batch(slots)
        for slot, pos in zip(slots, pw):
            pid = self.map.add_point(pos, frame.desc[slot], kid)
            self.map.add_observation(kid, slot, pid)
            frame.map_points[slot] = pid
            self.map.init_point_single_obs(pid, kid, slot, self.scale_factors,
                                           self.n_levels)
        self.ref_kf = kid
        self.last_kf_frame_id = frame.frame_id
        self.state = TrackingState.OK
        if self.local_mapper is not None:
            self.local_mapper.insert_keyframe(kid)

    def _monocular_initialization(self, frame: Frame):
        """Tracking::MonocularInitialization + CreateInitialMapMonocular
        (Tracking.cpp:724-917): a reference frame, brute-force matches to
        it, the two-view initializer, and the map scaled to a unit median
        depth."""
        min_kp = max(50, 0.02 * frame.n_slots)  # the reference gates at 100
        ref = self._mono_init_ref
        if ref is None or frame.valid.sum() < min_kp:
            if frame.valid.sum() >= min_kp:
                self._mono_init_ref = frame
            return
        count("init.attempts")
        with span("init.attempt"):
            match, _ = pull(matcher.match_brute_force(
                ref.dev("desc"), ref.dev("valid"), ref.dev("angle"),
                frame.dev("desc"), frame.dev("valid"), frame.dev("angle"),
                nn_ratio=0.9))
            s_ref = np.flatnonzero(match >= 0)
            if len(s_ref) < 50:
                self._mono_init_ref = frame
                return
            s_cur = match[s_ref]
            c = self.cam
            init = MonoInitializer(c.fx, c.fy, c.cx, c.cy, self.device)
            ok, R21, t21, X, good = init.initialize(
                ref.kp_xy[s_ref], frame.kp_xy[s_cur], np.ones(len(s_ref), bool))
        if not ok:
            return
        # unit median depth (invMedianDepth on the translation and points)
        z = X[good, 2]
        med = float(np.median(z)) if len(z) else 1.0
        if med <= 0:
            return
        X = X / med
        t21 = t21 / med
        ref.set_pose(np.eye(4, dtype=np.float32))
        T2 = np.eye(4, dtype=np.float32)
        T2[:3, :3] = R21
        T2[:3, 3] = t21
        frame.set_pose(T2)
        m = self.map
        kid1 = m.add_keyframe(ref)
        kid2 = m.add_keyframe(frame)
        for i in np.flatnonzero(good):
            pid = m.add_point(X[i], frame.desc[s_cur[i]], kid2)
            m.add_observation(kid1, int(s_ref[i]), pid)
            m.add_observation(kid2, int(s_cur[i]), pid)
            m.compute_distinctive_descriptor(pid)
            m.update_normal_and_depth(pid, self.scale_factors, self.n_levels)
            frame.map_points[s_cur[i]] = pid
        self.ref_kf = kid2
        self.last_kf_frame_id = frame.frame_id
        self.state = TrackingState.OK
        count("init.accepted")
        if self.local_mapper is not None:
            self.local_mapper.insert_keyframe(kid1)
            self.local_mapper.insert_keyframe(kid2)

    # ================================================== motion model
    def _update_last_frame(self):
        """Tracking::UpdateLastFrame: re-anchor the last frame on its
        reference keyframe and spawn temporary VO points for close stereo
        depths (Tracking.cpp:963-1027)."""
        lf = self.last_frame
        ref = getattr(lf, "ref_kf", -1)
        rel = self._last_rel_pose
        if rel is not None and ref is not None and ref >= 0 and \
                self.map.kf_alive[ref]:
            lf.set_pose((rel @ self.map.kf_pose[ref]).astype(np.float32))
        depth = lf.depth
        close = (depth > 0) & lf.valid
        if close.sum() == 0:
            self._last_temp_world = None
            self._last_temp_flag = None
            return
        order = np.argsort(np.where(close, depth, np.inf))
        n_close = int(((depth > 0) & (depth < self.th_depth) & lf.valid).sum())
        n_take = max(min(100, int(close.sum())), n_close)
        chosen = order[:n_take]
        need = chosen[(lf.map_points[chosen] < 0)]
        temp_flag = np.zeros(lf.n_slots, bool)
        temp_world = np.zeros((lf.n_slots, 3), np.float32)
        if len(need):
            temp_flag[need] = True
            temp_world[need] = lf.unproject_stereo_batch(need)
        self._last_temp_world = temp_world
        self._last_temp_flag = temp_flag

    def _last_frame_points(self):
        """World positions / masks of the last frame's associations,
        temporary VO points included."""
        lf = self.last_frame
        m = self.map
        has_real = lf.map_points >= 0
        pw = np.zeros((lf.n_slots, 3), np.float32)
        pw[has_real] = m.pt_pos[lf.map_points[has_real]]
        alive = np.zeros(lf.n_slots, bool)
        alive[has_real] = m.pt_alive[lf.map_points[has_real]]
        has_pt = alive.copy()
        if self._last_temp_flag is not None:
            has_pt |= self._last_temp_flag
            tf = self._last_temp_flag
            pw[tf] = self._last_temp_world[tf]
        return pw, has_pt, alive

    def _track_with_motion_model(self, frame: Frame):
        """Tracking::TrackWithMotionModel (Tracking.cpp:1030-1115)."""
        self._update_last_frame()
        lf = self.last_frame
        frame.set_pose(self.velocity @ lf.Tcw)
        pw, has_pt, alive = self._last_frame_points()
        tlc = (frame.Tcw @ lf.Twc)[:3, 3]
        mb = self.cam.bf / self.cam.fx
        mono = self.sensor == "mono"
        c = self.cam
        match_slot, n, R, t, inlier, n_map = pull(matcher.motion_model_track(
            self._t(frame.Rcw), self._t(frame.tcw), self._t(pw),
            self._t(has_pt), self._t(alive),
            lf.dev("octave"), lf.dev("angle"), lf.dev("desc"),
            frame.dev("kp_xy"), frame.dev("octave"), frame.dev("angle"),
            frame.dev("desc"), frame.dev("valid"), frame.dev("u_right"),
            15.0 if mono else 7.0, self._sf_dev, self._inv_s2_dev, self.n_levels,
            c.fx, c.fy, c.cx, c.cy, c.bf, self.min_x, self.max_x, self.min_y,
            self.max_y, not mono and bool(tlc[2] > mb),
            not mono and bool(-tlc[2] > mb)))
        if n < 20:
            return False
        self._apply_last_matches(frame, match_slot)
        T = np.eye(4, dtype=np.float32)
        T[:3, :3] = R
        T[:3, 3] = t
        frame.set_pose(T)
        frame.outlier = (match_slot >= 0) & ~inlier
        return int(n_map) >= 10

    def _apply_last_matches(self, frame, match_slot, snapshot=None):
        """match_slot: per-current-slot index into the last frame's slots;
        snapshot: the last frame's {map_points, temp_flag, temp_world} as
        the fused step saw them."""
        if snapshot is not None:
            lf_map_points = snapshot["map_points"]
            temp_flag = snapshot["temp_flag"]
            temp_world = snapshot["temp_world"]
        else:
            lf_map_points = self.last_frame.map_points
            temp_flag = self._last_temp_flag
            temp_world = self._last_temp_world
        cur = np.flatnonzero(match_slot >= 0)
        last_slots = match_slot[cur]
        pids = lf_map_points[last_slots]
        frame.map_points[:] = -1
        frame.temp_world = np.zeros((frame.n_slots, 3), np.float32)
        frame.temp_flag = np.zeros(frame.n_slots, bool)
        real = pids >= 0
        frame.map_points[cur[real]] = pids[real]
        if temp_flag is not None:
            is_temp = temp_flag[last_slots]
            frame.temp_flag[cur[is_temp]] = True
            frame.temp_world[cur[is_temp]] = temp_world[last_slots[is_temp]]

    # ================================================== pose refinement
    def _optimize_pose(self, frame: Frame):
        """PoseOptimization; returns the inliers with real map points."""
        has_real = frame.map_points >= 0
        temp_flag = getattr(frame, "temp_flag", None)
        has_any = has_real.copy()
        pts = np.zeros((frame.n_slots, 3), np.float32)
        pts[has_real] = self.map.pt_pos[frame.map_points[has_real]]
        if temp_flag is not None:
            has_any |= temp_flag
            pts[temp_flag] = frame.temp_world[temp_flag]
        if has_any.sum() < 3:
            return 0
        c = self.cam
        R, t, inlier, _ = pull(pose_optimization(
            self._t(frame.Rcw), self._t(frame.tcw), self._t(pts),
            frame.dev("kp_xy"), frame.dev("u_right"),
            self._t(self.inv_level_sigma2[frame.octave]), self._t(has_any),
            c.fx, c.fy, c.cx, c.cy, c.bf))
        T = np.eye(4, dtype=np.float32)
        T[:3, :3] = R
        T[:3, 3] = t
        frame.set_pose(T)
        frame.outlier = has_any & ~inlier
        return int((inlier & has_real).sum())

    # ================================================== reference KF
    def _track_reference_keyframe(self, frame: Frame):
        """Tracking::TrackReferenceKeyFrame (Tracking.cpp:919-961)."""
        if self.ref_kf < 0:
            return False
        kid = self.ref_kf
        m = self.map
        match, _ = pull(matcher.match_brute_force(
            frame.dev("desc"), frame.dev("valid"), frame.dev("angle"),
            self._t(m.kf_desc[kid]),
            self._t(m.kf_kp_valid[kid] & (m.kf_obs[kid] >= 0)),
            self._t(m.kf_kp_angle[kid]), nn_ratio=0.7))
        cur = np.flatnonzero(match >= 0)
        pids = m.kf_obs[kid][match[cur]]
        good = pids >= 0
        good[good] &= m.pt_alive[pids[good]]
        if good.sum() < 15:
            return False
        frame.map_points[:] = -1
        frame.map_points[cur[good]] = pids[good]
        frame.temp_flag = np.zeros(frame.n_slots, bool)
        frame.temp_world = np.zeros((frame.n_slots, 3), np.float32)
        if self.last_frame is not None and self.last_frame.pose_set:
            frame.set_pose(self.last_frame.Tcw)
        else:
            frame.set_pose(np.eye(4, dtype=np.float32))
        return self._optimize_pose(frame) >= 10

    # ================================================== local map
    def _vote_local_kfs(self, frame):
        """Covisibility vote over the frame's associations
        (Tracking::UpdateLocalKeyFrames core): keyframes observing the
        frame's points, best first, plus the top-10 covisible neighbours
        of the top 20, capped at 80."""
        m = self.map
        pids = frame.map_points[frame.map_points >= 0]
        pids = pids[m.pt_alive[pids]]
        if len(pids) == 0:
            return np.array([], np.int64)
        seen = np.zeros(m.max_points, bool)
        seen[pids] = True
        K = m._next_kf
        tab = m.kf_obs[:K]
        votes = (seen[np.where(tab >= 0, tab, 0)] & (tab >= 0)).sum(1)
        votes = votes * m.kf_alive[:K]
        local = np.flatnonzero(votes > 0)
        if len(local) == 0:
            return np.array([], np.int64)
        local = local[np.argsort(-votes[local], kind="stable")]
        out = list(local[:80])
        for neigh in m.covisible_neighbors_batch(local[:20], n=10):
            for nk in neigh:
                if nk not in out:
                    out.append(int(nk))
                    if len(out) >= 80:
                        break
            if len(out) >= 80:
                break
        return np.asarray(out, np.int64)

    def _local_keyframes(self, frame):
        """Tracking::UpdateLocalKeyFrames (vote + reference-KF update)."""
        out = self._vote_local_kfs(frame)
        if len(out):
            self.ref_kf = int(out[0])
            frame.ref_kf = self.ref_kf
        return out

    def _track_local_map(self, frame: Frame):
        """Tracking::TrackLocalMap + SearchLocalPoints
        (Tracking.cpp:1117-1806)."""
        m = self.map
        local_kfs = self._local_keyframes(frame)
        if len(local_kfs) == 0:
            return False
        obs = m.kf_obs[local_kfs]
        pids = np.unique(obs[obs >= 0])
        pids = pids[m.pt_alive[pids]]
        in_frame = np.zeros(m.max_points, bool)
        cur_pids = frame.map_points[frame.map_points >= 0]
        in_frame[cur_pids] = True
        m.pt_visible[cur_pids] += 1
        cand = pids[~in_frame[pids]]
        frame.temp_flag = np.zeros(frame.n_slots, bool)
        if len(cand):
            cap = 1 << max(int(np.ceil(np.log2(max(len(cand), 128)))), 7)
            pad = cap - len(cand)
            idx = np.concatenate([cand, np.zeros(pad, np.int64)])
            alive = np.concatenate([np.ones(len(cand), bool), np.zeros(pad, bool)])
            exist_has = frame.map_points >= 0
            exist_pts = np.zeros((frame.n_slots, 3), np.float32)
            exist_pts[exist_has] = m.pt_pos[frame.map_points[exist_has]]
            th = 5.0 if frame.frame_id < self.last_reloc_frame_id + 2 else 1.0
            c = self.cam
            ct = {k: self._t(v) for k, v in self._candidate_arrays(idx, alive).items()}
            ok, sel, R, t, inlier, n_map = pull(matcher.local_map_track(
                ct["pos"], ct["normal"], ct["maxd"], ct["mind"], ct["desc"],
                ct["alive"], self._t(frame.Rcw), self._t(frame.tcw),
                self._t(frame.camera_center),
                frame.dev("kp_xy"), frame.dev("octave"), frame.dev("desc"),
                frame.dev("valid"), frame.dev("u_right"), self._t(~exist_has),
                self._t(exist_pts), self._t(exist_has), self._t(exist_has),
                th, self._sf_dev, self._inv_s2_dev, self.n_levels,
                c.fx, c.fy, c.cx, c.cy, c.bf, self.min_x, self.max_x,
                self.min_y, self.max_y, self.log_scale))
            m.pt_visible[idx[ok]] += 1
            cur = np.flatnonzero(sel >= 0)
            frame.map_points[cur] = idx[sel[cur]]
            T = np.eye(4, dtype=np.float32)
            T[:3, :3] = R
            T[:3, 3] = t
            frame.set_pose(T)
            frame.outlier = (frame.map_points >= 0) & ~inlier
        else:
            self._optimize_pose(frame)
        return self._local_map_tail(frame)

    def _local_map_tail(self, frame: Frame):
        """Found counters and the inlier gates that end TrackLocalMap."""
        m = self.map
        has = (frame.map_points >= 0) & ~frame.outlier
        m.pt_found[frame.map_points[has]] += 1
        self.matches_inliers = int(
            (has & (m.pt_nobs[np.maximum(frame.map_points, 0)] > 0)).sum())
        if frame.frame_id < self.last_reloc_frame_id + self.max_frames and \
                self.matches_inliers < 50:
            return False
        # the reference gates at 30; the tile budget keeps slot counts below
        # ORB-SLAM2's 1000+ features, so the floor scales down
        return self.matches_inliers >= 10

    # ================================================== keyframe policy
    def _need_new_keyframe(self, frame: Frame):
        """Tracking::NeedNewKeyFrame (Tracking.cpp:1180-1264)."""
        if self.only_tracking:
            return False
        m = self.map
        if not m.kf_capacity_left():
            # the keyframe table is full: track without a keyframe
            return False
        n_kfs = m.n_keyframes()
        if frame.frame_id < self.last_reloc_frame_id + self.max_frames and \
                n_kfs > self.max_frames:
            return False
        min_obs = 3 if n_kfs > 2 else 2
        n_ref_matches = m.tracked_points_in_kf(self.ref_kf, min_obs) \
            if self.ref_kf >= 0 else 0
        idle = self.local_mapper.accepting() if self.local_mapper else True
        mono = self.sensor == "mono"
        # a mono frame has no depth, so no close points
        close = (frame.depth > 0) & (frame.depth < self.th_depth) & frame.valid
        tracked = (frame.map_points >= 0) & ~frame.outlier
        n_tracked_close = int((close & tracked).sum())
        n_nontracked_close = int((close & ~tracked).sum())
        # reference constants 100/70 (Tracking.cpp:1221) scale with the
        # NMS-G slot budget
        scale = min(1.0, frame.n_slots / 2000.0)
        need_close = (n_tracked_close < 100 * scale) and \
            (n_nontracked_close > 70 * scale)
        th_ref = 0.9 if mono else (0.75 if n_kfs >= 2 else 0.4)
        c1a = frame.frame_id >= self.last_kf_frame_id + self.max_frames
        c1b = frame.frame_id >= self.last_kf_frame_id + self.min_frames and idle
        c1c = not mono and (self.matches_inliers < n_ref_matches * 0.25 or need_close)
        c2 = (self.matches_inliers < n_ref_matches * th_ref or need_close) and \
            self.matches_inliers > 15
        if not ((c1a or c1b or c1c) and c2):
            return False
        count("keyframes.wanted")
        if idle:
            return True
        # a busy mapper: interrupt its BA; stereo and RGB-D insert while its
        # queue is short, mono waits
        self.local_mapper.interrupt_ba()
        if not mono and self.local_mapper.queue_len() < 3:
            return True
        count("keyframes.refused")
        return False

    def _create_new_keyframe(self, frame: Frame):
        """Tracking::CreateNewKeyFrame (Tracking.cpp:1266-1344): the
        keyframe plus map points for its close stereo or RGB-D slots (none
        in mono, which has no depth), walked by increasing depth (every
        slot counts toward n_points; the walk stops after the first slot
        deeper than ThDepth once 100 are processed)."""
        m = self.map
        kid = m.add_keyframe(frame)
        self.ref_kf = kid
        frame.ref_kf = kid
        depth = frame.depth
        valid_d = (depth > 0) & frame.valid
        order = np.argsort(np.where(valid_d, depth, np.inf))
        n_valid = int(valid_d.sum())
        order = order[:n_valid]
        far = depth[order] > self.th_depth
        far[:100] = False
        J = int(np.argmax(far)) + 1 if far.any() else n_valid
        sel = order[:J]
        pid0 = frame.map_points[sel]
        dead = (pid0 < 0) | ~m.pt_alive[np.maximum(pid0, 0)] | \
            (m.pt_nobs[np.maximum(pid0, 0)] < 1)
        create = sel[dead]
        if len(create):
            pos = frame.unproject_stereo_batch(create)
            frame.map_points[create] = m.add_points_batch(
                kid, create, pos, self.scale_factors, self.n_levels)
        self.last_kf_frame_id = frame.frame_id
        if self.local_mapper is not None:
            self.local_mapper.insert_keyframe(kid)

    # ================================================== relocalization
    RELOC_MAX_CANDIDATES = 8   # one batch shape; the database rarely gives more
    RELOC_HYPOTHESES = 256

    @span("slice.relocalize")
    def _relocalization(self, frame: Frame):
        """Tracking::Relocalization (Tracking.cpp:1954-2115): candidate
        keyframes from the BoW database, filled by a window that rotates over
        every keyframe on successive LOST frames (recent first on the first
        attempt), all run through ``_batched_reloc``; the best candidate
        with >= 15 matches and >= 20 inliers after the last LM is accepted."""
        m = self.map
        kfs = []
        if self.database is not None:
            kfs = self.database.detect_relocalization_candidates(
                frame.desc[frame.valid], m)
            kfs = [int(k) for k in kfs if m.kf_alive[k]]
        C = self.RELOC_MAX_CANDIDATES
        if len(kfs) < C:
            # newest first: rows are recycled, so order by frame id
            live = m.keyframe_ids()
            ids = [int(k) for k in live[np.argsort(-m.kf_frame_id[live], kind="stable")]]
            if len(ids) > C:
                off = (self._reloc_rr * C) % len(ids)
                ids = ids[off:] + ids[:off]
                self._reloc_rr += 1
            seen = set(kfs)
            kfs = kfs + [k for k in ids if k not in seen]
        if not kfs:
            return False
        kfs = kfs[:C]       # one batch shape; the reference tries them all
        n_real = len(kfs)
        idx = np.asarray(kfs + [kfs[0]] * (C - n_real), np.int64)
        obs = m.kf_obs[idx]
        safe = np.maximum(obs, 0)
        has = (obs >= 0) & m.pt_alive[safe] & m.kf_kp_valid[idx]
        has[n_real:] = False
        gen = torch.Generator(device=self.device)
        gen.manual_seed(int(frame.frame_id))
        sample = draw_samples(gen, (C, self.RELOC_HYPOTHESES, 4), self.device)
        c = self.cam
        n_match, n_final, R2, t2, inlier, match = pull(_batched_reloc(
            frame.dev("desc"), frame.dev("valid"), frame.dev("angle"),
            frame.dev("kp_xy"), frame.dev("u_right"), frame.dev("octave"),
            self._t(self.inv_level_sigma2[frame.octave]),
            self._t(m.kf_desc[idx]), self._t(has), self._t(m.kf_kp_angle[idx]),
            self._t(m.kf_kp_octave[idx]), self._t(m.pt_pos[safe]),
            self._t(m.kf_pose[idx, :3, :3]), self._t(m.kf_pose[idx, :3, 3]),
            self._sf_dev, self.n_levels, c.fx, c.fy, c.cx, c.cy, c.bf,
            self.min_x, self.max_x, self.min_y, self.max_y, sample))
        ok = (n_match >= 15) & (n_final >= 20)
        ok[n_real:] = False
        if not ok.any():
            return False
        best = int(np.argmax(np.where(ok, n_final, -1)))
        kid = kfs[best]
        mb = match[best]
        cur = np.flatnonzero(mb >= 0)
        pids = m.kf_obs[kid][mb[cur]]
        good = pids >= 0
        good[good] &= m.pt_alive[pids[good]]
        frame.map_points[:] = -1
        frame.map_points[cur[good]] = pids[good]
        frame.temp_flag = np.zeros(frame.n_slots, bool)
        frame.temp_world = np.zeros((frame.n_slots, 3), np.float32)
        T = np.eye(4, dtype=np.float32)
        T[:3, :3] = R2[best]
        T[:3, 3] = t2[best]
        frame.set_pose(T)
        frame.outlier = (frame.map_points >= 0) & ~inlier[best]
        self.last_reloc_frame_id = frame.frame_id
        self._reloc_rr = 0
        return True


def _batched_reloc(f_desc, f_valid, f_angle, f_xy, f_ur, f_octave, f_inv_s2,
                   c_desc, c_has, c_angle, c_octave, c_pw, c_R, c_t,
                   scale_factors, n_levels: int, fx, fy, cx, cy, bf,
                   min_x, max_x, min_y, max_y, sample):
    """Every relocalization candidate in one call (Tracking.cpp:1954-2115):
    per candidate, brute-force matching (SearchByBoW gates, nn ratio 0.75)
    -> PnP RANSAC (the candidate's own pose when it finds < 8 inliers) ->
    pose LM; with >= 10 inliers the candidate's other points are searched
    in a wide window (th 10) and the pose re-optimised; when that lands
    30 to 49 inliers, a narrow search (th 3, ORBdist 64) and LM again
    (Tracking.cpp:2060-2106).  The caller applies the acceptance gate.

    f_*: the frame's slots; c_*: the C candidates' slots (C, S), their
    points' positions c_pw (C, S, 3) and poses; sample (C, H, 4) the PnP
    minimal samples as positions into each candidate's matches.  The PnP
    and the three LMs run batched over the candidates, the matchers once
    per candidate; nothing reads back to the host.
    Returns (n_match (C,), n_final (C,), R (C, 3, 3), t (C, 3),
    inlier (C, S_frame), match (C, S_frame))."""
    C, S_c = c_has.shape

    def lm(R0, t0, pw, has):
        return torch.func.vmap(
            lambda R, t, p, h: pose_optimization(R, t, p, f_xy, f_ur, f_inv_s2, h,
                                                 fx, fy, cx, cy, bf))(R0, t0, pw, has)

    def points(match):
        idx = torch.where(match >= 0, match, torch.zeros_like(match)).to(torch.int64)
        return torch.gather(c_pw, 1, idx[..., None].expand(*idx.shape, 3))

    def taken(match):
        """The candidate slots that a match already uses; where several
        frame slots write one target (the unmatched ones write 0) the last
        writes, as the JAX package's scatter does."""
        has = match >= 0
        idx = torch.where(has, match, torch.zeros_like(match))
        w = matcher._last_writer(idx, S_c).to(torch.int64)
        return (w >= 0) & torch.gather(has, 1, w.clamp(min=0))

    def search(R, t, free, th, orb_dist=None):
        return torch.stack([matcher.search_by_projection_last(
            R[c], t[c], c_pw[c], free[c], c_octave[c], c_angle[c], c_desc[c],
            f_xy, f_octave, f_angle, f_desc, f_valid, f_ur, th, scale_factors,
            n_levels, fx, fy, cx, cy, bf, min_x, max_x, min_y, max_y,
            False, False, orb_dist=orb_dist) for c in range(C)])

    match = torch.stack([matcher.match_brute_force(
        f_desc, f_valid, f_angle, c_desc[c], c_has[c], c_angle[c],
        nn_ratio=0.75)[0] for c in range(C)])
    has = match >= 0
    pw = points(match)
    n_match = has.sum(1)
    R0, t0, _, n_pnp = pnp_ransac(pw, f_xy.expand(C, *f_xy.shape), f_inv_s2,
                                  has, fx, fy, cx, cy, sample)
    use_pnp = n_pnp >= 8
    R0 = torch.where(use_pnp[:, None, None], R0, c_R)
    t0 = torch.where(use_pnp[:, None], t0, c_t)
    R2, t2, inlier, n2 = lm(R0, t0, pw, has)
    # wide projection of the candidate's other points, then LM
    proj = search(R2, t2, c_has & ~taken(match), 10.0)
    match2 = torch.where(match >= 0, match, proj)
    pw2 = points(match2)
    R3, t3, inlier3, n3 = lm(R2, t2, pw2, match2 >= 0)
    aug = n2 >= 10
    # narrow retry with ORBdist 64, then LM
    proj2 = search(R3, t3, c_has & ~taken(match2), 3.0, orb_dist=64)
    match3 = torch.where(match2 >= 0, match2, proj2)
    pw3 = points(match3)
    R4, t4, inlier4, n4 = lm(R3, t3, pw3, match3 >= 0)
    retry = aug & (n3 >= 30) & (n3 < 50)

    def pick(a4, a3, a2):
        sh = (-1,) + (1,) * (a2.dim() - 1)
        return torch.where(retry.view(sh), a4,
                           torch.where(aug.view(sh), a3, a2))

    return (n_match, pick(n4, n3, n2), pick(R4, R3, R2), pick(t4, t3, t2),
            pick(inlier4, inlier3, inlier), pick(match3, match2, match))
