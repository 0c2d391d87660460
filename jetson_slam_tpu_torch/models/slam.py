"""SlamSystem: the session facade of the port (System.h equivalent).

Port of ``jetson_slam_tpu/models/slam.py`` for stereo, RGB-D and
monocular sensors: tracking, with local mapping on by default
(triangulation, fuse, local BA, keyframe culling), run synchronously after
each frame or, with ``async_mapping``, on a worker
thread (``core/pipeline.py``); ``pipeline_depth`` keeps fused tracking
steps in flight.  A ``vocabulary`` switches on the BoW keyframe database
(relocalization candidates) and the loop closer, which runs after each
mapped keyframe; under ``async_mapping`` its global BA runs on its own
thread.  Without a vocabulary the tracker still relocalizes, over a
rotating window of keyframes.  A config's ``mask.left`` image masks the
keypoints, ``change_calibration`` swaps the intrinsics from the next frame
on, and ``save_map`` / ``load_map`` checkpoint the map and resume from it.
``mapping_device`` puts local mapping's device work on another device than
the tracker's, and ``mesh`` (a torch.distributed ProcessGroup) shards local
BA and the loop closer's global BA over its ranks: every rank then runs
the same session on the same frames.  ``prewarm`` captures the fused
tracking step of every candidate bucket on a daemon thread at start (the
JAX package compiles them there); ``reset`` and ``load_map`` keep the
captured graphs.  An option of the wrong type raises
TypeError naming it; nothing is silently ignored.
"""
from __future__ import annotations

import numpy as np

from ..bow.database import KeyFrameDatabase
from ..config import SLAMConfig
from ..core.local_mapping import LocalMapper, check_distribution_options
from ..core.loop_closing import LoopCloser
from ..core.map import MapStore
from ..core.pipeline import AsyncMappingPipeline
from ..core.tracking import Tracker, TrackingState
from ..device import resolve_device
from ..io import checkpoint
from ..io.datasets import imread_gray
from ..io.trajectory import save_trajectory_kitti, save_trajectory_tum
from ..ops.frontend import OrbFrontend

SENSOR_MONOCULAR = "mono"
SENSOR_STEREO = "stereo"
SENSOR_RGBD = "rgbd"


class SlamSystem:
    def __init__(self, config: SLAMConfig, sensor: str = SENSOR_STEREO,
                 vocabulary=None, enable_mapping: bool = True,
                 enable_ba: bool = True, async_mapping: bool = False,
                 mapping_device=None, mesh=None, pipeline_depth: int = 0,
                 prewarm: bool = False, device="cuda"):
        if sensor not in (SENSOR_MONOCULAR, SENSOR_STEREO, SENSOR_RGBD):
            raise ValueError(f"unknown sensor {sensor!r}")
        if not isinstance(prewarm, (bool, np.bool_)):
            raise TypeError(f"prewarm must be a bool, not {type(prewarm).__name__}")
        check_distribution_options(mapping_device, mesh)
        dev = resolve_device(device)
        self.mapping_device = mapping_device
        self.mesh = mesh
        self.config = config
        self.sensor = sensor
        cam = config.camera
        orb = config.orb
        mask = None
        if orb.mask_left:
            mask = imread_gray(orb.mask_left)
            if mask.shape != (cam.height, cam.width):
                raise ValueError(f"mask {orb.mask_left} is {mask.shape[1]}x{mask.shape[0]}, "
                                 f"the camera {cam.width}x{cam.height}")
        self.frontend = OrbFrontend(
            cam.height, cam.width, n_levels=orb.n_levels,
            scale_factor=orb.scale_factor, fast_n_min=orb.fast_n_min,
            fast_n_max=orb.fast_n_max, threshold=orb.th_fast_max,
            tile_h=orb.tile_h, tile_w=orb.tile_w,
            fixed_multi_scale_tile_size=orb.fixed_multi_scale_tile_size,
            apply_nms_ms=orb.apply_nms_ms, mask=mask, device=dev)
        self.vocabulary = vocabulary
        self.enable_mapping = enable_mapping
        self.enable_ba = enable_ba
        self.async_mapping = async_mapping
        self.pipeline_depth = int(pipeline_depth)
        self.pipeline = None
        self.loop_closer = None
        self.localization_only = False
        self.tracker = None
        self._wire(self._new_map())
        if prewarm:
            # capture the fused step of every candidate bucket on a daemon
            # thread; a failure is raised by the next track_* call
            self.tracker.prewarm(background=True)

    def _new_map(self):
        return MapStore(max_points=self.config.max_map_points,
                        max_keyframes=self.config.max_keyframes,
                        n_slots=self.frontend.n_slots_padded)

    def _wire(self, map_store, populate_database=False):
        """(Re)bind the mapper, the BoW database and loop closer, the async
        worker and the tracker to map_store, so no module keeps a stale
        MapStore.  populate_database enters the map's keyframes into the new
        BoW database (a loaded map)."""
        if self.pipeline is not None:
            self.pipeline.shutdown()
            self.pipeline = None
        if self.loop_closer is not None:
            self.loop_closer.join_gba()
        self.map = map_store
        cam = self.config.camera
        dev = self.frontend.device
        self.local_mapper = (
            LocalMapper(self.map, cam, self.frontend.geom, dev,
                        sensor=self.sensor, run_ba=self.enable_ba,
                        mapping_device=self.mapping_device, mesh=self.mesh)
            if self.enable_mapping else None)
        self.database = None
        self.loop_closer = None
        if self.vocabulary is not None:
            self.database = KeyFrameDatabase(
                self.vocabulary, max_keyframes=self.config.max_keyframes)
            if populate_database:
                for kid in self.map.keyframe_ids():
                    self.database.add(
                        kid, self.map.kf_desc[kid][self.map.kf_kp_valid[kid]])
            self.loop_closer = LoopCloser(self.map, self.database, cam,
                                          self.frontend.geom, dev,
                                          sensor=self.sensor, mesh=self.mesh)
        # async: local mapping and loop closing on a worker thread
        # (System.cpp:97-111), else a synchronous stage after each frame
        mapper_handle = self.local_mapper
        map_lock = None
        if self.async_mapping and self.local_mapper is not None:
            self.pipeline = AsyncMappingPipeline(self.local_mapper,
                                                 self.loop_closer)
            mapper_handle = self.pipeline
            map_lock = self.pipeline.lock
            if self.loop_closer is not None:
                # the post-loop global BA on its own transient thread with
                # catch-up correction (LoopClosing.cpp:650-754)
                self.loop_closer.async_gba = True
                self.loop_closer.gba_lock = map_lock
        # the captured fused-step graphs outlive the map: shapes do not change
        step = self.tracker.fused_step if self.tracker is not None else None
        self.tracker = Tracker(self.frontend, cam, self.map, sensor=self.sensor,
                               local_mapper=mapper_handle, map_lock=map_lock,
                               pipeline_depth=self.pipeline_depth,
                               database=self.database, fused_step=step)
        self.tracker.only_tracking = self.localization_only

    # ------------------------------------------------------------- track
    def track_stereo(self, left, right, timestamp):
        """Track one rectified stereo pair; returns (state, Frame), the
        Frame None while pipelined frames are still in flight."""
        state, frame = self.tracker.track_stereo(left, right, timestamp)
        self._run_mapping()
        return state, frame

    def track_rgbd(self, rgb, depth, timestamp):
        """Track one grey image and its registered depth image in metres
        (<= 0 where unknown); returns (state, Frame) as track_stereo."""
        state, frame = self.tracker.track_rgbd(rgb, depth, timestamp)
        self._run_mapping()
        return state, frame

    def track_monocular(self, img, timestamp):
        """Track one grey image; returns (state, Frame) as track_stereo."""
        state, frame = self.tracker.track_monocular(img, timestamp)
        self._run_mapping()
        return state, frame

    def _run_mapping(self):
        if self.pipeline is not None:
            return  # the worker drains the queue
        if self.local_mapper is not None and not self.localization_only:
            done = self.local_mapper.process_pending()
            if self.loop_closer is not None:
                for kid in done:
                    if self.map.kf_alive[kid]:
                        self.loop_closer.process_keyframe(kid)

    # --------------------------------------------------------------- api
    def activate_localization_mode(self):
        """System::ActivateLocalizationMode (System.cpp:282): the tracker
        stops creating keyframes, so neither the synchronous stage nor the
        worker changes the map."""
        self.localization_only = True
        self.tracker.only_tracking = True

    def deactivate_localization_mode(self):
        self.localization_only = False
        self.tracker.only_tracking = False

    def get_tracking_state(self):
        return self.tracker.state

    def get_tracked_map_points(self):
        f = self.tracker.last_frame
        if f is None:
            return np.array([], np.int64)
        return f.map_points[f.map_points >= 0]

    def get_tracked_keypoints_un(self):
        """System::GetTrackedKeyPointsUn (System.h:123): the last frame's
        undistorted keypoints, valid slots only, (N, 2) px."""
        f = self.tracker.last_frame
        if f is None:
            return np.zeros((0, 2), np.float32)
        return f.kp_xy[f.valid]

    def change_calibration(self, fx, fy, cx, cy, k1=0.0, k2=0.0, p1=0.0,
                           p2=0.0, k3=0.0, bf=None):
        """Tracking::ChangeCalibration (Tracking.cpp:2165): swap the camera
        intrinsics mid-run; they take effect from the next frame.  Every
        module reads the one CameraConfig per call, and nothing keeps the
        intrinsics on the device between frames: the fused step stages
        them with each frame's inputs, and a lens that switches
        undistortion on or off drops its captured graphs."""
        cam = self.config.camera
        cam.fx, cam.fy, cam.cx, cam.cy = fx, fy, cx, cy
        cam.k1, cam.k2, cam.p1, cam.p2, cam.k3 = k1, k2, p1, p2, k3
        if bf is not None:
            cam.bf = bf
        self.tracker.th_depth = cam.th_depth * cam.bf / cam.fx

    def reset(self):
        """System::Reset -> Tracking::Reset (Tracking.cpp:2117): finishes
        the frames in flight, then starts on a new map."""
        self.tracker.flush_pipeline()
        self._wire(self._new_map())

    def shutdown(self):
        """System::Shutdown (System.cpp:313): finishes the frames in flight
        and the queued keyframes, stops the worker and waits for a running
        global BA."""
        self.tracker.flush_pipeline()
        if self.pipeline is not None:
            self.pipeline.shutdown()
            self.pipeline = None
        else:
            self._run_mapping()
        if self.loop_closer is not None:
            self.loop_closer.join_gba()

    def save_map(self, path):
        """Serialize the map (the reference's SaveMap TODO, System.h:115)
        after finishing the frames in flight and the queued keyframes."""
        self.tracker.flush_pipeline()
        if self.pipeline is not None:
            self.pipeline.drain()
        else:
            self._run_mapping()
        with self.tracker._map_lock:
            checkpoint.save_map(self.map, path)

    def load_map(self, path):
        """Load a map checkpoint and rebind every module to it, the BoW
        database filled with its keyframes.  The tracker restarts LOST, so
        the next frame relocalizes against the loaded map."""
        self.tracker.flush_pipeline()
        self._wire(checkpoint.load_map(path), populate_database=True)
        self.tracker.state = (TrackingState.LOST if self.map.n_keyframes()
                              else TrackingState.NO_IMAGES_YET)

    # --------------------------------------------------------- trajectory
    def camera_trajectory(self):
        """(timestamps, Twc list) after finishing the frames in flight: each
        pose rebuilt as Tcr x Trw with the reference keyframe's current,
        BA-refined pose (System.cpp:334-392).  The generation stamp rejects
        a reference row culled and recycled since."""
        self.tracker.flush_pipeline()
        out_ts, out_poses = [], []
        for ts, Tcw, ref_kf, lost, rel, ref_gen in self.tracker.trajectory:
            if lost:
                continue
            T = np.asarray(Tcw, np.float64)
            if rel is not None and ref_kf is not None and ref_kf >= 0 and \
                    self.map.kf_alive[ref_kf] and \
                    int(self.map.kf_gen[ref_kf]) == ref_gen:
                T = np.asarray(rel, np.float64) @ \
                    np.asarray(self.map.kf_pose[ref_kf], np.float64)
            out_ts.append(ts)
            out_poses.append(np.linalg.inv(T))
        return out_ts, out_poses

    def save_trajectory_tum(self, path):
        ts, poses = self.camera_trajectory()
        save_trajectory_tum(path, ts, poses)

    def save_trajectory_kitti(self, path):
        _, poses = self.camera_trajectory()
        save_trajectory_kitti(path, poses)

    def save_keyframe_trajectory_tum(self, path):
        ids = self.map.keyframe_ids()
        poses = [np.linalg.inv(self.map.kf_pose[k].astype(np.float64)) for k in ids]
        save_trajectory_tum(path, self.map.kf_timestamp[ids], poses)
