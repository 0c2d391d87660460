"""The port's async tracking / mapping pipeline (core/pipeline.py) on the
CPU: the port's versions of tests/test_pipeline.py, the shared map under
fast thread switching, a worker error reaching the caller, and
localization mode freezing the map.  Pipelined tracking (pipeline_depth=2)
is held against the JAX package in tests/test_torch_pipeline_parity.py."""
import sys

import numpy as np
import pytest
import torch

from jetson_slam_tpu_torch.config import SLAMConfig
from jetson_slam_tpu_torch.core.frame import Frame
from jetson_slam_tpu_torch.core.local_mapping import LocalMapper
from jetson_slam_tpu_torch.core.pipeline import AsyncMappingPipeline
from jetson_slam_tpu_torch.core.tracking import TrackingState
from jetson_slam_tpu_torch.io.evaluation import ate_rmse
from jetson_slam_tpu_torch.io.synthetic import make_stereo_sequence
from jetson_slam_tpu_torch.models.slam import SlamSystem

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def seq():
    return make_stereo_sequence(seed=11, n_frames=16, h=240, w=320, n_points=800)


def _slam(seq, **kw):
    cfg = SLAMConfig()
    c = cfg.camera
    c.fx, c.fy, c.cx, c.cy, c.bf = seq.fx, seq.fy, seq.cx, seq.cy, seq.bf
    c.width, c.height = 320, 240
    c.k1 = c.k2 = c.p1 = c.p2 = 0.0
    cfg.orb.n_levels, cfg.orb.tile_h, cfg.orb.tile_w = 4, 16, 16
    Frame._next_id = 0
    return SlamSystem(cfg, sensor="stereo", device="cpu", **kw)


def _track(slam, seq, n=None):
    return [slam.track_stereo(seq.lefts[i], seq.rights[i], seq.timestamps[i])[0]
            for i in range(n or len(seq.lefts))]


def _ate(slam, seq):
    ts, poses = slam.camera_trajectory()
    return len(ts), ate_rmse(np.asarray(ts), np.asarray(poses), seq.timestamps,
                             seq.poses_twc)


def test_async_pipeline_tracks_and_drains(seq):
    slam = _slam(seq, async_mapping=True)
    assert slam.pipeline is not None
    states = _track(slam, seq)
    slam.pipeline.drain()
    assert all(s == TrackingState.OK for s in states), states
    assert slam.map.n_keyframes() >= 2
    assert slam.map.n_points() > 50
    n, ate = _ate(slam, seq)
    assert n == len(seq.lefts)
    assert ate < 0.10, f"async ATE {ate}"
    slam.shutdown()
    assert slam.pipeline is None


def test_async_map_stays_consistent_under_thread_switching(seq):
    """The tracker and the worker share the map under one lock: with the
    interpreter switching threads every 10 us, every observation still
    points at a live point and the observation index matches kf_obs."""
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        slam = _slam(seq, async_mapping=True, pipeline_depth=2)
        _track(slam, seq)
        slam.shutdown()
    finally:
        sys.setswitchinterval(old)
    m = slam.map
    kfs = m.keyframe_ids()
    assert len(kfs) >= 2
    obs = m.kf_obs[kfs]
    assert m.pt_alive[obs[obs >= 0]].all()
    index = {(kf, slot, pid) for pid in np.flatnonzero(m.pt_alive)
             for kf, slot in m._pt_obs.get(int(pid), {}).items()}
    table = {(int(kfs[k]), int(s), int(obs[k, s])) for k, s in zip(*np.nonzero(obs >= 0))}
    assert index == table


def test_worker_error_surfaces():
    class BoomMapper:
        queue = []

        def interrupt_ba(self):
            pass

        def process_keyframe(self, kid, lock):
            raise RuntimeError("boom")

    p = AsyncMappingPipeline(BoomMapper())
    p.insert_keyframe(1)
    with pytest.raises(RuntimeError, match="boom"):
        p.drain()
    p.shutdown()
    assert not p._thread.is_alive()


def test_worker_error_reaches_the_caller(seq, monkeypatch):
    def boom(self, kid):
        raise RuntimeError("triangulation failed")

    monkeypatch.setattr(LocalMapper, "create_new_map_points", boom)
    slam = _slam(seq, async_mapping=True)
    pipeline = slam.pipeline
    with pytest.raises(RuntimeError, match="triangulation failed"):
        _track(slam, seq)
        pipeline.drain()
    try:
        pipeline.shutdown()
    except RuntimeError:  # a later keyframe's error, re-raised again
        pass
    assert not pipeline._thread.is_alive()


def test_localization_mode_freezes_the_map(seq):
    slam = _slam(seq)
    _track(slam, seq, n=6)
    slam.activate_localization_mode()
    n_kf, n_pts = slam.map.n_keyframes(), slam.map.n_points()
    for i in range(6, 12):
        state, _ = slam.track_stereo(seq.lefts[i], seq.rights[i], seq.timestamps[i])
        assert state == TrackingState.OK
    assert (slam.map.n_keyframes(), slam.map.n_points()) == (n_kf, n_pts)
    slam.deactivate_localization_mode()
    rest = [slam.track_stereo(seq.lefts[i], seq.rights[i], seq.timestamps[i])[0]
            for i in range(12, 16)]
    assert rest[-1] == TrackingState.OK
