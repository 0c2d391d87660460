"""Pipelined tracking (pipeline_depth=2) of the port against the JAX package
on the CPU, both packages on the 16-frame sequence of
tests/test_torch_pipeline.py.

- synchronous mapping: the run is deterministic in both packages, so the
  per-frame states, the keyframes created after each call, the fused
  frames and the tracked camera centres are held against JAX's (the
  velocity applied ``steps`` times, the motion-model window
  ``min(7 * steps, 21)`` and the dispatch-time snapshot of the last frame
  all show in them);
- async mapping: the worker's timing decides which keyframes it accepts,
  so keyframes created and ATE are held against JAX's async run within
  measured bands.
"""
import numpy as np
import pytest

pytest.importorskip("jax")
import torch  # noqa: E402

from jetson_slam_tpu.config import SLAMConfig as JaxConfig  # noqa: E402
from jetson_slam_tpu.core.frame import Frame as JaxFrame  # noqa: E402
from jetson_slam_tpu.core.tracking import TrackingState as JaxState  # noqa: E402
from jetson_slam_tpu.io.synthetic import make_stereo_sequence  # noqa: E402
from jetson_slam_tpu.models.slam import SlamSystem as JaxSlam  # noqa: E402
from jetson_slam_tpu_torch.config import SLAMConfig  # noqa: E402
from jetson_slam_tpu_torch.core.frame import Frame  # noqa: E402
from jetson_slam_tpu_torch.core.tracking import TrackingState  # noqa: E402
from jetson_slam_tpu_torch.io.evaluation import ate_rmse  # noqa: E402
from jetson_slam_tpu_torch.models.slam import SlamSystem  # noqa: E402

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def seq():
    return make_stereo_sequence(seed=11, n_frames=16, h=240, w=320, n_points=800)


def _config(cfg, seq):
    c = cfg.camera
    c.fx, c.fy, c.cx, c.cy, c.bf = seq.fx, seq.fy, seq.cx, seq.cy, seq.bf
    c.width, c.height = 320, 240
    c.k1 = c.k2 = c.p1 = c.p2 = 0.0
    cfg.orb.n_levels, cfg.orb.tile_h, cfg.orb.tile_w = 4, 16, 16
    return cfg


def _run(seq, jax_package, **kw):
    """Track the sequence and shut down; returns the per-call states, the
    keyframes created after each call, and the finished session."""
    if jax_package:
        JaxFrame._next_id = 0
        slam, ok = JaxSlam(_config(JaxConfig(), seq), sensor="stereo", **kw), JaxState.OK
    else:
        Frame._next_id = 0
        slam = SlamSystem(_config(SLAMConfig(), seq), sensor="stereo", device="cpu", **kw)
        ok = TrackingState.OK
    states, created = [], []
    for i in range(len(seq.lefts)):
        state, _ = slam.track_stereo(seq.lefts[i], seq.rights[i], seq.timestamps[i])
        states.append(state == ok)
        created.append(int(slam.map.kf_gen.sum()))
    slam.shutdown()
    ts, poses = slam.camera_trajectory()
    ate = ate_rmse(np.asarray(ts), np.asarray(poses), seq.timestamps, seq.poses_twc)
    centres = np.stack([-e[1][:3, :3].T @ e[1][:3, 3] for e in slam.tracker.trajectory])
    return dict(slam=slam, states=states, created=created, n_traj=len(ts), ate=ate,
                centres=centres, fused=slam.tracker.fused_frames,
                alive=slam.map.n_keyframes(), n_created=int(slam.map.kf_gen.sum()))


@pytest.fixture(scope="module")
def runs(seq):
    """Each package's run with pipeline_depth=2, by (jax_package,
    async_mapping), made on first use."""
    cache = {}

    def get(jax_package, async_mapping):
        key = (jax_package, async_mapping)
        if key not in cache:
            cache[key] = _run(seq, jax_package, async_mapping=async_mapping,
                              pipeline_depth=2)
        return cache[key]
    return get


@pytest.mark.parametrize("async_mapping", [False, True], ids=["sync", "async"])
def test_pipeline_depth_2_tracks_within_the_same_ate(seq, runs, async_mapping):
    """Measured on this sequence.  Sync: 16/16 OK in both, keyframes
    created after each call identical (13 in all), alive 12 (port) and 13
    (JAX), 14 fused each, ATE 0.008308 m port and 0.008603 m JAX, tracked
    centres within 3.0e-3 m.  Async, 9 runs of each package with three
    processes at once: keyframes created 12 to 13 (port) and 10 to 13
    (JAX), never more than the sync run's; 14 fused; ATE 0.00838 to
    0.01033 m (port) and 0.00724 to 0.01045 m (JAX), so a pair of runs
    can differ by 3.1e-3 m."""
    j = runs(True, async_mapping)
    t = runs(False, async_mapping)
    n = len(seq.lefts)
    slam = t["slam"]
    print(f"port: created {t['n_created']} alive {t['alive']} fused {t['fused']} "
          f"ATE {t['ate']:.6f}; jax: created {j['n_created']} alive {j['alive']} "
          f"fused {j['fused']} ATE {j['ate']:.6f}; centre gap "
          f"{np.abs(t['centres'] - j['centres']).max():.6f}")
    assert all(t["states"]) and all(j["states"])
    assert t["n_traj"] == j["n_traj"] == n           # the flush finished every frame
    assert not slam.tracker._inflight and slam.pipeline is None
    assert t["fused"] >= n - 4
    assert t["ate"] < 0.10, f"pipeline_depth=2 ATE {t['ate']}"
    if not async_mapping:
        assert t["created"] == j["created"]
        assert abs(t["alive"] - j["alive"]) <= 1
        assert t["fused"] == j["fused"]
        np.testing.assert_allclose(t["centres"], j["centres"], atol=5e-3, rtol=0)
        assert abs(t["ate"] - j["ate"]) <= 1e-3
    else:
        # a busy worker only holds keyframes back: the synchronous run
        # (the JAX one, deterministic) bounds the count from above
        assert j["n_created"] - 1 <= t["n_created"] <= runs(True, False)["n_created"] + 1
        assert abs(t["fused"] - j["fused"]) <= 2
        assert abs(t["ate"] - j["ate"]) <= 4e-3
        assert t["ate"] <= 0.0125
