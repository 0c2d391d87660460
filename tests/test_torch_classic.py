"""The unfused (classic) tracking path of the port against the JAX
package's, on the CPU, on the 25-frame arc of tests/test_fused_track.py
(seed 11, 320x240, 3 levels, tile 16, mapping on, synchronous):

- ``tracker.fused = False`` takes the reference's staged path on every
  frame: no fused step (``fused_frames`` 0), no speculated candidates,
  every frame OK, per-frame states and the keyframes created after each
  call equal to JAX's classic session; the
  port's fused session as tests/test_fused_track.py holds JAX's (the fused
  path on all but the first frames, ATE within max(2x the classic ATE,
  0.02 m)), with JAX's classic ATE as the reference; both port ATEs within
  that class and under 0.05 m;
- ``min_frames`` / ``max_frames``: with mapping off, on the first 16
  frames, and keyframes at least 4 frames apart (``min_frames=4,
  max_frames=6``), the keyframes created after each call equal JAX's,
  and differ from the default's;
- ``Tracker(fused=, min_frames=, max_frames=)``: ``max_frames=None`` is
  the camera's fps, options of the wrong type raise TypeError naming them.

JAX's sessions run in this process's JAX child (``torch_sessions``),
on the same rendered frames.
"""
import numpy as np
import pytest

pytest.importorskip("jax")
import torch  # noqa: E402

from tests.torch_sessions import config, jax_session, stereo_frames  # noqa: E402

torch.set_num_threads(2)

SPACING = dict(min_frames=4, max_frames=6)
SPACING_FRAMES = 16


def session(jax_package, fused=True, enable_mapping=True, spacing=None, n=25):
    """One session on the first n frames of the arc; returns per-call
    states, the keyframes created after each call, ATE and fused frames."""
    from jetson_slam_tpu_torch.io.evaluation import ate_rmse
    if jax_package:
        from jetson_slam_tpu.config import SLAMConfig
        from jetson_slam_tpu.core.frame import Frame
        from jetson_slam_tpu.models.slam import SlamSystem
        kw = {}
    else:
        from jetson_slam_tpu_torch.config import SLAMConfig
        from jetson_slam_tpu_torch.core.frame import Frame
        from jetson_slam_tpu_torch.models.slam import SlamSystem
        kw = dict(device="cpu")
    seq = stereo_frames(11, 25, range(n))
    Frame._next_id = 0
    slam = SlamSystem(config(SLAMConfig(), seq), sensor="stereo",
                      enable_mapping=enable_mapping, **kw)
    slam.tracker.fused = fused
    for k, v in (spacing or {}).items():
        setattr(slam.tracker, k, v)
    states, created = [], []
    for i in range(n):
        states.append(slam.track_stereo(seq.lefts[i], seq.rights[i],
                                        seq.timestamps[i])[0].name)
        created.append(int(slam.map.kf_gen.sum()))
    slam.shutdown()
    ts, poses = slam.camera_trajectory()
    ate = float(ate_rmse(np.asarray(ts), np.asarray(poses), seq.timestamps, seq.poses_twc))
    return dict(states=states, created=created, ate=ate,
                fused=int(slam.tracker.fused_frames), spec=slam.tracker._spec is not None)


@pytest.fixture(scope="module")
def jax_ref():
    """JAX's classic session and its spaced one, asked of the JAX child at
    the first test that needs one; each entry waits for its value."""
    return {"classic": jax_session(session, True, False),
            "spacing": jax_session(session, True, True, False, SPACING, SPACING_FRAMES)}


def test_classic_and_fused_sessions_match_jax_classic(jax_ref):
    classic = session(False, fused=False)
    fused = session(False, fused=True)
    ref = jax_ref["classic"]()
    print(f"port classic {classic}\nport fused {fused}\njax classic {ref}")
    n = len(classic["states"])
    assert classic["states"] == ref["states"] == ["OK"] * n
    assert classic["created"] == ref["created"]     # the same keyframe decisions
    assert classic["fused"] == ref["fused"] == 0
    assert not classic["spec"]                      # no speculated candidates
    assert fused["states"] == ["OK"] * n
    assert fused["fused"] >= n - 4
    bound = max(2.0 * ref["ate"], 0.02)
    for r in (classic, fused):
        assert r["ate"] < 0.05
        assert r["ate"] <= bound, (r["ate"], ref["ate"])


def test_keyframe_spacing_matches_jax(jax_ref):
    port = session(False, enable_mapping=False, spacing=SPACING, n=SPACING_FRAMES)
    default = session(False, enable_mapping=False, n=SPACING_FRAMES)
    ref = jax_ref["spacing"]()
    print(f"port {port['created']}\njax  {ref['created']}\ndefault {default['created']}")
    assert port["states"] == ref["states"]
    assert port["created"] == ref["created"]
    assert port["created"] != default["created"]
    made = np.flatnonzero(np.diff([0] + port["created"]) > 0)
    assert np.all(np.diff(made) >= SPACING["min_frames"])


def test_tracker_options():
    from jetson_slam_tpu_torch.config import SLAMConfig
    from jetson_slam_tpu_torch.core.map import MapStore
    from jetson_slam_tpu_torch.core.tracking import Tracker
    from jetson_slam_tpu_torch.ops.frontend import OrbFrontend
    cam = SLAMConfig().camera
    fe = OrbFrontend(120, 160, n_levels=2, tile_h=16, tile_w=16, device="cpu")

    def tracker(**kw):
        return Tracker(fe, cam, MapStore(max_points=64, max_keyframes=4,
                                         n_slots=fe.n_slots_padded), **kw)

    t = tracker()
    assert t.fused is True and t.min_frames == 0 and t.max_frames == int(cam.fps)
    t = tracker(fused=False, min_frames=2, max_frames=9)
    assert t.fused is False and (t.min_frames, t.max_frames) == (2, 9)
    for kw, name in ((dict(fused="no"), "fused"), (dict(min_frames=1.5), "min_frames"),
                     (dict(max_frames="30"), "max_frames"), (dict(fused=1), "fused")):
        with pytest.raises(TypeError, match=name):
            tracker(**kw)
