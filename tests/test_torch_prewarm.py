"""The prewarmed fused step of the port (``core/fused_track.FusedStep``,
``prewarm_fused``, ``Tracker.prewarm``, ``SlamSystem(prewarm=)``) on the
CPU, at 320x240, 4 levels, tile 16, mapping off:

- (a) the step with its flags and thresholds as 0-dim tensors, as a
  captured graph reads them, equals the step with Python bools and floats
  bit for bit, for the three motion-flag combinations; with ``forward``
  set, the port's step on the JAX package's inputs agrees with JAX's
  ``_fused_track_jit`` (run in a spawned child, ``torch_sessions``) within
  the fused-step parity tolerance of tests/test_torch_tracking.py;
- (b) a ``FusedStep`` fed three consecutive frames, the third in the
  next candidate bucket (128 -> 256), equals the eager step on each;
- (c) the device cache a frame returns is a copy the next frame leaves
  alone;
- (d) a 10-frame session with ``prewarm=True`` equals one without;
- (e) the two faults of the JAX package's prewarm are not copied
  (jetson_slam_tpu/core/tracking.py:101,117): an error of the prewarm
  raises (foreground) or is raised by the next track call (background),
  and a bucket beyond the prewarmed caps is set up at its first use,
  counted and warned about;
- (f) after ``change_calibration`` mid-session (a lens that switches
  undistortion on), the session's next fused step equals that of a fresh
  session built on the new intrinsics, on the same inputs.

On the CPU a bucket holds its staged inputs and no graph; the card's
capture and replay are held against the eager step by ``chip_smoke.py``'s
``fused_graph`` phase.
"""
import numpy as np
import pytest

pytest.importorskip("jax")
import torch  # noqa: E402

from tests.torch_sessions import jax_session, stereo_frames  # noqa: E402

torch.set_num_threads(2)

SEED, N_FRAMES = 7, 12
LENS = dict(k1=0.05, k2=-0.02, p1=0.001, p2=0.0005)


def _config(cfg_cls, seq):
    cfg = cfg_cls()
    c = cfg.camera
    c.fx, c.fy, c.cx, c.cy, c.bf = seq.fx, seq.fy, seq.cx, seq.cy, seq.bf
    c.width, c.height = 320, 240
    c.k1 = c.k2 = c.p1 = c.p2 = 0.0
    c.th_depth = 40.0
    cfg.orb.n_levels = 4
    cfg.orb.tile_h = cfg.orb.tile_w = 16
    cfg.orb.th_fast_max = 15
    cfg.max_map_points = 16384
    cfg.max_keyframes = 64
    return cfg


def _frames(n):
    return stereo_frames(SEED, N_FRAMES, range(n))


def jax_forward_step():
    """The JAX package's fused step with ``forward`` set, on the inputs of
    its own session's first fused frame (the child's function): returns
    those inputs, JAX's pyramid of the pair and JAX's outputs."""
    import jax.numpy as jnp

    import jetson_slam_tpu.core.fused_track as jf
    from jetson_slam_tpu.config import SLAMConfig
    from jetson_slam_tpu.core.frame import Frame
    from jetson_slam_tpu.models.slam import SlamSystem
    seq = _frames(6)
    captured = {}
    orig = jf.fused_track_dispatch

    def spy(*args, **kw):
        captured.setdefault("args", args)
        return orig(*args, **kw)

    jf.fused_track_dispatch = spy
    try:
        Frame._next_id = 0
        slam = SlamSystem(_config(SLAMConfig, seq), sensor="stereo", enable_mapping=False)
        for i in range(6):
            slam.track_stereo(seq.lefts[i], seq.rights[i], seq.timestamps[i])
            if "args" in captured:
                break
    finally:
        jf.fused_track_dispatch = orig
    args = captured["args"]
    out = orig(*args, forward=True, backward=False)
    pulled, _, fz = jf.fused_track_pull(*out)
    fe = slam.frontend
    imgs = np.stack([np.asarray(a) for a in args[2]])
    levels = fe._pyramid_batch(fe._tables, jnp.asarray(imgs))
    pyr = np.zeros((2, len(levels)) + imgs.shape[1:], np.uint8)
    for i, lv in enumerate(levels):
        lv = np.asarray(lv)
        pyr[:, i, :lv.shape[1], :lv.shape[2]] = lv
    (_fe, _cam, _imgs, _mode, _mbf, _min_z, pred, last_state, cand, th_mm, th_lm,
     sf, inv_s2, cam_params) = args
    return dict(imgs=imgs, pyr=pyr, pred=np.asarray(pred),
                last={k: np.asarray(v) for k, v in last_state.items()},
                cand={k: np.asarray(v) for k, v in cand.items()},
                th_mm=float(th_mm), th_lm=float(th_lm), sf=np.asarray(sf),
                inv_s2=np.asarray(inv_s2),
                cam_params=tuple(float(v) for v in cam_params[:11]) + (int(cam_params[11]),),
                fz=dict(vars(fz)), valid=np.asarray(pulled[0]))


@pytest.fixture(scope="module")
def jax_forward():
    return jax_session(jax_forward_step)


def _system(seq, lens=None, **kw):
    from jetson_slam_tpu_torch.config import SLAMConfig
    from jetson_slam_tpu_torch.core.frame import Frame
    from jetson_slam_tpu_torch.models.slam import SlamSystem
    cfg = _config(SLAMConfig, seq)
    for k, v in (lens or {}).items():
        setattr(cfg.camera, k, v)
    Frame._next_id = 0
    return SlamSystem(cfg, sensor="stereo", enable_mapping=False, device="cpu", **kw)


def _recorder(step):
    """Wrap step.dispatch to keep each call's arguments."""
    calls = []
    orig = step.dispatch

    def dispatch(*args, **kw):
        calls.append((args, kw))
        return orig(*args, **kw)

    step.dispatch = dispatch
    return calls


@pytest.fixture(scope="module")
def recorded(jax_forward):
    """A port session's fused dispatches: (step, [(args, kw)]).  Asks for
    jax_forward first, so the JAX child works beside the port's tests."""
    seq = _frames(7)
    slam = _system(seq)
    calls = _recorder(slam.tracker.fused_step)
    for i in range(7):
        slam.track_stereo(seq.lefts[i], seq.rights[i], seq.timestamps[i])
    step = slam.tracker.fused_step
    del step.dispatch       # the tests call the step itself
    assert len(calls) >= 3, "fewer than three fused frames"
    return step, calls


def _pad(cand, C):
    """The candidate dict cut or padded to bucket C (dead entries past
    the recorded ones)."""
    out = {}
    for k, v in cand.items():
        v = np.asarray(v)[:C]
        pad = np.full((C - len(v),) + v.shape[1:], -1 if k == "pid" else 0, v.dtype)
        out[k] = np.concatenate([v, pad])
    return out


def _pull(pair):
    from jetson_slam_tpu_torch.core.fused_track import fused_track_pull
    pulled, cache, fz = fused_track_pull(*pair)
    return pulled, cache, fz


def _same(a, b):
    """Pulled results (front-end arrays, FusedTrackResult) bit-equal."""
    pa, _, fa = a
    pb, _, fb = b
    for x, y in zip(pa, pb):
        assert np.array_equal(x, y)
    for k in ("m", "n_match", "R1", "t1", "inl1", "n_map1", "ok", "sel", "R2",
              "t2", "inl2", "n_map2"):
        assert np.array_equal(getattr(fa, k), getattr(fb, k)), k


@pytest.mark.parametrize("forward,backward", [(False, False), (True, False),
                                              (False, True)])
def test_traced_flags_equal_python_flags(recorded, forward, backward):
    from jetson_slam_tpu_torch.core.fused_track import (
        _start_pull, fused_track_device)
    step, calls = recorded
    args, kw = calls[-1]
    imgs, pred, last, cand, th_mm, th_lm, cam_params = args[:7]
    traced = _pull(step.dispatch(imgs, pred, last, cand, th_mm, th_lm, cam_params,
                                 forward, backward, eager=True))
    t = torch.as_tensor
    outs = fused_track_device(
        step.fe, tuple(t(np.asarray(a)) for a in imgs), "stereo",
        t(np.ascontiguousarray(pred[:3, :3])), t(np.ascontiguousarray(pred[:3, 3])),
        {k: t(np.asarray(v)) for k, v in last.items()},
        {k: t(np.asarray(v)) for k, v in cand.items()}, float(th_mm), float(th_lm),
        step._sf, step._inv_s2, cam_params, (0.0,) * 5, forward, backward, False)
    plain = _pull(_start_pull(outs))
    _same(traced, plain)
    assert traced[2].n_match >= 20


def test_fused_step_equals_eager_across_frames_and_buckets(recorded):
    """(b) and (c): one FusedStep over three frames, the last in bucket
    256, against the eager step on each; the first frame's device cache
    unchanged by the later frames."""
    from jetson_slam_tpu_torch.core.fused_track import FusedStep, fused_track_dispatch
    step0, calls = recorded
    step = FusedStep(step0.fe, step0.cam, "stereo", step0._sf, step0._inv_s2)
    frames = []
    for j, (args, kw) in enumerate(calls[-3:]):
        args = list(args)
        args[3] = _pad(args[3], 256 if j == 2 else 128)
        frames.append((args, kw))
    assert not np.array_equal(frames[0][0][0][0], frames[1][0][0][0])
    first_cache = None
    for args, kw in frames:
        got = _pull(step.dispatch(*args, **kw))
        want = _pull(fused_track_dispatch(step.fe, step.cam, args[0], "stereo",
                                          *args[1:6], step._sf, step._inv_s2,
                                          *args[6:], **kw))
        _same(got, want)
        if first_cache is None:
            first_cache = got[1]
            kept = {k: v.clone() for k, v in first_cache.items()}
    for k, v in kept.items():
        assert torch.equal(first_cache[k], v), k
    assert sorted(step._buckets) == [128, 256] and step.graphs_captured == 2


def _run(seq, n, **kw):
    slam = _system(seq, **kw)
    states, poses = [], []
    for i in range(n):
        state, frame = slam.track_stereo(seq.lefts[i], seq.rights[i], seq.timestamps[i])
        states.append(state.name)
        poses.append(frame.Tcw.copy())
    slam.shutdown()
    return slam, states, poses


def test_prewarmed_session_equals_unprewarmed():
    seq = _frames(10)
    cold, s0, p0 = _run(seq, 10)
    warm, s1, p1 = _run(seq, 10, prewarm=True)
    assert s0 == s1 and all(s == "OK" for s in s0)
    assert all(np.array_equal(a, b) for a, b in zip(p0, p1))
    assert warm.tracker.fused_frames == cold.tracker.fused_frames >= 7
    assert set(warm.tracker.fused_step.prewarmed) == {128, 256, 512, 1024, 2048}
    assert {128, 256, 512, 1024, 2048} <= set(warm.tracker.fused_step._buckets)


def test_prewarm_errors_raise_and_late_buckets_are_counted(recorded):
    from jetson_slam_tpu_torch.core.fused_track import FusedStep, prewarm_fused
    seq = _frames(2)
    slam = _system(seq)
    with pytest.raises(ValueError, match="power of two"):
        slam.tracker.prewarm(background=False, caps=(100,))
    t = slam.tracker.prewarm(caps=(128, 96))
    t.join(30)
    assert not t.is_alive()
    with pytest.raises(RuntimeError, match="background prewarm") as err:
        slam.track_stereo(seq.lefts[0], seq.rights[0], seq.timestamps[0])
    assert isinstance(err.value.__cause__, ValueError)
    # raised once: the session goes on
    assert slam.track_stereo(seq.lefts[1], seq.rights[1], seq.timestamps[1])[0].name == "OK"
    # a bucket past the caps: set up at its first use, counted and warned about
    step0, calls = recorded
    step = FusedStep(step0.fe, step0.cam, "stereo", step0._sf, step0._inv_s2)
    prewarm_fused(step, caps=(128,))
    assert step.graphs_captured == 1
    args, kw = calls[-1]
    args = list(args)
    args[3] = _pad(args[3], 4096)
    with pytest.warns(UserWarning, match="bucket 4096 set up at its first use"):
        _pull(step.dispatch(*args, **kw))
    assert step.graphs_captured == 2 and 4096 in step.capture_ms


def test_change_calibration_equals_fresh_session():
    seq = _frames(8)
    slam = _system(seq, prewarm=True)
    for i in range(6):
        slam.track_stereo(seq.lefts[i], seq.rights[i], seq.timestamps[i])
    step = slam.tracker.fused_step
    n_before = step.graphs_captured
    c = slam.config.camera
    new = dict(fx=c.fx * 1.01, fy=c.fy * 1.01, cx=c.cx + 1.5, cy=c.cy - 1.0, **LENS)
    slam.change_calibration(**new, bf=c.bf * 1.01)
    calls = _recorder(step)
    slam.track_stereo(seq.lefts[6], seq.rights[6], seq.timestamps[6])
    assert len(calls) == 1, "the frame after the change took no fused step"
    args, kw = calls[0]
    assert args[6][0] == pytest.approx(new["fx"])
    got = _pull(step.dispatch(*args, **kw))
    assert step._undistort and step.graphs_captured > n_before   # buckets rebuilt
    fresh = _system(seq, lens=dict(new, bf=c.bf))
    want = _pull(fresh.tracker.fused_step.dispatch(*args, **kw))
    _same(got, want)


def test_forward_step_matches_jax(jax_forward):
    from jetson_slam_tpu_torch.config import SLAMConfig
    from jetson_slam_tpu_torch.core.fused_track import FusedStep
    from jetson_slam_tpu_torch.ops.frontend import OrbFrontend
    r = jax_forward()
    seq = _frames(1)
    o = _config(SLAMConfig, seq).orb
    fe = OrbFrontend(240, 320, n_levels=o.n_levels, scale_factor=o.scale_factor,
                     fast_n_min=o.fast_n_min, fast_n_max=o.fast_n_max,
                     threshold=o.th_fast_max, tile_h=o.tile_h, tile_w=o.tile_w,
                     device="cpu")
    fe.pyramid = lambda imgs_u8: torch.as_tensor(r["pyr"])   # JAX's canvases
    cam = _config(SLAMConfig, seq).camera
    step = FusedStep(fe, cam, "stereo", torch.as_tensor(r["sf"]),
                     torch.as_tensor(r["inv_s2"]))
    last = {k: v for k, v in r["last"].items() if k != "ur"}
    pulled, _, fz_t = _pull(step.dispatch(
        tuple(r["imgs"]), r["pred"], last, r["cand"], r["th_mm"], r["th_lm"],
        r["cam_params"], True, False))
    fz_j = r["fz"]
    assert np.array_equal(pulled[0], r["valid"])
    assert np.array_equal(fz_t.m, fz_j["m"])
    assert fz_t.n_match == fz_j["n_match"] >= 20
    for k in ("R1", "t1", "R2", "t2"):
        np.testing.assert_allclose(getattr(fz_t, k), fz_j[k], atol=1e-4, rtol=0)
    for k in ("ok", "sel", "inl1", "inl2"):
        agree = (getattr(fz_t, k) == fz_j[k]).mean()
        assert agree >= 0.99, (k, agree)
