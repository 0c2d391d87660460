"""Relocalization of the port against the JAX package on the CPU.

Both packages track tests/test_relocalization.py's scene (seed 2, 320x240,
4 levels, tile 16, mapping on) for 12 frames, see 3 black frames, then
frame 5 again, once without a vocabulary (the rotating candidate window)
and once with the bundled small vocabulary (BoW candidates):

- identical per-frame states (12 OK, 3 LOST, OK), and the relocalized
  pose within 0.05 m of the truth, of the pose tracked at frame 5 and of
  the JAX package's (measured 0.0187 m, 0.0170 m and 1.9e-4 m);
- ``_batched_reloc`` on the JAX run's own inputs, given the minimal
  samples that ``jax.random`` draws there: identical n_match, n_final,
  matches and inliers, R and t within 1e-3;
- the narrow retry's ORBdist=64 gate of the projection search (port of
  tests/test_relocalization.py::test_projection_orb_dist_gate);
- without a vocabulary, the first attempt's eight candidates are the eight
  newest keyframes also after culling has recycled low rows.

The JAX sessions run in a child process (``InChild``), beside the port's
sessions, which run here.
"""
import numpy as np
import pytest

pytest.importorskip("jax")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

import jetson_slam_tpu.core.tracking as jtrack  # noqa: E402
from jetson_slam_tpu.bow.vocabulary import bundled_vocabulary as jax_vocab  # noqa: E402
from jetson_slam_tpu.config import SLAMConfig as JaxConfig  # noqa: E402
from jetson_slam_tpu.core.frame import Frame as JaxFrame  # noqa: E402
from jetson_slam_tpu.models.slam import SlamSystem as JaxSlam  # noqa: E402
from jetson_slam_tpu_torch.bow.vocabulary import bundled_vocabulary  # noqa: E402
from jetson_slam_tpu_torch.config import SLAMConfig  # noqa: E402
from jetson_slam_tpu_torch.core import matcher  # noqa: E402
from jetson_slam_tpu_torch.core import tracking as ttrack  # noqa: E402
from jetson_slam_tpu_torch.core.frame import Frame  # noqa: E402
from jetson_slam_tpu_torch.io.synthetic import make_stereo_sequence  # noqa: E402
from jetson_slam_tpu_torch.models.slam import SlamSystem  # noqa: E402
from tests.test_torch_solvers import InChild  # noqa: E402

torch.set_num_threads(2)

VIEW = 5


@pytest.fixture(scope="module")
def seq():
    return make_stereo_sequence(seed=2, n_frames=12, h=240, w=320)


def _config(cfg, seq):
    c = cfg.camera
    c.fx, c.fy, c.cx, c.cy, c.bf = seq.fx, seq.fy, seq.cx, seq.cy, seq.bf
    c.width, c.height = 320, 240
    c.k1 = c.k2 = c.p1 = c.p2 = 0.0
    cfg.orb.n_levels, cfg.orb.tile_h, cfg.orb.tile_w = 4, 16, 16
    return cfg


def _lost_then_relocalize(slam, seq):
    """12 frames, 3 black frames, frame VIEW again: (state names, tracked
    Tcw of frame VIEW, relocalized frame's Tcw)."""
    states, est = [], None
    for i in range(len(seq.lefts)):
        state, fr = slam.track_stereo(seq.lefts[i], seq.rights[i], seq.timestamps[i])
        states.append(state.name)
        if i == VIEW:
            est = fr.Tcw.copy()
    black = np.zeros((240, 320), np.uint8)
    for j in range(3):
        state, _ = slam.track_stereo(black, black, 100.0 + j)
        states.append(state.name)
    state, fr = slam.track_stereo(seq.lefts[VIEW], seq.rights[VIEW], 200.0)
    states.append(state.name)
    slam.shutdown()
    return states, est, fr.Tcw.copy()


def _jax_sessions(seq):
    """Both JAX sessions (run in a child process); the no-vocabulary one
    also keeps the inputs and outputs of its last _batched_reloc call, as
    numpy."""
    out = {}
    calls = []
    orig = jtrack._batched_reloc

    def kept(*args):
        res = orig(*args)
        calls.append((args, res))
        return res

    fe = None
    for name, vocab in (("none", None), ("small", jax_vocab("small"))):
        JaxFrame._next_id = 0
        jtrack._batched_reloc = kept
        try:
            slam = JaxSlam(_config(JaxConfig(), seq), sensor="stereo", vocabulary=vocab)
            # the JAX package compiles per front-end instance: the second
            # session reuses the first one's (same configuration)
            fe = fe or slam.frontend
            slam.frontend = slam.tracker.frontend = fe
            out[name] = _lost_then_relocalize(slam, seq)
        finally:
            jtrack._batched_reloc = orig
        if name == "none":
            args, res = calls[-1]
            out["call"] = (tuple(np.asarray(a) if isinstance(a, jax.Array) else a
                                 for a in args), tuple(np.asarray(a) for a in res))
    return out


@pytest.fixture(scope="module", autouse=True)
def jax_child():
    """The JAX sessions, started in a child process at the first test of
    this file, so that they run beside the port's."""
    child = InChild(_jax_sessions)
    child.start(make_stereo_sequence(seed=2, n_frames=12, h=240, w=320))
    yield child
    child.close()


@pytest.fixture(scope="module")
def port_runs(seq):
    out = {}
    for name, vocab in (("none", None), ("small", bundled_vocabulary("small"))):
        Frame._next_id = 0
        slam = SlamSystem(_config(SLAMConfig(), seq), sensor="stereo", device="cpu",
                          vocabulary=vocab)
        out[name] = _lost_then_relocalize(slam, seq)
    return out


@pytest.fixture(scope="module")
def jax_runs(jax_child, port_runs):
    """The child's result, waited for once the port's sessions have run."""
    return jax_child.result()


@pytest.mark.parametrize("vocab", ["none", "small"])
def test_lost_then_relocalize_matches_jax(vocab, jax_runs, port_runs, seq):
    j_states, j_est, j_pose = jax_runs[vocab]
    t_states, t_est, t_pose = port_runs[vocab]
    want = ["OK"] * 12 + ["LOST"] * 3 + ["OK"]
    assert j_states == want
    assert t_states == j_states
    truth = np.linalg.inv(seq.poses_twc[VIEW])[:3, 3]
    gaps = (np.linalg.norm(t_pose[:3, 3] - truth), np.linalg.norm(t_pose[:3, 3] - t_est[:3, 3]),
            np.linalg.norm(t_pose[:3, 3] - j_pose[:3, 3]))
    print(f"relocalized pose: {gaps[0]:.6f} m from the truth, {gaps[1]:.6f} m from "
          f"frame {VIEW}'s tracked pose, {gaps[2]:.6f} m from JAX's")
    assert max(gaps) < 0.05


def test_batched_reloc_matches_jax(jax_runs):
    """The JAX run's last relocalization, its inputs fed to the port with
    the samples jax.random drew for each candidate's PnP."""
    args, res = jax_runs["call"]
    (f_desc, f_valid, f_angle, f_xy, f_ur, f_octave, f_inv_s2, c_desc, c_has,
     c_angle, c_octave, _c_ur, c_pw, c_R, c_t, sf, n_levels, fx, fy, cx, cy, bf,
     _mb, min_x, max_x, min_y, max_y, key) = args
    n_match, n_final, R, t, inlier, match = (np.asarray(a) for a in res)
    C = c_desc.shape[0]
    keys = jax.random.split(key, C)
    draw = jax.vmap(lambda kk, n: jax.random.randint(kk, (4,), 0, n))
    sample = torch.stack([torch.as_tensor(np.asarray(draw(
        jax.random.split(keys[c], 256), jnp.full(256, max(int(n_match[c]), 1))))
        .astype(np.int64)) for c in range(C)])
    T = lambda a: torch.as_tensor(np.array(a))  # noqa: E731
    got = ttrack._batched_reloc(
        T(f_desc), T(f_valid), T(f_angle), T(f_xy), T(f_ur), T(f_octave),
        T(f_inv_s2), T(c_desc), T(c_has), T(c_angle), T(c_octave), T(c_pw), T(c_R),
        T(c_t), T(np.asarray(sf, np.float32)), n_levels, fx, fy, cx, cy, bf,
        min_x, max_x, min_y, max_y, sample)
    g = [a.numpy() for a in got]
    assert (n_final >= 20).any()
    assert np.array_equal(g[0], n_match)
    assert np.array_equal(g[1], n_final)
    assert np.array_equal(g[5], match)
    assert np.array_equal(g[4], inlier)
    np.testing.assert_allclose(g[2], R, atol=1e-3, rtol=0)
    np.testing.assert_allclose(g[3], t, atol=1e-3, rtol=0)


def test_projection_orb_dist_gate():
    """The narrow retry searches with ORBdist=64 instead of TH_HIGH
    (Tracking.cpp:2090): a candidate at Hamming distance 80 matches under
    the default gate and not under orb_dist=64."""
    rng = np.random.default_rng(0)
    S = 128
    base = rng.integers(0, 256, 32).astype(np.uint8)
    d80 = base.copy()
    d80[:10] ^= 0xFF
    assert np.unpackbits(base ^ d80).sum() == 80
    last_desc = np.tile(base, (S, 1))
    last_desc[1:] = 0
    cur_desc = np.tile(d80, (S, 1))
    cur_desc[1:] = 255
    pw = np.zeros((S, 3), np.float32)
    pw[:, 2] = 5.0
    has = np.zeros(S, bool)
    has[0] = True
    xy = np.full((S, 2), -1e6, np.float32)
    xy[0] = (160.0, 120.0)
    valid = np.zeros(S, bool)
    valid[0] = True
    T = torch.as_tensor

    def search(orb_dist):
        return matcher.search_by_projection_last(
            torch.eye(3), torch.zeros(3), T(pw), T(has), torch.zeros(S, dtype=torch.int32),
            torch.zeros(S), T(last_desc), T(xy), torch.zeros(S, dtype=torch.int32),
            torch.zeros(S), T(cur_desc), T(valid), torch.full((S,), -1.0), 10.0,
            torch.ones(4), 4, 260.0, 260.0, 160.0, 120.0, 20.0, 0.0, 320.0, 0.0,
            240.0, False, False, orb_dist=orb_dist)

    assert int(search(None)[0]) == 0      # TH_HIGH = 100 accepts 80
    assert int(search(64)[0]) == -1       # ORBdist = 64 rejects it


def test_reloc_window_is_newest_first_after_row_recycling():
    """The rotating window's first attempt takes the eight newest keyframes
    (by frame id), not the eight highest rows: culling frees low rows and
    the newest keyframes land there."""
    from jetson_slam_tpu_torch.core.map import MapStore
    from jetson_slam_tpu_torch.ops.frontend import OrbFrontend
    fe = OrbFrontend(120, 160, n_levels=2, tile_h=16, tile_w=16, device="cpu")
    cfg = SLAMConfig()
    S = fe.n_slots_padded
    m = MapStore(max_points=256, max_keyframes=32, n_slots=S)
    tracker = ttrack.Tracker(fe, cfg.camera, m)

    class F:
        timestamp = 0.0
        kp_xy = np.zeros((S, 2), np.float32)
        octave = np.zeros(S, np.int32)
        angle = np.zeros(S, np.float32)
        u_right = np.full(S, -1.0, np.float32)
        depth = np.full(S, -1.0, np.float32)
        desc = np.zeros((S, 32), np.uint8)
        valid = np.ones(S, bool)
        map_points = np.full(S, -1, np.int32)

    def add(frame_id):
        f = F()
        f.frame_id = frame_id
        f.Tcw = np.eye(4, dtype=np.float32)
        f.Tcw[0, 3] = frame_id       # the candidates' poses say who they are
        return m.add_keyframe(f)

    for i in range(12):
        add(i)                       # rows 0..11
    for k in (2, 3, 4):
        m.erase_keyframe(k)
    rows = [add(i) for i in (12, 13, 14)]
    assert sorted(rows) == [2, 3, 4]
    seen = []

    def spy(*args):
        c_t = args[13]
        seen.append([int(round(float(x))) for x in c_t[:, 0]])
        C, S_f = c_t.shape[0], args[0].shape[0]
        z = torch.zeros(C, dtype=torch.int64)
        return (z, z, torch.eye(3).expand(C, 3, 3), torch.zeros(C, 3),
                torch.zeros(C, S_f, dtype=torch.bool),
                torch.full((C, S_f), -1, dtype=torch.int64))

    rng = np.random.default_rng(0)
    frame = Frame.from_arrays(fe, cfg.camera, 0.0, np.ones(S, bool),
                              rng.uniform(30, 130, S).astype(np.float32),
                              rng.uniform(30, 90, S).astype(np.float32),
                              np.zeros(S, np.int32), np.zeros(S, np.float32),
                              rng.integers(0, 256, (S, 32)).astype(np.uint8),
                              np.full(S, -1.0, np.float32), np.full(S, -1.0, np.float32))
    orig = ttrack._batched_reloc
    ttrack._batched_reloc = spy
    try:
        assert not tracker._relocalization(frame)
    finally:
        ttrack._batched_reloc = orig
    assert seen == [[14, 13, 12, 11, 10, 9, 8, 7]]
