"""Whole RGB-D and monocular sessions of the port against the JAX package on
the CPU, on tests/test_sensors_e2e.py's own sequences and geometry
(320x240, 4 levels, tile 16, mapping on, synchronous):

- RGB-D (seed 4, 12 frames), and the same sequence with a small lens
  (k1 0.04, k2 -0.01, p1 0.001, p2 -0.0005) warped into the grey and depth
  images (``io.synthetic.warp_lens``): the same per-frame states, keyframes
  created within 1, SE(3)-aligned ATE < 0.05 m in both, and the ATE gap to
  JAX within 2e-3 m (measured: 0.005099 port, 0.005984 JAX without the
  lens, 0.005003 and 0.005032 with it);
- mono (seed 6, 14 frames), the port's initializer given the minimal
  samples ``jax.random`` draws in JAX's: the same initialization frame
  (frame 1) with the same number of good points and R, t within 1e-4
  (measured 3e-5), the same states, Sim(3)-aligned ATE < 0.15 m in both,
  and the gap within 0.05 m (measured: 0.021311 port, 0.057219 JAX).  A
  mono local BA's scale is held by one fixed keyframe alone, and the
  packages damp that free direction differently on purpose (JAX by
  lam * I, the port by the blocks' diagonals): on the last mono local BA
  problem of JAX's session, in float64, the two part along the scale
  alone: scaled about the fixed camera, the port's solution is within
  1e-6 of JAX's (``test_mono_local_ba_matches_jax_in_float64``, measured
  9.4e-9);
- the RGB-D sequence with ``pipeline_depth=2`` (synchronous mapping):
  every frame OK and most of them through the fused step, so the sensor
  mode threads through the pipelined path;
- mono with loop closing on the 84-frame 1.3-lap circle of
  tests/test_loop_fuzz.py (320x240, 3 levels, the vocabulary of
  tests/test_torch_loop_closing.py's circle run), so the mapper's and the
  loop closer's mono branches (free scale in the Sim(3) and the essential
  graph) run in a whole session: the same states, at least one loop
  closed in both, every correction with a scale away from 1,
  Sim(3)-aligned ATE < 0.15 m in both, within 0.05 m of each other, and
  keyframes created within 8 (measured, the port's initializer given
  JAX's draws: one loop each, keyframe 63 onto 4 in the port and 65 onto
  4 in JAX, at scale 1.073 port and 0.818 JAX, ATE 0.017847 and 0.024220
  m, 79 and 80 keyframes; which keyframes close the loop is not held,
  since the mono local BA above decides it).

The JAX sessions run in two child processes (``InChild``) started at the
file's first test, beside the port's, which run here.
"""
import contextlib

import numpy as np
import pytest

pytest.importorskip("jax")
import jax  # noqa: E402
import torch  # noqa: E402

from jetson_slam_tpu.bow.vocabulary import Vocabulary as JaxVocabulary  # noqa: E402
from jetson_slam_tpu.config import SLAMConfig as JaxConfig  # noqa: E402
from jetson_slam_tpu.core.frame import Frame as JaxFrame  # noqa: E402
from jetson_slam_tpu.models.slam import SlamSystem as JaxSlam  # noqa: E402
from jetson_slam_tpu_torch.bow.vocabulary import Vocabulary  # noqa: E402
from jetson_slam_tpu_torch.config import SLAMConfig  # noqa: E402
from jetson_slam_tpu_torch.convert import vocabulary_from_numpy  # noqa: E402
from jetson_slam_tpu_torch.core import initializer as tinit  # noqa: E402
from jetson_slam_tpu_torch.core.frame import Frame  # noqa: E402
from jetson_slam_tpu_torch.core.local_ba import local_ba  # noqa: E402
from jetson_slam_tpu_torch.io.evaluation import ate_rmse  # noqa: E402
from jetson_slam_tpu_torch.io.synthetic import make_stereo_sequence, warp_lens  # noqa: E402
from jetson_slam_tpu_torch.models.slam import SlamSystem  # noqa: E402
from jetson_slam_tpu_torch.ops.frontend import OrbFrontend  # noqa: E402
from tests.test_torch_solvers import InChild, jax_samples  # noqa: E402

torch.set_num_threads(2)

LENS = dict(k1=0.04, k2=-0.01, p1=0.001, p2=-0.0005, k3=0.0)
ATE_GAP = 2e-3
MONO_ATE_GAP = 0.05
MONO_ATE = 0.15
LBA_KEYS = ("Rs", "ts", "fixed", "pt_pos", "e_cam", "e_pt", "obs_arr", "is_stereo",
            "inv_s2", "e_valid", "pt_edges")


def _config(cfg, seq, lens=None):
    """tests/test_sensors_e2e.py's configuration, with an optional lens."""
    c = cfg.camera
    c.fx, c.fy, c.cx, c.cy, c.bf = seq.fx, seq.fy, seq.cx, seq.cy, seq.bf
    c.width, c.height = 320, 240
    c.k1 = c.k2 = c.p1 = c.p2 = c.k3 = 0.0
    for k, v in (lens or {}).items():
        setattr(c, k, v)
    cfg.orb.n_levels, cfg.orb.tile_h, cfg.orb.tile_w = 4, 16, 16
    return cfg


def _sequences():
    rgbd = make_stereo_sequence(seed=4, n_frames=12, h=240, w=320, with_depth=True)
    cam = _config(SLAMConfig(), rgbd, LENS).camera
    lens = dict(lefts=[warp_lens(im, cam, order=1) for im in rgbd.lefts],
                depths=[warp_lens(d, cam, order=0) for d in rgbd.depths])
    mono = make_stereo_sequence(seed=6, n_frames=14, h=240, w=320)
    return rgbd, lens, mono


def _session(slam, sensor, seq, lefts=None, depths=None):
    """Track the sequence; (per-frame state names, keyframes created, ATE,
    fused frames).  RGB-D is aligned in SE(3), mono in Sim(3)."""
    lefts = lefts or seq.lefts
    depths = depths or seq.depths
    states = []
    for i in range(len(lefts)):
        if sensor == "rgbd":
            state, _ = slam.track_rgbd(lefts[i], depths[i], seq.timestamps[i])
        else:
            state, _ = slam.track_monocular(lefts[i], seq.timestamps[i])
        states.append(state.name)
    slam.shutdown()
    ts, poses = slam.camera_trajectory()
    ate = ate_rmse(np.asarray(ts), np.asarray(poses), seq.timestamps, seq.poses_twc,
                   with_scale=sensor == "mono")
    return dict(states=states, created=int(slam.map.kf_gen.sum()), ate=ate,
                fused=slam.tracker.fused_frames)


def _kept_inits(cls):
    """Wrap cls.initialize to keep (ok, (R, t, good points) or None) of
    each call; returns the list and the original."""
    kept = []
    orig = cls.initialize

    def initialize(self, *args):
        out = orig(self, *args)
        kept.append((out[0], None if not out[0] else (out[1], out[2], int(out[4].sum()))))
        return out

    cls.initialize = initialize
    return kept, orig


def _jax_sessions(seqs):
    """The JAX package's three sessions (run in a child process); they
    share one front-end, whose programs compile once.  The mono session
    also returns its last local BA problem (float64) with JAX's float64
    solution of it."""
    import jax.numpy as jnp
    import jetson_slam_tpu.core.initializer as jinit
    import jetson_slam_tpu.core.local_mapping as jlm
    from jetson_slam_tpu.core.local_ba import local_ba as jax_local_ba
    rgbd, lens, mono = seqs
    out = {}
    kept, _ = _kept_inits(jinit.MonoInitializer)
    preps = []
    prepare = jlm.LocalMapper._lba_prepare

    def kept_prepare(self, kid):
        prep = prepare(self, kid)
        if prep is not None:
            preps.append([np.array(prep[k]) for k in LBA_KEYS])
        return prep

    fe = None
    for name, sensor, seq, lens_model, imgs in (
            ("rgbd", "rgbd", rgbd, None, {}), ("rgbd_lens", "rgbd", rgbd, LENS, lens),
            ("mono", "mono", mono, None, {})):
        JaxFrame._next_id = 0
        slam = JaxSlam(_config(JaxConfig(), seq, lens_model), sensor=sensor)
        fe = fe or slam.frontend
        slam.frontend = slam.tracker.frontend = fe
        jlm.LocalMapper._lba_prepare = kept_prepare if sensor == "mono" else prepare
        out[name] = _session(slam, sensor, seq, **imgs)
    jlm.LocalMapper._lba_prepare = prepare
    out["mono"]["inits"] = kept
    c = slam.config.camera
    cam = (c.fx, c.fy, c.cx, c.cy, c.bf)
    inp = [a.astype(np.float64) if a.dtype == np.float32 else a for a in preps[-1]]
    with jax.enable_x64(True):
        sol = [np.asarray(o) for o in jax_local_ba(*map(jnp.asarray, inp), *cam)]
    out["mono"]["lba"] = (inp, cam, sol)
    return out


def _circle():
    """The 1.3-lap circle (seed 3, 84 frames) and the arrays of a vocabulary
    trained on three of its frames (k=6, L=3, seed 0)."""
    seq = make_stereo_sequence(seed=3, n_frames=84, h=240, w=320, trajectory="circle",
                               n_points=1200, laps=1.3)
    fe = OrbFrontend(240, 320, n_levels=3, scale_factor=1.2, threshold=15, tile_h=16,
                     tile_w=16, device="cpu")
    descs = []
    for i in (0, len(seq.lefts) // 3, 2 * len(seq.lefts) // 3):
        r = fe.extract(seq.lefts[i])
        descs.append(r.desc.numpy()[r.valid.numpy()])
    voc = Vocabulary.train(np.concatenate(descs), k=6, L=3, seed=0)
    return seq, (voc.k, voc.L, voc.children, voc.centroids, voc.is_leaf, voc.word_id,
                 voc.weights, voc.node_level)


def _circle_config(cfg, seq):
    """tests/test_slam_e2e.py's make_system configuration, with room for
    mono's keyframe rate."""
    c = cfg.camera
    c.fx, c.fy, c.cx, c.cy, c.bf = seq.fx, seq.fy, seq.cx, seq.cy, seq.bf
    c.width, c.height = 320, 240
    c.k1 = c.k2 = c.p1 = c.p2 = 0.0
    c.th_depth = 40.0
    cfg.orb.n_levels, cfg.orb.tile_h, cfg.orb.tile_w = 3, 16, 16
    cfg.orb.th_fast_max = 15
    cfg.max_map_points, cfg.max_keyframes = 16384, 128
    return cfg


def _circle_session(slam, seq):
    """The mono circle with its loop corrections (keyframe, loop keyframe,
    scale)."""
    lc = slam.loop_closer
    events = []
    orig = lc.correct_loop

    def correct(kid, loop_kf, s, *args, **kw):
        events.append((int(kid), int(loop_kf), float(s)))
        return orig(kid, loop_kf, s, *args, **kw)

    lc.correct_loop = correct
    out = _session(slam, "mono", seq)
    out.update(events=events, loops=lc.n_loops_closed)
    return out


def _jax_circle(seq, tree):
    """The JAX package's mono circle (run in a child process)."""
    JaxFrame._next_id = 0
    slam = JaxSlam(_circle_config(JaxConfig(), seq), sensor="mono",
                   vocabulary=JaxVocabulary(*tree))
    return _circle_session(slam, seq)


@contextlib.contextmanager
def _jax_draws():
    """The port's initializer draws JAX's samples (PRNGKey(42), split once);
    yields the kept initialize results and the draws' pool sizes."""
    key = jax.random.split(jax.random.PRNGKey(42))[1]
    attempts = []

    def sample(self, n_valid):
        attempts.append(n_valid)
        return jax_samples(key, self.n_hyp, 8, n_valid)

    orig = tinit.MonoInitializer._sample
    tinit.MonoInitializer._sample = sample
    kept, orig_init = _kept_inits(tinit.MonoInitializer)
    try:
        yield kept, attempts
    finally:
        tinit.MonoInitializer._sample = orig
        tinit.MonoInitializer.initialize = orig_init


@pytest.fixture(scope="module")
def seqs():
    return _sequences()


@pytest.fixture(scope="module")
def circle():
    return _circle()


@pytest.fixture(scope="module", autouse=True)
def jax_child(seqs):
    """The JAX sessions, started in a child process at the first test of
    this file, so that they run beside the port's."""
    child = InChild(_jax_sessions)
    child.start(seqs)
    yield child
    child.close()


@pytest.fixture(scope="module", autouse=True)
def jax_circle_child(circle):
    """The JAX package's mono circle, in a second child started with the
    first."""
    child = InChild(_jax_circle)
    child.start(*circle)
    yield child
    child.close()


@pytest.fixture(scope="module")
def jax_runs(jax_child, port_runs, port_circle):
    """The child's result, waited for once the port's sessions have run."""
    return jax_child.result()


@pytest.fixture(scope="module")
def port_circle(circle):
    seq, tree = circle
    with _jax_draws():
        Frame._next_id = 0
        slam = SlamSystem(_circle_config(SLAMConfig(), seq), sensor="mono", device="cpu",
                          vocabulary=vocabulary_from_numpy(vars(JaxVocabulary(*tree))))
        return _circle_session(slam, seq)


@pytest.fixture(scope="module")
def port_runs(seqs):
    rgbd, lens, mono = seqs
    out = {}
    for name, seq, lens_model, imgs in (("rgbd", rgbd, None, {}),
                                        ("rgbd_lens", rgbd, LENS, lens)):
        Frame._next_id = 0
        slam = SlamSystem(_config(SLAMConfig(), seq, lens_model), sensor="rgbd",
                          device="cpu")
        out[name] = _session(slam, "rgbd", seq, **imgs)
    with _jax_draws() as (kept, attempts):
        Frame._next_id = 0
        slam = SlamSystem(_config(SLAMConfig(), mono), sensor="mono", device="cpu")
        out["mono"] = _session(slam, "mono", mono)
    out["mono"]["inits"] = kept
    out["mono"]["init_attempts"] = len(attempts)
    return out


def _report(name, got, want):
    print(f"{name}: port {got['states']}, ATE {got['ate']:.6f} m, {got['created']} "
          f"keyframes, {got['fused']} fused; jax ATE {want['ate']:.6f} m, "
          f"{want['created']} keyframes, {want['fused']} fused")


@pytest.mark.parametrize("name", ["rgbd", "rgbd_lens"])
def test_rgbd_session_matches_jax(name, port_runs, jax_runs):
    got, want = port_runs[name], jax_runs[name]
    _report(name, got, want)
    assert want["states"] == ["OK"] * 12
    assert got["states"] == want["states"]
    assert abs(got["created"] - want["created"]) <= 1
    assert got["ate"] < 0.05 and want["ate"] < 0.05
    assert abs(got["ate"] - want["ate"]) <= ATE_GAP
    assert got["fused"] >= 12 - 4


def test_mono_session_matches_jax(port_runs, jax_runs):
    got, want = port_runs["mono"], jax_runs["mono"]
    _report("mono", got, want)
    first = want["states"].index("OK")
    assert first <= 2 and got["init_attempts"] == len(got["inits"]) >= 1
    assert got["states"] == want["states"]
    assert want["states"][first:] == ["OK"] * (14 - first)
    # the same attempts, the last one accepted with the same two-view pose
    assert [ok for ok, _ in got["inits"]] == [ok for ok, _ in want["inits"]]
    (R, t, n_good), (R_j, t_j, n_good_j) = got["inits"][-1][1], want["inits"][-1][1]
    assert n_good == n_good_j >= 30
    np.testing.assert_allclose(R, R_j, atol=1e-4, rtol=0)
    np.testing.assert_allclose(t, t_j, atol=1e-4, rtol=0)
    assert got["ate"] < MONO_ATE and want["ate"] < MONO_ATE
    assert abs(got["ate"] - want["ate"]) <= MONO_ATE_GAP
    assert got["fused"] > 0


def test_mono_local_ba_matches_jax_in_float64(jax_runs):
    """The last mono local BA problem of JAX's session (one fixed keyframe
    holds its scale; 12 free cameras, 2764 mono edges) solved by both
    packages in float64.  The two damp such a problem differently on
    purpose: JAX by lam * I, the port, the problem having no depth edge, by
    the blocks' own diagonals, which keeps the free scale from running
    (tests/test_torch_mono_tracking.py).  So the solutions part along the
    scale alone (camera centres 1.4e-3 apart and points 2.0e-2; the points'
    median distance 1.0018 of its start in the port, 1.0058 in JAX): the
    fixed cameras, every rotation, and every free camera centre and point
    once the port's solution is scaled about the fixed camera's centre (by
    1.0040) are within 1e-6 of JAX's (measured 9.4e-9), and the outliers
    identical."""
    inp, cam, want = jax_runs["mono"]["lba"]
    got = [o.numpy() for o in local_ba(*map(torch.as_tensor, inp), *cam)]
    fixed = inp[2].astype(bool)
    assert got[2].dtype == np.float64 and not fixed.all()    # a camera is free
    assert not (inp[7] & inp[9]).any()                      # no depth edge
    np.testing.assert_array_equal(got[3], want[3])
    np.testing.assert_allclose(got[0], want[0], atol=1e-6, rtol=0)
    np.testing.assert_allclose(got[1][fixed], want[1][fixed], atol=1e-6, rtol=0)
    seen = np.zeros(len(fixed), bool)
    seen[inp[4][inp[9]]] = True
    (anchor,) = np.flatnonzero(fixed & seen)                # one holds the gauge
    live = (inp[10] >= 0).any(1)
    np.testing.assert_allclose(got[2][~live], want[2][~live], atol=1e-6, rtol=0)

    def free_part(R, t, p):
        centres = -np.einsum("cji,cj->ci", R, t)
        return np.concatenate([centres[~fixed], p[live]]) - centres[anchor]
    x_got, x_want = free_part(*got[:3]), free_part(*want[:3])
    s = (x_got * x_want).sum() / (x_got * x_got).sum()
    np.testing.assert_allclose(s * x_got, x_want, atol=1e-6, rtol=0)
    pts0, P = inp[3], int(live.sum())
    scale = np.median(np.linalg.norm(got[2][:P], axis=1)) / np.median(np.linalg.norm(pts0[:P], axis=1))
    assert abs(scale - 1.0) < 0.01, scale


def test_rgbd_pipelined_every_frame_ok(seqs):
    rgbd = seqs[0]
    Frame._next_id = 0
    slam = SlamSystem(_config(SLAMConfig(), rgbd), sensor="rgbd", device="cpu",
                      pipeline_depth=2)
    calls = [slam.track_rgbd(rgbd.lefts[i], rgbd.depths[i], rgbd.timestamps[i])
             for i in range(len(rgbd.lefts))]
    slam.shutdown()
    traj = slam.tracker.trajectory
    assert all(state.name == "OK" for state, _ in calls)
    assert len(traj) == 12 and not any(e[3] for e in traj)
    assert any(frame is None for _, frame in calls)     # frames were in flight
    assert slam.tracker.fused_frames >= 12 - 4
    ts, poses = slam.camera_trajectory()
    assert ate_rmse(np.asarray(ts), np.asarray(poses), rgbd.timestamps,
                    rgbd.poses_twc) < 0.05


def test_mono_circle_closes_loops_like_jax(circle, port_circle, jax_circle_child):
    seq = circle[0]
    got, want = port_circle, jax_circle_child.result()
    print(f"mono circle: port loops {got['events']}, ATE {got['ate']:.6f} m, "
          f"{got['created']} keyframes; jax loops {want['events']}, ATE "
          f"{want['ate']:.6f} m, {want['created']} keyframes")
    first = want["states"].index("OK")
    assert want["states"][first:] == ["OK"] * (len(seq.lefts) - first)
    assert got["states"] == want["states"]
    for run in (got, want):
        assert run["loops"] >= 1 and len(run["events"]) == run["loops"]
        assert all(abs(s - 1.0) > 0.01 for _, _, s in run["events"])   # scale free
        assert run["ate"] < MONO_ATE
    assert abs(got["ate"] - want["ate"]) <= MONO_ATE_GAP
    assert abs(got["created"] - want["created"]) <= 8
