"""The port's tracking math against the JAX package on the CPU.

- pose_optimization on seeded random problems: the same inlier mask, the
  pose within 1e-4 rad and 1e-4 m (the class of TPU_PARITY.json's BA
  entries);
- the matchers: identical match indices on fixed inputs;
- one fused tracking step fed identical inputs (through convert.py):
  identical motion-model matches, poses within 1e-4, and the frustum,
  selection and inlier masks agreeing on >= 99 % of slots.
"""
import numpy as np
import pytest

pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

import jetson_slam_tpu.core.fused_track as jax_fused  # noqa: E402
from jetson_slam_tpu.config import SLAMConfig as JaxConfig  # noqa: E402
from jetson_slam_tpu.core import matcher as jm  # noqa: E402
from jetson_slam_tpu.core.frame import Frame as JaxFrame  # noqa: E402
from jetson_slam_tpu.core.optimizer import pose_optimization as jax_pose_opt  # noqa: E402
from jetson_slam_tpu.io.synthetic import make_stereo_sequence  # noqa: E402
from jetson_slam_tpu.models.slam import SlamSystem as JaxSlam  # noqa: E402
from jetson_slam_tpu_torch.config import SLAMConfig  # noqa: E402
from jetson_slam_tpu_torch.convert import fused_inputs_from_numpy  # noqa: E402
from jetson_slam_tpu_torch.core import matcher as tm  # noqa: E402
from jetson_slam_tpu_torch.core.fused_track import fused_track  # noqa: E402
from jetson_slam_tpu_torch.core.optimizer import pose_optimization  # noqa: E402
from jetson_slam_tpu_torch.ops.frontend import OrbFrontend  # noqa: E402

torch.set_num_threads(2)

FX, FY, CX, CY, BF = 300.0, 300.0, 160.0, 120.0, 120.0
SF = np.array([1.0, 1.2, 1.44], np.float32)
INV_S2 = (1.0 / SF ** 2).astype(np.float32)


def _rot(rng, scale):
    w = rng.normal(0, scale, 3)
    th = np.linalg.norm(w)
    k = w / th
    K = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    return (np.eye(3) + np.sin(th) * K + (1 - np.cos(th)) * K @ K).astype(np.float32)


def _project(R, t, pw):
    pc = pw @ R.T + t
    u = FX * pc[:, 0] / pc[:, 2] + CX
    v = FY * pc[:, 1] / pc[:, 2] + CY
    return u, v, u - BF / pc[:, 2], pc[:, 2]


def _pose_problem(seed, n=256):
    rng = np.random.default_rng(seed)
    R = _rot(rng, 0.1)
    t = rng.normal(0, 0.3, 3).astype(np.float32)
    pc = np.stack([rng.uniform(-4, 4, n), rng.uniform(-3, 3, n),
                   rng.uniform(2, 10, n)], 1)
    pw = ((pc - t) @ R).astype(np.float32)
    u, v, ur, _ = _project(R, t, pw)
    obs = np.stack([u, v], 1) + rng.normal(0, 0.5, (n, 2))
    ur = ur + rng.normal(0, 0.5, n)
    out = rng.random(n) < 0.12
    obs[out] += rng.choice([-1, 1], (out.sum(), 2)) * rng.uniform(8, 30, (out.sum(), 2))
    ur = np.where(rng.random(n) < 0.5, ur, -1.0)
    inv_s2 = INV_S2[rng.integers(0, 3, n)]
    valid = rng.random(n) < 0.9
    R0 = (_rot(rng, 0.02) @ R).astype(np.float32)
    t0 = (t + rng.normal(0, 0.05, 3)).astype(np.float32)
    return (R0, t0, pw, obs.astype(np.float32), ur.astype(np.float32),
            inv_s2.astype(np.float32), valid), (R, t)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_pose_optimization_matches_jax(seed):
    args, (R_true, t_true) = _pose_problem(seed)
    Rj, tj, inl_j, n_j = jax_pose_opt(*[jnp.asarray(a) for a in args],
                                      FX, FY, CX, CY, BF)
    Rt, tt, inl_t, n_t = pose_optimization(*[torch.as_tensor(a) for a in args],
                                           FX, FY, CX, CY, BF)
    assert np.array_equal(inl_t.numpy(), np.asarray(inl_j))
    assert int(n_t) == int(n_j)
    # elementwise, which bounds the angle between them to ~1e-4 rad (an
    # arccos of the trace drowns in the float32 rounding of the matrices)
    np.testing.assert_allclose(Rt.numpy(), np.asarray(Rj), atol=1e-4, rtol=0)
    np.testing.assert_allclose(tt.numpy(), np.asarray(tj), atol=1e-4, rtol=0)
    # and the solve is a real one: near the truth
    np.testing.assert_allclose(tt.numpy(), t_true, atol=0.05)


def _frames(seed, n_last=384, n_cur=512):
    """Two dense slot sets seeing the same points: last slots carry world
    points (some duplicated, so several pick one current slot); current
    slots hold their projections under a slightly moved pose."""
    rng = np.random.default_rng(seed)
    R = _rot(rng, 0.03)
    t = rng.normal(0, 0.05, 3).astype(np.float32)
    pc = np.stack([rng.uniform(-4, 4, n_last), rng.uniform(-3, 3, n_last),
                   rng.uniform(2, 10, n_last)], 1)
    pw = pc.astype(np.float32)
    pw[-20:] = pw[:20]                       # duplicated points
    desc_last = rng.integers(0, 256, (n_last, 32), np.uint8)
    desc_last[-20:] = desc_last[:20]
    oct_last = rng.integers(0, 3, n_last).astype(np.int32)
    oct_last[-20:] = oct_last[:20]
    ang_last = rng.uniform(0, 360, n_last).astype(np.float32)
    u, v, ur, z = _project(R, t, pw)
    perm = rng.permutation(n_cur)[:n_last]
    cur_xy = rng.uniform([0, 0], [320, 240], (n_cur, 2)).astype(np.float32)
    cur_xy[perm] = np.stack([u, v], 1) + rng.normal(0, 0.7, (n_last, 2))
    cur_desc = rng.integers(0, 256, (n_cur, 32), np.uint8)
    flips = rng.integers(0, 2, (n_last, 32)) * (1 << rng.integers(0, 8, (n_last, 32)))
    cur_desc[perm] = desc_last ^ flips.astype(np.uint8)
    cur_oct = rng.integers(0, 3, n_cur).astype(np.int32)
    cur_oct[perm] = oct_last
    cur_ang = rng.uniform(0, 360, n_cur).astype(np.float32)
    cur_ang[perm] = ang_last - 5.0 + rng.normal(0, 2, n_last)
    cur_ur = np.full(n_cur, -1.0, np.float32)
    st = rng.random(n_last) < 0.6
    cur_ur[perm[st]] = (ur + rng.normal(0, 0.5, n_last))[st]
    cur_valid = rng.random(n_cur) < 0.95
    has = rng.random(n_last) < 0.9
    real = has & (rng.random(n_last) < 0.8)
    return dict(R=R, t=t, pw=pw, has=has, real=real, oct_last=oct_last,
                ang_last=ang_last, desc_last=desc_last, cur_xy=cur_xy,
                cur_oct=cur_oct, cur_ang=cur_ang, cur_desc=cur_desc,
                cur_valid=cur_valid, cur_ur=cur_ur)


@pytest.mark.parametrize("seed,direction", [(0, (False, False)), (1, (True, False)),
                                            (2, (False, True))])
def test_motion_model_track_matches_jax(seed, direction):
    d = _frames(seed)
    fwd, bwd = direction
    j = [jnp.asarray(d[k]) for k in ("R", "t", "pw", "has", "real", "oct_last",
                                     "ang_last", "desc_last", "cur_xy", "cur_oct",
                                     "cur_ang", "cur_desc", "cur_valid", "cur_ur")]
    m_j, n_j, R_j, t_j, inl_j, nmap_j = jm.motion_model_track(
        *j[:8], np.full(384, -1.0, np.float32), *j[8:], 7.0, SF, INV_S2, 3,
        FX, FY, CX, CY, BF, BF / FX, 0.0, 320.0, 0.0, 240.0, fwd, bwd)
    # the port's last-frame u_right is not an input (the reference reads
    # last_ur only to build an unused flag)
    t_ = [torch.as_tensor(d[k]) for k in ("R", "t", "pw", "has", "real", "oct_last",
                                          "ang_last", "desc_last", "cur_xy", "cur_oct",
                                          "cur_ang", "cur_desc", "cur_valid", "cur_ur")]
    m_t, n_t, R_t, tt, inl_t, nmap_t = tm.motion_model_track(
        *t_, 7.0, torch.as_tensor(SF), torch.as_tensor(INV_S2), 3,
        FX, FY, CX, CY, BF, 0.0, 320.0, 0.0, 240.0, fwd, bwd)
    assert np.array_equal(m_t.numpy(), np.asarray(m_j))
    assert int(n_t) == int(n_j) >= 20
    assert np.array_equal(inl_t.numpy(), np.asarray(inl_j))
    assert int(nmap_t) == int(nmap_j)
    np.testing.assert_allclose(R_t.numpy(), np.asarray(R_j), atol=1e-4, rtol=0)
    np.testing.assert_allclose(tt.numpy(), np.asarray(t_j), atol=1e-4, rtol=0)


def test_local_map_track_matches_jax():
    d = _frames(5)
    rng = np.random.default_rng(5)
    C = 384
    normal = rng.normal(0, 1, (C, 3)).astype(np.float32)
    normal[:, 2] = np.abs(normal[:, 2]) + 2.0      # viewing direction ~ +z
    normal /= np.linalg.norm(normal, axis=1, keepdims=True)
    dist = np.linalg.norm(d["pw"], axis=1)
    # the predicted level of a point is its octave (ratio 1.2^(octave - 0.5))
    maxd = (dist * 1.2 ** (d["oct_last"] - 0.5)).astype(np.float32)
    mind = (maxd / 1.44 ** 2).astype(np.float32)
    alive = rng.random(C) < 0.9
    free = rng.random(512) < 0.7
    exist_pts = rng.normal(0, 1, (512, 3)).astype(np.float32)
    exist_has = ~free & (rng.random(512) < 0.5)
    common = dict(pos=d["pw"], normal=normal, maxd=maxd, mind=mind,
                  desc=d["desc_last"], alive=alive)
    Ow = (-d["R"].T @ d["t"]).astype(np.float32)
    cur = (d["cur_xy"], d["cur_oct"], d["cur_desc"], d["cur_valid"], d["cur_ur"], free,
           exist_pts, exist_has, exist_has)
    cams = (FX, FY, CX, CY, BF, 0.0, 320.0, 0.0, 240.0, float(np.log(1.2)))
    out_j = jm.local_map_track(*[jnp.asarray(common[k]) for k in common],
                               jnp.asarray(d["R"]), jnp.asarray(d["t"]), jnp.asarray(Ow),
                               *[jnp.asarray(a) for a in cur], 1.0, SF, INV_S2, 3, *cams)
    out_t = tm.local_map_track(*[torch.as_tensor(common[k]) for k in common],
                               torch.as_tensor(d["R"]), torch.as_tensor(d["t"]),
                               torch.as_tensor(Ow), *[torch.as_tensor(a) for a in cur],
                               1.0, torch.as_tensor(SF), torch.as_tensor(INV_S2), 3, *cams)
    ok_j, sel_j, R_j, t_j, inl_j, nmap_j = out_j
    ok_t, sel_t, R_t, t_t, inl_t, nmap_t = out_t
    assert np.array_equal(ok_t.numpy(), np.asarray(ok_j))
    assert np.array_equal(sel_t.numpy(), np.asarray(sel_j))
    assert (sel_t.numpy() >= 0).sum() >= 50
    assert np.array_equal(inl_t.numpy(), np.asarray(inl_j))
    assert int(nmap_t) == int(nmap_j)
    np.testing.assert_allclose(R_t.numpy(), np.asarray(R_j), atol=1e-4, rtol=0)
    np.testing.assert_allclose(t_t.numpy(), np.asarray(t_j), atol=1e-4, rtol=0)


def test_match_brute_force_and_rotation_matches_jax():
    d = _frames(7)
    a = (d["desc_last"], d["has"], d["ang_last"])
    b = (d["cur_desc"], d["cur_valid"], d["cur_ang"])
    mj, dj = jm.match_brute_force(*[jnp.asarray(x) for x in a + b], nn_ratio=0.7)
    mt, dt = tm.match_brute_force(*[torch.as_tensor(x) for x in a + b], nn_ratio=0.7)
    assert np.array_equal(mt.numpy(), np.asarray(mj))
    assert np.array_equal(dt.numpy(), np.asarray(dj))
    assert (mt.numpy() >= 0).sum() >= 50
    # tied histogram bins: the lower bin ranks first, as jax.lax.top_k does
    rot = np.repeat(np.array([24.0, 48.0, 96.0, 120.0, 200.0], np.float32), [5, 5, 5, 2, 5])
    matched = np.ones(rot.shape, bool)
    rj = jm.rotation_consistency(jnp.asarray(rot), jnp.asarray(matched))
    rt = tm.rotation_consistency(torch.as_tensor(rot), torch.as_tensor(matched))
    assert np.array_equal(rt.numpy(), np.asarray(rj))


def _configs(seq):
    cfgs = []
    for cfg in (JaxConfig(), SLAMConfig()):
        c = cfg.camera
        c.fx, c.fy, c.cx, c.cy, c.bf = seq.fx, seq.fy, seq.cx, seq.cy, seq.bf
        c.width, c.height = seq.lefts[0].shape[1], seq.lefts[0].shape[0]
        c.k1 = c.k2 = c.p1 = c.p2 = 0.0
        c.th_depth = 40.0
        cfg.orb.n_levels = 3
        cfg.orb.tile_h = cfg.orb.tile_w = 16
        cfg.orb.th_fast_max = 15
        cfg.max_map_points = 16384
        cfg.max_keyframes = 64
        cfgs.append(cfg)
    return cfgs


def test_fused_step_matches_jax(monkeypatch):
    seq = make_stereo_sequence(seed=7, n_frames=25, h=240, w=320, trajectory="arc",
                               n_points=900)
    jcfg, tcfg = _configs(seq)
    captured = {}
    orig = jax_fused.fused_track_dispatch

    def spy(*args, **kw):
        captured["args"], captured["kw"] = args, kw
        out = orig(*args, **kw)
        captured["out"] = out
        return out

    monkeypatch.setattr(jax_fused, "fused_track_dispatch", spy)
    JaxFrame._next_id = 0
    slam = JaxSlam(jcfg, sensor="stereo", enable_mapping=False)
    for i in range(3):
        slam.track_stereo(seq.lefts[i], seq.rights[i], seq.timestamps[i])
    assert "args" in captured, "the JAX tracker never took the fused path"
    (_fe, _cam, imgs, _mode, _mbf, _min_z, pred, last_state, cand, th_mm, th_lm,
     sf, inv_s2, cam_params) = captured["args"]
    _, _, fz_j = jax_fused.fused_track_pull(*captured["out"])

    o = tcfg.orb
    fe = OrbFrontend(240, 320, n_levels=o.n_levels, scale_factor=o.scale_factor,
                     fast_n_min=o.fast_n_min, fast_n_max=o.fast_n_max,
                     threshold=o.th_fast_max, tile_h=o.tile_h, tile_w=o.tile_w,
                     device="cpu")
    last, cands = fused_inputs_from_numpy(
        {k: np.asarray(v) for k, v in last_state.items()},
        {k: np.asarray(v) for k, v in cand.items()}, device="cpu")
    _, _, fz_t = fused_track(
        fe, tcfg.camera, (np.asarray(imgs[0]), np.asarray(imgs[1])), "stereo",
        np.asarray(pred),
        last, cands, th_mm, th_lm, torch.as_tensor(np.asarray(sf)),
        torch.as_tensor(np.asarray(inv_s2)), cam_params,
        bool(captured["kw"]["forward"]), bool(captured["kw"]["backward"]))
    assert np.array_equal(fz_t.m, fz_j.m)
    assert fz_t.n_match == fz_j.n_match >= 20
    for k in ("R1", "t1", "R2", "t2"):
        np.testing.assert_allclose(getattr(fz_t, k), getattr(fz_j, k), atol=1e-4,
                                   rtol=0)
    for k in ("ok", "sel", "inl1", "inl2"):
        agree = (getattr(fz_t, k) == getattr(fz_j, k)).mean()
        assert agree >= 0.99, (k, agree)
    assert (fz_t.sel >= 0).sum() > 0 or (fz_j.sel >= 0).sum() == 0
