"""The port's mono initializer, lens undistortion and mono / RGB-D fused
step against the JAX package on the CPU, on the same numpy-seeded inputs.

- ``MonoInitializer`` given the minimal samples that ``jax.random`` draws
  inside the JAX initializer, on a planar scene (H wins) and a general 3D
  scene (F wins): every hypothesis's SH within rtol 1e-4, and its SF on
  98 % of the samples of 8 distinct matches (measured 187 and 188 of 190; a
  repeated match leaves F undetermined), the best SH and SF on the same
  hypotheses within rtol 1e-4, the same model, identical inlier and good
  masks, R and t within 1e-4 and the points within 1e-3 relative;
- ``undistort_points`` (host) and ``undistort_device`` against JAX's
  ``undistort_points`` and ``_undistort_device`` with the lens models of
  ``TUM1_rgbd.yaml`` and ``EuRoC_mono.yaml``: the same float32 chain, held
  within 1e-3 px (measured: 1.2e-4 px; JAX's own 2e-2 in
  tests/test_fused_track.py compares float32 with float64);
- one fused step in ``rgbd`` and in ``mono`` mode with a lens, fed the
  inputs the JAX tracker gave its own fused step and the JAX pyramid (the
  exact resize differs from it on a few pixels, which moves a subpixel
  keypoint by up to 4e-3 px), as
  tests/test_torch_tracking.py::test_fused_step_matches_jax does for
  stereo: identical valid slots and depths, the virtual right coordinate
  within 1e-4 px, identical motion-model matches, poses within 1e-4.
"""
import numpy as np
import pytest

pytest.importorskip("jax")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

import jetson_slam_tpu.core.fused_track as jax_fused  # noqa: E402
import jetson_slam_tpu.core.initializer as jinit  # noqa: E402
from jetson_slam_tpu.config import SLAMConfig as JaxConfig  # noqa: E402
from jetson_slam_tpu.core.frame import Frame as JaxFrame  # noqa: E402
from jetson_slam_tpu.core.frame import undistort_points as jax_undistort  # noqa: E402
from jetson_slam_tpu.models.slam import SlamSystem as JaxSlam  # noqa: E402
from jetson_slam_tpu_torch.config import SLAMConfig, load_config  # noqa: E402
from jetson_slam_tpu_torch.convert import fused_inputs_from_numpy  # noqa: E402
from jetson_slam_tpu_torch.core import initializer as tinit  # noqa: E402
from jetson_slam_tpu_torch.core.frame import undistort_points  # noqa: E402
from jetson_slam_tpu_torch.core.fused_track import fused_track, undistort_device  # noqa: E402
from jetson_slam_tpu_torch.io.synthetic import make_stereo_sequence, warp_lens  # noqa: E402
from jetson_slam_tpu_torch.ops.frontend import OrbFrontend  # noqa: E402
from tests.test_torch_frontend import use_jax_pyramid  # noqa: E402
from tests.test_torch_solvers import jax_samples  # noqa: E402

torch.set_num_threads(2)

FX, FY, CX, CY = 300.0, 300.0, 160.0, 120.0
N_HYP = 200


def _rot(w):
    th = np.linalg.norm(w)
    k = np.asarray(w) / th
    K = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    return np.eye(3) + np.sin(th) * K + (1 - np.cos(th)) * K @ K


def _two_views(planar: bool, seed: int, n=300):
    """Matches of n points seen from the origin and from a second camera,
    with 0.3 px noise and 10 % outliers."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(-3.0, 3.0, n)
    y = rng.uniform(-2.0, 2.0, n)
    z = 6.0 + 0.3 * x - 0.2 * y if planar else rng.uniform(4.0, 10.0, n)
    pw = np.stack([x * z / 6.0, y * z / 6.0, z], 1)
    R = _rot([0.02, -0.04, 0.01])
    t = np.array([0.35, 0.05, 0.03])

    def project(pc):
        return np.stack([FX * pc[:, 0] / pc[:, 2] + CX, FY * pc[:, 1] / pc[:, 2] + CY], 1)

    kp1 = project(pw) + rng.normal(0, 0.3, (n, 2))
    kp2 = project(pw @ R.T + t) + rng.normal(0, 0.3, (n, 2))
    out = rng.random(n) < 0.1
    kp2[out] += rng.uniform(-40, 40, (out.sum(), 2))
    return kp1.astype(np.float32), kp2.astype(np.float32)


def _jax_hypotheses(kp1, kp2, valid):
    """JAX's vmapped hypotheses, exactly as MonoInitializer.initialize
    builds them (PRNGKey(42), one split, 200 subkeys)."""
    ini = jinit.MonoInitializer(FX, FY, CX, CY)
    _, k1 = jax.random.split(ini._key)
    p1, p2 = jnp.asarray(kp1), jnp.asarray(kp2)
    vmask = jnp.asarray(valid)
    idx_pool = jnp.flatnonzero(vmask, size=len(kp1), fill_value=0)
    n_valid = jnp.sum(vmask)
    p1n_, T1 = jinit._normalize(p1)
    p2n_, T2 = jinit._normalize(p2)

    def hyp(key):
        sel = jnp.take(idx_pool, jax.random.randint(key, (8,), 0, jnp.maximum(n_valid, 1)))
        H21 = jnp.linalg.inv(T2) @ jinit._dlt_h(p1n_[sel], p2n_[sel]) @ T1
        H21 = H21 / jnp.where(jnp.abs(H21[2, 2]) > 1e-12, H21[2, 2], 1.0)
        F21 = T2.T @ jinit._dlt_f(p1n_[sel], p2n_[sel]) @ T1
        sh, _ = jinit._score_h(H21, p1, p2, vmask, 1.0)
        sf, _ = jinit._score_f(F21, p1, p2, vmask, 1.0)
        return sh, sf

    sh, sf = jax.vmap(hyp)(jax.random.split(k1, N_HYP))
    return np.asarray(sh), np.asarray(sf), jax_samples(k1, N_HYP, 8, int(valid.sum()))


def _spied_jax_initialize(kp1, kp2, valid):
    """JAX's initialize, with the model it decomposed and the inlier mask
    its CheckRT saw."""
    ini = jinit.MonoInitializer(FX, FY, CX, CY)
    seen = {}
    for name in ("_decompose_h", "_decompose_f"):
        orig = getattr(ini, name)

        def spy(M, _orig=orig, _name=name):
            seen["model"] = _name[-1]
            return _orig(M)
        setattr(ini, name, spy)
    orig_check = jinit._triangulate_and_check

    def check(R, t, p1n, p2n, inl, *a):
        seen["inl"] = np.asarray(inl)
        return orig_check(R, t, p1n, p2n, inl, *a)

    jinit._triangulate_and_check = check
    try:
        out = ini.initialize(kp1, kp2, valid)
    finally:
        jinit._triangulate_and_check = orig_check
    return out, seen


@pytest.mark.parametrize("planar,model", [(True, "h"), (False, "f")],
                         ids=["planar_h", "general_f"])
def test_mono_initializer_matches_jax(planar, model):
    kp1, kp2 = _two_views(planar, seed=3 if planar else 4)
    valid = np.ones(len(kp1), bool)
    sh_j, sf_j, sample = _jax_hypotheses(kp1, kp2, valid)
    (ok_j, R_j, t_j, X_j, good_j), seen = _spied_jax_initialize(kp1, kp2, valid)
    assert ok_j and seen["model"] == model

    ini = tinit.MonoInitializer(FX, FY, CX, CY, "cpu")
    ini._sample = lambda n_valid: sample
    sh, _, sf, _ = ini.hypotheses(torch.as_tensor(kp1), torch.as_tensor(kp2),
                                  torch.as_tensor(valid), sample)
    sh, sf = sh.numpy(), sf.numpy()
    np.testing.assert_allclose(sh, sh_j, rtol=1e-4, atol=1e-3)
    # F: a sample that repeats a match leaves a 2-D null space, whose
    # vector each SVD picks its own way; those scores are not compared,
    # and a well-posed sample may still sit near such a degeneracy
    distinct = np.array([len(set(r)) == 8 for r in sample.tolist()])
    f_agree = np.isclose(sf, sf_j, rtol=1e-4, atol=1e-3)[distinct].mean()
    print(f"SF agrees on {f_agree:.3f} of {distinct.sum()} samples of 8 distinct matches")
    assert f_agree >= 0.98
    for got, want in ((sh, sh_j), (sf, sf_j)):
        assert got.argmax() == want.argmax()
        np.testing.assert_allclose(got.max(), want.max(), rtol=1e-4)
    SH, SF = sh_j.max(), sf_j.max()
    assert (SH / (SH + SF) > 0.40) == (model == "h")

    got = {}
    orig = tinit._triangulate_and_check

    def check(R, t, p1n, p2n, inl, *a):
        got["inl"] = inl.numpy()
        return orig(R, t, p1n, p2n, inl, *a)

    tinit._triangulate_and_check = check
    try:
        ok, R, t, X, good = ini.initialize(kp1, kp2, valid)
    finally:
        tinit._triangulate_and_check = orig
    assert ok
    assert np.array_equal(got["inl"], seen["inl"])
    assert np.array_equal(good, good_j)
    np.testing.assert_allclose(R, R_j, atol=1e-4, rtol=0)
    np.testing.assert_allclose(t, t_j, atol=1e-4, rtol=0)
    scale = np.linalg.norm(X_j[good_j], axis=1)
    err = np.linalg.norm(X[good] - X_j[good_j], axis=1) / scale
    assert err.max() <= 1e-3, err.max()


LENSES = {"TUM1_rgbd": "TUM1_rgbd.yaml", "EuRoC_mono": "EuRoC_mono.yaml"}


@pytest.mark.parametrize("lens", sorted(LENSES))
def test_undistortion_matches_jax(lens):
    import os
    cam = load_config(os.path.join(os.path.dirname(__file__), "..", "examples",
                                   "configs", LENSES[lens])).camera
    assert cam.k1 != 0.0
    rng = np.random.default_rng(5)
    xy = np.stack([rng.uniform(0, cam.width, 4000),
                   rng.uniform(0, cam.height, 4000)], 1).astype(np.float32)
    coef = (cam.fx, cam.fy, cam.cx, cam.cy, cam.k1, cam.k2, cam.p1, cam.p2, cam.k3)
    host = undistort_points(xy, *coef)
    host_j = jax_undistort(xy, *coef)
    dev = undistort_device(torch.as_tensor(xy), *coef).numpy()
    dev_j = np.asarray(jax_fused._undistort_device(jnp.asarray(xy), *coef))
    err = max(np.abs(host - host_j).max(), np.abs(dev - dev_j).max(),
              np.abs(dev - host_j).max())
    print(f"{lens}: max |port - JAX| {err:.3e} px, lens shift up to "
          f"{np.abs(host_j - xy).max():.1f} px")
    assert np.abs(host_j - xy).max() > 5.0
    assert err <= 1e-3


K_LENS = dict(k1=0.04, k2=-0.01, p1=0.001, p2=-0.0005, k3=0.0)


def _sensor_configs(seq):
    cfgs = []
    for cfg in (JaxConfig(), SLAMConfig()):
        c = cfg.camera
        c.fx, c.fy, c.cx, c.cy, c.bf = seq.fx, seq.fy, seq.cx, seq.cy, seq.bf
        c.width, c.height = 320, 240
        for k, v in K_LENS.items():
            setattr(c, k, v)
        cfg.orb.n_levels, cfg.orb.tile_h, cfg.orb.tile_w = 4, 16, 16
        cfgs.append(cfg)
    return cfgs


@pytest.mark.parametrize("mode", ["rgbd", "mono"])
def test_fused_step_matches_jax(mode, monkeypatch):
    """The JAX tracker's own fused step of a lens-warped sequence (RGB-D
    seed 4, mono seed 6), fed to the port's fused step in the same mode."""
    seq = make_stereo_sequence(seed=4 if mode == "rgbd" else 6, n_frames=8, h=240,
                               w=320, with_depth=True)
    jcfg, tcfg = _sensor_configs(seq)
    lefts = [warp_lens(im, tcfg.camera, order=1) for im in seq.lefts]
    depths = [warp_lens(d, tcfg.camera, order=0) for d in seq.depths]
    captured = {}
    orig = jax_fused.fused_track_dispatch

    def spy(*args, **kw):
        captured["args"], captured["kw"] = args, kw
        out = orig(*args, **kw)
        captured["out"] = out
        return out

    monkeypatch.setattr(jax_fused, "fused_track_dispatch", spy)
    JaxFrame._next_id = 0
    slam = JaxSlam(jcfg, sensor=mode, enable_mapping=False)
    for i in range(len(seq.lefts)):
        if mode == "rgbd":
            slam.track_rgbd(lefts[i], depths[i], seq.timestamps[i])
        else:
            slam.track_monocular(lefts[i], seq.timestamps[i])
        if "args" in captured:
            break
    assert "args" in captured, "the JAX tracker never took the fused path"
    (_fe, _cam, imgs, jmode, _mbf, _min_z, pred, last_state, cand, th_mm, th_lm,
     sf, inv_s2, cam_params) = captured["args"]
    assert jmode == mode
    _, _, fz_j = jax_fused.fused_track_pull(*captured["out"])
    pulled_j = jax_fused.fused_track_pull(*captured["out"])[0]

    o = tcfg.orb
    fe = OrbFrontend(240, 320, n_levels=o.n_levels, scale_factor=o.scale_factor,
                     fast_n_min=o.fast_n_min, fast_n_max=o.fast_n_max,
                     threshold=o.th_fast_max, tile_h=o.tile_h, tile_w=o.tile_w,
                     device="cpu")
    use_jax_pyramid(fe, slam.frontend)
    last, cands = fused_inputs_from_numpy(
        {k: np.asarray(v) for k, v in last_state.items()},
        {k: np.asarray(v) for k, v in cand.items()}, device="cpu")
    pulled, _, fz_t = fused_track(
        fe, tcfg.camera, tuple(np.asarray(a) for a in imgs), mode, np.asarray(pred),
        last, cands, th_mm, th_lm, torch.as_tensor(np.asarray(sf)),
        torch.as_tensor(np.asarray(inv_s2)), cam_params,
        bool(captured["kw"]["forward"]), bool(captured["kw"]["backward"]))
    # the virtual right coordinate and depth of every valid slot
    valid = pulled_j[0]
    assert np.array_equal(pulled[0], valid)
    u_r, depth = pulled[6], pulled[7]
    np.testing.assert_allclose(u_r[valid], pulled_j[7][valid], atol=1e-4, rtol=0)
    np.testing.assert_array_equal(depth[valid], pulled_j[8][valid])
    if mode == "mono":
        assert (u_r == -1).all() and (depth == -1).all()
    else:
        assert (depth[valid] > 0).mean() > 0.9
    assert np.array_equal(fz_t.m, fz_j.m)
    assert fz_t.n_match == fz_j.n_match >= 20
    for k in ("R1", "t1", "R2", "t2"):
        np.testing.assert_allclose(getattr(fz_t, k), getattr(fz_j, k), atol=1e-4,
                                   rtol=0)
    for k in ("ok", "sel", "inl1", "inl2"):
        agree = (getattr(fz_t, k) == getattr(fz_j, k)).mean()
        assert agree >= 0.99, (k, agree)
