"""The port's local mapping against the JAX package on the CPU.

- epipolar matching, triangulation and the fuse search on seeded scenes:
  identical indices and ok flags, points within 1e-6 in float64 and
  within float32's SVD accuracy in float32;
- stage by stage: a JAX SlamSystem with mapping on tracks the 25-frame
  arc of tests/test_slam_e2e.py (320x240, 3 levels, tile 16) and, through a
  wrapper around its mapper's process_keyframe, snapshots the map before
  each keyframe; both mappers then run the last keyframe whose local BA
  had a free camera from that snapshot, the port's map carried across by
  ``convert.map_store_from_numpy``: the same new points, observations
  after the fuse, BA problem, BA poses and outliers, and culled keyframes;
- the whole run of both packages: every frame OK, ATE < 0.18 m and within
  1e-3 m of JAX's (measured gap 1.1e-4 m), keyframes created and alive
  within one of JAX's;
- the port's versions of tests/test_slam_e2e.py's map, trajectory and
  tracked-points tests.
"""
import copy

import numpy as np
import pytest

pytest.importorskip("jax")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

import jetson_slam_tpu.core.local_mapping as jax_lm  # noqa: E402
from jetson_slam_tpu.config import SLAMConfig as JaxConfig  # noqa: E402
from jetson_slam_tpu.core import matcher as jm  # noqa: E402
from jetson_slam_tpu.core import triangulation as jt  # noqa: E402
from jetson_slam_tpu.core.frame import Frame as JaxFrame  # noqa: E402
from jetson_slam_tpu.core.map import MapStore as JaxMapStore  # noqa: E402
from jetson_slam_tpu.core.tracking import TrackingState as JaxState  # noqa: E402
from jetson_slam_tpu.io.synthetic import make_stereo_sequence  # noqa: E402
from jetson_slam_tpu.models.slam import SlamSystem as JaxSlam  # noqa: E402
from jetson_slam_tpu_torch.config import SLAMConfig  # noqa: E402
from jetson_slam_tpu_torch.convert import map_store_from_numpy  # noqa: E402
from jetson_slam_tpu_torch.core import matcher as tm  # noqa: E402
from jetson_slam_tpu_torch.core import triangulation as tt  # noqa: E402
from jetson_slam_tpu_torch.core.frame import Frame  # noqa: E402
from jetson_slam_tpu_torch.core.local_mapping import LocalMapper  # noqa: E402
from jetson_slam_tpu_torch.core.tracking import TrackingState  # noqa: E402
from jetson_slam_tpu_torch.io.evaluation import ate_rmse  # noqa: E402
from jetson_slam_tpu_torch.io.trajectory import load_trajectory_tum  # noqa: E402
from jetson_slam_tpu_torch.models.slam import SlamSystem  # noqa: E402

torch.set_num_threads(2)

FX, FY, CX, CY, BF = 300.0, 300.0, 160.0, 120.0, 60.0
SF = np.array([1.0, 1.2, 1.44], np.float32)
SIG2 = SF ** 2
K = np.array([[FX, 0, CX], [0, FY, CY], [0, 0, 1]], np.float32)


def _rot(rng, scale):
    w = rng.normal(0, scale, 3)
    th = np.linalg.norm(w)
    k = w / th
    Kx = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    return (np.eye(3) + np.sin(th) * Kx + (1 - np.cos(th)) * Kx @ Kx).astype(np.float32)


def _project(R, t, pw):
    pc = pw @ R.T + t
    return np.stack([FX * pc[:, 0] / pc[:, 2] + CX, FY * pc[:, 1] / pc[:, 2] + CY], 1), pc[:, 2]


def _scene(seed, n_pts=300, n_slots=512):
    """Two keyframes seeing one scene: kf2 moved 0.4 m sideways and turned
    a little; slots 0..n_pts-1 of kf1 see the points, kf2 holds them under a
    permutation with 0.5 px noise, flipped descriptor bits, and stereo depth
    on about half; the other slots are clutter."""
    rng = np.random.default_rng(seed)
    pw = np.stack([rng.uniform(-4, 4, n_pts), rng.uniform(-3, 3, n_pts),
                   rng.uniform(3, 20, n_pts)], 1).astype(np.float32)
    R1, t1 = np.eye(3, dtype=np.float32), np.zeros(3, np.float32)
    R2 = _rot(rng, 0.03)
    t2 = (np.array([-0.4, 0.02, 0.05]) + rng.normal(0, 0.01, 3)).astype(np.float32)
    xy1 = rng.uniform([0, 0], [320, 240], (n_slots, 2)).astype(np.float32)
    xy2 = rng.uniform([0, 0], [320, 240], (n_slots, 2)).astype(np.float32)
    perm = rng.permutation(n_slots)[:n_pts]
    p1, z1 = _project(R1, t1, pw)
    p2, z2 = _project(R2, t2, pw)
    xy1[:n_pts] = p1 + rng.normal(0, 0.5, (n_pts, 2))
    xy2[perm] = p2 + rng.normal(0, 0.5, (n_pts, 2))
    desc1 = rng.integers(0, 256, (n_slots, 32), np.uint8)
    desc2 = rng.integers(0, 256, (n_slots, 32), np.uint8)
    flips = rng.integers(0, 2, (n_pts, 32)) * (1 << rng.integers(0, 8, (n_pts, 32)))
    desc2[perm] = desc1[:n_pts] ^ (flips * (rng.random((n_pts, 32)) < 0.3)).astype(np.uint8)
    oct1 = rng.integers(0, 3, n_slots).astype(np.int32)
    oct2 = rng.integers(0, 3, n_slots).astype(np.int32)
    oct2[perm] = oct1[:n_pts]
    ang1 = rng.uniform(0, 360, n_slots).astype(np.float32)
    ang2 = rng.uniform(0, 360, n_slots).astype(np.float32)
    ang2[perm] = ang1[:n_pts] + rng.normal(0, 3, n_pts)
    st = rng.random(n_pts) < 0.5
    dep1 = np.full(n_slots, -1.0, np.float32)
    dep2 = np.full(n_slots, -1.0, np.float32)
    dep1[:n_pts] = np.where(st, z1 * (1 + rng.normal(0, 0.01, n_pts)), -1.0)
    dep2[perm] = np.where(st, z2 * (1 + rng.normal(0, 0.01, n_pts)), -1.0)
    ur1 = np.where(dep1 > 0, xy1[:, 0] - BF / np.maximum(dep1, 1e-6), -1.0).astype(np.float32)
    ur2 = np.where(dep2 > 0, xy2[:, 0] - BF / np.maximum(dep2, 1e-6), -1.0).astype(np.float32)
    valid1 = rng.random(n_slots) < 0.95
    valid2 = rng.random(n_slots) < 0.95
    return dict(R1=R1, t1=t1, R2=R2, t2=t2, xy1=xy1, xy2=xy2, desc1=desc1, desc2=desc2,
                oct1=oct1, oct2=oct2, ang1=ang1, ang2=ang2, dep1=dep1, dep2=dep2,
                ur1=ur1, ur2=ur2, valid1=valid1, valid2=valid2, perm=perm, pw=pw)


def _epipolar_inputs(d):
    F12 = tt.fundamental_matrix(d["R1"], d["t1"], d["R2"], d["t2"], K)
    c1 = -d["R1"].T @ d["t1"]
    cc = d["R2"] @ c1 + d["t2"]
    ex, ey = FX * cc[0] / cc[2] + CX, FY * cc[1] / cc[2] + CY
    return F12, float(ex), float(ey)


@pytest.mark.parametrize("seed", [0, 1])
def test_epipolar_match_matches_jax(seed):
    d = _scene(seed)
    F12, ex, ey = _epipolar_inputs(d)
    np.testing.assert_array_equal(
        F12, jt.fundamental_matrix(d["R1"], d["t1"], d["R2"], d["t2"], K))
    kf1 = [d[k] for k in ("desc1", "valid1", "ang1", "xy1")]
    kf2 = [d[k] for k in ("desc2", "valid2", "ang2", "xy2")]
    mj = np.asarray(jt.epipolar_match(
        *map(jnp.asarray, kf1), jnp.asarray(d["ur1"]), *map(jnp.asarray, kf2),
        jnp.asarray(F12), jnp.asarray(SIG2), jnp.asarray(d["oct2"]), ex, ey,
        jnp.asarray(SIG2)))
    mt = tt.epipolar_match(
        *map(torch.as_tensor, kf1 + kf2), torch.as_tensor(F12), torch.as_tensor(SIG2),
        torch.as_tensor(d["oct2"]), ex, ey, torch.as_tensor(SIG2)).numpy()
    assert np.array_equal(mt, mj)
    hits = mt[:300] == d["perm"]
    assert hits.sum() >= 100, hits.sum()


def _pairs(d, n=256):
    """n matched pairs of the scene: rays, keypoints, stereo and octaves."""
    s1 = np.arange(n)
    s2 = d["perm"][:n]
    xy1, xy2 = d["xy1"][s1], d["xy2"][s2]
    ray = lambda xy: np.stack([(xy[:, 0] - CX) / FX, (xy[:, 1] - CY) / FY,  # noqa: E731
                               np.ones(n, np.float32)], 1).astype(np.float32)
    rep = lambda a, shape: np.broadcast_to(a, (n,) + shape).copy()  # noqa: E731
    return [rep(d["R1"], (3, 3)), rep(d["t1"], (3,)), rep(d["R2"], (3, 3)),
            rep(d["t2"], (3,)), ray(xy1), ray(xy2), d["ur1"][s1], d["ur2"][s2],
            d["dep1"][s1], d["dep2"][s2], xy1, xy2, SIG2[d["oct1"][s1]],
            SIG2[d["oct2"][s2]]], (d["oct1"][s1], d["oct2"][s2])


def _triangulate_both(args, octaves, dtype):
    args = [a.astype(dtype) if a.dtype == np.float32 else a for a in args]
    with jax.enable_x64(dtype == np.float64):
        pj, okj = jt.triangulate_pairs(*map(jnp.asarray, args[:12]),
                                       *map(jnp.asarray, octaves),
                                       *map(jnp.asarray, args[12:]),
                                       FX, FY, CX, CY, BF, 1.8)
        pj, okj = np.asarray(pj), np.asarray(okj)
    pt, okt = tt.triangulate_pairs(*map(torch.as_tensor, args), FX, FY, CX, CY, BF, 1.8)
    return pj, okj, pt.numpy(), okt.numpy()


@pytest.mark.parametrize("seed", [0, 1])
def test_triangulate_pairs_matches_jax(seed):
    """In float64 the points agree within 1e-6.  In float32 each package's
    SVD lands up to 2e-4 m from the float64 point at 15-20 m depth, so
    the two are held within 1e-4 m plus 2e-5 of the distance (measured:
    at most 1.0e-5 of it)."""
    d = _scene(seed)
    args, octaves = _pairs(d)
    pj, okj, pt, okt = _triangulate_both(args, octaves, np.float64)
    assert np.array_equal(okt, okj)
    np.testing.assert_allclose(pt[okt], pj[okj], atol=1e-6, rtol=0)
    pj, okj, pt, okt = _triangulate_both(args, octaves, np.float32)
    assert np.array_equal(okt, okj)
    assert okt.sum() >= 100, okt.sum()
    gap = np.abs(pt[okt] - pj[okj]).max(1)
    assert (gap <= 1e-4 + 2e-5 * np.linalg.norm(pj[okj], axis=1)).all(), gap.max()
    # and the points are the scene's
    err = np.linalg.norm(pt[okt] - d["pw"][:256][okt], axis=1)
    assert np.median(err) < 0.1 * np.median(d["pw"][:256, 2])


def test_fuse_search_matches_jax():
    """Points of kf1 projected into kf2 through the frustum check and the
    projection search with the fuse gates (chi2 per octave, TH_LOW)."""
    d = _scene(2)
    pw = d["pw"]
    n = len(pw)
    Ow = -d["R2"].T @ d["t2"]
    normal = pw - Ow
    normal /= np.linalg.norm(normal, axis=1, keepdims=True)
    dist = np.linalg.norm(pw - Ow, axis=1)
    maxd = (dist * 1.2 ** (d["oct1"][:n] + 0.5)).astype(np.float32)
    mind = (maxd / 1.44 ** 3).astype(np.float32)
    alive = np.random.default_rng(2).random(n) < 0.95
    frustum = [pw, normal.astype(np.float32), maxd, mind, d["R2"], d["t2"],
               Ow.astype(np.float32)]
    geo = (FX, FY, CX, CY, 0.0, 320.0, 0.0, 240.0, 3, float(np.log(1.2)), 0.5)
    cur = [d["desc1"][:n], d["xy2"], d["oct2"], d["desc2"], d["valid2"], d["ur2"],
           np.ones(len(d["xy2"]), bool)]
    okj, uj, vj, izj, lvj, vcj = jm.frustum_check(*map(jnp.asarray, frustum), *geo,
                                                  jnp.asarray(alive))
    selj = jm.search_by_projection_points(
        uj, vj, uj - BF * izj, lvj, vcj, okj, *map(jnp.asarray, cur), 3.0, SF, 3,
        nn_ratio=1.0, fuse=True)
    okt, ut, vt, izt, lvt, vct = tm.frustum_check(*map(torch.as_tensor, frustum), *geo,
                                                  torch.as_tensor(alive))
    selt = tm.search_by_projection_points(
        ut, vt, ut - BF * izt, lvt, vct, okt, *map(torch.as_tensor, cur), 3.0,
        torch.as_tensor(SF), 3, nn_ratio=1.0, fuse=True)
    assert np.array_equal(okt.numpy(), np.asarray(okj))
    assert np.array_equal(selt.numpy(), np.asarray(selj))
    assert (selt.numpy() >= 0).sum() >= 50
    # the fuse gates are tighter than the tracking search's
    loose = tm.search_by_projection_points(
        ut, vt, ut - BF * izt, lvt, vct, okt, *map(torch.as_tensor, cur), 3.0,
        torch.as_tensor(SF), 3, nn_ratio=1.0)
    assert (loose.numpy() >= 0).sum() >= (selt.numpy() >= 0).sum()


# ------------------------------------------------------------ whole system
def _config(cfg, seq):
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
    return cfg


@pytest.fixture(scope="module")
def seq():
    return make_stereo_sequence(seed=7, n_frames=25, h=240, w=320,
                                trajectory="arc", n_points=900)


def _run(slam, seq, ok_state, n=None):
    states = [slam.track_stereo(seq.lefts[i], seq.rights[i], seq.timestamps[i])[0]
              for i in range(n or len(seq.lefts))]
    ts, poses = slam.camera_trajectory()
    ate = ate_rmse(np.asarray(ts), np.asarray(poses), seq.timestamps[:len(states)],
                   seq.poses_twc[:len(states)])
    return sum(s == ok_state for s in states), ate


@pytest.fixture(scope="module")
def jax_run(seq):
    """The JAX run, with a snapshot of the map (and the mapper's recent
    points) before each process_keyframe, and for each whether its local
    BA ran with a free camera."""
    snaps = []
    orig_process, orig_solve = jax_lm.LocalMapper.process_keyframe, jax_lm.LocalMapper._lba_solve

    def process(self, kid):
        state = {k: copy.deepcopy(v) for k, v in vars(self.map).items() if k != "erase_hooks"}
        snaps.append(dict(kid=kid, map=state, recent=list(self.recent_points), ba=False))
        return orig_process(self, kid)

    def solve(self, prep):
        snaps[-1]["ba"] = bool((~prep["fixed"][:len(prep["cams"])]).any())
        return orig_solve(self, prep)

    mp = pytest.MonkeyPatch()
    mp.setattr(jax_lm.LocalMapper, "process_keyframe", process)
    mp.setattr(jax_lm.LocalMapper, "_lba_solve", solve)
    try:
        JaxFrame._next_id = 0
        slam = JaxSlam(_config(JaxConfig(), seq), sensor="stereo")
        n_ok, ate = _run(slam, seq, JaxState.OK)
    finally:
        mp.undo()
    return dict(slam=slam, n_ok=n_ok, ate=ate, snaps=snaps,
                created=int(slam.map.kf_gen.sum()), alive=slam.map.n_keyframes())


@pytest.fixture(scope="module")
def port_run(seq):
    Frame._next_id = 0
    slam = SlamSystem(_config(SLAMConfig(), seq), sensor="stereo", device="cpu")
    n_ok, ate = _run(slam, seq, TrackingState.OK)
    return dict(slam=slam, n_ok=n_ok, ate=ate, created=int(slam.map.kf_gen.sum()),
                alive=slam.map.n_keyframes())


def _jax_map(state):
    m = JaxMapStore(max_points=len(state["pt_alive"]), max_keyframes=len(state["kf_alive"]),
                    n_slots=state["kf_obs"].shape[1])
    for k, v in copy.deepcopy(state).items():
        setattr(m, k, v)
    return m


def test_mapping_stages_match_jax(jax_run, port_run):
    snap = [s for s in jax_run["snaps"] if s["ba"]][-1]
    kid = snap["kid"]
    jslam, pslam = jax_run["slam"], port_run["slam"]
    jmap = _jax_map(snap["map"])
    pmap = map_store_from_numpy(snap["map"])
    for k, v in vars(jmap).items():
        if k.startswith(("pt_", "kf_")):
            assert np.array_equal(getattr(pmap, k), v), k
    jmp = jax_lm.LocalMapper(jmap, jslam.config.camera, jslam.frontend.geom)
    pmp = LocalMapper(pmap, pslam.config.camera, pslam.frontend.geom, "cpu")
    for mp in (jmp, pmp):
        mp.recent_points = list(snap["recent"])
        mp.map.update_spanning_tree(kid)
        mp._register_new_points(kid)
        mp.cull_map_points(kid)
    assert np.array_equal(pmap.pt_alive, jmap.pt_alive)
    assert np.array_equal(pmap.kf_parent, jmap.kf_parent)

    before = jmap.pt_alive.copy()
    jmp.create_new_map_points(kid)
    pmp.create_new_map_points(kid)
    new_j = np.flatnonzero(jmap.pt_alive & ~before)
    new_t = np.flatnonzero(pmap.pt_alive & ~before)
    assert len(new_j) > 0
    assert np.array_equal(new_t, new_j)
    np.testing.assert_allclose(pmap.pt_pos[new_t], jmap.pt_pos[new_j], atol=1e-4, rtol=0)
    assert np.array_equal(pmap.kf_obs, jmap.kf_obs)

    jmp.search_in_neighbors(kid)
    pmp.search_in_neighbors(kid)
    assert np.array_equal(pmap.kf_obs, jmap.kf_obs)
    assert np.array_equal(pmap.pt_alive, jmap.pt_alive)

    prep_j = jmp._lba_prepare(kid)
    prep_t = pmp._lba_prepare(kid)
    assert prep_j is not None and prep_t is not None
    assert set(prep_t) == set(prep_j)
    for k in prep_j:
        if k == "pt_pos":   # the new points' positions differ within 1e-4
            np.testing.assert_allclose(prep_t[k], prep_j[k], atol=1e-4, rtol=0)
        else:
            assert np.array_equal(prep_t[k], prep_j[k]), k
    n_free = int((~prep_t["fixed"][:len(prep_t["cams"])]).sum())
    assert n_free >= 1

    Rj, tj, _, out_j = jmp._lba_solve(prep_j)
    Rt, tt_, _, out_t = pmp._lba_solve(prep_t)
    np.testing.assert_allclose(Rt, Rj, atol=1e-4, rtol=0)
    np.testing.assert_allclose(tt_, tj, atol=1e-4, rtol=0)
    assert np.array_equal(out_t, out_j)
    jmp._lba_commit(prep_j, (Rj, tj, _, out_j))
    pmp._lba_commit(prep_t, (Rt, tt_, _, out_t))
    assert np.array_equal(pmap.kf_obs, jmap.kf_obs)

    jmp.cull_keyframes(kid)
    pmp.cull_keyframes(kid)
    assert np.array_equal(pmap.kf_alive, jmap.kf_alive)


def test_slam_mapping_on_matches_jax(jax_run, port_run, seq):
    """Measured: 25/25 OK in both, 6 keyframes created and 6 alive in both,
    ATE 0.007262 m port and 0.007370 m JAX (gap 1.1e-4 m)."""
    n = len(seq.lefts)
    print(f"port: {port_run['n_ok']} OK, ATE {port_run['ate']:.6f} m, keyframes "
          f"{port_run['created']} created {port_run['alive']} alive; jax: "
          f"{jax_run['n_ok']} OK, ATE {jax_run['ate']:.6f} m, keyframes "
          f"{jax_run['created']} created {jax_run['alive']} alive")
    assert port_run["n_ok"] == jax_run["n_ok"] == n
    assert port_run["ate"] < 0.18
    assert abs(port_run["ate"] - jax_run["ate"]) <= 1e-3
    assert abs(port_run["created"] - jax_run["created"]) <= 1
    assert abs(port_run["alive"] - jax_run["alive"]) <= 1


def test_map_grows_and_culls(port_run):
    slam = port_run["slam"]
    m = slam.map
    assert m.n_keyframes() >= 2
    assert m.n_points() > 100
    assert (m.pt_gen > 1).any() or (~m.pt_alive[:m._next_pt] & (m.pt_gen[:m._next_pt] > 0)).any(), \
        "no point was ever culled"
    for k in m.keyframe_ids():
        obs = m.kf_obs[k]
        assert m.pt_alive[obs[obs >= 0]].all()
    for pid in np.flatnonzero(m.pt_alive):
        for kf, slot in m._pt_obs.get(int(pid), {}).items():
            assert m.kf_obs[kf, slot] == pid


@pytest.fixture(scope="module")
def short_run(seq):
    Frame._next_id = 0
    slam = SlamSystem(_config(SLAMConfig(), seq), sensor="stereo", device="cpu")
    _run(slam, seq, TrackingState.OK, n=8)
    return slam


def test_trajectory_save_roundtrip(tmp_path, short_run):
    p = str(tmp_path / "traj.txt")
    short_run.save_trajectory_tum(p)
    ts, _ = load_trajectory_tum(p)
    assert len(ts) >= 6
    kf_p = str(tmp_path / "kf.txt")
    short_run.save_keyframe_trajectory_tum(kf_p)
    kf_ts, _ = load_trajectory_tum(kf_p)
    assert len(kf_ts) == short_run.map.n_keyframes()
    kitti = tmp_path / "kitti.txt"
    short_run.save_trajectory_kitti(str(kitti))
    assert len(kitti.read_text().splitlines()) == len(ts)


def test_tracked_keypoints_and_points_api(short_run):
    pts = short_run.get_tracked_map_points()
    kps = short_run.get_tracked_keypoints_un()
    assert len(pts) > 10
    assert kps.ndim == 2 and kps.shape[1] == 2 and len(kps) > 50
    w, h = short_run.config.camera.width, short_run.config.camera.height
    assert (kps[:, 0] > -50).all() and (kps[:, 0] < w + 50).all()
    assert (kps[:, 1] > -50).all() and (kps[:, 1] < h + 50).all()
    short_run.shutdown()
