"""The port's landmark-sharded BA over torch.distributed against the JAX
package's DistBA and the port's own local_ba, on the CPU.

Ranks are spawned processes on a gloo group over a FileStore in the test's
tmp_path (``run_ranks``), so parallel test workers never share a port.

- ``partition_problem`` equals the JAX partitioner array for array, empty
  shards and degree-1 points included;
- ``local_ba(allreduce=identity)`` equals ``allreduce=None`` bit for bit;
- DistBA on 2 ranks against JAX's DistBA on the 8-device CPU mesh and
  against ``local_ba``, on tests/test_dist_ba.py's noisy problem with 10 %
  outliers, with that test's bounds (t within 5e-3, >= 98 % outlier
  agreement, >= 5 % of the edges caught; against JAX in float32 the
  outlier agreement, see the test), one all_gather per solve and two
  collectives per LM iteration;
- a stop on one rank stops both at the same iteration; ranks holding
  different problems raise, each of them;
- where one shard holds every depth edge and the other none, both ranks
  damp as the whole problem asks, agree bit for bit and land on the
  unsharded solve;
- ``SlamSystem(mesh=group)`` on 2 ranks tracks tests/test_dist_ba.py's
  10-frame scene within its ATE gate, every local BA through DistBA, the
  ranks' trajectories equal; the LoopCloser's global BA over the mesh (on
  its own group, sync and on the async thread) agrees with the plain solve.
"""
import multiprocessing
import time
import traceback

import numpy as np
import pytest

pytest.importorskip("jax")
import jax  # noqa: E402
import torch  # noqa: E402
from jax.sharding import Mesh  # noqa: E402

from jetson_slam_tpu.parallel.dist_ba import DistBA as JaxDistBA  # noqa: E402
from jetson_slam_tpu.parallel.dist_ba import partition_problem as jax_partition  # noqa: E402
from jetson_slam_tpu_torch.core.local_ba import local_ba  # noqa: E402
from jetson_slam_tpu_torch.parallel.dist_ba import partition_problem  # noqa: E402
from tests.test_local_ba import BF, CX, CY, FX, FY, make_ba_problem  # noqa: E402

torch.set_num_threads(2)


# ------------------------------------------------------------- rank harness
def _rank_entry(conn, rank, world, store, fn, args):
    try:
        import torch.distributed as dist
        from jetson_slam_tpu_torch.parallel import multihost as mh
        torch.set_num_threads(2)
        mh.initialize("file://" + store, world, rank, backend="gloo", timeout_s=60)
        try:
            conn.send((True, fn(rank, *args)))
        finally:
            dist.destroy_process_group()
    except BaseException:
        conn.send((False, traceback.format_exc()))
    finally:
        conn.close()


def run_ranks(fn, tmp_path, *args, world=2, timeout=150.0):
    """fn(rank, *args) on each of ``world`` spawned ranks of a gloo group
    (the default group, over a FileStore in tmp_path); returns the results
    by rank.  Raises if a rank fails or gives no result within timeout
    seconds, and stops every rank before returning."""
    ctx = multiprocessing.get_context("spawn")
    store = str(tmp_path / f"store_{fn.__name__}_{time.monotonic_ns()}")
    conns, procs = [], []
    for r in range(world):
        parent, child = ctx.Pipe()
        p = ctx.Process(target=_rank_entry, args=(child, r, world, store, fn, args),
                        daemon=True)
        p.start()
        child.close()
        conns.append(parent)
        procs.append(p)
    deadline = time.monotonic() + timeout
    out = []
    try:
        for r, c in enumerate(conns):
            if not c.poll(max(0.0, deadline - time.monotonic())):
                raise TimeoutError(f"rank {r} of {fn.__name__} gave no result in {timeout} s")
            ok, value = c.recv()
            if not ok:
                raise RuntimeError(f"rank {r} of {fn.__name__} failed:\n{value}")
            out.append(value)
    finally:
        for p in procs:
            p.join(timeout=10)
            if p.is_alive():
                p.kill()
                p.join()
        for c in conns:
            c.close()
    return out


# ----------------------------------------------------------------- problems
def noisy_problem():
    """tests/test_dist_ba.py's problem: 5 cameras, 64 points, 10 % gross
    outliers."""
    prob = make_ba_problem(np.random.default_rng(0), n_cams=5, n_pts=64, pix_noise=0.4,
                           pose_noise=0.06, pt_noise=0.15, outlier_frac=0.1)
    Rs_i, ts_i, fixed, pts_i, e_cam, e_pt, obs, stereo, pt_edges, Rs_gt, ts_gt = prob[:11]
    E = len(e_cam)
    args = (Rs_i, ts_i, fixed, pts_i, e_cam, e_pt, obs, stereo,
            np.ones(E, np.float32), np.ones(E, bool))
    return args, pt_edges, ts_gt


def _solve_on_rank(rank, args, stop_at=None, perturb=False):
    """DistBA over the default group on this rank's shard; counts the
    all_gather calls of the solve.  ``stop_at``: rank 0's stop fires at that
    LM iteration; ``perturb``: rank 1 holds another problem (returns the
    ValueError's text)."""
    import torch.distributed as dist
    from jetson_slam_tpu_torch.parallel import multihost as mh
    from jetson_slam_tpu_torch.parallel.dist_ba import DistBA
    args = [np.array(a) for a in args]
    if perturb and rank == 1:
        args[6][3, 0] += 0.5
    calls = {"n": 0}

    def stop():
        calls["n"] += 1
        return rank == 0 and calls["n"] >= stop_at

    gathers = []
    all_gather = dist.all_gather

    def counted(*a, **kw):
        gathers.append(1)
        return all_gather(*a, **kw)

    dist.all_gather = counted
    try:
        solver = DistBA(mh.global_group(), device="cpu")
        try:
            out = solver.solve(*args, FX, FY, CX, CY, BF,
                               stop=stop if stop_at is not None else None)
        except ValueError as e:
            return str(e)
    finally:
        dist.all_gather = all_gather
    return dict(out=out, stats=solver.stats, gathers=len(gathers))


# ------------------------------------------------------------------ tests
@pytest.mark.parametrize("n_shards,P,E,seed", [(4, 5, 12, 0), (3, 10, 40, 1), (8, 37, 100, 2),
                                               (2, 64, 0, 3), (5, 3, 7, 4), (8, 9, 9, 5)])
def test_partition_matches_jax(n_shards, P, E, seed):
    """Array for array, dtypes included.  (4, 5): one empty shard; (8, 9,
    9): one edge per point on average, many points of degree 1 or 0."""
    rng = np.random.default_rng(seed)
    pts = rng.normal(size=(P, 3)).astype(np.float32)
    e_pt = rng.integers(0, P, E).astype(np.int32)
    inp = (pts, rng.integers(0, 4, E).astype(np.int32), e_pt,
           rng.normal(size=(E, 3)).astype(np.float32), rng.random(E) < 0.5,
           rng.random(E).astype(np.float32), rng.random(E) < 0.9)
    if E:
        deg = np.bincount(e_pt, minlength=P)
        assert (deg == 1).any() or n_shards * (-(-P // n_shards)) > P
    want = jax_partition(n_shards, *inp)
    got = partition_problem(n_shards, *inp)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        if isinstance(w, np.ndarray):
            assert g.dtype == w.dtype and np.array_equal(g, w)
        else:
            assert g == w


@pytest.mark.parametrize("stop_at", [None, 3, 9])
def test_allreduce_identity_is_bit_equal(stop_at):
    """The packed reduction path, given the identity, is the unsharded solve
    bit for bit, with and without a stop (in phase 1 and in phase 2)."""
    args, pt_edges, _ = noisy_problem()
    inp = [torch.as_tensor(a) for a in args] + [torch.as_tensor(pt_edges)]

    def stopper():
        n = [0]

        def stop():
            n[0] += 1
            return n[0] >= stop_at
        return stop if stop_at is not None else None

    plain = local_ba(*inp, FX, FY, CX, CY, BF, stop=stopper())
    calls = []

    def identity(x):
        calls.append(x.numel())
        return x

    packed = local_ba(*inp, FX, FY, CX, CY, BF, stop=stopper(), allreduce=identity)
    for a, b in zip(plain, packed):
        assert torch.equal(a, b)
    # (packed reductions, scalar reductions): one each per iteration run,
    # and a packed one alone where a phase stops (at 3: phase 1's third
    # iteration and phase 2's first; at 9: phase 2's fourth); and the
    # depth flag's scalar once per solve
    want = {None: (15, 16), 3: (4, 3), 9: (9, 9)}[stop_at]
    assert (sum(n > 1 for n in calls), calls.count(1)) == want


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_dist_ba_two_ranks_matches_jax_and_local_ba(tmp_path, dtype):
    """tests/test_dist_ba.py's gates on the 2-rank solve: error halved, the
    gauge camera unmoved, >= 5 % of the edges caught; against the port's
    local_ba t within 5e-3 and >= 98 % outlier agreement; against JAX's
    DistBA the same bounds.  In both dtypes the sharded solve lands within
    1e-4 of the float64 solution with JAX's outlier classes: in float32
    the landmark blocks are inverted in float64 (``local_ba.inv3x3``);
    with float32 inverses one block's determinant cancels to 0 in phase 1
    and the solve lands 1.3e-4 to 7e-3 away."""
    args, pt_edges, ts_gt = noisy_problem()
    if dtype == "float64":
        args = tuple(a.astype(np.float64) if a.dtype == np.float32 else a for a in args)
    ranks = run_ranks(_solve_on_rank, tmp_path, args)
    R2, t2, p2, outlier = ranks[0]["out"]
    for a, b in zip(ranks[0]["out"], ranks[1]["out"]):
        assert np.array_equal(a, b)
    E = len(args[4])
    with jax.enable_x64(dtype == "float64"):
        jsolver = JaxDistBA(Mesh(np.array(jax.devices()), ("data",)))
        jt, jout = (np.asarray(a) for a in jsolver.solve(*args, FX, FY, CX, CY, BF)[1::2])
    lR, lt, lp, lout = (o.numpy() for o in local_ba(
        *(torch.as_tensor(a) for a in args), torch.as_tensor(pt_edges), FX, FY, CX, CY, BF))

    ts_i = args[1]
    err_before = np.linalg.norm(ts_i - ts_gt, axis=1).mean()
    err_after = np.linalg.norm(t2 - ts_gt, axis=1).mean()
    assert err_after < 0.5 * err_before, (err_before, err_after)
    np.testing.assert_allclose(t2[0], ts_i[0], atol=1e-7)     # the gauge camera
    assert outlier.sum() >= 0.05 * E
    np.testing.assert_allclose(t2, lt, atol=5e-3, rtol=0)
    assert (outlier == lout).mean() > 0.98
    assert (outlier == jout).mean() > 0.98
    np.testing.assert_allclose(t2, jt, atol=5e-3, rtol=0)
    a64 = tuple(a.astype(np.float64) if a.dtype == np.float32 else a for a in args)
    t64 = local_ba(*(torch.as_tensor(a) for a in a64), torch.as_tensor(pt_edges),
                   FX, FY, CX, CY, BF)[1].numpy()
    np.testing.assert_allclose(t2, t64, atol=1e-4, rtol=0)
    assert np.array_equal(outlier, jout)
    for r in ranks:
        st = r["stats"]
        assert r["gathers"] == 1, r["gathers"]     # the shards' results in one gather
        assert st["lm_iterations"] == 15 and st["lm_collectives"] == 30, st


def test_stop_on_one_rank_stops_both(tmp_path):
    """Rank 0's stop fires from its 4th check on, rank 1 has none: both
    leave phase 1 at its 4th iteration and phase 2 at its first (within the
    run_ranks timeout) with the same solution, the unsharded solve's with
    the same stop."""
    args, pt_edges, _ = noisy_problem()
    ranks = run_ranks(_solve_on_rank, tmp_path, args, 4, timeout=120.0)
    for r in ranks:
        assert r["stats"]["lm_iterations"] == 5 and r["stats"]["lm_collectives"] == 8
    for a, b in zip(ranks[0]["out"], ranks[1]["out"]):
        assert np.array_equal(a, b)
    n = [0]

    def stop():
        n[0] += 1
        return n[0] >= 4

    want = [o.numpy() for o in local_ba(*(torch.as_tensor(a) for a in args),
                                        torch.as_tensor(pt_edges), FX, FY, CX, CY, BF,
                                        stop=stop)]
    np.testing.assert_allclose(ranks[0]["out"][1], want[1], atol=5e-3, rtol=0)


def test_ranks_agree_where_one_shard_has_no_depth_edge(tmp_path):
    """The noisy problem with its stereo edges kept on the first shard's
    points alone: the second shard alone would damp as a depth-free (mono)
    problem does, but both ranks take the whole problem's damping, so they
    solve the same reduced system and land on the unsharded solve (float64,
    so that only the order of the sums parts them)."""
    args, pt_edges, _ = noisy_problem()
    args = [a.astype(np.float64) if a.dtype == np.float32 else a for a in args]
    per_pts = -(-args[3].shape[0] // 2)
    args[7] = args[7] & (args[5] < per_pts)
    assert args[7].any() and not args[7][args[5] >= per_pts].any()
    ranks = run_ranks(_solve_on_rank, tmp_path, tuple(args))
    for a, b in zip(ranks[0]["out"], ranks[1]["out"]):
        assert np.array_equal(a, b)
    lt = local_ba(*(torch.as_tensor(a) for a in args), torch.as_tensor(pt_edges),
                  FX, FY, CX, CY, BF)[1].numpy()
    np.testing.assert_allclose(ranks[0]["out"][1], lt, atol=1e-6, rtol=0)


def test_mismatched_problems_raise_on_every_rank(tmp_path):
    args, _, _ = noisy_problem()
    ranks = run_ranks(_solve_on_rank, tmp_path, args, None, True, timeout=120.0)
    for msg in ranks:
        assert isinstance(msg, str) and "different problems" in msg, msg


# ------------------------------------------------------- SlamSystem(mesh=)
def _mesh_session(rank):
    """tests/test_dist_ba.py's 10-frame scene with SlamSystem(mesh=) on this
    rank, then the LoopCloser's global BA over the mesh against the plain
    solve, synchronous and on the async thread."""
    from jetson_slam_tpu_torch.config import SLAMConfig
    from jetson_slam_tpu_torch.core.frame import Frame
    from jetson_slam_tpu_torch.core.loop_closing import LoopCloser
    from jetson_slam_tpu_torch.core.tracking import TrackingState
    from jetson_slam_tpu_torch.io.evaluation import ate_rmse
    from jetson_slam_tpu_torch.io.synthetic import make_stereo_sequence
    from jetson_slam_tpu_torch.models.slam import SlamSystem
    from jetson_slam_tpu_torch.parallel import multihost as mh

    seq = make_stereo_sequence(seed=5, n_frames=10, h=240, w=320, n_points=800)
    cfg = SLAMConfig()
    c = cfg.camera
    c.fx, c.fy, c.cx, c.cy, c.bf = seq.fx, seq.fy, seq.cx, seq.cy, seq.bf
    c.width, c.height = 320, 240
    cfg.orb.n_levels, cfg.orb.tile_h, cfg.orb.tile_w = 3, 16, 16
    group = mh.global_group()
    Frame._next_id = 0
    slam = SlamSystem(cfg, sensor="stereo", device="cpu", mesh=group)
    mapper = slam.local_mapper
    counts = {"lba": 0, "dist": 0}
    lba_solve, dist_solve = mapper._lba_solve, mapper._dist_ba.solve

    def counted_lba(prep):
        counts["lba"] += 1
        return lba_solve(prep)

    def counted_dist(*a, **kw):
        counts["dist"] += 1
        return dist_solve(*a, **kw)

    mapper._lba_solve, mapper._dist_ba.solve = counted_lba, counted_dist
    states = [slam.track_stereo(seq.lefts[i], seq.rights[i], seq.timestamps[i])[0]
              for i in range(len(seq.lefts))]
    ts, poses = slam.camera_trajectory()
    ate = ate_rmse(np.asarray(ts), np.asarray(poses), seq.timestamps, seq.poses_twc)
    length = np.linalg.norm(np.diff(seq.poses_twc[:, :3, 3], axis=0), axis=1).sum()

    lc = LoopCloser(slam.map, None, c, slam.frontend.geom, "cpu", mesh=group)
    plain = LoopCloser(slam.map, None, c, slam.frontend.geom, "cpu")
    prep = lc._gba_prepare()
    gba_dist, gba_plain = lc._gba_solve(prep), plain._gba_solve(prep)
    thread = lc.launch_async_gba()
    thread.join(timeout=60)
    return dict(ok=[s == TrackingState.OK for s in states], ate=ate, length=length,
                poses=np.asarray(poses), counts=counts, gba_dist=gba_dist,
                gba_plain=gba_plain, C=len(prep["kids"]), async_alive=thread.is_alive(),
                kf_pose=slam.map.kf_pose.copy(), own_group=lc._dist_ba.group is not group)


@pytest.fixture(scope="module")
def mesh_runs(tmp_path_factory):
    return run_ranks(_mesh_session, tmp_path_factory.mktemp("mesh"), timeout=240.0)


def test_slam_mesh_tracks_within_the_gate(mesh_runs):
    for r in mesh_runs:
        assert all(r["ok"])
        assert r["ate"] < 0.05 * max(r["length"], 0.5), r["ate"]
        assert r["counts"]["lba"] >= 1 and r["counts"]["dist"] == r["counts"]["lba"], r["counts"]


def test_slam_mesh_ranks_agree(mesh_runs):
    a, b = mesh_runs
    assert np.array_equal(a["poses"], b["poses"])
    assert np.array_equal(a["kf_pose"], b["kf_pose"])


def test_loop_closer_mesh_gba_matches_the_plain_solve(mesh_runs):
    for r in mesh_runs:
        assert r["own_group"] and not r["async_alive"]
        (R, t, _), (Rp, tp, _) = r["gba_dist"], r["gba_plain"]
        C = r["C"]
        centre = lambda R, t: -np.einsum("cji,cj->ci", R[:C], t[:C])  # noqa: E731
        np.testing.assert_allclose(centre(R, t), centre(Rp, tp), atol=5e-3, rtol=0)
        np.testing.assert_array_equal(t[0], r["gba_plain"][1][0])   # the gauge
