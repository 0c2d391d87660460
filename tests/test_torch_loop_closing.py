"""Loop closing of the port against the JAX package on the CPU.

- The port's versions of the 11 tests of tests/test_loop_parity.py and the
  two of tests/test_async_gba.py: each builds its map with the JAX
  package's helpers, copies it into the port (``convert.map_store_from_
  numpy``), runs the JAX LoopCloser on one copy and the port's on the
  other, makes the original assertions on the port and compares the two
  packages' results exactly (maps, edges, matches) or, for poses, within
  1e-4.  The port's Sim(3) RANSAC is given the minimal samples that the
  JAX LoopCloser's key chain draws (``_sim3_sample``).
- One whole run of both packages on the 84-frame, 1.3-lap circle of
  tests/test_loop_fuzz.py (320x240, 3 levels, mapping on, synchronous),
  one vocabulary trained with k=6, L=3, seed 0 for both
  (``convert.vocabulary_from_numpy``): the same keyframe and loop
  keyframe at each correction, the same number of loops closed, every
  frame OK, ATE < 0.05 m and within 1.7e-3 m of JAX's (measured: one loop,
  keyframe 27 onto keyframe 2 in both, 29 keyframes each, ATE 0.010505 m
  port and 0.010338 m JAX, gap 1.67e-4 m; the bound is ten times the
  gap).  The JAX session runs in a child process (``InChild``), started
  at the first test of this file, beside the others.
"""
import threading

import numpy as np
import pytest

pytest.importorskip("jax")
import jax  # noqa: E402
import torch  # noqa: E402

from jetson_slam_tpu.bow.vocabulary import Vocabulary as JaxVocabulary  # noqa: E402
from jetson_slam_tpu.core.frame import Frame as JaxFrame  # noqa: E402
from jetson_slam_tpu.core.loop_closing import LoopCloser as JaxLoopCloser  # noqa: E402
from jetson_slam_tpu.core.map import MapStore as JaxMapStore  # noqa: E402
from jetson_slam_tpu.io.evaluation import ate_rmse as jax_ate  # noqa: E402
from jetson_slam_tpu_torch.bow.vocabulary import Vocabulary  # noqa: E402
from jetson_slam_tpu_torch.config import CameraConfig, SLAMConfig  # noqa: E402
from jetson_slam_tpu_torch.convert import map_store_from_numpy, vocabulary_from_numpy  # noqa: E402
from jetson_slam_tpu_torch.core.frame import Frame  # noqa: E402
from jetson_slam_tpu_torch.core.loop_closing import LoopCloser  # noqa: E402
from jetson_slam_tpu_torch.io.evaluation import ate_rmse  # noqa: E402
from jetson_slam_tpu_torch.io.synthetic import make_stereo_sequence  # noqa: E402
from jetson_slam_tpu_torch.models.slam import SlamSystem  # noqa: E402
from jetson_slam_tpu_torch.ops import tables  # noqa: E402
from jetson_slam_tpu_torch.ops.frontend import OrbFrontend  # noqa: E402
from tests.test_loop_parity import (FX, CX, CY, _add_kf, _cam, _geom,  # noqa: E402
                                    _project, _shared_map)
from tests.test_slam_e2e import make_system  # noqa: E402
from tests.test_torch_solvers import InChild, jax_samples  # noqa: E402

torch.set_num_threads(2)


def _port_cam():
    cam = CameraConfig()
    cam.fx, cam.fy, cam.cx, cam.cy = FX, FX, CX, CY
    cam.bf = 0.1 * FX
    return cam


def _port_geom():
    return tables.pyramid_geometry(240, 320, 3, 1.2, 16, 16)


def _closers(jm, sensor="stereo", run_gba=False):
    """(JAX LoopCloser on jm, port LoopCloser on a copy of jm); the port's
    RANSAC samples follow the JAX closer's key chain (PRNGKey(0), one split
    per candidate that reaches RANSAC)."""
    pm = map_store_from_numpy(vars(jm))
    jlc = JaxLoopCloser(jm, database=None, cam=_cam(), geom=_geom(),
                        sensor=sensor, run_gba=run_gba)
    plc = LoopCloser(pm, None, _port_cam(), _port_geom(), "cpu", sensor=sensor,
                     run_gba=run_gba)
    key = [jax.random.PRNGKey(0)]

    def sample(n_valid):
        key[0], sub = jax.random.split(key[0])
        return jax_samples(sub, plc.SIM3_HYPOTHESES, 3, n_valid)

    plc._sim3_sample = sample
    return jlc, plc


def _same_map(pm, jm):
    for k, v in vars(jm).items():
        if k.startswith(("pt_", "kf_")):
            assert np.array_equal(getattr(pm, k), v), k
    assert pm.loop_edges == jm.loop_edges


def _both(jm):
    return jm, map_store_from_numpy(vars(jm))


# --------------------------------------------------------------- spanning tree
def test_parent_assignment_first_connection():
    jm, m = _both(_shared_map(n_kf=3)[0])
    for mm in (jm, m):
        mm.update_spanning_tree(1)
        mm.update_spanning_tree(2)
    assert m.kf_parent[0] == -1
    assert m.kf_parent[1] == 0
    assert m.kf_parent[2] in (0, 1)
    assert not m.kf_first_connection[1]
    p = m.kf_parent[2]
    m.update_spanning_tree(2)
    jm.update_spanning_tree(2)
    assert m.kf_parent[2] == p
    _same_map(m, jm)


def test_erase_keyframe_reassigns_children():
    jm, m = _both(_shared_map(n_kf=4)[0])
    for mm in (jm, m):
        for k in (1, 2, 3):
            mm.update_spanning_tree(k)
        mm.kf_parent[2] = 1
        mm.kf_parent[3] = 2
        mm.erase_keyframe(1)
    assert not m.kf_alive[1]
    assert m.kf_parent[2] == 0
    assert m.kf_parent[3] == 2
    _same_map(m, jm)


def test_loop_edge_blocks_erase_and_persists():
    jm, m = _both(_shared_map(n_kf=4)[0])
    for mm in (jm, m):
        mm.add_loop_edge(3, 1)
        mm.erase_keyframe(1)
    assert (1, 3) in m.loop_edges
    assert m.kf_alive[1]
    for mm in (jm, m):
        mm.erase_keyframe(2)
    assert not m.kf_alive[2]
    _same_map(m, jm)


def test_essential_edges_carry_tree_loop_and_covis():
    jm = _shared_map(n_kf=4)[0]
    for k in (1, 2, 3):
        jm.update_spanning_tree(k)
    jm.add_loop_edge(0, 3)
    jlc, plc = _closers(jm)
    kids = plc.map.keyframe_ids()
    edges = plc._essential_edges(kids)
    assert edges == jlc._essential_edges(jm.keyframe_ids())
    kinds = {(a, b): kind for a, b, kind in edges}
    pos = {int(k): i for i, k in enumerate(kids)}
    assert kinds[(pos[0], pos[3])] == "loop"
    assert (pos[0], pos[1]) in kinds
    assert all(k != "covis" for k in kinds.values())


# ------------------------------------------------------------- SearchBySim3
@pytest.mark.parametrize("half", [False, True], ids=["identity", "skips_already_matched"])
def test_search_by_sim3_matches_jax(half):
    """tests/test_loop_parity.py's test_search_by_sim3_identity_recovers_
    matches and test_search_by_sim3_skips_already_matched."""
    jm, pts, _, _ = _shared_map(n_kf=2)
    jlc, plc = _closers(jm)
    already = np.zeros(jm.n_slots, bool)
    if half:
        already[: len(pts) // 2] = True
    args = (0, 1, 1.0, np.eye(3), np.zeros(3), already, already)
    got = plc._search_by_sim3(*args)
    assert np.array_equal(got, np.asarray(jlc._search_by_sim3(*args)))
    found = np.flatnonzero(got >= 0)
    if half:
        assert (got[: len(pts) // 2] == -1).all()
        assert (got[len(pts) // 2: len(pts)] >= 0).sum() > 0.8 * (len(pts) // 2)
    else:
        assert len(found) > 0.9 * len(pts)
        assert (got[found] == found).all()


# ------------------------------------------------- ComputeSim3 acceptance
def _compute_both(jm, sensor="stereo"):
    jlc, plc = _closers(jm, sensor=sensor)
    want = jlc.compute_sim3(1, [0])
    got = plc.compute_sim3(1, [0])
    assert got[0] == want[0] and got[1] == want[1]
    if want[0]:
        assert abs(got[2] - want[2]) <= 1e-4
        np.testing.assert_allclose(got[3], np.asarray(want[3]), atol=1e-4, rtol=0)
        np.testing.assert_allclose(got[4], np.asarray(want[4]), atol=1e-4, rtol=0)
        assert got[5] == want[5]
    return got


def test_compute_sim3_accepts_true_loop():
    ok, loop_kf, s, R, t, matched = _compute_both(_shared_map(n_kf=2, n_pts=80)[0])
    assert ok and loop_kf == 0
    assert len(matched) >= 40
    assert s == pytest.approx(1.0, abs=0.05)
    assert np.linalg.norm(t) < 0.2


def test_compute_sim3_rejects_aliased_geometry():
    rng = np.random.default_rng(5)
    m = JaxMapStore(max_points=1024, max_keyframes=16, n_slots=256)
    n = 80
    descs = rng.integers(0, 256, (n, 32)).astype(np.uint8)
    pts_a = rng.uniform([-2, -1.5, 4], [2, 1.5, 8], (n, 3)).astype(np.float32)
    pts_b = pts_a[rng.permutation(n)].copy()
    pts_b[:, 2] = rng.uniform(4, 8, n)
    pids_a, pids_b = [], []
    for pts, pids, ref in ((pts_a, pids_a, 0), (pts_b, pids_b, 1)):
        for i in range(n):
            p = m.add_point(pts[i], descs[i], ref)
            m.pt_min_dist[p] = 0.5
            m.pt_max_dist[p] = 50.0
            pids.append(p)
    eye = np.eye(4, dtype=np.float32)
    _add_kf(m, eye, _project(pts_a, eye), descs, pids_a)
    _add_kf(m, eye, _project(pts_b, eye), descs, pids_b)
    ok, *_ = _compute_both(m)
    assert not ok


def test_compute_sim3_enforces_40_total_gate():
    ok, *_ = _compute_both(_shared_map(n_kf=2, n_pts=30)[0])
    assert not ok


def test_second_loop_reuses_first_loop_edge():
    jm = _shared_map(n_kf=6)[0]
    for k in range(1, 6):
        jm.update_spanning_tree(k)
    jm.add_loop_edge(4, 0)
    jm.add_loop_edge(5, 1)
    jlc, plc = _closers(jm)
    edges = plc._essential_edges(plc.map.keyframe_ids())
    assert edges == jlc._essential_edges(jm.keyframe_ids())
    loops = {(a, b) for a, b, kind in edges if kind == "loop"}
    assert (0, 4) in loops and (1, 5) in loops


def test_mono_sim3_recovers_scale_drift():
    lam = 1.3
    rng = np.random.default_rng(8)
    m = JaxMapStore(max_points=1024, max_keyframes=16, n_slots=256)
    n = 80
    pts = rng.uniform([-2.0, -1.5, 4.0], [2.0, 1.5, 8.0], (n, 3)).astype(np.float32)
    descs = rng.integers(0, 256, (n, 32)).astype(np.uint8)

    def add_points(P, ref):
        out = []
        for i in range(n):
            pid = m.add_point(P[i], descs[i], ref)
            d = float(np.linalg.norm(P[i]))
            m.pt_max_dist[pid] = d
            m.pt_min_dist[pid] = d / 1.2 ** 2
            m.pt_normal[pid] = P[i] / max(d, 1e-9)
            out.append(pid)
        return out

    eye = np.eye(4, dtype=np.float32)
    xy = _project(pts, eye)
    pids_loop = add_points(pts, 0)
    pids_cur = add_points((lam * pts).astype(np.float32), 1)
    _add_kf(m, eye, xy, descs, pids_loop)
    _add_kf(m, eye, xy, descs, pids_cur)
    ok, loop_kf, s, R, t, matched = _compute_both(m, sensor="mono")
    assert ok and loop_kf == 0
    assert s == pytest.approx(1.0 / lam, rel=0.05), s
    assert len(matched) >= 40


# ----------------------------------------------------------------- async GBA
def _gba_maps():
    jm = _shared_map(n_kf=4, n_pts=80)[0]
    for k in (1, 2, 3):
        jm.update_spanning_tree(k)
    return jm


def test_gba_catchup_corrects_keyframes_created_during_solve():
    """tests/test_async_gba.py's catch-up test on both packages: the same
    snapshot, solutions within 1e-4, and the same map after the commit."""
    jm = _gba_maps()
    jlc, plc = _closers(jm, run_gba=True)
    m = plc.map
    prep_j = jlc._gba_prepare()
    prep = plc._gba_prepare()
    assert prep is not None and set(prep) == set(prep_j)
    for k in prep_j:
        assert np.array_equal(np.asarray(prep[k]), np.asarray(prep_j[k])), k
    _, pts, descs, pids = _shared_map(n_kf=4, n_pts=80)
    pose = np.eye(4, dtype=np.float32)
    pose[0, 3] = 0.2
    for mm in (jm, m):
        new_kid = _add_kf(mm, pose, _project(pts, pose), descs, pids)
        mm.kf_parent[new_kid] = 3
        new_pid = mm.add_point(np.array([0.5, 0.5, 6.0], np.float32), descs[0], 3)
        mm.pt_ref_kf[new_pid] = 3
    rel_R = pose[:3, :3] @ np.linalg.inv(m.kf_pose[3])[:3, :3]
    p_in_kf3 = m.kf_pose[3, :3, :3] @ m.pt_pos[new_pid] + m.kf_pose[3, :3, 3]
    sol_j = [np.array(a) for a in jlc._gba_solve(prep_j)]
    sol = [np.array(a) for a in plc._gba_solve(prep)]
    for a, b in zip(sol, sol_j):
        np.testing.assert_allclose(a, b, atol=1e-4, rtol=0)
    i3 = int(np.flatnonzero(prep["kids"] == 3)[0])
    for s_ in (sol, sol_j):
        s_[1][i3] = s_[1][i3] + np.array([0.1, 0.0, 0.0], np.float32)
    jlc._gba_commit(prep_j, tuple(sol_j))
    plc._gba_commit(prep, tuple(sol))
    rel_after = m.kf_pose[new_kid, :3, :3] @ np.linalg.inv(m.kf_pose[3])[:3, :3]
    np.testing.assert_allclose(rel_after, rel_R, atol=1e-4)
    p_after = m.kf_pose[3, :3, :3] @ m.pt_pos[new_pid] + m.kf_pose[3, :3, 3]
    np.testing.assert_allclose(p_after, p_in_kf3, atol=1e-3)
    assert np.linalg.norm(m.kf_pose[3, :3, 3] - prep["ts"][i3]) > 0.05
    np.testing.assert_allclose(m.kf_pose, jm.kf_pose, atol=1e-4, rtol=0)
    np.testing.assert_allclose(m.pt_pos, jm.pt_pos, atol=1e-4, rtol=0)


def test_async_gba_runs_off_thread_and_commits():
    jm = _gba_maps()
    jlc, plc = _closers(jm, run_gba=True)
    m = plc.map
    lock = threading.Lock()
    t = plc.launch_async_gba(lock=lock)
    tj = jlc.launch_async_gba(lock=threading.Lock())
    assert t is not None and t is not threading.current_thread()
    t.join(timeout=120.0)
    tj.join(timeout=120.0)
    assert not t.is_alive()
    assert np.isfinite(m.kf_pose[m.kf_alive]).all()
    np.testing.assert_allclose(m.kf_pose, jm.kf_pose, atol=1e-4, rtol=0)
    t2 = plc.launch_async_gba(lock=lock)
    assert t2 is not None
    t2.join(timeout=120.0)
    plc.join_gba()
    assert not t2.is_alive()


def test_async_gba_commits_under_concurrent_map_writes():
    """Stress: while a GBA solves on its own thread, a writer thread
    recycles point rows under the same lock, with a short switch interval:
    it erases a point and allocates its row again (a new generation) at a
    marker position, with no observation and no reference keyframe.  The
    commit waits until the writer is done (a hook after the solve), so it
    must skip every recycled row, whose generation its snapshot did not
    see, and every marker survives; the map stays consistent.  Three
    rounds."""
    import sys
    jm = _gba_maps()
    _, plc = _closers(jm, run_gba=True)
    m = plc.map
    lock = threading.RLock()
    release = threading.Event()
    solve = plc._gba_solve

    def held_solve(prep):
        sol = solve(prep)
        assert release.wait(timeout=60.0)
        return sol

    plc._gba_solve = held_solve
    rng = np.random.default_rng(1)
    marker = {}

    def writer():
        for pid in range(40, 80):
            with lock:
                m.erase_point(pid)
                m._next_pt = pid
                pos = (rng.uniform(-1.0, 1.0, 3) + [0, 0, 6]).astype(np.float32)
                assert m.add_point(pos, m.pt_desc[pid], -1) == pid
                marker[pid] = pos

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        for _ in range(3):
            release.clear()
            with lock:
                t = plc.launch_async_gba(lock=lock)
            assert t is not None
            w = threading.Thread(target=writer)
            w.start()
            w.join(timeout=60.0)
            assert not w.is_alive()
            release.set()
            t.join(timeout=120.0)
            assert not t.is_alive()
            for pid, pos in marker.items():
                assert np.array_equal(m.pt_pos[pid], pos), pid
    finally:
        sys.setswitchinterval(old)
    assert np.isfinite(m.kf_pose[m.keyframe_ids()]).all()
    for pid in np.flatnonzero(m.pt_alive):
        for kf, slot in m._pt_obs.get(int(pid), {}).items():
            assert m.kf_obs[kf, slot] == pid


@pytest.mark.parametrize("hold", ["after_solve", "before_solve"])
def test_stale_async_gba_is_dropped_and_a_new_one_follows(hold):
    """Two loop corrections with the first correction's GBA held open
    between them (LoopClosing.cpp's mbStopGBA / mnFullBAIdx): the held GBA
    solved for the map before the second correction, so its commit is
    dropped, and a second GBA, launched by the second correction, commits.
    The map ends as a synchronous GBA from the state after the second
    correction leaves it: the second correction's poses are not overwritten
    by the first GBA's solution.  Held before its solve starts, the stale
    GBA stops before its first LM iteration: its solution is its snapshot."""
    jm = _gba_maps()
    _, plc = _closers(jm, run_gba=True)
    m = plc.map
    lock = threading.RLock()
    plc.async_gba, plc.gba_lock = True, lock
    entered, release = threading.Event(), threading.Event()
    solve, commit = plc._gba_solve, plc._gba_commit
    solves, sols, commits = [], [], []

    def held_solve(prep):
        solves.append(prep)
        hold_this = not entered.is_set()
        entered.set()
        if hold_this and hold == "before_solve":
            assert release.wait(timeout=60.0)
            # moved off its optimum, so that any LM iteration would move it
            prep["pt_pos"] = prep["pt_pos"] + np.float32(0.05)
        sol = solve(prep)
        sols.append(sol)
        if hold_this and hold == "after_solve":
            assert release.wait(timeout=60.0)
        return sol

    def counted_commit(prep, sol):
        commits.append(prep)
        return commit(prep, sol)

    plc._gba_solve, plc._gba_commit = held_solve, counted_commit
    eye = np.eye(3, dtype=np.float32)
    with lock:
        plc.correct_loop(3, 0, 1.0, eye, np.array([0.04, 0.0, 0.01], np.float32))
    assert entered.wait(timeout=60.0)
    with lock:
        plc.correct_loop(3, 1, 1.0, eye, np.array([-0.03, 0.02, 0.0], np.float32))
        after = map_store_from_numpy(vars(m))
    release.set()
    plc.join_gba()
    assert len(solves) == 2, "no GBA followed the second correction"
    assert len(commits) == 1 and commits[0] is solves[1], "the stale GBA committed"
    assert plc.gba_dropped == 1
    if hold == "before_solve":
        stale, sol = solves[0], sols[0]
        np.testing.assert_array_equal(np.asarray(sol[0]), stale["Rs"])
        np.testing.assert_array_equal(np.asarray(sol[1]), stale["ts"])
        np.testing.assert_array_equal(np.asarray(sol[2]), stale["pt_pos"])
    ref = LoopCloser(after, None, _port_cam(), _port_geom(), "cpu", run_gba=True)
    ref.global_bundle_adjustment()
    np.testing.assert_allclose(m.kf_pose, ref.map.kf_pose, atol=1e-5, rtol=0)
    np.testing.assert_allclose(m.pt_pos, ref.map.pt_pos, atol=1e-5, rtol=0)


class _Database:
    """The keyframe database's protocol, with no vocabulary."""

    def __init__(self, n):
        self.has = np.zeros(n, bool)

    def add(self, kid, _descs):
        self.has[kid] = True

    def erase(self, kid):
        self.has[kid] = False


@pytest.mark.parametrize("loop_row", ["fresh", "recycled"])
def test_loop_spacing_counts_keyframes_created_not_rows(loop_row):
    """After a loop, detection is skipped for exactly the next 9 keyframes
    created (DetectLoop's mnId < mLastLoopKFid + 10), whether they land on
    rows that culling freed (low) or on fresh rows (high), and whether the
    loop's own keyframe sits on a fresh or a recycled row.  Rows churn as
    in tests/test_aux_subsystems.py::test_keyframe_rows_recycle."""
    from jetson_slam_tpu_torch.core.map import MapStore
    S = 16
    m = MapStore(max_points=256, max_keyframes=48, n_slots=S)

    class F:
        timestamp = 0.0
        frame_id = 0
        Tcw = np.eye(4, dtype=np.float32)
        kp_xy = np.zeros((S, 2), np.float32)
        octave = np.zeros(S, np.int32)
        angle = np.zeros(S, np.float32)
        u_right = np.full(S, -1.0, np.float32)
        depth = np.full(S, -1.0, np.float32)
        desc = np.zeros((S, 32), np.uint8)
        valid = np.ones(S, bool)
        map_points = np.full(S, -1, np.int32)

    lc = LoopCloser(m, _Database(48), _port_cam(), _port_geom(), "cpu")
    order = []          # (row, creation index) of every keyframe created
    attempts = []       # creation indices that reached detection
    loop_at = []

    def detect(kid):
        attempts.append(order[-1][1])
        return [0] if not loop_at and order[-1][1] == want_loop else []

    def sim3(kid, candidates):
        loop_at.append(order[-1][1])
        return True, 0, 1.0, np.eye(3, dtype=np.float32), np.zeros(3, np.float32), {}

    lc.detect_loop, lc.compute_sim3 = detect, sim3
    lc.correct_loop = lambda *a, **k: None

    def create():
        kid = m.add_keyframe(F())
        order.append((int(kid), len(order)))
        lc.process_keyframe(kid)

    want_loop = 15      # the 16th keyframe closes the loop
    for _ in range(15):
        create()                         # rows 0..14
    if loop_row == "fresh":
        create()                         # the loop on row 15; rows 7..3 reused after
        for k in range(3, 8):
            m.erase_keyframe(k)
    else:
        for k in range(3, 8):
            m.erase_keyframe(k)          # the loop on row 7, recycled
    for _ in range(20):
        create()
    assert loop_at == [want_loop]
    rows = dict((i, r) for r, i in order)
    assert (rows[want_loop] >= 15) == (loop_row == "fresh")
    after = [i for _, i in order if i > want_loop]
    assert any(rows[i] < 15 for i in after[:9]) and any(rows[i] >= 15 for i in after[:9])
    assert [i for i in attempts if i > want_loop] == after[9:]


# ------------------------------------------------------------ the whole run
def _port_system(seq, **kw):
    """tests/test_slam_e2e.py's make_system for the port."""
    cfg = SLAMConfig()
    c = cfg.camera
    c.fx, c.fy, c.cx, c.cy, c.bf = seq.fx, seq.fy, seq.cx, seq.cy, seq.bf
    c.width, c.height = seq.lefts[0].shape[1], seq.lefts[0].shape[0]
    c.k1 = c.k2 = c.p1 = c.p2 = 0.0
    c.th_depth = 40.0
    cfg.orb.n_levels, cfg.orb.tile_h, cfg.orb.tile_w = 3, 16, 16
    cfg.orb.th_fast_max = 15
    cfg.max_map_points, cfg.max_keyframes = 16384, 64
    return SlamSystem(cfg, sensor="stereo", device="cpu", **kw)


def _circle_run(slam, seq, jax_package):
    events = []
    lc = slam.loop_closer
    orig = lc.correct_loop

    def correct(kid, loop_kf, *a, **k):
        events.append((int(kid), int(loop_kf)))
        return orig(kid, loop_kf, *a, **k)

    lc.correct_loop = correct
    states = []
    for i in range(len(seq.lefts)):
        state, _ = slam.track_stereo(seq.lefts[i], seq.rights[i], seq.timestamps[i])
        states.append(state.name)
    slam.shutdown()
    ts, poses = slam.camera_trajectory()
    ate = (jax_ate if jax_package else ate_rmse)(
        np.asarray(ts), np.asarray(poses), seq.timestamps, seq.poses_twc)
    return dict(events=events, loops=lc.n_loops_closed, states=states, ate=ate,
                created=int(slam.map.kf_gen.sum()))


def _jax_circle(tree, seq):
    """The JAX package's session on the circle (run in a child process)."""
    JaxFrame._next_id = 0
    return _circle_run(make_system(seq, vocabulary=JaxVocabulary(*tree)), seq, True)


@pytest.fixture(scope="module", autouse=True)
def jax_circle():
    """Trains the circle's vocabulary and starts the JAX package's session
    in a child process at the first test of this file, so that it runs
    beside the others; yields (the sequence, the vocabulary's arrays, the
    child)."""
    child = InChild(_jax_circle)
    seq = make_stereo_sequence(seed=3, n_frames=84, h=240, w=320, trajectory="circle",
                               n_points=1200, laps=1.3)
    fe = OrbFrontend(240, 320, n_levels=3, scale_factor=1.2, threshold=15, tile_h=16,
                     tile_w=16, device="cpu")
    descs = []
    for i in (0, len(seq.lefts) // 3, 2 * len(seq.lefts) // 3):
        r = fe.extract(seq.lefts[i])
        descs.append(r.desc.numpy()[r.valid.numpy()])
    voc = Vocabulary.train(np.concatenate(descs), k=6, L=3, seed=0)
    tree = (voc.k, voc.L, voc.children, voc.centroids, voc.is_leaf, voc.word_id,
            voc.weights, voc.node_level)
    child.start(tree, seq)
    yield seq, tree, child
    child.close()


def test_circle_closes_the_same_loops_as_jax(jax_circle):
    seq, tree, child = jax_circle
    Frame._next_id = 0
    got = _circle_run(_port_system(seq, vocabulary=vocabulary_from_numpy(
        vars(JaxVocabulary(*tree)))), seq, False)
    want = child.result()
    print(f"port: loops {got['loops']} at {got['events']}, ATE {got['ate']:.6f} m, "
          f"keyframes {got['created']}; jax: loops {want['loops']} at "
          f"{want['events']}, ATE {want['ate']:.6f} m, keyframes {want['created']}")
    assert want["loops"] >= 1
    assert got["events"] == want["events"]
    assert got["loops"] == want["loops"]
    assert got["states"] == want["states"] == ["OK"] * len(seq.lefts)
    assert got["ate"] < 0.05
    assert abs(got["ate"] - want["ate"]) <= 1.7e-3
