"""The port's Lie algebra and loop-closing / relocalization solvers against
the JAX package on the CPU, on the same numpy-seeded inputs:

- SO(3), SE(3) and Sim(3) exp, log, compose and inverse within 1e-6
  (measured <= 2.4e-7), near the identity and near pi included;
- PnP RANSAC and Sim(3) RANSAC given the minimal samples that
  ``jax.random`` draws inside the JAX functions: identical best count and
  inlier mask, R and t within 1e-4 (s too for Sim(3));
- Horn's closed form, both scale modes, within 1e-4;
- sim3_optimization from a perturbed start, fix_scale both ways: identical
  inliers, s, R and t within 1e-4;
- the pose graph of tests/test_solvers.py's loop test, fix_scale both
  ways: poses within 1e-4.
"""
import multiprocessing
import traceback

import numpy as np
import pytest

pytest.importorskip("jax")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from jetson_slam_tpu.core import optimizer as jopt  # noqa: E402
from jetson_slam_tpu.core import pnp_solver as jpnp  # noqa: E402
from jetson_slam_tpu.core import pose_graph as jpg  # noqa: E402
from jetson_slam_tpu.core import sim3_solver as jsim3  # noqa: E402
from jetson_slam_tpu.utils import lie as jl  # noqa: E402
from jetson_slam_tpu_torch.core import optimizer as topt  # noqa: E402
from jetson_slam_tpu_torch.core import pnp_solver as tpnp  # noqa: E402
from jetson_slam_tpu_torch.core import pose_graph as tpg  # noqa: E402
from jetson_slam_tpu_torch.core import sim3_solver as tsim3  # noqa: E402
from jetson_slam_tpu_torch.utils import lie as tl  # noqa: E402

torch.set_num_threads(2)

FX, FY, CX, CY = 300.0, 300.0, 160.0, 120.0


def _t(a):
    return torch.as_tensor(np.array(a))


def _close(a, b, atol):
    np.testing.assert_allclose(np.asarray(b), np.asarray(a), atol=atol, rtol=0)


def _child_main(conn, fn):
    try:
        jax.config.update("jax_platforms", "cpu")
        args = conn.recv()
        conn.send((True, fn(*args)))
    except BaseException:
        conn.send((False, traceback.format_exc()))
    finally:
        conn.close()


class InChild:
    """fn(*args) in a spawned process, beside the tests of this one: the
    whole-run tests run the JAX package's sessions there while the port's
    run here.  The process starts (and imports fn's module) at once;
    ``start(*args)`` hands it the arguments, ``result()`` waits for the
    value, ``close()`` stops the process.  fn and args must pickle (fn at a
    module's top level)."""

    def __init__(self, fn):
        ctx = multiprocessing.get_context("spawn")
        self._conn, child_conn = ctx.Pipe()
        self._proc = ctx.Process(target=_child_main, args=(child_conn, fn), daemon=True)
        self._proc.start()
        child_conn.close()

    def start(self, *args):
        self._conn.send(args)
        return self

    def result(self):
        while not self._conn.poll(1.0):
            if not self._proc.is_alive() and not self._conn.poll(0):
                raise RuntimeError(f"the child exited with {self._proc.exitcode}")
        ok, value = self._conn.recv()
        self._proc.join()
        if not ok:
            raise RuntimeError(f"the child failed:\n{value}")
        return value

    def close(self):
        if self._proc.is_alive():
            self._proc.kill()
        self._proc.join()
        self._conn.close()


def jax_samples(key, n_hyp, k, n_valid):
    """The minimal-sample positions the JAX solvers draw: one split of key
    per hypothesis, k integers in [0, max(n_valid, 1)) each."""
    keys = jax.random.split(key, n_hyp)
    draw = jax.vmap(lambda kk: jax.random.randint(kk, (k,), 0, max(n_valid, 1)))
    return torch.as_tensor(np.asarray(draw(keys)).astype(np.int64))


def _tangents(seed, n=24):
    rng = np.random.default_rng(seed)
    xi = (rng.normal(size=(n, 7)) * 0.5).astype(np.float32)
    xi[0] = 0.0                          # identity
    xi[1, 3:6] = 0.0                     # pure translation and scale
    xi[2, 6] = 0.0                       # no scale
    xi[3] = 1e-6                         # Taylor branches
    xi[4, 3:6] = [3.05, 0.0, 0.0]        # rotation near pi
    xi[5, 3:6] = [0.0, -1.9, 2.1]
    return xi


@pytest.mark.parametrize("fn", ["exp_sim3", "log_sim3", "sim3_compose",
                                "sim3_inverse", "sim3_apply", "exp_so3",
                                "log_so3", "exp_se3", "log_se3", "se3_inverse"])
def test_lie_matches_jax(fn):
    xi = _tangents(0)
    xj = _tangents(1)
    s, R, t = (np.asarray(a) for a in jl.exp_sim3(jnp.asarray(xi)))
    s2, R2, t2 = (np.asarray(a) for a in jl.exp_sim3(jnp.asarray(xj)))
    p = np.random.default_rng(2).normal(size=(len(xi), 3)).astype(np.float32)
    args = {"exp_sim3": (xi,), "log_sim3": (s, R, t),
            "sim3_compose": (s, R, t, s2, R2, t2), "sim3_inverse": (s, R, t),
            "sim3_apply": (s, R, t, p), "exp_so3": (xi[:, 3:6],),
            "log_so3": (R,), "exp_se3": (xi[:, :6],), "log_se3": (R, t),
            "se3_inverse": (R, t)}[fn]
    want = getattr(jl, fn)(*(jnp.asarray(a) for a in args))
    got = getattr(tl, fn)(*(_t(a) for a in args))
    if not isinstance(want, tuple):
        want, got = (want,), (got,)
    for w, g in zip(want, got):
        _close(w, g.numpy(), 1e-6)


def _pnp_problem(seed, N=80):
    rng = np.random.default_rng(seed)
    pw = np.stack([rng.uniform(-4, 4, N), rng.uniform(-3, 3, N),
                   rng.uniform(4, 12, N)], 1).astype(np.float32)
    R, t = (np.asarray(a) for a in jl.exp_se3(jnp.asarray(
        (rng.normal(size=6) * 0.2).astype(np.float32))))
    pc = pw @ R.T + t
    uv = np.stack([FX * pc[:, 0] / pc[:, 2] + CX, FY * pc[:, 1] / pc[:, 2] + CY],
                  1).astype(np.float32)
    out = rng.choice(N, 15, replace=False)
    uv[out] += rng.uniform(20, 60, (15, 2))
    valid = rng.random(N) < 0.85
    inv = (1.0 / 1.2 ** (2 * rng.integers(0, 3, N))).astype(np.float32)
    return pw, uv, inv, valid


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_pnp_ransac_matches_jax(seed):
    pw, uv, inv, valid = _pnp_problem(seed)
    key = jax.random.PRNGKey(seed + 10)
    Rj, tj, inl_j, n_j = jpnp.pnp_ransac(
        jnp.asarray(pw), jnp.asarray(uv), jnp.asarray(inv), jnp.asarray(valid),
        FX, FY, CX, CY, key, n_hyp=256)
    sample = jax_samples(key, 256, 4, int(valid.sum()))
    Rt, tt, inl_t, n_t = tpnp.pnp_ransac(_t(pw), _t(uv), _t(inv), _t(valid),
                                         FX, FY, CX, CY, sample)
    assert int(n_t) == int(n_j) >= 40
    assert np.array_equal(inl_t.numpy(), np.asarray(inl_j))
    _close(Rj, Rt.numpy(), 1e-4)
    _close(tj, tt.numpy(), 1e-4)


def test_pnp_ransac_batched_matches_single():
    """Leading batch dimensions (the relocalization's candidates) give each
    problem's single-call result."""
    probs = [_pnp_problem(s) for s in (3, 4)]
    samples = [jax_samples(jax.random.PRNGKey(s), 64, 4, int(p[3].sum()))
               for s, p in zip((3, 4), probs)]
    stack = [torch.stack([_t(p[i]) for p in probs]) for i in range(4)]
    Rb, tb, inl_b, n_b = tpnp.pnp_ransac(*stack, FX, FY, CX, CY, torch.stack(samples))
    for c, (p, smp) in enumerate(zip(probs, samples)):
        R, t, inl, n = tpnp.pnp_ransac(*(_t(a) for a in p), FX, FY, CX, CY, smp)
        assert int(n_b[c]) == int(n)
        assert torch.equal(inl_b[c], inl)
        _close(R.numpy(), Rb[c].numpy(), 1e-5)
        _close(t.numpy(), tb[c].numpy(), 1e-5)


def _sim3_problem(seed, scale, N=60):
    rng = np.random.default_rng(seed)
    p1 = np.stack([rng.uniform(-3, 3, N), rng.uniform(-2, 2, N),
                   rng.uniform(4, 10, N)], 1).astype(np.float32)
    xi = np.array([0.1, -0.2, 0.05, 0.02, 0.03, -0.01, np.log(scale)], np.float32)
    s, R, t = jl.exp_sim3(jnp.asarray(xi))
    p2 = np.asarray(jl.sim3_apply(s, R, t, jnp.asarray(p1))).copy()
    out = rng.choice(N, 12, replace=False)
    p2[out] += rng.uniform(1, 3, (12, 3)).astype(np.float32)
    valid = rng.random(N) < 0.9
    th = (9.21 * 1.2 ** (2 * rng.integers(0, 3, N))).astype(np.float32)
    return p1, p2, valid, th, (float(s), np.asarray(R), np.asarray(t))


@pytest.mark.parametrize("fix_scale", [True, False])
def test_horn_sim3_matches_jax(fix_scale):
    p1, p2, _, _, _ = _sim3_problem(5, 1.0 if fix_scale else 1.3, N=12)
    p2 = p2[:12]
    want = jsim3.horn_sim3(jnp.asarray(p1), jnp.asarray(p2), fix_scale)
    got = tsim3.horn_sim3(_t(p1), _t(p2), fix_scale)
    for w, g in zip(want, got):
        _close(w, g.numpy(), 1e-4)


@pytest.mark.parametrize("fix_scale", [True, False])
def test_sim3_ransac_matches_jax(fix_scale):
    p1, p2, valid, th, (s, R, t) = _sim3_problem(6, 1.0 if fix_scale else 1.3)
    cam = (FX, FY, CX, CY)
    key = jax.random.PRNGKey(3)
    want = jsim3.sim3_ransac(jnp.asarray(p1), jnp.asarray(p2), jnp.asarray(valid),
                             cam, cam, jnp.asarray(th), jnp.asarray(th), key,
                             n_hyp=128, fix_scale=fix_scale)
    sample = jax_samples(key, 128, 3, int(valid.sum()))
    got = tsim3.sim3_ransac(_t(p1), _t(p2), _t(valid), cam, cam, _t(th), _t(th),
                            sample, fix_scale=fix_scale)
    assert int(got[4]) == int(want[4]) >= 35
    assert np.array_equal(got[3].numpy(), np.asarray(want[3]))
    for w, g in zip(want[:3], got[:3]):
        _close(w, g.numpy(), 1e-4)
    _close(t, got[2].numpy(), 0.05)


@pytest.mark.parametrize("fix_scale", [True, False])
def test_sim3_optimization_matches_jax(fix_scale):
    rng = np.random.default_rng(4)
    N, fx, fy, cx, cy = 60, 320.0, 320.0, 160.0, 120.0
    w = np.array([0.03, -0.05, 0.02], np.float32)
    R12 = np.asarray(jl.exp_so3(jnp.asarray(w)))
    t12 = np.array([0.3, -0.1, 0.2], np.float32)
    scale = 1.0 if fix_scale else 1.2
    P2 = np.stack([rng.uniform(-2, 2, N), rng.uniform(-1.5, 1.5, N),
                   rng.uniform(4, 10, N)], 1).astype(np.float32)
    P1 = (scale * (P2 @ R12.T) + t12).astype(np.float32)

    def proj(P):
        return np.stack([fx * P[:, 0] / P[:, 2] + cx, fy * P[:, 1] / P[:, 2] + cy],
                        1).astype(np.float32)

    obs1 = proj(P1) + rng.normal(0, 0.5, (N, 2)).astype(np.float32)
    obs2 = proj(P2) + rng.normal(0, 0.5, (N, 2)).astype(np.float32)
    obs1[:6] += 40.0
    R0 = np.asarray(jl.exp_so3(jnp.asarray(w + 0.02)))
    t0 = t12 + np.array([0.05, 0.02, -0.04], np.float32)
    inv1 = (1.0 / 1.2 ** (2 * rng.integers(0, 3, N))).astype(np.float32)
    inv2 = np.ones(N, np.float32)
    valid = np.ones(N, bool)
    valid[-3:] = False
    want = jopt.sim3_optimization(
        jnp.asarray(P1), jnp.asarray(P2), jnp.asarray(obs1), jnp.asarray(obs2),
        jnp.asarray(inv1), jnp.asarray(inv2), jnp.asarray(valid), jnp.float32(1.0),
        jnp.asarray(R0), jnp.asarray(t0), fx, fy, cx, cy, fix_scale=fix_scale)
    got = topt.sim3_optimization(
        _t(P1), _t(P2), _t(obs1), _t(obs2), _t(inv1), _t(inv2), _t(valid), 1.0,
        _t(R0), _t(t0), fx, fy, cx, cy, fix_scale=fix_scale)
    assert np.array_equal(got[3].numpy(), np.asarray(want[3]))
    assert int(got[4]) == int(want[4]) >= N - 10
    assert not got[3].numpy()[:6].any()
    for w_, g in zip(want[:3], got[:3]):
        _close(w_, g.numpy(), 1e-4)
    # from s = 1 both packages reach 1.186 of the true 1.2 in 15 iterations
    _close(scale, got[0].numpy(), 0.03)


def _loop_graph(seed):
    """tests/test_solvers.py::test_pose_graph_closes_loop's graph: a chain
    of 12 poses along x with accumulated drift, true relative
    measurements, and a loop edge from the last to the first."""
    rng = np.random.default_rng(seed)
    K = 12
    ts_gt = np.zeros((K, 3), np.float32)
    ts_gt[:, 0] = np.arange(K) * 0.5
    Rs = np.tile(np.eye(3, dtype=np.float32), (K, 1, 1))
    drift = np.cumsum(rng.normal(0, 0.05, (K, 3)), axis=0).astype(np.float32)
    drift -= drift[0]
    ts_est = ts_gt + drift
    e_i, e_j, mR, mt, ms = [], [], [], [], []
    for a, b in [(a + 1, a) for a in range(K - 1)] + [(K - 1, 0)]:
        R_ij = np.eye(3, dtype=np.float32)
        t_ij = -ts_gt[a] + ts_gt[b]
        e_i.append(a)
        e_j.append(b)
        mR.append(R_ij.T)
        mt.append(-R_ij.T @ t_ij)
        ms.append(1.0)
    fixed = np.zeros(K, bool)
    fixed[0] = True
    return ((np.ones(K, np.float32), Rs, (-ts_est).astype(np.float32), fixed,
             np.array(e_i, np.int32), np.array(e_j, np.int32),
             np.array(ms, np.float32), np.stack(mR), np.stack(mt).astype(np.float32),
             np.ones(len(e_i), bool)), ts_gt)


@pytest.mark.parametrize("fix_scale", [True, False])
def test_pose_graph_matches_jax(fix_scale):
    args, ts_gt = _loop_graph(0)
    want = jpg.pose_graph_optimize(*(jnp.asarray(a) for a in args), n_iters=30,
                                   fix_scale=fix_scale)
    got = tpg.pose_graph_optimize(*(_t(a) for a in args), n_iters=30,
                                  fix_scale=fix_scale)
    for w, g in zip(want, got):
        _close(w, g.numpy(), 1e-4)
    assert np.abs(got[2].numpy() + ts_gt).max() < 0.02
