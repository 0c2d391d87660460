"""The port's Schur-complement local BA against the JAX package on the CPU.

The three problems of tests/test_local_ba.py (``make_ba_problem``, seeded
numpy) go through both ``local_ba``s: in float64, identical outlier flags
and cameras and points within 1e-6; in float32, the gaps measured and
stated in ``test_local_ba_matches_jax``.  The port then passes the JAX
tests' own gates (error reduced, noise-free exact, outliers flagged).  The closed-form edge
Jacobians match ``torch.func.jacfwd`` through the exp/compose residual,
and ``inv3x3`` matches ``torch.linalg.inv``.  In float32, ``inv3x3``
inverts in float64, so a block whose cofactor determinant cancels to 0
in float32 gets its inverse, and the noisy 10 %-outlier problem of
tests/test_dist_ba.py lands within 1e-4 of float64 with JAX's outlier
classes.
"""
import numpy as np
import pytest

pytest.importorskip("jax")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from jetson_slam_tpu.core.local_ba import local_ba as jax_local_ba  # noqa: E402
from jetson_slam_tpu_torch.core.local_ba import (  # noqa: E402
    _edge_residual, _edges_jacobians, inv3x3, local_ba)
from jetson_slam_tpu_torch.utils.lie import exp_so3  # noqa: E402
from tests.test_local_ba import BF, CX, CY, FX, FY, make_ba_problem  # noqa: E402

torch.set_num_threads(2)

PROBLEMS = {
    "reduces_error": (0, dict(pix_noise=0.1, pt_noise=0.6, pose_noise=0.03)),
    "noise_free": (3, dict(pix_noise=0.0)),
    "outliers": (1, dict(outlier_frac=0.1)),
}


def _problem(name):
    seed, kw = PROBLEMS[name]
    return make_ba_problem(np.random.default_rng(seed), **kw)


def _inputs(problem):
    Rs_i, ts_i, fixed, pts_i, e_cam, e_pt, obs, stereo, pt_edges = problem[:9]
    E = len(e_cam)
    return (Rs_i, ts_i, fixed, pts_i, e_cam, e_pt, obs, stereo,
            np.ones(E, np.float32), np.ones(E, bool), pt_edges)


def _run_jax(problem, dtype=np.float32):
    inp = [a.astype(dtype) if a.dtype == np.float32 else a
           for a in map(np.asarray, _inputs(problem))]
    with jax.enable_x64(dtype == np.float64):
        out = jax_local_ba(*(jnp.asarray(a) for a in inp), FX, FY, CX, CY, BF)
        return [np.asarray(o) for o in out]


def _run_port(problem, dtype=np.float32):
    inp = [a.astype(dtype) if a.dtype == np.float32 else a
           for a in map(np.asarray, _inputs(problem))]
    out = local_ba(*(torch.as_tensor(a) for a in inp), FX, FY, CX, CY, BF)
    return [o.numpy() for o in out]


@pytest.mark.parametrize("name", list(PROBLEMS))
def test_local_ba_matches_jax(name):
    """In float64 the two agree to rounding: the same algorithm.  In
    float32, as both run, rounding moves the weakly held points (one mono
    edge, or edges dropped as outliers) along their free directions, and
    JAX's float32 solve of the outlier problem drifts 2e-4 m from the
    float64 one: the port is held to the float64 solution there, and to
    JAX's float32 one within the measured gaps."""
    problem = _problem(name)
    R64, t64, p64, out64 = _run_jax(problem, np.float64)
    Rt, tt, pt, out_t = _run_port(problem, np.float64)
    assert np.array_equal(out_t, out64)
    for a, b in ((Rt, R64), (tt, t64), (pt, p64)):
        np.testing.assert_allclose(a, b, atol=1e-6, rtol=0)

    Rj, tj, pj, out_j = _run_jax(problem)
    Rt, tt, pt, out_t = _run_port(problem)
    assert (out_t != out_j).sum() <= 0.01 * len(out_j)
    np.testing.assert_allclose(Rt, Rj, atol=1e-4, rtol=0)
    np.testing.assert_allclose(tt, tj, atol=5e-4, rtol=0)
    assert np.median(np.abs(pt - pj)) < 1e-4
    np.testing.assert_allclose(tt, t64, atol=1e-5, rtol=0)
    assert np.median(np.abs(pt - p64)) < 1e-5
    assert (out_t != out64).sum() <= 1


def test_local_ba_reduces_error():
    problem = _problem("reduces_error")
    ts_gt, pts_gt = problem[10], problem[11]
    _, t2, p2, outlier = _run_port(problem)
    err_t_before = np.linalg.norm(problem[1] - ts_gt, axis=1).mean()
    err_t_after = np.linalg.norm(t2 - ts_gt, axis=1).mean()
    err_p_before = np.linalg.norm(problem[3] - pts_gt, axis=1).mean()
    err_p_after = np.median(np.linalg.norm(p2 - pts_gt, axis=1))
    assert err_t_after < 0.5 * err_t_before, (err_t_before, err_t_after)
    assert err_p_after < 0.5 * err_p_before, (err_p_before, err_p_after)
    np.testing.assert_allclose(t2[0], problem[1][0], atol=1e-7)  # fixed camera
    assert outlier.sum() < 0.05 * len(problem[4])


def test_local_ba_noise_free_exact():
    problem = _problem("noise_free")
    _, t2, _, _ = _run_port(problem)
    assert np.linalg.norm(t2 - problem[10], axis=1).mean() < 1e-4


def test_local_ba_flags_outliers():
    problem = _problem("outliers")
    _, _, _, outlier = _run_port(problem)
    assert outlier[problem[12]].mean() > 0.8


def test_analytic_jacobians_match_jacfwd():
    """The reference Jacobians come from jacfwd in float64: torch's forward
    mode gives a float32 0-dim expression such as ``1.0 - t2 / 6.0`` a
    float64 tangent, which a float32 matmul then refuses."""
    rng = np.random.default_rng(5)
    E = 64
    fx, fy, cx, cy, bf = 310.0, 305.0, 160.0, 120.0, 38.0
    Rg = exp_so3(torch.as_tensor(rng.normal(0, 0.4, (E, 3)).astype(np.float32)))
    tg = torch.as_tensor(rng.normal(0, 1.0, (E, 3)).astype(np.float32))
    pg = rng.normal(0, 2.0, (E, 3)).astype(np.float32)
    pg[:, 2] += 8.0  # in front of the cameras
    pg = torch.as_tensor(pg)
    zero3 = torch.zeros(3, dtype=torch.float64)
    zero6 = torch.zeros(6, dtype=torch.float64)
    Jc_ref, Jp_ref = [], []
    for R, t, p in zip(Rg.double(), tg.double(), pg.double()):
        Jc_ref.append(torch.func.jacfwd(lambda xi: _edge_residual(
            xi, zero3, R, t, p, zero3, fx, fy, cx, cy, bf)[0])(zero6))
        Jp_ref.append(torch.func.jacfwd(lambda dp: _edge_residual(
            zero6, dp, R, t, p, zero3, fx, fy, cx, cy, bf)[0])(zero3))
    Jc, Jp = _edges_jacobians(Rg, tg, pg, fx, fy, cx, cy, bf)
    np.testing.assert_allclose(Jc.numpy(), torch.stack(Jc_ref).numpy(),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(Jp.numpy(), torch.stack(Jp_ref).numpy(),
                               rtol=1e-4, atol=1e-4)


def test_inv3x3_matches_linalg_inv():
    rng = np.random.default_rng(2)
    A = rng.normal(0, 1, (256, 3, 3)).astype(np.float32)
    M = torch.as_tensor(A @ A.transpose(0, 2, 1) + 0.5 * np.eye(3, dtype=np.float32))
    np.testing.assert_allclose(inv3x3(M).numpy(), torch.linalg.inv(M).numpy(),
                               rtol=1e-4, atol=1e-4)


# A landmark block Hpp + lam I of tests/test_dist_ba.py's noisy problem (a
# point held by one mono edge, at phase 1's third LM iteration of the
# unguarded solve): exact float32 values whose cofactor determinant is 0 in
# float32 and 10.38 in float64.
CANCELLED_BLOCK = np.array([[1050.1375732421875, 0.0, -623.1981811523438],
                            [0.0, 1050.1375732421875, 93.91535949707031],
                            [-623.1981811523438, 93.91535949707031, 378.232421875]],
                           np.float32)


def adjugate_inverse(M):
    """(adjugate / determinant, determinant) of a batch of 3x3 matrices in
    M's own dtype: inv3x3's formula without its float64."""
    a, b, c = M[..., 0, 0], M[..., 0, 1], M[..., 0, 2]
    d, e, f = M[..., 1, 0], M[..., 1, 1], M[..., 1, 2]
    g, h, i = M[..., 2, 0], M[..., 2, 1], M[..., 2, 2]
    A, B, C = e * i - f * h, c * h - b * i, b * f - c * e
    D, E, F_ = f * g - d * i, a * i - c * g, c * d - a * f
    G, H, I = d * h - e * g, b * g - a * h, a * e - b * d
    det = a * A + b * D + c * G
    rows = torch.stack([torch.stack([A, B, C], -1), torch.stack([D, E, F_], -1),
                        torch.stack([G, H, I], -1)], -2)
    return rows * (1.0 / det)[..., None, None], det


def test_inv3x3_inverts_a_cancelled_block_in_float64():
    """inv3x3 of a float32 batch is the float64 inverse cast back: finite
    and right on the cancelled block, where the float32 adjugate divides by
    0, and within float32 rounding of the float32 adjugate elsewhere."""
    rng = np.random.default_rng(7)
    A = rng.normal(0, 1, (32, 3, 3)).astype(np.float32)
    M = A @ A.transpose(0, 2, 1) + 0.5 * np.eye(3, dtype=np.float32)
    M[11] = CANCELLED_BLOCK
    M = torch.as_tensor(M)
    plain, det = adjugate_inverse(M)
    assert det[11] == 0 and not torch.isfinite(plain[11]).all()
    assert np.linalg.det(CANCELLED_BLOCK.astype(np.float64)) > 10.0
    out = inv3x3(M)
    assert out.dtype == torch.float32
    assert torch.equal(out, adjugate_inverse(M.double())[0].float())
    want = np.linalg.inv(CANCELLED_BLOCK.astype(np.float64)).astype(np.float32)
    np.testing.assert_allclose(out[11].numpy(), want, rtol=1e-6, atol=0)
    keep = torch.arange(32) != 11
    np.testing.assert_allclose(out[keep].numpy(), plain[keep].numpy(), rtol=1e-5,
                               atol=1e-6)


def test_noisy_outlier_problem_lands_near_float64_with_jax_classes():
    """tests/test_dist_ba.py's noisy problem (5 cameras, 64 points, 10 %
    gross outliers), unsharded: the port's float32 solve within 1e-4 of
    the float64 one (measured 9.5e-7; 7.0e-3 with float32 inverses), its
    outlier flags equal to JAX's float32 and float64 ones."""
    from tests.test_torch_dist_ba import noisy_problem
    args, pt_edges, _ = noisy_problem()
    a64 = tuple(a.astype(np.float64) if a.dtype == np.float32 else a for a in args)

    def port(a):
        return [o.numpy() for o in local_ba(*(torch.as_tensor(x) for x in a),
                                            torch.as_tensor(pt_edges), FX, FY, CX, CY, BF)]

    def jax_run(a, x64):
        with jax.enable_x64(x64):
            return [np.asarray(o) for o in jax_local_ba(
                *(jnp.asarray(x) for x in a), jnp.asarray(pt_edges), FX, FY, CX, CY, BF)]

    _, t32, p32, out32 = port(args)
    _, t64, p64, out64 = port(a64)
    np.testing.assert_allclose(t32, t64, atol=1e-4, rtol=0)
    assert np.median(np.abs(p32 - p64)) < 1e-4
    assert np.array_equal(out32, jax_run(args, False)[3])
    assert np.array_equal(out32, jax_run(a64, True)[3])
    assert np.array_equal(out32, out64)


def test_committed_noisy_problem_is_current():
    """tests/data/noisy_ba_problem.npz (chip_smoke.py's dist_ba phase reads
    it on the card, without JAX) equals a fresh run of
    tests/jax_ba_reference.py."""
    from tests.jax_ba_reference import PATH, reference
    fresh = reference()
    with np.load(PATH) as saved:
        assert sorted(saved.files) == sorted(fresh)
        for k, v in fresh.items():
            assert np.array_equal(saved[k], v), k
    assert np.array_equal(fresh["out32"], fresh["out64"])
