"""Bundle adjustment with the Schur complement on landmark blocks (PyTorch).

Port of ``jetson_slam_tpu/core/local_ba.py``, the replacement of g2o's
Optimizer::LocalBundleAdjustment (Optimizer.cpp:458-784): cameras and
landmarks in padded arrays, per-point edge lists of bounded degree D, and
the reduced camera system assembled with one-hot contractions, all plain
matrix products.

Reference semantics kept:
- Huber deltas sqrt(5.991) mono / sqrt(7.815) stereo (Optimizer.cpp:550-556).
- Phase 1: 5 iterations with Huber; edges with chi2 > gate or negative
  depth drop; phase 2: 10 iterations without the robust kernel
  (Optimizer.cpp:669-713).
- Fixed cameras anchor the gauge: their Jacobians are zeroed and identity
  blocks keep the reduced system positive definite.
- A problem whose edges carry no depth (monocular) leaves the map's scale
  free besides: the fixed cameras hold it only through the points, and
  the system is singular along it.  Damped by lam * I, tiny beside the
  Hessian, each step slides along that direction through the weakly held
  landmark blocks, in float64 too: a mono map grew 3.6 times in its first
  local BA and the points' depth bounds no longer matched them.  Such a
  problem is damped as Marquardt damps, lam times each block's own
  diagonal, which holds every direction in proportion to its curvature
  (g2o's lambda, 1e-5 of the largest diagonal entry, holds it as well).
  A problem with a depth edge keeps lam * I: either rule for every
  problem would move the stereo and RGB-D solves off the JAX package's
  (by 0.097 and 1.8e-05 on tests/test_torch_local_ba.py's problems,
  against its 1e-6).  In a sharded solve the whole problem decides, on
  every shard (one collective per solve).

The LM loop never synchronises with the host: the accept test is a
``torch.where`` on tensors and the reduced system is solved with
``torch.linalg.solve_ex``, which does not check ``info`` on the host (a
failed solve gives a non-finite cost, which the accept test rejects).
Float32 throughout; ``device.resolve_device`` keeps TF32 off on the card.

The same body solves one shard of a landmark-sharded problem
(``parallel/dist_ba.py``, the JAX package's ``psum_axis``): with
``allreduce`` set, each LM iteration sums over the shards the reduced
system, its right-hand side, the cost f0 and the stop flag packed into one
flat tensor, then the trial cost f1: two collectives per iteration, where
the JAX body makes five (Hcc, S, rhs, f0, f1).  Everything per landmark
(Hpp^-1, dxp, the back-substitution, the outlier flags) stays on its
shard, and every shard solves the same reduced system, so all take the
same accept and stop decisions.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..utils.lie import exp_se3, se3_compose

CHI2_MONO = 5.991
CHI2_STEREO = 7.815


def _edge_residual(xi_c, dp, R, t, pw, ob, fx, fy, cx, cy, bf):
    """Residual of one edge under camera update xi_c (6,) and point update
    dp (3,): the function whose Jacobians at zero `_edges_jacobians` gives
    in closed form.  Returns (r (3,), depth)."""
    dR, dt = exp_se3(xi_c)
    Rn, tn = se3_compose(dR, dt, R, t)
    pc = Rn @ (pw + dp) + tn
    invz = 1.0 / torch.clamp(pc[2], min=1e-6)
    u = fx * pc[0] * invz + cx
    v = fy * pc[1] * invz + cy
    return torch.stack([u, v, u - bf * invz]) - ob, pc[2]


def _edges_project(Rg, tg, pg, ob, fx, fy, cx, cy, bf):
    """Batched `_edge_residual` at zero: Rg (E, 3, 3), tg/pg/ob (E, 3) ->
    (r (E, 3), z (E,))."""
    pc = (Rg @ pg[:, :, None])[:, :, 0] + tg
    invz = 1.0 / torch.clamp(pc[:, 2], min=1e-6)
    u = fx * pc[:, 0] * invz + cx
    v = fy * pc[:, 1] * invz + cy
    return torch.stack([u, v, u - bf * invz], 1) - ob, pc[:, 2]


def inv3x3(M):
    """Batched closed-form 3x3 inverse (adjugate over determinant) of the
    damped landmark Hessian blocks, computed in float64 and cast back to
    M's dtype: in float32 the cofactor determinant of a nearly rank-2 block
    (a point held by one mono edge, or by a few from nearby views) cancels
    to 0, below it, or to a positive value with no correct bit, and the
    inverse is then inf or wrong and the LM step lost or misled.  No host
    sync."""
    dtype = M.dtype
    M = M.to(torch.float64)
    a, b, c = M[..., 0, 0], M[..., 0, 1], M[..., 0, 2]
    d, e, f = M[..., 1, 0], M[..., 1, 1], M[..., 1, 2]
    g, h, i = M[..., 2, 0], M[..., 2, 1], M[..., 2, 2]
    A = e * i - f * h
    B = c * h - b * i
    C = b * f - c * e
    D = f * g - d * i
    E = a * i - c * g
    F_ = c * d - a * f
    G = d * h - e * g
    H = b * g - a * h
    I = a * e - b * d
    det = a * A + b * D + c * G
    rows = torch.stack([torch.stack([A, B, C], -1), torch.stack([D, E, F_], -1),
                        torch.stack([G, H, I], -1)], -2)
    return (rows * (1.0 / det)[..., None, None]).to(dtype)


def _edges_jacobians(Rg, tg, pg, fx, fy, cx, cy, bf):
    """Closed-form (Jc (E, 3, 6), Jp (E, 3, 3)) of `_edge_residual` at zero.

    With q = R pw + t, the camera update acts as pc(xi) = exp(phi) q +
    J_l(phi) rho, so at xi = 0: dpc/drho = I, dpc/dphi = -hat(q); the point
    update gives dpc/ddp = R.  The projection rows take the clamped depth,
    with zero slope where the clamp is active:
      du/dpc  = [fx/z, 0,    -fx x / z^2]
      dv/dpc  = [0,    fy/z, -fy y / z^2]
      dur/dpc = [fx/z, 0,    (bf - fx x) / z^2]"""
    E = Rg.shape[0]
    q = (Rg @ pg[:, :, None])[:, :, 0] + tg
    x, y, zraw = q[:, 0], q[:, 1], q[:, 2]
    invz = 1.0 / torch.clamp(zraw, min=1e-6)
    invz2 = invz * invz * (zraw >= 1e-6).to(q.dtype)
    zero = torch.zeros_like(x)
    Pj = torch.stack([
        torch.stack([fx * invz, zero, -fx * x * invz2], 1),
        torch.stack([zero, fy * invz, -fy * y * invz2], 1),
        torch.stack([fx * invz, zero, (bf - fx * x) * invz2], 1),
    ], 1)
    hatq = torch.stack([
        torch.stack([zero, -q[:, 2], q[:, 1]], 1),
        torch.stack([q[:, 2], zero, -q[:, 0]], 1),
        torch.stack([-q[:, 1], q[:, 0], zero], 1),
    ], 1)
    I3 = torch.eye(3, dtype=q.dtype, device=q.device).expand(E, 3, 3)
    return Pj @ torch.cat([I3, -hatq], 2), Pj @ Rg


def local_ba(cam_R, cam_t, cam_fixed, pts, e_cam, e_pt, obs, is_stereo,
             inv_sigma2, e_valid, pt_edges, fx, fy, cx, cy, bf,
             its1: int = 5, its2: int = 10, stop=None, allreduce=None):
    """Sparse LM with the landmark Schur complement.

    cam_R (C, 3, 3), cam_t (C, 3), cam_fixed (C,) bool; pts (P, 3); per
    edge (E,): e_cam, e_pt, obs (E, 3) = (u, v, ur or 0), is_stereo,
    inv_sigma2, e_valid; pt_edges (P, D) indices into the edge list (-1 =
    pad).  ``stop``, when given, is called on the host before each LM
    iteration, and a True ends the solve there (g2o's force-stop flag).
    ``allreduce``, when given, is a callable that returns the sum of a
    tensor over the shards of a landmark-sharded problem (the points and
    edges here are one shard's, the cameras every shard's); each iteration
    then calls it twice, and reads the summed stop flag on the host, so
    that a stop on any shard ends the solve on all.  With ``allreduce``
    None the result is the unsharded solve's.
    Returns (cam_R', cam_t', pts', outlier (E,) bool)."""
    C = cam_R.shape[0]
    E = e_cam.shape[0]
    dtype = pts.dtype
    dev = pts.device
    e_cam = e_cam.to(torch.int64)
    e_pt = e_pt.to(torch.int64)
    ones = torch.ones(E, dtype=dtype, device=dev)
    comp = torch.stack([ones, ones, is_stereo.to(dtype)], 1)
    delta2 = torch.where(is_stereo, torch.full_like(ones, CHI2_STEREO),
                         torch.full_like(ones, CHI2_MONO))
    sqrt_delta2 = torch.sqrt(delta2)
    fixed_f = cam_fixed.to(dtype)
    free = 1.0 - fixed_f
    I6 = torch.eye(6, dtype=dtype, device=dev)
    I3 = torch.eye(3, dtype=dtype, device=dev)
    has_depth = (is_stereo & e_valid).any().to(dtype).reshape(1)
    if allreduce is not None:
        has_depth = allreduce(has_depth)
    depth_free = has_depth[0] == 0                  # 0-dim: no host sync

    def damped(H, lam, eye):
        """H plus its damping: lam * I, or lam times the blocks' own
        diagonals where the problem has no depth edge (an edge-free
        block, a padded one, keeps the identity)."""
        d = torch.diagonal(H, dim1=-2, dim2=-1)
        marquardt = torch.diag_embed(lam * d + (d == 0).to(dtype))
        return H + torch.where(depth_free, marquardt, lam * eye)
    eye_c = torch.eye(C, dtype=dtype, device=dev)[:, :, None, None]

    # scatter-free segment sums: a one-hot contraction per camera, the
    # pt_edges gather lists per point
    onehot_c = F.one_hot(e_cam, C).to(dtype)                   # (E, C)
    pe_ok = pt_edges >= 0
    pe_safe = torch.where(pe_ok, pt_edges, torch.zeros_like(pt_edges)).to(torch.int64)
    pe_okf = pe_ok.to(dtype)
    camp = torch.where(pe_ok, e_cam[pe_safe], torch.zeros_like(pe_safe))
    A_pc = F.one_hot(camp, C).to(dtype) * pe_okf[..., None]   # (P, D, C)

    def seg_cam(blocks):
        flat = blocks.reshape(E, -1)
        return (onehot_c.T @ flat).reshape((C,) + blocks.shape[1:])

    def seg_pt(values):
        g = values[pe_safe]
        return (g * pe_okf.reshape(pe_okf.shape + (1,) * (g.ndim - 2))).sum(1)

    def edge_res(R, t, p):
        return _edges_project(R[e_cam], t[e_cam], p[e_pt], obs, fx, fy, cx, cy, bf)

    def chi2_of(r):
        return (r * r * comp).sum(1) * inv_sigma2

    def cost_of(r, active, use_huber: bool):
        chi2 = chi2_of(r)
        if use_huber:
            e = torch.sqrt(torch.clamp(chi2, min=1e-12))
            chi2 = torch.where(chi2 <= delta2, chi2, 2.0 * sqrt_delta2 * e - delta2)
        return torch.where(active, chi2, torch.zeros_like(chi2)).sum()

    def build(R, t, p, r, active, use_huber: bool):
        """This shard's normal-equation blocks, undamped: Hcc (C, 6, 6), gc
        (C, 6), Hpp (P, 3, 3), gp (P, 3) and the per-edge G_e (E, 6, 3)."""
        Jc, Jp = _edges_jacobians(R[e_cam], t[e_cam], p[e_pt], fx, fy, cx, cy, bf)
        w = inv_sigma2
        if use_huber:
            chi2 = chi2_of(r)
            w = torch.where(chi2 <= delta2, ones,
                            sqrt_delta2 / torch.sqrt(torch.clamp(chi2, min=1e-12))) * w
        w = torch.where(active, w, torch.zeros_like(w))
        Jc = Jc * comp[:, :, None] * free[e_cam][:, None, None]
        Jp = Jp * comp[:, :, None]
        rm = r * comp
        Jcw = Jc * w[:, None, None]
        Hcc_e = Jcw.transpose(1, 2) @ Jc                            # (E, 6, 6)
        Hpp_e = (Jp * w[:, None, None]).transpose(1, 2) @ Jp        # (E, 3, 3)
        G_e = Jcw.transpose(1, 2) @ Jp                              # (E, 6, 3)
        gc_e = (Jcw * rm[:, :, None]).sum(1)                        # (E, 6)
        gp_e = (Jp * (w[:, None] * rm)[:, :, None]).sum(1)          # (E, 3)

        Hcc = seg_cam(Hcc_e)
        gc = seg_cam(gc_e)
        return Hcc, gc, seg_pt(Hpp_e), seg_pt(gp_e), G_e

    def solve(lam, pairs, Hcc, rhs, Hpp_inv, gp, G_e):
        """Damp, solve the reduced camera system and back-substitute this
        shard's landmarks."""
        Hcc = damped(Hcc, lam, I6)
        S = pairs + eye_c * Hcc[:, None]
        # fixed cameras: identity rows and columns, zero right-hand side
        S = S * free[:, None, None, None] * free[None, :, None, None] \
            + eye_c * (fixed_f[:, None, None] * I6)[:, None]
        rhs = rhs * free[:, None]
        Sd = S.permute(0, 2, 1, 3).reshape(C * 6, C * 6)
        dxc = torch.linalg.solve_ex(Sd, rhs.reshape(-1), check_errors=False)[0]
        dxc = dxc.reshape(C, 6) * free[:, None]
        # back-substitute the landmarks: dxp = Hpp^-1 (-gp - sum_e G_e^T dxc)
        back = seg_pt((dxc[e_cam][:, None, :] @ G_e)[:, 0])
        return dxc, (Hpp_inv @ (-gp - back)[:, :, None])[:, :, 0]

    def schur(lam, Hpp, gp, G_e):
        """This shard's Schur terms at damping lam: the pairs (C, C, 6, 6),
        the right-hand side's landmark part and Hpp^-1."""
        Hpp_inv = inv3x3(damped(Hpp, lam, I3))
        K_e = G_e @ Hpp_inv[e_pt]                                   # (E, 6, 3)
        # Schur pairs: bucket each point's K and G rows by camera with the
        # per-point one-hot, then contract over points
        Kp = K_e[pe_safe] * pe_okf[..., None, None]                 # (P, D, 6, 3)
        Gp = G_e[pe_safe] * pe_okf[..., None, None]
        T = torch.einsum("pdc,pdij->pcij", A_pc, Kp)
        U = torch.einsum("pdc,pdij->pcij", A_pc, Gp)
        pairs = -torch.einsum("pcij,pCkj->cCik", T, U)
        return pairs, seg_cam((K_e @ gp[e_pt][:, :, None])[:, :, 0]), Hpp_inv

    n_pair, n_cam, n_rhs = C * C * 36, C * 36, C * 6

    def lm_phase(R, t, p, active, use_huber: bool, n_iters: int):
        lam = torch.full((), 1e-4, dtype=dtype, device=dev)
        for _ in range(n_iters):
            stopping = stop is not None and stop()
            if stopping and allreduce is None:
                break
            r, _ = edge_res(R, t, p)
            Hcc, gc, Hpp, gp, G_e = build(R, t, p, r, active, use_huber)
            pairs, rhs_p, Hpp_inv = schur(lam, Hpp, gp, G_e)
            rhs = -gc + rhs_p
            f0 = cost_of(r, active, use_huber)
            if allreduce is not None:
                # one collective for the reduced system, its cost and the
                # stop flag; the flag is read on the host so every shard
                # leaves the loop at the same iteration
                flag = torch.full((1,), float(stopping), dtype=dtype, device=dev)
                packed = allreduce(torch.cat([pairs.reshape(-1), Hcc.reshape(-1),
                                              rhs.reshape(-1), f0.reshape(1), flag]))
                if float(packed[-1]) > 0:
                    break
                pairs = packed[:n_pair].reshape(C, C, 6, 6)
                Hcc = packed[n_pair:n_pair + n_cam].reshape(C, 6, 6)
                rhs = packed[n_pair + n_cam:n_pair + n_cam + n_rhs].reshape(C, 6)
                f0 = packed[-2]
            dxc, dxp = solve(lam, pairs, Hcc, rhs, Hpp_inv, gp, G_e)
            dR, dt = exp_se3(dxc)
            Rn, tn = se3_compose(dR, dt, R, t)
            pn = p + dxp
            f1 = cost_of(edge_res(Rn, tn, pn)[0], active, use_huber)
            if allreduce is not None:
                f1 = allreduce(f1.reshape(1))[0]
            ok = (f1 < f0) & torch.isfinite(f1)
            R = torch.where(ok, Rn, R)
            t = torch.where(ok, tn, t)
            p = torch.where(ok, pn, p)
            lam = torch.where(ok, lam / 3.0, lam * 4.0)
        return R, t, p

    R1, t1, p1 = lm_phase(cam_R, cam_t, pts, e_valid, True, its1)
    r1, z1 = edge_res(R1, t1, p1)
    active2 = e_valid & (chi2_of(r1) <= delta2) & (z1 > 0)
    R2, t2, p2 = lm_phase(R1, t1, p1, active2, False, its2)
    r2, z2 = edge_res(R2, t2, p2)
    outlier = e_valid & ((chi2_of(r2) > delta2) | (z2 <= 0))
    return R2, t2, p2, outlier
