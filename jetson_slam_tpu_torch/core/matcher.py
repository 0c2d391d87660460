"""Tracking data association in PyTorch: projection searches, frustum
culling, brute-force matching.

Port of the tracking matchers of ``jetson_slam_tpu/core/matcher.py``
(spec: ORBmatcher.cpp and the reference's batch visibility kernel):

- ``search_by_projection_last``   <- SearchByProjection(F, LastFrame, th)
- ``frustum_check``               <- isInFrustum_GPU
- ``search_by_projection_points`` <- SearchByProjection(F, vpMapPoints, th),
  and with ``fuse=True`` the search of ORBmatcher::Fuse (local mapping)
- ``motion_model_track`` / ``local_map_track``: search + pose LM, the two
  stages of the fused tracking step
- ``match_brute_force``           <- SearchByBoW gates, bucketed by the
  vocabulary's nodes when they are given
- ``search_by_sim3``               <- SearchBySim3 (loop closing)
- ``search_loop_projection``       <- SearchByProjection(KeyFrame*, Scw, ...)

Candidate gating is a (Q, S) mask and the Hamming table one matrix product
(``ops/hamming.py``).  Argmin and argmax take the first extremum, as the
reference does.  Where several queries pick the same current slot, the
highest query index wins (the reference's sequential overwrite); this is
a ``scatter_reduce`` with ``amax``, which is deterministic on the card.
No function here synchronises with the host.
"""
from __future__ import annotations

import torch

from ..ops.hamming import hamming_matrix
from .optimizer import pose_optimization

TH_HIGH = 100
TH_LOW = 50
HISTO_LENGTH = 30
BIG = 1 << 29


def _last_writer(tgt, n_out: int):
    """out[..., j] = the highest i with tgt[..., i] == j, else -1; tgt ==
    n_out drops.  Leading dimensions are batch dimensions."""
    src = torch.arange(tgt.shape[-1], dtype=torch.int64,
                       device=tgt.device).expand(tgt.shape)
    out = torch.full((*tgt.shape[:-1], n_out + 1), -1, dtype=torch.int64,
                     device=tgt.device)
    out = out.scatter_reduce(-1, tgt.to(torch.int64), src, reduce="amax")
    return out[..., :n_out].to(torch.int32)


def _take(table, idx):
    return table[idx.to(torch.int64)]


def _select(flag, a, b):
    """a where ``flag`` holds, else b.  ``flag`` is a 0-dim bool tensor (a
    traced flag: one ``torch.where``, so a captured step serves both
    values, as JAX's ``jnp.where``) or a Python bool."""
    if isinstance(flag, torch.Tensor):
        return torch.where(flag, a, b)
    return a if flag else b


def rotation_consistency(rot_deg, matched):
    """Keep only matches whose angle difference falls in the 3 largest of 30
    bins (ComputeThreeMaxima, ORBmatcher.cpp:2097-2141); ties between bins
    rank the lower bin first."""
    bin_f = torch.round(rot_deg * (HISTO_LENGTH / 360.0))
    bin_i = torch.where(bin_f == HISTO_LENGTH, torch.zeros_like(bin_f),
                        bin_f).to(torch.int64) % HISTO_LENGTH
    counts = torch.zeros(HISTO_LENGTH, dtype=torch.int32, device=rot_deg.device)
    counts.index_add_(0, torch.where(matched, bin_i, torch.zeros_like(bin_i)),
                      matched.to(torch.int32))
    top_vals, top_idx = torch.sort(counts, descending=True, stable=True)
    top_vals, top_idx = top_vals[:3], top_idx[:3]
    keep = top_vals.to(torch.float32) > 0.1 * top_vals[0].to(torch.float32)
    keep = torch.cat([(top_vals[0] > 0)[None], keep[1:]])
    keep_bin = torch.zeros(HISTO_LENGTH, dtype=torch.bool, device=rot_deg.device)
    keep_bin[top_idx] = keep
    return matched & keep_bin[bin_i]


def search_by_projection_last(
        Rcw, tcw, last_pw, last_has_pt, last_octave, last_angle, last_desc,
        cur_xy, cur_octave, cur_angle, cur_desc, cur_valid, cur_ur,
        th, scale_factors, n_levels: int, fx, fy, cx, cy, bf,
        min_x, max_x, min_y, max_y, forward, backward,
        orb_dist=None):
    """Motion-model projection search (ORBmatcher.cpp:1315-1966).
    scale_factors: (L,) float32 tensor.  orb_dist replaces TH_HIGH as the
    descriptor gate (relocalization's narrow retry uses 64,
    Tracking.cpp:2090).  Returns per-current-slot index into the last slots
    (-1 = unmatched).  th may be a 0-dim tensor, and forward / backward
    0-dim bool tensors, as the fused step passes them."""
    pc = last_pw @ Rcw.T + tcw
    z = pc[:, 2]
    invz = 1.0 / torch.clamp(z, min=1e-9)
    u = fx * pc[:, 0] * invz + cx
    v = fy * pc[:, 1] * invz + cy
    ur_proj = u - bf * invz
    proj_ok = last_has_pt & (z > 0) & (u >= min_x) & (u <= max_x) & \
        (v >= min_y) & (v <= max_y)
    radius = th * _take(scale_factors, last_octave)
    lo = last_octave
    oct_lo = _select(forward, lo, _select(backward, torch.zeros_like(lo), lo - 1))
    oct_hi = _select(forward, torch.full_like(lo, n_levels - 1),
                     _select(backward, lo, lo + 1))
    du = (cur_xy[None, :, 0] - u[:, None]).abs()
    dv = (cur_xy[None, :, 1] - v[:, None]).abs()
    in_window = (du < radius[:, None]) & (dv < radius[:, None])
    oct_ok = (cur_octave[None, :] >= oct_lo[:, None]) & \
        (cur_octave[None, :] <= oct_hi[:, None])
    stereo_ok = (cur_ur[None, :] <= 0) | \
        ((ur_proj[:, None] - cur_ur[None, :]).abs() < radius[:, None])
    cand = proj_ok[:, None] & cur_valid[None, :] & in_window & oct_ok & stereo_ok
    dist = torch.where(cand, hamming_matrix(last_desc, cur_desc),
                       torch.full_like(cand, BIG, dtype=torch.int32))
    best_cur = torch.argmin(dist, dim=1)
    best_dist = torch.gather(dist, 1, best_cur[:, None])[:, 0]
    matched = best_dist <= (TH_HIGH if orb_dist is None else orb_dist)
    matched = rotation_consistency(last_angle - cur_angle[best_cur], matched)
    S_cur = cur_xy.shape[0]
    tgt = torch.where(matched, best_cur, torch.full_like(best_cur, S_cur))
    return _last_writer(tgt, S_cur)


def frustum_check(pw, pn, max_dist_raw, min_dist_raw, Rcw, tcw, Ow,
                  fx, fy, cx, cy, min_x, max_x, min_y, max_y,
                  n_levels: int, log_scale, view_cos_th, alive):
    """Batch map-point visibility (tracking_isinfrustum.cu:19-110).
    Returns (ok, u, v, invz, predicted_level, view_cos)."""
    pc = pw @ Rcw.T + tcw
    z = pc[:, 2]
    invz = 1.0 / torch.clamp(z, min=1e-9)
    u = fx * pc[:, 0] * invz + cx
    v = fy * pc[:, 1] * invz + cy
    po = pw - Ow
    dist = torch.linalg.norm(po, dim=1)
    view_cos = (po * pn).sum(1) / torch.clamp(dist, min=1e-9)
    ratio = max_dist_raw / torch.clamp(dist, min=1e-9)
    level = torch.ceil(torch.log(torch.clamp(ratio, min=1e-9)) / log_scale)
    level = level.to(torch.int32).clamp(0, n_levels - 1)
    ok = (alive & (z > 0)
          & (u >= min_x) & (u <= max_x) & (v >= min_y) & (v <= max_y)
          & (dist >= 0.8 * min_dist_raw) & (dist <= 1.2 * max_dist_raw)
          & (view_cos >= view_cos_th))
    return ok, u, v, invz, level, view_cos


def search_by_projection_points(u, v, ur_proj, pred_level, view_cos, pt_ok,
                                pt_desc, cur_xy, cur_octave, cur_desc,
                                cur_valid, cur_ur, cur_free, th, scale_factors,
                                n_levels: int, nn_ratio=0.8, fuse: bool = False):
    """Local-map projection search (ORBmatcher.cpp:32-144).  u, v, ur_proj,
    pred_level, view_cos come from frustum_check (ur_proj = u - bf * invz).
    Returns per-current-slot index into the point list (-1 = none).

    fuse=True applies the gates of ORBmatcher::Fuse (ORBmatcher.cpp:812-962):
    each candidate's reprojection chi2, with the ur residual where the slot
    is stereo, times the inverse sigma^2 of the slot's octave must stay
    within 5.99 (mono) or 7.8 (stereo), and the descriptor threshold is
    TH_LOW in place of TH_HIGH.  n_levels is the pyramid depth (the JAX
    signature; the gates read it from pred_level)."""
    r = torch.where(view_cos > 0.998, torch.full_like(view_cos, 2.5),
                    torch.full_like(view_cos, 4.0)) * th
    radius = r * _take(scale_factors, pred_level)
    du = (cur_xy[None, :, 0] - u[:, None]).abs()
    dv = (cur_xy[None, :, 1] - v[:, None]).abs()
    in_window = (du < radius[:, None]) & (dv < radius[:, None])
    oct_ok = (cur_octave[None, :] >= pred_level[:, None] - 1) & \
        (cur_octave[None, :] <= pred_level[:, None])
    cand = pt_ok[:, None] & cur_valid[None, :] & cur_free[None, :] & \
        in_window & oct_ok
    if fuse:
        inv_s2 = 1.0 / (_take(scale_factors, cur_octave) ** 2)
        e2 = du * du + dv * dv
        is_st = cur_ur[None, :] >= 0
        dur = ur_proj[:, None] - cur_ur[None, :]
        chi2 = torch.where(is_st, e2 + dur * dur, e2) * inv_s2[None, :]
        gate = torch.where(is_st, torch.full_like(chi2, 7.8),
                           torch.full_like(chi2, 5.99))
        cand = cand & (chi2 <= gate)
    dist = torch.where(cand, hamming_matrix(pt_desc, cur_desc),
                       torch.full_like(cand, BIG, dtype=torch.int32))
    best_cur = torch.argmin(dist, dim=1)
    best_dist = torch.gather(dist, 1, best_cur[:, None])[:, 0]
    best_level = cur_octave[best_cur]
    dist2 = dist.scatter(1, best_cur[:, None], BIG)
    second_cur = torch.argmin(dist2, dim=1)
    second_dist = torch.gather(dist2, 1, second_cur[:, None])[:, 0]
    second_level = cur_octave[second_cur]
    ratio_reject = (best_level == second_level) & \
        (best_dist.to(torch.float32) > nn_ratio * second_dist.to(torch.float32))
    matched = (best_dist <= (TH_LOW if fuse else TH_HIGH)) & ~ratio_reject
    S_cur = cur_xy.shape[0]
    tgt = torch.where(matched, best_cur, torch.full_like(best_cur, S_cur))
    return _last_writer(tgt, S_cur)


def motion_model_track(
        Rcw, tcw, last_pw, last_has_pt, last_real, last_octave, last_angle,
        last_desc, cur_xy, cur_octave, cur_angle, cur_desc, cur_valid, cur_ur,
        th, scale_factors, inv_level_sigma2, n_levels: int,
        fx, fy, cx, cy, bf, min_x, max_x, min_y, max_y,
        forward, backward):
    """Tracking::TrackWithMotionModel on device: the projection search,
    its retry at 2*th when it finds fewer than 20 matches
    (Tracking.cpp:1060-1066; both searches run and a ``where`` picks, so
    the host never waits), and the motion-only pose LM.  th, forward and
    backward may be 0-dim tensors (``search_by_projection_last``).
    Returns (match_slot, n_match, Rcw', tcw', inlier, n_map)."""
    def search(thv):
        return search_by_projection_last(
            Rcw, tcw, last_pw, last_has_pt, last_octave, last_angle, last_desc,
            cur_xy, cur_octave, cur_angle, cur_desc, cur_valid, cur_ur, thv,
            scale_factors, n_levels, fx, fy, cx, cy, bf,
            min_x, max_x, min_y, max_y, forward, backward)

    m1 = search(th)
    m2 = search(2.0 * th)
    m = torch.where((m1 >= 0).sum() < 20, m2, m1)
    has_m = m >= 0
    midx = torch.where(has_m, m, torch.zeros_like(m)).to(torch.int64)
    pts = last_pw[midx]
    has_real = has_m & last_real[midx]
    inv_s2 = _take(inv_level_sigma2, cur_octave)
    R, t, inlier, _ = pose_optimization(Rcw, tcw, pts, cur_xy, cur_ur, inv_s2,
                                        has_m, fx, fy, cx, cy, bf)
    n_map = (inlier & has_real).sum(dtype=torch.int32)
    return m, has_m.sum(dtype=torch.int32), R, t, inlier, n_map


def local_map_track(
        cand_pos, cand_normal, cand_maxd, cand_mind, cand_desc, cand_alive,
        Rcw, tcw, Ow, cur_xy, cur_octave, cur_desc, cur_valid, cur_ur,
        cur_free, exist_pts, exist_has, exist_real,
        th, scale_factors, inv_level_sigma2, n_levels: int,
        fx, fy, cx, cy, bf, min_x, max_x, min_y, max_y, log_scale):
    """Tracking::TrackLocalMap on device: frustum culling, the local-map
    projection search and the motion-only pose LM.  exist_* describe the
    frame's associations so far; newly selected candidates override them.
    Returns (ok, sel, Rcw', tcw', inlier, n_map)."""
    ok, u, v, invz, lvl, vcos = frustum_check(
        cand_pos, cand_normal, cand_maxd, cand_mind, Rcw, tcw, Ow,
        fx, fy, cx, cy, min_x, max_x, min_y, max_y, n_levels, log_scale, 0.5,
        cand_alive)
    sel = search_by_projection_points(
        u, v, u - bf * invz, lvl, vcos, ok, cand_desc, cur_xy, cur_octave,
        cur_desc, cur_valid, cur_ur, cur_free, th, scale_factors, n_levels)
    has_sel = sel >= 0
    sidx = torch.where(has_sel, sel, torch.zeros_like(sel)).to(torch.int64)
    pts = torch.where(has_sel[:, None], cand_pos[sidx], exist_pts)
    has_any = exist_has | has_sel
    has_real = exist_real | has_sel
    inv_s2 = _take(inv_level_sigma2, cur_octave)
    R, t, inlier, _ = pose_optimization(Rcw, tcw, pts, cur_xy, cur_ur, inv_s2,
                                        has_any, fx, fy, cx, cy, bf)
    n_map = (inlier & has_real).sum(dtype=torch.int32)
    return ok, sel, R, t, inlier, n_map


def match_brute_force(desc_a, valid_a, angle_a, desc_b, valid_b, angle_b,
                      check_rotation=True, nn_ratio=0.7, node_a=None,
                      node_b=None):
    """All-pairs descriptor matching with the TH_LOW, ratio and rotation
    gates, one a per b (the best; among equals the one ranked last by a
    stable sort on worsening distance).  node_a / node_b, the vocabulary's
    node ids levelsup above the leaves (``bow/vocabulary.transform``),
    restrict the candidates to pairs in one node, the FeatureVector
    bucketing of SearchByBoW (ORBmatcher.cpp:155-165).  Returns (per-a
    index into b or -1, best distance per a)."""
    ok = valid_a[:, None] & valid_b[None, :]
    if node_a is not None:
        ok = ok & (node_a[:, None] == node_b[None, :])
    dist = torch.where(ok, hamming_matrix(desc_a, desc_b),
                       torch.full_like(ok, BIG, dtype=torch.int32))
    best_b = torch.argmin(dist, dim=1)
    best_dist = torch.gather(dist, 1, best_b[:, None])[:, 0]
    second = dist.scatter(1, best_b[:, None], BIG).min(dim=1).values
    matched = (best_dist <= TH_LOW) & \
        (best_dist.to(torch.float32) < nn_ratio * second.to(torch.float32))
    if check_rotation:
        matched = rotation_consistency(angle_a - angle_b[best_b], matched)
    S_a, S_b = dist.shape
    order = torch.argsort(-best_dist, stable=True)
    tgt = torch.where(matched[order], best_b[order],
                      torch.full_like(best_b, S_b))
    pos = _last_writer(tgt, S_b).to(torch.int64)          # rank in `order`
    a_of_b = torch.where(pos >= 0, order[pos.clamp(min=0)],
                         torch.full_like(pos, -1))
    src = torch.where(a_of_b >= 0, a_of_b, torch.full_like(a_of_b, S_a))
    match_a = torch.full((S_a + 1,), -1, dtype=torch.int64, device=dist.device)
    match_a[src] = torch.arange(S_b, device=dist.device)
    return match_a[:S_a].to(torch.int32), best_dist


def _sim3_direction(pos_w, pt_desc, pt_ok, mind_raw, maxd_raw,
                    R_own, t_own, sR_to_other, t_to_other,
                    kp_xy, kp_octave, kp_desc, kp_valid,
                    th, sf, n_levels: int,
                    min_x, max_x, min_y, max_y, fx, fy, cx, cy, log_scale):
    """One direction of SearchBySim3 (ORBmatcher.cpp:1135-1211 and its
    mirror): side-A points through their own pose, then the Sim(3) into
    side-B's camera; window and octave gates on side-B's keypoints; the
    best Hamming distance <= TH_HIGH.  Returns per-A-slot B slot or -1."""
    pc = (pos_w @ R_own.T + t_own) @ sR_to_other.T + t_to_other
    z = pc[:, 2]
    invz = 1.0 / torch.clamp(z, min=1e-9)
    u = fx * pc[:, 0] * invz + cx
    v = fy * pc[:, 1] * invz + cy
    dist3d = torch.linalg.norm(pc, dim=1)
    ratio = maxd_raw / torch.clamp(dist3d, min=1e-9)
    pred = torch.ceil(torch.log(torch.clamp(ratio, min=1e-9)) / log_scale)
    pred = pred.to(torch.int32).clamp(0, n_levels - 1)
    ok = (pt_ok & (z > 0)
          & (u >= min_x) & (u <= max_x) & (v >= min_y) & (v <= max_y)
          & (dist3d >= 0.8 * mind_raw) & (dist3d <= 1.2 * maxd_raw))
    radius = th * _take(sf, pred)
    du = (kp_xy[None, :, 0] - u[:, None]).abs()
    dv = (kp_xy[None, :, 1] - v[:, None]).abs()
    cand = (ok[:, None] & kp_valid[None, :]
            & (du < radius[:, None]) & (dv < radius[:, None])
            & (kp_octave[None, :] >= pred[:, None] - 1)
            & (kp_octave[None, :] <= pred[:, None]))
    dist = torch.where(cand, hamming_matrix(pt_desc, kp_desc),
                       torch.full_like(cand, BIG, dtype=torch.int32))
    best = torch.argmin(dist, dim=1)
    best_dist = torch.gather(dist, 1, best[:, None])[:, 0]
    return torch.where(best_dist <= TH_HIGH, best.to(torch.int32),
                       torch.full_like(best, -1, dtype=torch.int32))


def search_by_sim3(
        xy1, oct1, kdesc1, kvalid1, pos1, pdesc1, has1, mind1, maxd1,
        xy2, oct2, kdesc2, kvalid2, pos2, pdesc2, has2, mind2, maxd2,
        R1w, t1w, R2w, t2w, s12, R12, t12,
        th, scale_factors, n_levels: int,
        min_x, max_x, min_y, max_y, fx, fy, cx, cy, log_scale):
    """ORBmatcher::SearchBySim3 (ORBmatcher.cpp:1089-1313): two batched
    projections and the mutual-agreement check.  S12 = (s12, R12, t12)
    maps keyframe-2 camera coordinates into keyframe 1's; hasN marks slots
    holding an alive, not yet matched point, whose world position,
    descriptor and raw scale distances are posN, pdescN, mindN, maxdN.
    Returns per-KF1-slot KF2 slot where both directions agree, else -1."""
    sR21 = (1.0 / s12) * R12.T
    t21 = -(sR21 @ t12)
    sR12 = s12 * R12
    m1 = _sim3_direction(pos1, pdesc1, has1, mind1, maxd1, R1w, t1w,
                         sR21, t21, xy2, oct2, kdesc2, kvalid2, th,
                         scale_factors, n_levels, min_x, max_x, min_y, max_y,
                         fx, fy, cx, cy, log_scale)
    m2 = _sim3_direction(pos2, pdesc2, has2, mind2, maxd2, R2w, t2w,
                         sR12, t12, xy1, oct1, kdesc1, kvalid1, th,
                         scale_factors, n_levels, min_x, max_x, min_y, max_y,
                         fx, fy, cx, cy, log_scale)
    # my best slot must point back at me and hold a point itself
    idx2 = torch.where(m1 >= 0, m1, torch.zeros_like(m1)).to(torch.int64)
    ar = torch.arange(m1.shape[0], dtype=torch.int32, device=m1.device)
    agree = (m1 >= 0) & has2[idx2] & (m2[idx2] == ar)
    return torch.where(agree, m1, torch.full_like(m1, -1))


def search_loop_projection(u, v, pred_level, pt_ok, pt_desc,
                           cur_xy, cur_octave, cur_desc, cur_valid, cur_free,
                           th, scale_factors):
    """Guided projection of the loop region's points into the current
    keyframe under the corrected Sim(3) (ORBmatcher::SearchByProjection(
    KeyFrame*, Scw, ...), ORBmatcher.cpp:277-391): radius th * sf[level],
    octave in [level - 1, level], best Hamming distance <= TH_LOW, matched
    slots excluded by cur_free.  u, v, pred_level, pt_ok come from
    frustum_check.  Returns per-current-slot point index or -1 (a slot
    picked by several points keeps the highest index)."""
    radius = th * _take(scale_factors, pred_level)
    du = (cur_xy[None, :, 0] - u[:, None]).abs()
    dv = (cur_xy[None, :, 1] - v[:, None]).abs()
    cand = (pt_ok[:, None] & cur_valid[None, :] & cur_free[None, :]
            & (du < radius[:, None]) & (dv < radius[:, None])
            & (cur_octave[None, :] >= pred_level[:, None] - 1)
            & (cur_octave[None, :] <= pred_level[:, None]))
    dist = torch.where(cand, hamming_matrix(pt_desc, cur_desc),
                       torch.full_like(cand, BIG, dtype=torch.int32))
    best_cur = torch.argmin(dist, dim=1)
    best_dist = torch.gather(dist, 1, best_cur[:, None])[:, 0]
    S_cur = cur_xy.shape[0]
    tgt = torch.where(best_dist <= TH_LOW, best_cur,
                      torch.full_like(best_cur, S_cur))
    return _last_writer(tgt, S_cur)
