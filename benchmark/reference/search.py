"""The tracker's two projection searches, the plain reference of the fused
step's data association.

Frozen copy of the port's ``core/matcher.py`` searches (ORB-SLAM2's
ORBmatcher.cpp: SearchByProjection(F, LastFrame, th) for the motion-model
stage, isInFrustum and SearchByProjection(F, vpMapPoints, th) for the
local-map stage; the all-pairs match of the mono initialization), kept as
the benchmark's yardstick.  The geometry
(projection, windows, frustum, predicted level) is computed in ``dtype``:
float64 for the reference, bfloat16 for the lower-precision control.
Hamming distances are exact in float32 (``hamming.py``).  Argmin takes the
first minimum; where several queries pick one current slot the highest
query index wins, as the reference's sequential overwrite does.
"""
from __future__ import annotations

import torch

from .hamming import hamming_matrix

TH_HIGH = 100
TH_LOW = 50
INIT_NN_RATIO = 0.9     # the mono initialization's ratio test
HISTO_LENGTH = 30
BIG = 1 << 29


def _last_writer(tgt, n_out: int):
    src = torch.arange(tgt.shape[-1], dtype=torch.int64, device=tgt.device)
    out = torch.full((n_out + 1,), -1, dtype=torch.int64, device=tgt.device)
    out = out.scatter_reduce(0, tgt.to(torch.int64), src, reduce="amax")
    return out[:n_out]


def rotation_consistency(rot_deg, matched):
    """Matches whose angle difference falls in the 3 largest of 30 bins
    (ComputeThreeMaxima); ties rank the lower bin first."""
    bin_f = torch.round(rot_deg * (HISTO_LENGTH / 360.0))
    bin_i = torch.where(bin_f == HISTO_LENGTH, torch.zeros_like(bin_f),
                        bin_f).to(torch.int64) % HISTO_LENGTH
    counts = torch.zeros(HISTO_LENGTH, dtype=torch.int64, device=rot_deg.device)
    counts.index_add_(0, torch.where(matched, bin_i, torch.zeros_like(bin_i)),
                      matched.to(torch.int64))
    top_vals, top_idx = torch.sort(counts, descending=True, stable=True)
    top_vals, top_idx = top_vals[:3], top_idx[:3]
    keep = top_vals.to(torch.float64) > 0.1 * top_vals[0].to(torch.float64)
    keep = torch.cat([(top_vals[0] > 0)[None], keep[1:]])
    keep_bin = torch.zeros(HISTO_LENGTH, dtype=torch.bool, device=rot_deg.device)
    keep_bin[top_idx] = keep
    return matched & keep_bin[bin_i]


def _project(pw, R, t, fx, fy, cx, cy):
    pc = pw @ R.T + t
    z = pc[:, 2]
    invz = 1.0 / torch.clamp(z, min=1e-9)
    return pc, z, invz, fx * pc[:, 0] * invz + cx, fy * pc[:, 1] * invz + cy


def search_last(R, t, last, cur, th, scale_factors, n_levels, cam, forward, backward):
    """Motion-model search: for each current slot the index of the last
    frame's slot it matched, or -1.  ``last``: pw, has_pt, octave, angle,
    desc; ``cur``: kp_xy, octave, angle, desc, valid, u_right; geometry
    tensors in one dtype."""
    fx, fy, cx, cy, bf, min_x, max_x, min_y, max_y = cam
    _, z, invz, u, v = _project(last["pw"], R, t, fx, fy, cx, cy)
    ur_proj = u - bf * invz
    proj_ok = last["has_pt"] & (z > 0) & (u >= min_x) & (u <= max_x) & \
        (v >= min_y) & (v <= max_y)
    lo = last["octave"].to(torch.int64)
    radius = th * scale_factors[lo]
    if forward:
        oct_lo, oct_hi = lo, torch.full_like(lo, n_levels - 1)
    elif backward:
        oct_lo, oct_hi = torch.zeros_like(lo), lo
    else:
        oct_lo, oct_hi = lo - 1, lo + 1
    co = cur["octave"].to(torch.int64)
    du = (cur["kp_xy"][None, :, 0] - u[:, None]).abs()
    dv = (cur["kp_xy"][None, :, 1] - v[:, None]).abs()
    cand = (proj_ok[:, None] & cur["valid"][None, :]
            & (du < radius[:, None]) & (dv < radius[:, None])
            & (co[None, :] >= oct_lo[:, None]) & (co[None, :] <= oct_hi[:, None])
            & ((cur["u_right"][None, :] <= 0)
               | ((ur_proj[:, None] - cur["u_right"][None, :]).abs() < radius[:, None])))
    del du, dv
    dist = torch.where(cand, hamming_matrix(last["desc"], cur["desc"]),
                       torch.full_like(cand, BIG, dtype=torch.int32))
    best = torch.argmin(dist, dim=1)
    matched = torch.gather(dist, 1, best[:, None])[:, 0] <= TH_HIGH
    rot = last["angle"] - cur["angle"][best]
    matched = rotation_consistency(rot, matched)
    S = cur["kp_xy"].shape[0]
    return _last_writer(torch.where(matched, best, torch.full_like(best, S)), S)


def motion_model_matches(R, t, last, cur, th, scale_factors, n_levels, cam,
                         forward, backward):
    """The search at ``th``, and at 2 th where it finds fewer than 20."""
    m = search_last(R, t, last, cur, th, scale_factors, n_levels, cam, forward, backward)
    if int((m >= 0).sum()) < 20:
        m = search_last(R, t, last, cur, 2.0 * th, scale_factors, n_levels, cam,
                        forward, backward)
    return m


def local_map_matches(R, t, cand, free, cur, th, scale_factors, n_levels, log_scale, cam,
                      nn_ratio=0.8):
    """Frustum check of the candidates from the pose (R, t), then the
    projection search over the current slots that are ``free``: for each
    current slot the index of the candidate it matched, or -1."""
    fx, fy, cx, cy, bf, min_x, max_x, min_y, max_y = cam
    Ow = -R.T @ t
    _, z, invz, u, v = _project(cand["pos"], R, t, fx, fy, cx, cy)
    po = cand["pos"] - Ow
    dist = torch.linalg.norm(po, dim=1)
    view_cos = (po * cand["normal"]).sum(1) / torch.clamp(dist, min=1e-9)
    ratio = cand["maxd"] / torch.clamp(dist, min=1e-9)
    level = torch.ceil(torch.log(torch.clamp(ratio, min=1e-9)) / log_scale)
    level = level.to(torch.int64).clamp(0, n_levels - 1)
    ok = (cand["alive"] & (z > 0) & (u >= min_x) & (u <= max_x) & (v >= min_y)
          & (v <= max_y) & (dist >= 0.8 * cand["mind"]) & (dist <= 1.2 * cand["maxd"])
          & (view_cos >= 0.5))
    r = torch.where(view_cos > 0.998, torch.full_like(view_cos, 2.5),
                    torch.full_like(view_cos, 4.0)) * th
    radius = r * scale_factors[level]
    co = cur["octave"].to(torch.int64)
    du = (cur["kp_xy"][None, :, 0] - u[:, None]).abs()
    dv = (cur["kp_xy"][None, :, 1] - v[:, None]).abs()
    gate = (ok[:, None] & cur["valid"][None, :] & free[None, :]
            & (du < radius[:, None]) & (dv < radius[:, None])
            & (co[None, :] >= level[:, None] - 1) & (co[None, :] <= level[:, None]))
    del du, dv
    d = torch.where(gate, hamming_matrix(cand["desc"], cur["desc"]),
                    torch.full_like(gate, BIG, dtype=torch.int32))
    best = torch.argmin(d, dim=1)
    best_d = torch.gather(d, 1, best[:, None])[:, 0]
    d2 = d.scatter(1, best[:, None], BIG)
    second = torch.argmin(d2, dim=1)
    second_d = torch.gather(d2, 1, second[:, None])[:, 0]
    ratio_reject = (co[best] == co[second]) & \
        (best_d.to(torch.float32) > nn_ratio * second_d.to(torch.float32))
    matched = (best_d <= TH_HIGH) & ~ratio_reject
    S = cur["kp_xy"].shape[0]
    return _last_writer(torch.where(matched, best, torch.full_like(best, S)), S)


def brute_force_matches(desc_a, valid_a, angle_a, desc_b, valid_b, angle_b):
    """All-pairs matching with the TH_LOW, ratio and rotation gates, one a
    per b (the best; among equals the one ranked last by a stable sort on
    worsening distance), as the mono initialization matches its reference
    frame: for each a the index into b, or -1."""
    ok = valid_a[:, None] & valid_b[None, :]
    dist = torch.where(ok, hamming_matrix(desc_a, desc_b),
                       torch.full_like(ok, BIG, dtype=torch.int32))
    best_b = torch.argmin(dist, dim=1)
    best_dist = torch.gather(dist, 1, best_b[:, None])[:, 0]
    second = dist.scatter(1, best_b[:, None], BIG).min(dim=1).values
    matched = (best_dist <= TH_LOW) & \
        (best_dist.to(torch.float32) < INIT_NN_RATIO * second.to(torch.float32))
    matched = rotation_consistency(angle_a - angle_b[best_b], matched)
    S_a, S_b = dist.shape
    order = torch.argsort(-best_dist, stable=True)
    tgt = torch.where(matched[order], best_b[order], torch.full_like(best_b, S_b))
    pos = _last_writer(tgt, S_b)
    a_of_b = torch.where(pos >= 0, order[pos.clamp(min=0)], torch.full_like(pos, -1))
    src = torch.where(a_of_b >= 0, a_of_b, torch.full_like(a_of_b, S_a))
    match_a = torch.full((S_a + 1,), -1, dtype=torch.int64, device=dist.device)
    match_a[src] = torch.arange(S_b, device=dist.device)
    return match_a[:S_a]
