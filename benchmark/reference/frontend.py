"""The plain ORB front end and stereo matcher the benchmark judges against.

A frozen copy of the arithmetic of the port's plain versions
(``ops/frontend.py``, ``ops/stereo.py`` and the plain functions beside the
three CUDA kernels), in plain PyTorch, importing nothing of the port:

1. pyramid: separable 2-tap bilinear resize, exact in int64;
2. FAST score + NMS-L (the segment-test table of ``tables.fast_lut``);
3. NMS-G per tile, the 3x3 score parabola for subpixel coordinates;
4. blur + intensity-centroid angle + rBRIEF;
5. stereo: Hamming coarse match, 11x11 window SAD over +-5 px, parabola
   refinement and median prune.

``fdt`` is the float type of the steps that the configuration computes in
float32 (the subpixel parabola and level scaling, the angle and the
pattern's rotation, the stereo parabola and depth): ``torch.bfloat16``
gives the lower-precision control of the output check.  Integer steps stay
exact either way.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from . import tables
from .hamming import hamming_matrix

BORDER_SKIP = tables.BORDER_SKIP
RESIZE_FRAC_BITS = 23
_RING = [(int(dy), int(dx)) for dy, dx in np.asarray(tables.FAST_RING)]
R_WIN, DESC_HALF, IC_HALF = 22, 19, 15
RAD2DEG = 57.29577951308232
PATCH_HALF, NBRHOOD, NBR_HALF = 5, 11, 5
TH_HIGH, TH_LOW, NO_MATCH = 100, 50, 29952


def _resize_weights(in_size, out_size, scale):
    W = np.zeros((out_size, in_size), dtype=np.float32)
    for o in range(out_size):
        ip = np.float32(np.float32(scale) * o)
        lo = int(np.floor(ip))
        hi = min(lo + 1, in_size - 1)
        w_lo = np.float32(lo + 1) - ip
        W[o, lo] += w_lo
        W[o, hi] += np.float32(1.0) - w_lo
    return W


def _two_taps(W):
    n = np.arange(W.shape[0])
    lo = np.argmax(W > 0, axis=1)
    hi = np.minimum(lo + 1, W.shape[1] - 1)
    w_lo = W[n, lo].astype(np.float64)
    w_hi = np.where(hi != lo, W[n, hi], np.float32(0.0)).astype(np.float64)
    num = [np.ldexp(w, RESIZE_FRAC_BITS).astype(np.int64) for w in (w_lo, w_hi)]
    return lo, hi, num[0], num[1]


def _resize(x, taps, dim):
    lo, hi, w_lo, w_hi = taps
    shape = [1] * x.dim()
    shape[dim] = -1
    return (x.index_select(dim, lo) * w_lo.view(shape)
            + x.index_select(dim, hi) * w_hi.view(shape))


def fast_nms(stack_u8, roi, lut, threshold):
    """FAST score + NMS-L over (N, H, W) canvases; roi (M, 4) per level."""
    N, H, W = stack_u8.shape
    M = roi.shape[0]
    v = stack_u8.to(torch.int32)
    p = F.pad(v, (3, 3, 3, 3))
    vt, v_t = v + threshold, v - threshold
    bright = torch.zeros_like(v)
    dark = torch.zeros_like(v)
    sad = torch.zeros_like(v)
    within = {}
    for k, (dy, dx) in enumerate(_RING):
        r = p[:, 3 + dy:3 + dy + H, 3 + dx:3 + dx + W]
        bright |= (r > vt).to(torch.int32) << k
        dark |= (r < v_t).to(torch.int32) << k
        sad += (r - v).abs()
        if k in (0, 4, 8, 12):
            within[k] = (r <= vt) & (r >= v_t)
    pruned = (within[4] & within[12]) | (within[0] & within[8])
    lut_b = lut.to(torch.bool)
    corner = lut_b[bright.long()] | lut_b[dark.long()]
    rows = torch.arange(H, device=v.device)[None, :, None]
    cols = torch.arange(W, device=v.device)[None, None, :]
    r_ = roi.long().repeat(N // M, 1)
    in_roi = ((rows >= r_[:, 0, None, None]) & (rows < r_[:, 1, None, None])
              & (cols >= r_[:, 2, None, None]) & (cols < r_[:, 3, None, None]))
    raw = torch.where(corner & ~pruned & in_roi, sad, torch.zeros_like(sad))
    pr = F.pad(raw, (1, 1, 1, 1))
    nmax = torch.zeros_like(raw)
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            if dy or dx:
                nmax = torch.maximum(nmax, pr[:, 1 + dy:1 + dy + H, 1 + dx:1 + dx + W])
    return raw, torch.where(raw >= nmax, raw, torch.zeros_like(raw))


def nms_g(score, tile_h, tile_w):
    """Per-tile argmax (first maximum in row-major order), (B, H, W)."""
    B, H, W = score.shape
    n_th, n_tw = (H - 1) // tile_h + 1, (W - 1) // tile_w + 1
    padded = score.new_zeros((B, n_th * tile_h, n_tw * tile_w))
    padded[:, :H, :W] = score
    flat = (padded.reshape(B, n_th, tile_h, n_tw, tile_w).transpose(2, 3)
            .reshape(B, n_th * n_tw, tile_h * tile_w))
    idx = torch.argmax(flat, dim=-1)
    s = torch.gather(flat, -1, idx[..., None])[..., 0]
    t = torch.arange(n_th * n_tw, device=score.device, dtype=torch.int32)
    y = (t // n_tw) * tile_h + (idx // tile_w).to(torch.int32)
    x = (t % n_tw) * tile_w + (idx % tile_w).to(torch.int32)
    zero = torch.zeros_like(s)
    empty = s <= 0
    return (torch.where(empty, zero, x), torch.where(empty, zero, y),
            torch.where(empty, zero, s))


def _parabola(sm, s0, sp):
    den = sm - 2.0 * s0 + sp
    off = torch.where(den.abs() > 1e-6, 0.5 * (sm - sp) / den, torch.zeros_like(den))
    return off.clamp(-0.5, 0.5)


def orb_descriptor(pyr, kx, ky, ks, slot_level, level_hw, pattern, gauss,
                   ic_masks, fdt=torch.float32):
    """Blur + IC angle + rBRIEF per slot; returns desc (B, K, 32) uint8 and
    angle (B, K) float32 degrees, zeros on invalid slots."""
    B, L, H0, W0 = pyr.shape
    K = kx.shape[1]
    dev = pyr.device
    lvl = slot_level.long()[None, :].expand(B, K)
    valid = ks > 0
    pad = F.pad(pyr, (R_WIN,) * 4)
    off = torch.arange(-R_WIN, R_WIN + 1, device=dev)
    rows = (ky.long() + R_WIN)[..., None] + off
    cols = (kx.long() + R_WIN)[..., None] + off
    bidx = torch.arange(B, device=dev)[:, None, None, None]
    win = pad[bidx, lvl[..., None, None], rows[..., :, None], cols[..., None, :]]
    raw = win.to(torch.float32)
    c = R_WIN - IC_HALF
    patch = win[..., c:c + 2 * IC_HALF + 1, c:c + 2 * IC_HALF + 1].to(torch.int32)
    m10 = (patch * ic_masks[0]).sum((-2, -1), dtype=torch.int32)
    m01 = (patch * ic_masks[1]).sum((-2, -1), dtype=torch.int32)
    ang = torch.atan2(m01.to(fdt), m10.to(fdt))
    n = 2 * DESC_HALF + 1
    tx = raw[..., :, 0:n] * gauss[0]
    for j in range(1, 7):
        tx = tx + raw[..., :, j:j + n] * gauss[j]
    ty = tx[..., 0:n, :] * gauss[0]
    for j in range(1, 7):
        ty = ty + tx[..., j:j + n, :] * gauss[j]
    hw = level_hw.long()[lvl]
    ioff = torch.arange(-DESC_HALF, DESC_HALF + 1, device=dev)
    iy = ky.long()[..., None] + ioff
    ix = kx.long()[..., None] + ioff
    ok_y = (iy >= 3) & (iy < hw[..., 0:1] - 3)
    ok_x = (ix >= 3) & (ix < hw[..., 1:2] - 3)
    interior = ok_y[..., :, None] & ok_x[..., None, :]
    s = R_WIN - DESC_HALF
    blur = torch.where(interior, torch.floor(ty), raw[..., s:s + n, s:s + n])
    ca = torch.cos(ang)[..., None]
    sa = torch.sin(ang)[..., None]
    px, py = pattern[:, 0].to(fdt), pattern[:, 1].to(fdt)
    pr = torch.round(px * sa + py * ca).long() + DESC_HALF
    pc = torch.round(px * ca - py * sa).long() + DESC_HALF
    flat = blur.reshape(B, K, n * n)
    samples = torch.gather(flat, 2, pr * n + pc)
    bits = (samples[..., 0::2] < samples[..., 1::2]).to(torch.int32).reshape(B, K, 32, 8)
    weights = 1 << torch.arange(8, device=dev, dtype=torch.int32)
    desc = (bits * weights).sum(-1).to(torch.uint8)
    desc = torch.where(valid[..., None], desc, torch.zeros_like(desc))
    ang32 = (ang * RAD2DEG).to(torch.float32)
    return desc, torch.where(valid, ang32, torch.zeros_like(ang32))


def stereo_costs(pyr_l, pyr_r, lvl, yy, xl, xr, matched):
    """11x11 SAD of the left patch against 11 right windows, (B, K, 11)."""
    B, L, H0, W0 = pyr_l.shape
    dev = pyr_l.device
    b = torch.arange(B, device=dev)[:, None, None, None]
    lv = lvl.long().clamp(0, L - 1)[..., None, None]
    u = torch.arange(-PATCH_HALF, PATCH_HALF + 1, device=dev)
    s = torch.arange(-PATCH_HALF - NBR_HALF, PATCH_HALF + NBR_HALF + 1, device=dev)
    rows = (yy.long()[..., None] + u).clamp(0, H0 - 1)[..., :, None]
    lcols = (xl.long()[..., None] + u).clamp(0, W0 - 1)[..., None, :]
    rcols = (xr.long()[..., None] + s).clamp(0, W0 - 1)[..., None, :]
    lp = pyr_l[b, lv, rows, lcols].to(torch.int32)
    rs = pyr_r[b, lv, rows, rcols].to(torch.int32)
    ld = lp - lp[..., PATCH_HALF:PATCH_HALF + 1, PATCH_HALF:PATCH_HALF + 1]
    costs = []
    for o in range(NBRHOOD):
        w = rs[..., o:o + 2 * PATCH_HALF + 1]
        rd = w - rs[..., PATCH_HALF:PATCH_HALF + 1, o + PATCH_HALF:o + PATCH_HALF + 1]
        costs.append((ld - rd).abs().sum((-2, -1), dtype=torch.int32))
    costs = torch.stack(costs, -1)
    return torch.where(matched[..., None], costs, torch.zeros_like(costs))


class Frontend:
    """The reference extractor at one camera geometry, on ``device``."""

    def __init__(self, height, width, n_levels, scale_factor, fast_n_min,
                 fast_n_max, threshold, tile_h, tile_w, device="cpu",
                 fdt=torch.float32):
        self.g = g = tables.pyramid_geometry(height, width, n_levels,
                                             scale_factor, tile_h, tile_w)
        self.dev = dev = torch.device(device)
        self.fdt = fdt
        self.threshold = int(threshold)
        self.n_slots = g.total_slots
        self.n_slots_padded = -(-g.total_slots // 128) * 128
        L, H0, W0 = g.n_levels, g.heights[0], g.widths[0]
        t = lambda a: torch.as_tensor(np.ascontiguousarray(a), device=dev)  # noqa: E731
        self.lut = t(tables.fast_lut(fast_n_min, fast_n_max).astype(np.uint8))
        self.roi = t(np.array([[BORDER_SKIP, g.heights[i] - BORDER_SKIP, BORDER_SKIP,
                                g.widths[i] - BORDER_SKIP] for i in range(L)], np.int32))
        lvl = np.zeros(self.n_slots_padded, np.int32)
        scl = np.ones(self.n_slots_padded, np.float32)
        for i in range(L):
            o = g.level_offsets[i]
            k = g.n_tiles_h[i] * g.n_tiles_w[i]
            lvl[o:o + k] = i
            scl[o:o + k] = np.float32(g.scales[i])
        self.slot_level, self.slot_scale = t(lvl), t(scl)
        self.level_hw = t(np.array([[g.heights[i], g.widths[i]] for i in range(L)], np.int32))
        self.widths = t(np.asarray(g.widths, np.int32))
        self.scales = t(np.asarray(g.scales, np.float32))
        self.inv_scales = t(np.asarray(g.inv_scales, np.float32))
        self.taps = {}
        for i in range(1, L):
            for ax, n0, n in (("y", H0, g.heights[i]), ("x", W0, g.widths[i])):
                self.taps[ax, i] = tuple(t(a) for a in _two_taps(
                    _resize_weights(n0, n, g.scales[i])))
        g1 = np.exp(-(np.arange(-3, 4, dtype=np.float64) ** 2) / 200.0)
        self.gauss = t((g1 / g1.sum()).astype(np.float32))
        wu, wv = tables.ic_angle_masks()
        self.ic_masks = t(np.stack([wu, wv]).astype(np.int32))
        self.pattern = t(tables.orb_pattern().astype(np.float32))

    def pyramid(self, imgs_u8):
        g = self.g
        B = imgs_u8.shape[0]
        stack = imgs_u8.new_zeros((B, g.n_levels, g.heights[0], g.widths[0]))
        stack[:, 0] = imgs_u8
        f0 = imgs_u8.to(torch.int64)
        for i in range(1, g.n_levels):
            out = _resize(_resize(f0, self.taps["x", i], 2), self.taps["y", i], 1)
            stack[:, i, :g.heights[i], :g.widths[i]] = (
                out >> (2 * RESIZE_FRAC_BITS)).to(torch.uint8)
        return stack

    def extract_batch(self, imgs_u8):
        """(B, H, W) uint8 -> (dict of (B, K) slot fields, pyramid)."""
        g, fdt = self.g, self.fdt
        imgs_u8 = torch.as_tensor(np.asarray(imgs_u8), device=self.dev)
        B = imgs_u8.shape[0]
        L, H0, W0 = g.n_levels, g.heights[0], g.widths[0]
        pyr = self.pyramid(imgs_u8)
        raw, nms = fast_nms(pyr.reshape(B * L, H0, W0), self.roi, self.lut,
                            self.threshold)
        raw, nms = raw.reshape(B, L, H0, W0), nms.reshape(B, L, H0, W0)
        parts = [nms_g(nms[:, i, :g.heights[i], :g.widths[i]], g.tile_h[i], g.tile_w[i])
                 for i in range(L)]
        zpad = torch.zeros((B, self.n_slots_padded - self.n_slots), dtype=torch.int32,
                           device=self.dev)
        kx, ky, ks = (torch.cat([p[j] for p in parts] + [zpad], 1) for j in range(3))
        desc, angle = orb_descriptor(pyr, kx, ky, ks, self.slot_level, self.level_hw,
                                     self.pattern, self.gauss, self.ic_masks, fdt)
        flat = raw.reshape(B, -1)
        base = self.slot_level.to(torch.int64)[None, :] * (H0 * W0)

        def at(dy, dx):
            idx = (base + (ky.long() + dy).clamp(0, H0 - 1) * W0
                   + (kx.long() + dx).clamp(0, W0 - 1))
            return torch.gather(flat, 1, idx).to(fdt)

        s0 = ks.to(fdt)
        dx = _parabola(at(0, -1), s0, at(0, 1))
        dy = _parabola(at(-1, 0), s0, at(1, 0))
        scale = self.slot_scale[None, :].to(fdt)
        xs = ((kx.to(fdt) + dx) * scale).to(torch.float32)
        ys = ((ky.to(fdt) + dy) * scale).to(torch.float32)
        res = dict(xs=xs, ys=ys, response=ks, angle=angle,
                   octave=self.slot_level[None, :].expand(B, -1), valid=ks > 0,
                   desc=desc)
        return res, pyr

    def extract(self, img_u8):
        res, _ = self.extract_batch(np.asarray(img_u8)[None])
        return {k: v[0] for k, v in res.items()}

    def frame_step(self, left_u8, right_u8, mbf, min_z):
        """Both eyes and the stereo match: (left fields, u_right, depth)."""
        res, pyr = self.extract_batch(np.stack([left_u8, right_u8]))
        left = {k: v[0:1] for k, v in res.items()}
        right = {k: v[1:2] for k, v in res.items()}
        u_r, depth = self._stereo(left, right, pyr[0:1], pyr[1:2], mbf, min_z)
        return {k: v[0] for k, v in left.items()}, u_r[0], depth[0]

    def _stereo(self, left, right, pyr_l, pyr_r, mbf, min_z):
        fdt = self.fdt
        take = lambda table, idx: table[idx.long()]  # noqa: E731
        vL, uL, vR, uR = left["ys"], left["xs"], right["ys"], right["xs"]
        r_right = 2.0 * take(self.scales, right["octave"])
        row_lo, row_hi = torch.floor(vR - r_right), torch.ceil(vR + r_right)
        t_row = torch.floor(vL)
        max_d = float(np.float32(mbf) / np.float32(min_z))
        ok = (left["valid"][..., :, None] & right["valid"][..., None, :]
              & (t_row[..., :, None] >= row_lo[..., None, :])
              & (t_row[..., :, None] <= row_hi[..., None, :])
              & ((left["octave"][..., :, None] - right["octave"][..., None, :]).abs() <= 1)
              & (uR[..., None, :] >= uL[..., :, None] - max_d)
              & (uR[..., None, :] <= uL[..., :, None]))
        dist = torch.where(ok, hamming_matrix(left["desc"], right["desc"]),
                           torch.full(ok.shape, NO_MATCH, dtype=torch.int32, device=ok.device))
        best_idx = torch.argmin(dist, dim=-1)
        best_dist = torch.gather(dist, -1, best_idx[..., None])[..., 0]
        matched = best_dist < (TH_HIGH + TH_LOW) // 2
        inv_s = take(self.inv_scales, left["octave"])
        s = take(self.scales, left["octave"])
        uR0 = torch.gather(uR, -1, best_idx)
        suR0, suL0, svL0 = (torch.round(a * inv_s) for a in (uR0, uL, vL))
        w_lvl = take(self.widths, left["octave"]).to(torch.float32)
        matched = matched & (suR0 - (PATCH_HALF + NBR_HALF) >= 0) & (
            suR0 + (PATCH_HALF + NBR_HALF) < w_lvl)
        costs = stereo_costs(pyr_l, pyr_r, left["octave"].to(torch.int32),
                             svL0.to(torch.int32), suL0.to(torch.int32),
                             suR0.to(torch.int32), matched).to(torch.float32)
        K = uL.shape[-1]
        best_r = torch.argmin(costs, dim=-1)
        best_cost = torch.gather(costs, -1, best_r[..., None])[..., 0]
        interior = (best_r > 0) & (best_r < NBRHOOD - 1)
        br = best_r.clamp(1, NBRHOOD - 2)
        d1, d2, d3 = (torch.gather(costs, -1, (br + o)[..., None])[..., 0].to(fdt)
                      for o in (-1, 0, 1))
        denom = 2.0 * (d1 + d3 - 2.0 * d2)
        delta = torch.where(denom.abs() > 0, (d1 - d3) / denom, torch.full_like(denom, 2.0))
        good_delta = (delta >= -1.0) & (delta <= 1.0)
        best_u_r = (s.to(fdt) * (suR0.to(fdt) + br.to(fdt) - NBR_HALF + delta))
        disparity = uL.to(fdt) - best_u_r
        in_disp = (disparity >= 0.0) & (disparity < max_d)
        clamped = disparity <= 0.0
        disparity = torch.where(clamped, torch.full_like(disparity, 0.01), disparity)
        best_u_r = torch.where(clamped, uL.to(fdt) - 0.01, best_u_r)
        accept = matched & interior & good_delta & in_disp
        depth = (disparity.reciprocal() * float(np.float32(mbf))).to(torch.float32)
        best_u_r = best_u_r.to(torch.float32)
        neg = torch.full_like(uL, -1.0)
        depth = torch.where(accept, depth, neg)
        u_right = torch.where(accept, best_u_r, neg)
        n_acc = accept.sum(-1, keepdim=True)
        sort_costs = torch.sort(torch.where(accept, best_cost,
                                            torch.full_like(best_cost, float("inf"))),
                                dim=-1).values
        median = torch.gather(sort_costs, -1, (n_acc // 2).clamp(0, K - 1))
        keep = accept & (best_cost < 1.5 * 1.4 * median)
        return torch.where(keep, u_right, neg), torch.where(keep, depth, neg)

