"""ORB front-end in PyTorch: pyramid, FAST, NMS, subpixel, blur, IC, rBRIEF.

Port of ``jetson_slam_tpu/ops/frontend.py`` (the fused batched extractor
``_extract_batch_core`` and the stereo ``frame_step``).  Keypoints live in
dense per-tile slots (one slot per NMS-G tile, score 0 = empty), padded to a
multiple of 128, at level-0 coordinates.

Per frame, for a batch of images (both stereo eyes ride one call):

1. pyramid: a separable 2-tap bilinear resize per level with the
   reference's float32 weights, x then y, then ``floor``, computed exactly
   (int64 on the weights' numerators).  The reference's f32 matmul pair
   rounds its intermediate, so a few of its pixels that lie within an ulp
   of an integer floor one grey lower or higher than the exact resize;
2. FAST score + NMS-L: kernel 1 (``ops/cuda_frontend.py``) over all
   eyes x levels canvases at once;
3. NMS-G: per-tile argmax (first maximum in row-major order), optional
   NMS-MS, and the 3x3 score parabola for subpixel coordinates (unless
   ``subpixel=False``; ``quantize_level0_coords=True`` floors the level-0
   coordinates instead, as the reference does);
4. blur + IC angle + rBRIEF: kernel 2 (``ops/cuda_descriptor.py``).

The TPU package's tile-anchored bands (``ops/bands.py``) are not ported:
they exist because TPU gathers are slow.  Here the kernels and their plain
versions read the zero-padded pyramid stack ``(B, L, H0, W0)`` directly,
which gives the same values for every valid keypoint (the FAST ROI keeps a
keypoint at least ``BORDER_SKIP`` = 20 px inside its level; rBRIEF reaches
19 px and IC 15 px).  Descriptors and angles of invalid slots are not
defined in the port: zeros are written there.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch import nn

from ..device import resolve_device
from . import tables
from .cuda_descriptor import orb_descriptor
from .cuda_frontend import fast_nms
from .stereo import stereo_match
from .tables import BORDER_SKIP


def _resize_weights(in_size: int, out_size: int, scale: float) -> np.ndarray:
    """Dense (out, in) separable bilinear weight matrix, float32
    (orb_pyramid.cu:45-64: src = scale * dst, top-left aligned, the
    neighbour clamped at the image edge)."""
    W = np.zeros((out_size, in_size), dtype=np.float32)
    for o in range(out_size):
        ip = np.float32(np.float32(scale) * o)
        lo = int(np.floor(ip))
        hi = min(lo + 1, in_size - 1)
        w_lo = np.float32(lo + 1) - ip
        W[o, lo] += w_lo
        W[o, hi] += np.float32(1.0) - w_lo
    return W


# Every resize weight is a multiple of 2**-23: w_lo = (lo + 1) - ip is exact
# in float32 (ip >= 1 past the first row, so ulp(ip) >= 2**-23), and so is
# 1 - w_lo.  The resize therefore runs exactly in int64 on the weights'
# numerators, and floor() of the two passes is a shift by 2 * 23 bits.
RESIZE_FRAC_BITS = 23


def _two_taps(W: np.ndarray):
    """The two non-zero taps of each row of a resize matrix: (lo, hi) int64
    indices and their weights as int64 numerators over 2**RESIZE_FRAC_BITS
    (weight 0 where the row has one tap)."""
    n = np.arange(W.shape[0])
    lo = np.argmax(W > 0, axis=1)
    hi = np.minimum(lo + 1, W.shape[1] - 1)
    w_lo = W[n, lo].astype(np.float64)
    w_hi = np.where(hi != lo, W[n, hi], np.float32(0.0)).astype(np.float64)
    num = [np.ldexp(w, RESIZE_FRAC_BITS) for w in (w_lo, w_hi)]
    if any((v != np.floor(v)).any() for v in num):
        raise ValueError("a resize weight is not a multiple of 2**-23")
    return lo, hi, num[0].astype(np.int64), num[1].astype(np.int64)


def resize_taps(W: np.ndarray, axis: str, level: int) -> dict:
    """The front-end's buffers for one resize matrix: {axis}lo{level},
    {axis}hi{level}, {axis}wlo{level}, {axis}whi{level}."""
    return dict(zip((f"{axis}lo{level}", f"{axis}hi{level}",
                     f"{axis}wlo{level}", f"{axis}whi{level}"), _two_taps(W)))


def resize_two_tap(x, lo, hi, w_lo, w_hi, dim: int):
    """One separable resize pass along ``dim`` in exact int64 arithmetic:
    x[lo] * w_lo + x[hi] * w_hi on the weights' numerators (the result
    carries RESIZE_FRAC_BITS more fraction bits than x)."""
    a = x.index_select(dim, lo)
    b = x.index_select(dim, hi)
    shape = [1] * x.dim()
    shape[dim] = -1
    return a * w_lo.view(shape) + b * w_hi.view(shape)


def nms_g(score, tile_h: int, tile_w: int):
    """NMS-G: per-tile argmax over an NMS-L score map (spec
    orb_FAST_apply_NMS_G.cu:1256-1384).  score: (B, H, W) int32.  Returns
    dense per-tile (x, y, s) int32 of shape (B, n_tiles), row-major tiles,
    ties resolved to the first maximum in row-major order; empty tiles are
    all zero."""
    B, H, W = score.shape
    n_th = (H - 1) // tile_h + 1
    n_tw = (W - 1) // tile_w + 1
    padded = score.new_zeros((B, n_th * tile_h, n_tw * tile_w))
    padded[:, :H, :W] = score
    flat = (padded.reshape(B, n_th, tile_h, n_tw, tile_w).transpose(2, 3)
            .reshape(B, n_th * n_tw, tile_h * tile_w))
    idx = torch.argmax(flat, dim=-1)
    s = torch.gather(flat, -1, idx[..., None])[..., 0]
    t = torch.arange(n_th * n_tw, device=score.device, dtype=torch.int32)
    y = (t // n_tw) * tile_h + (idx // tile_w).to(torch.int32)
    x = (t % n_tw) * tile_w + (idx % tile_w).to(torch.int32)
    empty = s <= 0
    zero = torch.zeros_like(s)
    return (torch.where(empty, zero, x), torch.where(empty, zero, y),
            torch.where(empty, zero, s))


def nms_ms(kp_x, kp_y, kp_s, kp_level, kp_scale, n_levels: int, h0: int,
           w0: int):
    """Multi-scale NMS over the concatenated per-tile slots of one image
    (spec orb_FAST_apply_NMS_MS.cu:389-467; the deterministic variant of the
    reference: every phase-2 column read happens before any zeroing).
    All arguments (K,); returns the suppressed scores (K,)."""
    dev = kp_s.device
    valid = kp_s > 0
    hs = (kp_y.to(torch.float32) * kp_scale).to(torch.int64)
    ws = (kp_x.to(torch.float32) * kp_scale).to(torch.int64)
    lvl = kp_level.to(torch.int64)
    # phase 1: the winners scattered into the (L, H0, W0) level-0 grid;
    # (level, cell) pairs of valid slots are unique (scales > 1)
    dump = n_levels * h0 * w0
    flat_idx = torch.where(valid, (lvl * h0 + hs) * w0 + ws,
                           torch.full_like(hs, dump))
    s0 = torch.zeros(dump + 1, dtype=torch.int32, device=dev)
    s0[flat_idx] = torch.where(valid, kp_s, torch.zeros_like(kp_s))
    # phase 2: per slot, the column over levels at its cell
    cell = (hs * w0 + ws).clamp(0, h0 * w0 - 1)
    col = s0[:-1].reshape(n_levels, h0 * w0)[:, cell]
    col = torch.where(valid[None, :], col, torch.zeros_like(col))
    max_level = torch.argmax(col, dim=0).to(torch.int32)
    col_sum = col.sum(0, dtype=torch.int32)
    zero_count = (col == 0).sum(0, dtype=torch.int32)
    winner = valid & (kp_level == max_level)
    cell_dump = h0 * w0
    w_idx = torch.where(winner, cell, torch.full_like(cell, cell_dump))
    nms_score = torch.zeros(cell_dump + 1, dtype=torch.int32, device=dev)
    nms_level = torch.zeros(cell_dump + 1, dtype=torch.int32, device=dev)
    nms_score[w_idx] = torch.where(winner, col_sum, torch.zeros_like(col_sum))
    nms_level[w_idx] = torch.where(winner, zero_count,
                                   torch.zeros_like(zero_count))
    # phase 3: 3x3 cross-scale suppression on (sum * zero_count) products
    prod = nms_score[:-1] * nms_level[:-1]
    my_p = prod[cell]
    ok = torch.ones_like(valid)
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            nb = ((hs + dy) * w0 + (ws + dx)).clamp(0, h0 * w0 - 1)
            ok = ok & (my_p >= prod[nb])
    return torch.where(valid & ~ok, torch.zeros_like(kp_s), kp_s)


def _parabola(sm, s0, sp):
    """Subpixel offset of a 3-point score parabola, clipped to +-0.5."""
    den = sm - 2.0 * s0 + sp
    off = torch.where(den.abs() > 1e-6, 0.5 * (sm - sp) / den,
                      torch.zeros_like(den))
    return off.clamp(-0.5, 0.5)


@dataclasses.dataclass
class FrontendResult:
    """Dense keypoint slots at level-0 coordinates (one slot per NMS-G tile);
    every field has a leading batch axis when it comes from a batch."""
    xs: torch.Tensor        # float32 level-0 x
    ys: torch.Tensor        # float32
    response: torch.Tensor  # int32 SAD score
    angle: torch.Tensor     # float32 degrees
    octave: torch.Tensor    # int32
    size: torch.Tensor      # float32 floor(31 * scale)
    valid: torch.Tensor     # bool
    desc: torch.Tensor      # (..., 32) uint8
    lx: torch.Tensor        # int32 level-local x
    ly: torch.Tensor        # int32 level-local y

    def map(self, fn) -> "FrontendResult":
        return FrontendResult(*(fn(getattr(self, f.name))
                                for f in dataclasses.fields(self)))


class OrbFrontend(nn.Module):
    """The batched both-eye ORB extractor (``OrbFrontend`` of the JAX
    package).  Its static tables are buffers on ``device``; ``extract`` and
    ``frame_step`` take numpy images or tensors and return tensors there."""

    def __init__(self, height, width, n_levels=8, scale_factor=1.2,
                 fast_n_min=9, fast_n_max=16, threshold=20, tile_h=30,
                 tile_w=30, fixed_multi_scale_tile_size=False,
                 apply_nms_ms=False, mask=None, quantize_level0_coords=False,
                 subpixel=True, device="cuda"):
        super().__init__()
        for name, v in (("quantize_level0_coords", quantize_level0_coords),
                        ("subpixel", subpixel)):
            if not isinstance(v, (bool, np.bool_)):
                raise TypeError(f"{name} must be a bool, not {type(v).__name__}")
        dev = resolve_device(device)
        # quantize_level0_coords floors the level-0 coordinates as the
        # reference's int cast does (orb_copy_output.cu:35), which
        # quantizes a level-L keypoint by scale^L pixels; subpixel adds the
        # 3x3 score parabola's offsets and is off when quantizing.  Both act
        # on xs / ys only: descriptors come from the integer level
        # coordinates either way
        self.quantize_level0_coords = bool(quantize_level0_coords)
        self.subpixel = bool(subpixel) and not self.quantize_level0_coords
        self.geom = g = tables.pyramid_geometry(
            height, width, n_levels, scale_factor, tile_h, tile_w,
            fixed_multi_scale_tile_size)
        self.threshold = int(threshold)
        self.fast_n_min = int(fast_n_min)
        self.fast_n_max = int(fast_n_max)
        self.apply_nms_ms = bool(apply_nms_ms) and n_levels > 1
        self.n_slots = g.total_slots
        self.n_slots_padded = -(-g.total_slots // 128) * 128
        H0, W0, L = g.heights[0], g.widths[0], g.n_levels
        self._h0w0 = (H0, W0)

        def buf(name, arr):
            self.register_buffer(name, torch.as_tensor(np.ascontiguousarray(arr)),
                                 persistent=False)

        buf("lut", tables.fast_lut(fast_n_min, fast_n_max).astype(np.uint8))
        buf("roi", np.array([[BORDER_SKIP, g.heights[i] - BORDER_SKIP,
                              BORDER_SKIP, g.widths[i] - BORDER_SKIP]
                             for i in range(L)], np.int32))
        lvl = np.zeros(self.n_slots_padded, np.int32)
        scl = np.ones(self.n_slots_padded, np.float32)
        for i in range(L):
            o = g.level_offsets[i]
            n = g.n_tiles_h[i] * g.n_tiles_w[i]
            lvl[o:o + n] = i
            scl[o:o + n] = np.float32(g.scales[i])
        buf("slot_level", lvl)
        buf("slot_scale", scl)
        buf("level_hw", np.array([[g.heights[i], g.widths[i]]
                                  for i in range(L)], np.int32))
        buf("widths", np.asarray(g.widths, np.int32))
        buf("scales", np.asarray(g.scales, np.float32))
        buf("inv_scales", np.asarray(g.inv_scales, np.float32))
        # resize: the two taps of every output row, per level and axis
        for i in range(1, L):
            for ax, n0, n in (("y", H0, g.heights[i]), ("x", W0, g.widths[i])):
                for k, v in resize_taps(_resize_weights(n0, n, g.scales[i]), ax, i).items():
                    buf(k, v)
        g1 = np.exp(-(np.arange(-3, 4, dtype=np.float64) ** 2) / 200.0)
        buf("gauss", (g1 / g1.sum()).astype(np.float32))
        wu, wv = tables.ic_angle_masks()
        buf("ic_masks", np.stack([wu, wv]).astype(np.int32))
        buf("pattern", tables.orb_pattern().astype(np.float32))
        # per-level masks (resized nearest + binarised, orb_gpu.cpp:64-91)
        self.has_mask = mask is not None
        if self.has_mask:
            m0 = np.asarray(mask)
            ms = np.zeros((L, H0, W0), np.uint8)
            for i in range(L):
                hi_, wi_ = g.heights[i], g.widths[i]
                ys = (np.arange(hi_) * (H0 / hi_)).astype(np.int64).clip(0, H0 - 1)
                xs = (np.arange(wi_) * (W0 / wi_)).astype(np.int64).clip(0, W0 - 1)
                ms[i, :hi_, :wi_] = (m0[ys][:, xs] > 10).astype(np.uint8)
            buf("mask_stack", ms)
        self.to(dev)

    @property
    def device(self) -> torch.device:
        return self.lut.device

    def _as_images(self, imgs):
        t = torch.as_tensor(imgs)
        if t.dtype != torch.uint8:
            t = t.to(torch.uint8)
        return t.to(self.device)

    # ------------------------------------------------------------------
    def pyramid(self, imgs_u8):
        """(B, H0, W0) uint8 -> (B, L, H0, W0) uint8 stack, each level
        zero-padded to the level-0 canvas."""
        g = self.geom
        B = imgs_u8.shape[0]
        H0, W0 = self._h0w0
        stack = imgs_u8.new_zeros((B, g.n_levels, H0, W0))
        stack[:, 0] = imgs_u8
        f0 = imgs_u8.to(torch.int64)
        for i in range(1, g.n_levels):
            t = resize_two_tap(f0, getattr(self, f"xlo{i}"), getattr(self, f"xhi{i}"),
                               getattr(self, f"xwlo{i}"), getattr(self, f"xwhi{i}"), 2)
            out = resize_two_tap(t, getattr(self, f"ylo{i}"), getattr(self, f"yhi{i}"),
                                 getattr(self, f"ywlo{i}"), getattr(self, f"ywhi{i}"), 1)
            stack[:, i, :g.heights[i], :g.widths[i]] = (
                out >> (2 * RESIZE_FRAC_BITS)).to(torch.uint8)
        return stack

    def _subpixel(self, raw, kp_x, kp_y, kp_s):
        """3x3-cross parabola on the raw (pre-NMS) score stack.
        raw: (B, L, H0, W0) int32; kp_*: (B, Kp)."""
        B, L, H0, W0 = raw.shape
        flat = raw.reshape(B, -1)
        base = self.slot_level.to(torch.int64)[None, :] * (H0 * W0)
        y = kp_y.to(torch.int64)
        x = kp_x.to(torch.int64)

        def at(dy, dx):
            idx = base + (y + dy).clamp(0, H0 - 1) * W0 + (x + dx).clamp(0, W0 - 1)
            return torch.gather(flat, 1, idx).to(torch.float32)

        s0 = kp_s.to(torch.float32)
        return (_parabola(at(0, -1), s0, at(0, 1)),
                _parabola(at(-1, 0), s0, at(1, 0)))

    def extract_batch(self, imgs_u8):
        """The fused extractor over a batch of images (both stereo eyes ride
        one call).  imgs_u8: (B, H0, W0) uint8 on the frontend's device.
        Returns (FrontendResult with a leading batch axis, pyramid stack
        (B, L, H0, W0) uint8)."""
        g = self.geom
        B = imgs_u8.shape[0]
        H0, W0 = self._h0w0
        L = g.n_levels
        Kp = self.n_slots_padded
        pyr = self.pyramid(imgs_u8)
        raw, nms = fast_nms(pyr.reshape(B * L, H0, W0), self.roi, self.lut,
                            self.threshold,
                            self.mask_stack if self.has_mask else None)
        raw = raw.reshape(B, L, H0, W0)
        nms = nms.reshape(B, L, H0, W0)
        xs_l, ys_l, s_l = [], [], []
        for i in range(L):
            x, y, s = nms_g(nms[:, i, :g.heights[i], :g.widths[i]],
                            g.tile_h[i], g.tile_w[i])
            xs_l.append(x)
            ys_l.append(y)
            s_l.append(s)
        zpad = torch.zeros((B, Kp - self.n_slots), dtype=torch.int32,
                           device=pyr.device)
        kp_x = torch.cat(xs_l + [zpad], 1)
        kp_y = torch.cat(ys_l + [zpad], 1)
        kp_s = torch.cat(s_l + [zpad], 1)
        if self.apply_nms_ms:
            kp_s = torch.stack([
                nms_ms(kp_x[b], kp_y[b], kp_s[b], self.slot_level,
                       self.slot_scale, L, H0, W0) for b in range(B)])
        desc, angle = orb_descriptor(pyr, kp_x, kp_y, kp_s, self.slot_level,
                                     self.level_hw, self.pattern, self.gauss,
                                     self.ic_masks)
        scale = self.slot_scale[None, :]
        xs = kp_x.to(torch.float32)
        ys = kp_y.to(torch.float32)
        if self.subpixel:
            dx, dy = self._subpixel(raw, kp_x, kp_y, kp_s)
            xs, ys = xs + dx, ys + dy
        xs, ys = xs * scale, ys * scale
        if self.quantize_level0_coords:
            xs, ys = torch.floor(xs), torch.floor(ys)
        res = FrontendResult(
            xs=xs, ys=ys, response=kp_s, angle=angle,
            octave=self.slot_level[None, :].expand(B, Kp).contiguous(),
            size=torch.floor(31.0 * scale).expand(B, Kp).contiguous(),
            valid=kp_s > 0, desc=desc, lx=kp_x, ly=kp_y)
        return res, pyr

    def extract(self, img_u8) -> FrontendResult:
        """One image (H, W) uint8 -> FrontendResult of (Kp,) slots."""
        res, _ = self.extract_batch(self._as_images(img_u8)[None])
        return res.map(lambda a: a[0])

    def frame_step(self, left_u8, right_u8, mbf, min_z):
        """ORB on both eyes in one batch + dense stereo matching.  mbf,
        min_z: floats, or 0-dim float32 tensors on the front-end's device.
        Returns (left, right, u_right, depth, best_dist), unbatched."""
        imgs = torch.stack([self._as_images(left_u8), self._as_images(right_u8)])
        res, pyr = self.extract_batch(imgs)
        left = res.map(lambda a: a[0:1])
        right = res.map(lambda a: a[1:2])
        u_r, depth, dist = stereo_match(
            left, right, pyr[0:1], pyr[1:2], self.scales, self.inv_scales,
            self.widths, mbf, min_z)
        sq = lambda r: r.map(lambda a: a[0])  # noqa: E731
        return sq(left), sq(right), u_r[0], depth[0], dist[0]

    def frame_step_batch(self, lefts_u8, rights_u8, mbf: float, min_z: float):
        """``frame_step`` over a batch of B stereo frames, (B, H, W) per eye:
        one extraction over the 2B eyes (lefts, then rights) and one stereo
        match over the B frames, so each kernel launches once per batch.
        Returns (left, right, u_right, depth, best_dist) with a leading B
        axis, equal frame by frame to ``frame_step``.  The JAX package
        shards this batch over a mesh; here per-frame work is independent,
        so a rank calls it on its own frames."""
        lefts, rights = self._as_images(lefts_u8), self._as_images(rights_u8)
        B = lefts.shape[0]
        res, pyr = self.extract_batch(torch.cat([lefts, rights]))
        left = res.map(lambda a: a[:B])
        right = res.map(lambda a: a[B:])
        u_r, depth, dist = stereo_match(
            left, right, pyr[:B], pyr[B:], self.scales, self.inv_scales,
            self.widths, mbf, min_z)
        return left, right, u_r, depth, dist
