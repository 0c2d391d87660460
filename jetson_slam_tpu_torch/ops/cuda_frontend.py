"""Kernel 1: FAST-16 score + 3x3 NMS-L over a batch of pyramid canvases.

Replaces ``jetson_slam_tpu/ops/pallas_frontend.py::fast_score_nms_pallas``
(kernel body ``_fast_nms_kernel``) with the hand-written CUDA kernel
``csrc/fast_nms.cu``.

What bounds it on an H100: bytes.  At the EuRoC slice (16 canvases of
480x752) it reads 5.8 MB of uint8 pixels and writes two int32 maps, 46 MB,
so about 16 us at 3.35 TB/s.  The design spends its time on those stores
and little else: one block per (canvas, 32x32 tile) and four adjacent
outputs per thread, written as 16-byte stores.  A tile whose pixels all
lie outside its canvas's ROI writes zeros and loads nothing (its raw is 0
by the ROI rule, so its nms is 0 too); at the slice that is about two
thirds of the tiles.  Other tiles stage the tile plus a 4-px halo, and
the mask, with 4-byte reads, and the segment-test table as a bitset in
shared memory: ``lut_bits`` packs ``tables.fast_lut(n_min, n_max)`` into
2048 32-bit words once per table and caches it.  The segment test runs in
exact f32 on the FMA pipe and tests the opposite-pair prune first.  The
int32 outputs are kept as the reference defines them.

``fast_nms`` runs the plain PyTorch version for tensors on the CPU and the
CUDA kernel for tensors on the card; there is no other route.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch
import torch.nn.functional as F

from . import cuda_build
from .tables import FAST_RING

_RING = [(int(dy), int(dx)) for dy, dx in np.asarray(FAST_RING)]
TILE = 32           # the kernel's output tile side
_LUT_BITS: dict = {}


def lut_bits(lut):
    """The segment-test table ``lut`` (65536,) uint8 as a bitset: (2048,)
    int32 on lut's device, bit ``m & 31`` of word ``m >> 5`` set iff
    ``lut[m] != 0``.

    Packed on the host once per table and cached.  The cache holds the
    table itself, so its address cannot be reused while cached, and keys
    on the table's version counter, so an in-place edit repacks.
    """
    key = (lut.device, lut.data_ptr(), lut._version)
    hit = _LUT_BITS.get(key)
    if hit is None:
        words = np.packbits(lut.cpu().numpy() != 0, bitorder="little").view("<i4")
        if len(_LUT_BITS) >= 8:
            _LUT_BITS.clear()
        hit = _LUT_BITS[key] = (lut, torch.as_tensor(words.copy(), device=lut.device))
    return hit[1]


def fast_nms_plain(stack_u8, roi, lut, threshold: int, mask=None):
    """Plain PyTorch FAST score + NMS-L, the arithmetic of ``fast_nms``.

    stack_u8: (N, H, W) uint8 zero-padded canvases.  roi: (M, 4) int32
    half-open [y_lo, y_hi, x_lo, x_hi) with N a multiple of M; canvas n uses
    row n % M.  lut: (65536,) uint8 segment-test table
    (``tables.fast_lut(n_min, n_max)``).  mask: optional (M, H, W) uint8,
    score zeroed where it is 0; canvas n uses mask n % M.
    Returns (raw, nms), both (N, H, W) int32.
    """
    N, H, W = stack_u8.shape
    M = roi.shape[0]
    v = stack_u8.to(torch.int32)
    p = F.pad(v, (3, 3, 3, 3))
    vt = v + threshold
    v_t = v - threshold
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
    r_ = roi.to(v.device).long().repeat(N // M, 1)
    in_roi = ((rows >= r_[:, 0, None, None]) & (rows < r_[:, 1, None, None])
              & (cols >= r_[:, 2, None, None]) & (cols < r_[:, 3, None, None]))
    keep = corner & ~pruned & in_roi
    if mask is not None:
        keep &= mask.repeat(N // M, 1, 1) > 0
    raw = torch.where(keep, sad, torch.zeros_like(sad))
    pr = F.pad(raw, (1, 1, 1, 1))
    nmax = torch.zeros_like(raw)
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            if dy or dx:
                nmax = torch.maximum(nmax, pr[:, 1 + dy:1 + dy + H, 1 + dx:1 + dx + W])
    nms = torch.where(raw >= nmax, raw, torch.zeros_like(raw))
    return raw, nms


def _check(stack_u8, roi, lut, mask):
    if stack_u8.dtype != torch.uint8 or stack_u8.dim() != 3:
        raise ValueError("stack_u8 must be (N, H, W) uint8")
    N, H, W = stack_u8.shape
    if roi.dtype != torch.int32 or roi.dim() != 2 or roi.shape[1] != 4 \
            or N % roi.shape[0]:
        raise ValueError("roi must be (M, 4) int32 with N a multiple of M")
    if lut.dtype != torch.uint8 or lut.shape != (1 << 16,):
        raise ValueError("lut must be (65536,) uint8")
    if mask is not None and (mask.dtype != torch.uint8 or mask.dim() != 3
                             or mask.shape[1:] != (H, W) or N % mask.shape[0]):
        raise ValueError("mask must be (M, H, W) uint8 with N a multiple of M")
    ts = (stack_u8, roi, lut) + ((mask,) if mask is not None else ())
    devs = {t.device for t in ts}
    if len(devs) != 1:
        raise ValueError(f"all inputs must be on one device, got {devs}")
    if not all(t.is_contiguous() for t in ts):
        raise ValueError("fast_nms takes contiguous tensors")


def fast_nms(stack_u8, roi, lut, threshold: int, mask=None):
    """FAST score + NMS-L (see ``fast_nms_plain`` for the contract).

    A CPU tensor takes the plain version; a CUDA tensor launches
    ``csrc/fast_nms.cu`` and adds one to ``fast_nms.launches``
    (``cuda_build.count_launch``: once per replay inside a CUDA graph).
    """
    _check(stack_u8, roi, lut, mask)
    if stack_u8.device.type == "cpu":
        return fast_nms_plain(stack_u8, roi, lut, threshold, mask)
    if stack_u8.device.type != "cuda":
        raise ValueError(f"fast_nms: unsupported device {stack_u8.device}")
    m = mask
    N, H, W = stack_u8.shape
    bits = lut_bits(lut)
    raw = torch.empty((N, H, W), dtype=torch.int32, device=stack_u8.device)
    nms = torch.empty_like(raw)
    lib = _lib()
    status = lib.fast_nms_launch(
        stack_u8.data_ptr(), m.data_ptr() if m is not None else None,
        m.shape[0] if m is not None else 1, roi.data_ptr(),
        roi.shape[0], bits.data_ptr(), N, H, W, int(threshold),
        raw.data_ptr(), nms.data_ptr(),
        torch.cuda.current_stream(stack_u8.device).cuda_stream)
    cuda_build.check(status, "fast_nms")
    cuda_build.count_launch(fast_nms)
    return raw, nms


fast_nms.launches = 0


def _lib():
    lib = cuda_build.load("fast_nms")
    fn = lib.fast_nms_launch
    if fn.argtypes is None:
        P, I = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [P, P, I, P, I, P, I, I, I, I, P, P, P]
        fn.restype = ctypes.c_int
    return lib
