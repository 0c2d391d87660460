"""Kernel 2: Gaussian blur + intensity-centroid angle + rBRIEF per slot.

Replaces ``jetson_slam_tpu/ops/pallas_descriptor.py::orb_descriptors_pallas``
(kernel body ``_descriptor_kernel``) with the hand-written CUDA kernel
``csrc/orb_descriptor.cu``.

The TPU kernel works on tile-anchored bands because gathers are slow there.
Here the kernel and its plain version read the zero-padded pyramid stack
``(B, L, H0, W0)`` directly, a 45x45 window around each keypoint.  The
window equals the band's content for every valid keypoint: the FAST ROI
keeps a keypoint at least 20 px inside its level, rBRIEF reaches +-19 px
and the IC patch +-15 px, and blurred pixels within 3 px of the true level
border keep their raw value.

Arithmetic (kernel and plain version alike): separable 7-tap blur in f32,
along x then along y, each tap a rounded multiply followed by a rounded add
in tap order (no fused multiply-add), weights exp(-d^2/200) normalised in
float64 then cast to f32; ``floor``; raw values within 3 px of the level
border.  Moments m10, m01 are exact integer sums over the 31x31 umax disc;
the angle is ``atan2(m01, m10)`` in f32, then ``cos``/``sin``; the rotated
pattern is rounded half to even.  The TPU kernel's bf16 blur is not copied:
on this card f32 costs nothing.

What bounds it on an H100: operations.  One read of the pyramid plus the
32-byte descriptors and angles is about 6 MB at the EuRoC slice, under
2 us at 3.35 TB/s, while the blur, moments and rBRIEF of ~4.8 k valid
slots are ~46 k 32-bit ops each, and the rounded multiply-then-add issues
one instruction per op.  So the kernel does only the work the result
needs and keeps many slots in flight: one warp per slot (a block each)
with no block-wide barrier, the window kept as u8 and read as aligned
16-byte chunks, the y-blur evaluated only at the 512 points rBRIEF
samples (bit-equal to the full blur there), the moments reduced by warp
shuffles, the bits packed with ``__ballot_sync``, and the pattern and IC
weights read through L1 rather than staged per block.  Invalid slots
retire at once.

Descriptors and angles of invalid slots (score <= 0) are not defined by the
port: both the kernel and the plain version write zeros there.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from . import cuda_build

R_WIN = 22          # window half size: rBRIEF reach 19 + blur support 3
DESC_HALF = 19      # max |rint(rotated pattern offset)|
IC_HALF = 15
RAD2DEG = 57.29577951308232  # f32(180 / pi) once cast


def orb_descriptor_plain(pyr, kx, ky, ks, slot_level, level_hw, pattern,
                         gauss, ic_masks):
    """Plain PyTorch version of ``orb_descriptor`` (same arithmetic).

    pyr: (B, L, H0, W0) uint8 zero-padded pyramid stack.  kx, ky, ks: (B, K)
    int32 level-local keypoint coordinates and NMS score (slot valid iff
    ks > 0).  slot_level: (K,) int32.  level_hw: (L, 2) int32 true level
    (height, width).  pattern: (512, 2) float32 (x, y).  gauss: (7,)
    float32.  ic_masks: (2, 31, 31) int32 (m10 and m01 weights).
    Returns desc (B, K, 32) uint8 and angle (B, K) float32 degrees.
    """
    B, L, H0, W0 = pyr.shape
    K = kx.shape[1]
    dev = pyr.device
    lvl = slot_level.long()[None, :].expand(B, K)
    valid = ks > 0
    pad = F.pad(pyr, (R_WIN,) * 4)
    off = torch.arange(-R_WIN, R_WIN + 1, device=dev)
    rows = (ky.long() + R_WIN)[..., None] + off              # (B, K, 45)
    cols = (kx.long() + R_WIN)[..., None] + off
    bidx = torch.arange(B, device=dev)[:, None, None, None]
    win = pad[bidx, lvl[..., None, None], rows[..., :, None],
              cols[..., None, :]]                             # (B, K, 45, 45)
    raw = win.to(torch.float32)

    # intensity-centroid moments: exact integer sums
    c = R_WIN - IC_HALF
    patch = win[..., c:c + 2 * IC_HALF + 1, c:c + 2 * IC_HALF + 1].to(torch.int32)
    m10 = (patch * ic_masks[0]).sum((-2, -1), dtype=torch.int32)
    m01 = (patch * ic_masks[1]).sum((-2, -1), dtype=torch.int32)
    ang = torch.atan2(m01.to(torch.float32), m10.to(torch.float32))

    # separable blur, x then y, tap by tap (rounded mul, rounded add)
    n = 2 * DESC_HALF + 1
    tx = raw[..., :, 0:n] * gauss[0]
    for j in range(1, 7):
        tx = tx + raw[..., :, j:j + n] * gauss[j]
    ty = tx[..., 0:n, :] * gauss[0]
    for j in range(1, 7):
        ty = ty + tx[..., j:j + n, :] * gauss[j]
    hw = level_hw.long()[lvl]                                 # (B, K, 2)
    ioff = torch.arange(-DESC_HALF, DESC_HALF + 1, device=dev)
    iy = ky.long()[..., None] + ioff
    ix = kx.long()[..., None] + ioff
    ok_y = (iy >= 3) & (iy < hw[..., 0:1] - 3)
    ok_x = (ix >= 3) & (ix < hw[..., 1:2] - 3)
    interior = ok_y[..., :, None] & ok_x[..., None, :]
    s = R_WIN - DESC_HALF
    blur = torch.where(interior, torch.floor(ty), raw[..., s:s + n, s:s + n])

    # rBRIEF on the blurred window
    ca = torch.cos(ang)[..., None]
    sa = torch.sin(ang)[..., None]
    px, py = pattern[:, 0], pattern[:, 1]
    pr = torch.round(px * sa + py * ca).long() + DESC_HALF    # (B, K, 512)
    pc = torch.round(px * ca - py * sa).long() + DESC_HALF
    flat = blur.reshape(B, K, n * n)
    samples = torch.gather(flat, 2, pr * n + pc)
    bits = (samples[..., 0::2] < samples[..., 1::2]).to(torch.int32)
    bits = bits.reshape(B, K, 32, 8)
    weights = (1 << torch.arange(8, device=dev, dtype=torch.int32))
    desc = (bits * weights).sum(-1).to(torch.uint8)
    desc = torch.where(valid[..., None], desc, torch.zeros_like(desc))
    angle = torch.where(valid, ang * RAD2DEG, torch.zeros_like(ang))
    return desc, angle


def _check(pyr, kx, ky, ks, slot_level, level_hw, pattern, gauss, ic_masks):
    if pyr.dtype != torch.uint8 or pyr.dim() != 4:
        raise ValueError("pyr must be (B, L, H0, W0) uint8")
    B, L = pyr.shape[:2]
    for name, t in (("kx", kx), ("ky", ky), ("ks", ks)):
        if t.dtype != torch.int32 or t.dim() != 2 or t.shape[0] != B:
            raise ValueError(f"{name} must be (B, K) int32")
    K = kx.shape[1]
    if ky.shape != kx.shape or ks.shape != kx.shape:
        raise ValueError("kx, ky, ks must share one shape")
    if slot_level.dtype != torch.int32 or slot_level.shape != (K,):
        raise ValueError("slot_level must be (K,) int32")
    if level_hw.dtype != torch.int32 or level_hw.shape != (L, 2):
        raise ValueError("level_hw must be (L, 2) int32")
    if pattern.dtype != torch.float32 or pattern.shape != (512, 2):
        raise ValueError("pattern must be (512, 2) float32")
    if gauss.dtype != torch.float32 or gauss.shape != (7,):
        raise ValueError("gauss must be (7,) float32")
    if ic_masks.dtype != torch.int32 or ic_masks.shape != (2, 31, 31):
        raise ValueError("ic_masks must be (2, 31, 31) int32")
    devs = {t.device for t in (pyr, kx, ky, ks, slot_level, level_hw, pattern,
                               gauss, ic_masks)}
    if len(devs) != 1:
        raise ValueError(f"all inputs must be on one device, got {devs}")
    if not all(t.is_contiguous() for t in (pyr, kx, ky, ks, slot_level, level_hw,
                                           pattern, gauss, ic_masks)):
        raise ValueError("orb_descriptor takes contiguous tensors")


def orb_descriptor(pyr, kx, ky, ks, slot_level, level_hw, pattern, gauss,
                   ic_masks):
    """Blur + IC angle + rBRIEF (see ``orb_descriptor_plain``).

    A CPU tensor takes the plain version; a CUDA tensor launches
    ``csrc/orb_descriptor.cu`` and adds one to ``orb_descriptor.launches``
    (``cuda_build.count_launch``: once per replay inside a CUDA graph).
    """
    args = (pyr, kx, ky, ks, slot_level, level_hw, pattern, gauss, ic_masks)
    _check(*args)
    if pyr.device.type == "cpu":
        return orb_descriptor_plain(*args)
    if pyr.device.type != "cuda":
        raise ValueError(f"orb_descriptor: unsupported device {pyr.device}")
    B, L, H0, W0 = pyr.shape
    K = kx.shape[1]
    desc = torch.empty((B, K, 32), dtype=torch.uint8, device=pyr.device)
    angle = torch.empty((B, K), dtype=torch.float32, device=pyr.device)
    status = _lib().orb_descriptor_launch(
        *[a.data_ptr() for a in args], B, L, H0, W0, K, desc.data_ptr(),
        angle.data_ptr(), torch.cuda.current_stream(pyr.device).cuda_stream)
    cuda_build.check(status, "orb_descriptor")
    cuda_build.count_launch(orb_descriptor)
    return desc, angle


orb_descriptor.launches = 0


def _lib():
    lib = cuda_build.load("orb_descriptor")
    fn = lib.orb_descriptor_launch
    if fn.argtypes is None:
        P, I = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [P] * 9 + [I] * 5 + [P, P, P]
        fn.restype = ctypes.c_int
    return lib
