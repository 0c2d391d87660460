"""All-pairs Hamming distances of 32-byte binary descriptors.

Frozen copy of the port's ``ops/hamming.py``, kept as the benchmark's
yardstick.  With descriptors unpacked to
{0, 1} bit vectors a, b of length 256, hamming(a, b) = |a| + |b| - 2 a.b, so
the whole table is one float32 matrix product (``torch.matmul``, a plain
product outside any kernel).  Every partial sum is an integer below 2^24,
so float32 is exact; the table is returned as int32 unless asked for
another type.  ``hamming_pairs`` counts the differing bits of aligned
pairs.
"""
from __future__ import annotations

import torch


def unpack_bits(desc_u8):
    """(K, 32) uint8 -> (K, 256) float32 in {0, 1}, LSB-first per byte."""
    shifts = torch.arange(8, device=desc_u8.device, dtype=torch.uint8)
    bits = (desc_u8[..., None] >> shifts) & 1
    return bits.reshape(*desc_u8.shape[:-1], 256).to(torch.float32)


def hamming_matrix(desc_a, desc_b, dtype=torch.int32):
    """(M, 32) uint8 x (N, 32) uint8 -> (M, N) Hamming distances in
    ``dtype``.  Distances are at most 256, so bfloat16 and every integer
    type from int16 up hold them exactly, in less memory than int32."""
    if not isinstance(dtype, torch.dtype):
        raise TypeError(f"dtype must be a torch.dtype, not {type(dtype).__name__}")
    a = unpack_bits(desc_a)
    b = unpack_bits(desc_b)
    dots = a @ b.transpose(-1, -2)
    pa = a.sum(-1, keepdim=True)
    pb = b.sum(-1, keepdim=True)
    return (pa + pb.transpose(-1, -2) - 2.0 * dots).to(dtype)


def hamming_pairs(desc_a, desc_b):
    """Row-wise Hamming distance of aligned pairs: (K, 32) uint8 x (K, 32)
    uint8 -> (K,) int32."""
    shifts = torch.arange(8, device=desc_a.device, dtype=torch.uint8)
    bits = ((desc_a ^ desc_b)[..., None] >> shifts) & 1
    return bits.sum((-2, -1), dtype=torch.int32)
