"""PNG reader and writer on the standard library's zlib.

The one image decoder of the port, on every machine: the JAX package
decodes with Pillow, which the card's machine need not have.  ``read``
takes non-interlaced 8-bit grey, RGB and RGBA and 16-bit grey, with all
five row filters, which covers what EuRoC, KITTI and TUM ship:

- 8-bit grey is returned as is, (H, W) uint8;
- RGB and RGBA become grey by Pillow's ``convert("L")`` integer formula,
  ``(19595 R + 38470 G + 7471 B + 0x8000) >> 16`` (alpha ignored), so the
  tracker sees the same image as the JAX package's;
- 16-bit grey stays (H, W) uint16 (TUM depth).

Palette, interlaced and other files raise ValueError naming the file.
The row unfilter is a C function (``csrc/png_unfilter.c``, built with the
host's ``cc`` at first use, ``io/native_build.py``): Sub, Average and
Paeth depend on the previous pixel and are too slow as a Python loop for
replay at the camera's rate.  ``write`` and ``encode`` emit filter 0 only
(tests, ``chip_smoke.py`` and the live viewer's renders).
"""
from __future__ import annotations

import ctypes
import functools
import struct
import zlib
from pathlib import Path

import numpy as np

from . import native_build

SIGNATURE = b"\x89PNG\r\n\x1a\n"
_SOURCE = Path(__file__).resolve().parent.parent / "csrc" / "png_unfilter.c"
_FLAGS = ("-O3", "-std=c99", "-fPIC", "-shared")
_CHANNELS = {0: 1, 2: 3, 6: 4}   # colour type -> samples per pixel


@functools.cache
def _unfilter():
    lib = native_build.load(_SOURCE, "cc", _FLAGS)
    fn = lib.png_unfilter
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _chunks(data: bytes, name: str):
    """(type, body) of each chunk up to IEND, CRCs checked."""
    if data[:8] != SIGNATURE:
        raise ValueError(f"{name}: not a PNG file")
    pos = 8
    while True:
        head = data[pos:pos + 8]
        if len(head) < 8:
            raise ValueError(f"{name}: truncated PNG (no IEND chunk)")
        n, kind = struct.unpack(">I4s", head)
        body = data[pos + 8:pos + 8 + n]
        crc = data[pos + 8 + n:pos + 12 + n]
        if len(body) != n or len(crc) != 4:
            raise ValueError(f"{name}: truncated PNG chunk {kind!r}")
        if zlib.crc32(kind + body) != struct.unpack(">I", crc)[0]:
            raise ValueError(f"{name}: CRC mismatch in PNG chunk {kind!r}")
        yield kind, body
        if kind == b"IEND":
            return
        pos += 12 + n


def decode(data: bytes, name: str = "<bytes>") -> np.ndarray:
    """A PNG file's bytes as a grey (H, W) uint8 or 16-bit (H, W) uint16
    image; ``name`` labels the errors."""
    ihdr, idat = None, []
    for kind, body in _chunks(data, name):
        if kind == b"IHDR":
            ihdr = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
    if ihdr is None:
        raise ValueError(f"{name}: PNG without an IHDR chunk")
    w, h, depth, ctype, comp, filt, interlace = ihdr
    if ctype == 3:
        raise ValueError(f"{name}: palette PNG (colour type 3) is not supported")
    if interlace:
        raise ValueError(f"{name}: interlaced (Adam7) PNG is not supported")
    if ctype not in _CHANNELS or (depth, ctype) not in ((8, 0), (8, 2), (8, 6), (16, 0)) \
            or comp or filt:
        raise ValueError(f"{name}: PNG of bit depth {depth}, colour type {ctype} is "
                         "not supported (8-bit grey, RGB, RGBA or 16-bit grey)")
    ch = _CHANNELS[ctype]
    bpp = ch * depth // 8
    stride = w * bpp
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size != h * (stride + 1):
        raise ValueError(f"{name}: PNG image data holds {raw.size} bytes, "
                         f"{h * (stride + 1)} expected")
    out = np.empty(h * stride, np.uint8)
    bad = _unfilter()(raw.ctypes.data, h, stride, bpp, out.ctypes.data)
    if bad:
        raise ValueError(f"{name}: PNG row {bad - 1} has an unknown filter type")
    if depth == 16:
        return out.view(">u2").reshape(h, w).astype(np.uint16)
    if ch == 1:
        return out.reshape(h, w)
    rgb = out.reshape(h, w, ch)[..., :3].astype(np.uint32)
    grey = 19595 * rgb[..., 0] + 38470 * rgb[..., 1] + 7471 * rgb[..., 2] + 0x8000
    return (grey >> 16).astype(np.uint8)


def read(path) -> np.ndarray:
    """The PNG at ``path``, as ``decode`` returns it."""
    return decode(Path(path).read_bytes(), str(path))


def _chunk(kind: bytes, body: bytes) -> bytes:
    return struct.pack(">I", len(body)) + kind + body + \
        struct.pack(">I", zlib.crc32(kind + body))


def encode(img, level: int = 6) -> bytes:
    """PNG bytes of a (H, W) uint8 or uint16 grey, or (H, W, 3 | 4) uint8
    RGB(A) image; every row filter 0."""
    a = np.ascontiguousarray(img)
    if a.dtype == np.uint16 and a.ndim == 2:
        depth, ctype, rows = 16, 0, a.astype(">u2").view(np.uint8)
    elif a.dtype == np.uint8 and a.ndim == 2:
        depth, ctype, rows = 8, 0, a
    elif a.dtype == np.uint8 and a.ndim == 3 and a.shape[2] in (3, 4):
        depth, ctype, rows = 8, 2 if a.shape[2] == 3 else 6, a
    else:
        raise ValueError(f"cannot encode a {a.dtype} image of shape {a.shape} as PNG")
    h, w = a.shape[:2]
    rows = rows.reshape(h, -1)
    filtered = np.concatenate([np.zeros((h, 1), np.uint8), rows], axis=1)
    return (SIGNATURE
            + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, ctype, 0, 0, 0))
            + _chunk(b"IDAT", zlib.compress(filtered.tobytes(), level))
            + _chunk(b"IEND", b""))


def write(path, img, level: int = 6) -> None:
    """Write ``img`` to ``path`` as ``encode`` does."""
    Path(path).write_bytes(encode(img, level))
