"""The port's ORB front-end against the JAX package on the CPU.

Kernel 1's plain version (FAST score + NMS-L) must be bit-exact and the
pyramid must be the exact resize; from the same pyramid, the extractor must
give the same slots, coordinates within 1e-5, angles within 1e-3 degrees
and descriptors within the drift bound of tests/test_pallas_frontend.py
(mean Hamming <= 6 bits, >= 60 % within 8 bits), with at least 95 % of
them identical.
"""
import numpy as np
import pytest

pytest.importorskip("jax")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from jetson_slam_tpu.io.synthetic import make_stereo_sequence  # noqa: E402
from jetson_slam_tpu.ops.frontend import OrbFrontend as JaxFrontend  # noqa: E402
from jetson_slam_tpu.ops.frontend import fast_score_map  # noqa: E402
from jetson_slam_tpu.ops.pallas_frontend import fast_score_nms_pallas  # noqa: E402
from jetson_slam_tpu.ops.tables import BORDER_SKIP, fast_lut  # noqa: E402
from jetson_slam_tpu_torch.convert import frontend_tables_from_numpy  # noqa: E402
from jetson_slam_tpu_torch.ops import tables as torch_tables  # noqa: E402
from jetson_slam_tpu_torch.ops.cuda_frontend import (TILE, fast_nms,  # noqa: E402
                                                     fast_nms_plain, lut_bits)
from jetson_slam_tpu_torch.ops.frontend import OrbFrontend  # noqa: E402

torch.set_num_threads(2)

SIZES = [(120, 160), (100, 133), (83, 111)]   # test_pallas_frontend.py:28-50


def _stack(rng):
    stack = np.zeros((len(SIZES), 120, 160), np.uint8)
    for i, (h, w) in enumerate(SIZES):
        stack[i, :h, :w] = rng.integers(0, 256, (h, w), np.uint8)
    roi = np.array([[BORDER_SKIP, h - BORDER_SKIP, BORDER_SKIP, w - BORDER_SKIP]
                    for h, w in SIZES], np.int32)
    mask = np.zeros((len(SIZES), 120, 160), np.uint8)
    for i, (h, w) in enumerate(SIZES):
        mask[i, 20:h - 15, 30:w - 25] = 1
    return stack, roi, mask


@pytest.mark.parametrize("n_min,n_max", [(9, 16), (9, 14), (9, 12)])
def test_fast_nms_plain_matches_pallas_and_score_map(n_min, n_max):
    stack, roi, mask = _stack(np.random.default_rng(3 + n_max))
    lut = fast_lut(n_min, n_max)
    for m in (None, mask):
        raw_t, nms_t = fast_nms(
            torch.as_tensor(stack), torch.as_tensor(roi),
            torch.as_tensor(lut.astype(np.uint8)), 20,
            None if m is None else torch.as_tensor(m))
        raw_t, nms_t = raw_t.numpy(), nms_t.numpy()
        raw_p, nms_p = fast_score_nms_pallas(
            jnp.asarray(stack), jnp.asarray(roi), 20, n_min, n_max,
            mask_u8=None if m is None else jnp.asarray(m), interpret=True)
        assert np.array_equal(raw_t, np.asarray(raw_p))
        assert np.array_equal(nms_t, np.asarray(nms_p))
        for i, (h, w) in enumerate(SIZES):
            score = np.asarray(fast_score_map(
                jnp.asarray(stack[i, :h, :w]), jnp.asarray(lut.astype(np.int32)),
                20, None if m is None else jnp.asarray(m[i, :h, :w].astype(np.int32))))
            assert np.array_equal(raw_t[i, :h, :w], score)
            assert not raw_t[i, h:].any() and not raw_t[i, :, w:].any()
            neigh = [np.roll(score, (-dy, -dx), axis=(0, 1))
                     for dy in (-1, 0, 1) for dx in (-1, 0, 1) if (dy, dx) != (0, 0)]
            ref = np.where(score >= np.max(np.stack(neigh), axis=0), score, 0)
            assert np.array_equal(nms_t[i, :h, :w], ref)
        assert (raw_t > 0).sum() > 100


@pytest.mark.parametrize("n_min,n_max", [(9, 16), (9, 14), (9, 12)])
def test_lut_bits_packs_fast_lut(n_min, n_max):
    """The bitset the FAST kernel stages gives back fast_lut(n_min, n_max)
    bit for bit: bit m & 31 of word m >> 5 is lut[m]."""
    lut = torch_tables.fast_lut(n_min, n_max)
    assert np.array_equal(lut, fast_lut(n_min, n_max))
    lut_t = torch.as_tensor(lut.astype(np.uint8))
    bits = lut_bits(lut_t)
    assert bits.dtype == torch.int32 and bits.shape == (2048,)
    words = bits.numpy().view(np.uint32)
    m = np.arange(1 << 16)
    assert np.array_equal((words[m >> 5] >> (m & 31)) & 1, lut)
    assert lut_bits(lut_t) is bits                  # packed once, cached
    lut_t[0] = 1                                    # an in-place edit repacks
    assert int(lut_bits(lut_t)[0]) & 1 == 1


@pytest.mark.parametrize("masked", [False, True])
def test_fast_nms_plain_zero_on_tiles_outside_roi(masked):
    """raw == nms == 0 on every TILE x TILE tile that lies wholly outside its
    canvas's ROI, whatever the canvas holds around it: the invariant the
    FAST kernel's zero-only tiles rely on."""
    h, w, levels = 240, 320, 4
    tf = OrbFrontend(h, w, n_levels=levels, scale_factor=1.2, threshold=20,
                     tile_h=16, tile_w=16, device="cpu")
    seq = make_stereo_sequence(seed=5, n_frames=1, h=h, w=w, n_points=300)
    pyr = tf.pyramid(torch.as_tensor(np.stack([seq.lefts[0], seq.rights[0]])))
    rng = np.random.default_rng(2)
    rand = torch.as_tensor(rng.integers(0, 256, (2 * levels, h, w), dtype=np.uint8))
    mask = (torch.as_tensor((rng.random((levels, h, w)) < 0.7).astype(np.uint8))
            if masked else None)
    roi = tf.roi.numpy()
    for stack in (pyr.reshape(2 * levels, h, w), rand):
        raw, nms = fast_nms_plain(stack, tf.roi, tf.lut, 20, mask)
        n_zero = n_tiles = 0
        for n in range(stack.shape[0]):
            ylo, yhi, xlo, xhi = roi[n % levels]
            for y0 in range(0, h, TILE):
                for x0 in range(0, w, TILE):
                    n_tiles += 1
                    if y0 >= yhi or y0 + TILE <= ylo or x0 >= xhi or x0 + TILE <= xlo:
                        n_zero += 1
                        assert not raw[n, y0:y0 + TILE, x0:x0 + TILE].any()
                        assert not nms[n, y0:y0 + TILE, x0:x0 + TILE].any()
        assert n_zero >= n_tiles // 4 and int((nms > 0).sum()) > 100
    print(f"{n_zero} of {n_tiles} tiles lie wholly outside the ROI")


def use_jax_pyramid(tf, jf):
    """Make the port's front-end read the JAX package's pyramid, so that
    what follows the pyramid is compared on the same canvases.  The two
    pyramids differ only where the reference's f32 rounding floors a pixel
    next to an integer the other way (test_pyramid_bit_exact)."""
    pyr = jax.jit(lambda x: jf._pyramid_batch(jf._tables, x))

    def pyramid(imgs_u8):
        levels = pyr(jnp.asarray(imgs_u8.numpy()))
        out = torch.zeros((imgs_u8.shape[0], len(levels)) + tuple(imgs_u8.shape[1:]),
                          dtype=torch.uint8)
        for i, lv in enumerate(levels):
            out[:, i, :lv.shape[1], :lv.shape[2]] = torch.as_tensor(np.asarray(lv))
        return out

    tf.pyramid = pyramid


# at EuRoC geometry, the first frame pair of chip_smoke.py's sequence
PYRAMID_SEQ = {(480, 752): dict(seed=7, fx=435.2047, baseline=0.110076,
                                trajectory="arc", n_points=900)}


@pytest.mark.parametrize("h,w,levels", [(120, 160, 3), (240, 320, 4), (480, 752, 8)])
def test_pyramid_bit_exact(h, w, levels):
    """The port's pyramid is the exact resize: bit-equal to the float64
    resize with the reference's float32 weights.  The JAX package's f32
    matmul pair differs from it only by one grey level, on a few pixels
    whose exact value lies within 1e-4 of an integer."""
    seq = make_stereo_sequence(n_frames=1, h=h, w=w,
                               **PYRAMID_SEQ.get((h, w), dict(seed=5, n_points=300)))
    rng = np.random.default_rng(1)
    imgs = np.stack([seq.lefts[0], seq.rights[0],
                     rng.integers(0, 256, (h, w), np.uint8)])
    jf = JaxFrontend(h, w, n_levels=levels, scale_factor=1.2, tile_h=16, tile_w=16)
    tf = OrbFrontend(h, w, n_levels=levels, scale_factor=1.2, tile_h=16,
                     tile_w=16, device="cpu")
    ref = jax.jit(lambda x: jf._pyramid_batch(jf._tables, x))(jnp.asarray(imgs))
    got = tf.pyramid(torch.as_tensor(imgs)).numpy()
    g = jf.geom
    n_flips = n_pix = n_flips_pair = 0
    for i in range(levels):
        lv = got[:, i, :g.heights[i], :g.widths[i]]
        assert not got[:, i, g.heights[i]:].any()
        assert not got[:, i, :, g.widths[i]:].any()
        if i == 0:
            assert np.array_equal(lv, imgs)
            continue
        wy = np.asarray(jf._tables["wy"][i - 1], np.float64)
        wx = np.asarray(jf._tables["wx"][i - 1], np.float64)
        exact = np.einsum("oh,bhx->box", wy,
                          np.einsum("bhw,xw->bhx", imgs.astype(np.float64), wx))
        assert np.array_equal(lv, np.floor(exact).astype(np.uint8)), f"level {i}"
        flip = lv != np.asarray(ref[i])
        assert (np.abs(lv[flip].astype(np.int32)
                       - np.asarray(ref[i])[flip].astype(np.int32)) == 1).all()
        assert (np.abs(exact[flip] - np.round(exact[flip])) <= 1e-4).all(), f"level {i}"
        n_flips += int(flip.sum())
        n_flips_pair += int(flip[:2].sum())
        n_pix += lv.size
    print(f"{h}x{w}x{levels}: {n_flips} of {n_pix} level pixels differ from the "
          f"JAX package's f32 pyramid, {n_flips_pair} of them on the frame pair")
    assert n_flips <= 1e-3 * n_pix


def test_tables_from_numpy_equal_port_tables():
    kw = dict(n_levels=3, scale_factor=1.2, threshold=20, tile_h=12, tile_w=12,
              fast_n_max=14)
    jf = JaxFrontend(120, 160, **kw)
    tf = OrbFrontend(120, 160, device="cpu", **kw)
    d = {k: ([np.asarray(x) for x in v] if isinstance(v, tuple) else np.asarray(v))
         for k, v in jf._tables.items()}
    conv = frontend_tables_from_numpy(d, device="cpu")
    assert set(conv) >= {"lut", "roi", "slot_level", "slot_scale", "ic_masks",
                         "pattern", "ylo1", "xwhi2"}
    for k, v in conv.items():
        mine = getattr(tf, k)
        assert v.dtype == mine.dtype and torch.equal(v, mine), k


EXTRACT_CASES = [
    # (h, w, levels, tile, masked, nms_ms)
    (120, 160, 3, 12, False, False),
    (120, 160, 3, 12, True, False),
    (120, 160, 3, 12, False, True),
    (120, 160, 3, 12, True, True),
    (240, 320, 4, 16, False, False),
]


@pytest.mark.parametrize("h,w,levels,tile,masked,nms_ms", EXTRACT_CASES)
def test_extract_matches_jax(h, w, levels, tile, masked, nms_ms):
    seq = make_stereo_sequence(seed=11, n_frames=1, h=h, w=w, n_points=300)
    mask = None
    if masked:
        mask = np.zeros((h, w), np.uint8)
        mask[10:h - 10, 20:w - 20] = 255
    kw = dict(n_levels=levels, scale_factor=1.2, threshold=20, tile_h=tile,
              tile_w=tile, apply_nms_ms=nms_ms, mask=mask)
    jf = JaxFrontend(h, w, **kw)
    tf = OrbFrontend(h, w, device="cpu", **kw)
    use_jax_pyramid(tf, jf)
    rj = jf.extract(seq.lefts[0])
    rt = tf.extract(seq.lefts[0])
    v = np.asarray(rj.valid)
    assert v.sum() > 20
    for f in ("valid", "response", "octave", "lx", "ly"):
        assert np.array_equal(np.asarray(getattr(rj, f)), getattr(rt, f).numpy()), f
    for f in ("xs", "ys"):
        np.testing.assert_allclose(getattr(rt, f).numpy(), np.asarray(getattr(rj, f)),
                                   atol=1e-5, rtol=0)
    np.testing.assert_allclose(rt.angle.numpy()[v], np.asarray(rj.angle)[v],
                               atol=1e-3, rtol=0)
    ham = np.unpackbits(np.asarray(rj.desc)[v] ^ rt.desc.numpy()[v], axis=1).sum(1)
    assert ham.mean() <= 6.0 and (ham <= 8).mean() >= 0.6
    print(f"exact desc fraction {(ham == 0).mean():.6f} over {int(v.sum())} valid slots")
    assert (ham == 0).mean() >= 0.95, (ham == 0).mean()
    assert not rt.desc.numpy()[~v].any()   # invalid slots hold zeros
