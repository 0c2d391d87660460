"""The port's dataset I/O against Pillow and the JAX package on the CPU:

- ``io/png.py`` bit-equal to Pillow's ``convert("L")`` for 8-bit grey,
  RGB and RGBA and to Pillow's values for 16-bit grey, on files Pillow
  saved (optimize on and off) and on rows filtered by hand with each of
  the five filter types; palette and interlaced files raise; Pillow reads
  back what the port writes;
- the 16-bit TUM depth round-trips exactly through ``io.datasets.imread``,
  where the JAX package's ``imread_gray`` returns at most 255 (its fault,
  documented here, not fixed there);
- the six loaders give the JAX package's entries on the same trees;
- ``io/rectify.py`` bit-equal to the JAX package's maps and remaps;
- the native loader, built from ``native/loader.cpp``: its FAST LUT equals
  ``ops/tables.fast_lut``, its prefetch reads PGM and raw columns, and
  ``ImageSource`` dispatches by format;
- checkpoints: a map saved by either package loads in the other with
  equal tables and observation index (``kf_seq`` derived for a JAX map),
  and the keyframe free list is rebuilt on load;
- ``config.save_config`` round-trips every example config.
"""
import dataclasses
import io
import os
import struct
import zlib

import numpy as np
import pytest

pytest.importorskip("jax")
from PIL import Image  # noqa: E402

from jetson_slam_tpu.config import load_config as jax_load_config  # noqa: E402
from jetson_slam_tpu.core.map import MapStore as JaxMap  # noqa: E402
from jetson_slam_tpu.io import checkpoint as jckpt  # noqa: E402
from jetson_slam_tpu.io import datasets as jdatasets  # noqa: E402
from jetson_slam_tpu.io import rectify as jrect  # noqa: E402
from jetson_slam_tpu_torch.config import load_config, save_config  # noqa: E402
from jetson_slam_tpu_torch.core.map import MapStore  # noqa: E402
from jetson_slam_tpu_torch.io import checkpoint, datasets, png, rectify  # noqa: E402
from jetson_slam_tpu_torch.io.native_loader import PrefetchLoader, fast_lut_native  # noqa: E402
from jetson_slam_tpu_torch.ops.tables import fast_lut  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = os.path.join(REPO, "examples", "configs")

# kind -> (colour type, bit depth, bytes per pixel)
KINDS = {"grey8": (0, 8, 1), "rgb": (2, 8, 3), "rgba": (6, 8, 4), "grey16": (0, 16, 2)}


def _image(kind, seed=0, h=37, w=53):
    """A random image with smooth parts (so the filters matter) of a kind."""
    rng = np.random.default_rng(seed)
    ramp = np.add.outer(np.arange(h), np.arange(w))
    if kind == "grey16":
        return (ramp * 400 + rng.integers(0, 300, (h, w))).astype(np.uint16)
    ch = KINDS[kind][2]
    img = (ramp[..., None] * (1 + np.arange(ch)) + rng.integers(0, 40, (h, w, ch))) % 256
    return img[..., 0].astype(np.uint8) if ch == 1 else img.astype(np.uint8)


def _pillow_grey(data: bytes) -> np.ndarray:
    im = Image.open(io.BytesIO(data))
    if im.mode in ("I;16", "I;16B", "I"):
        return np.asarray(im).astype(np.uint16)
    return np.asarray(im.convert("L"))


def _raw_bytes(img, kind) -> np.ndarray:
    """(h, stride) rows of samples as the PNG stores them."""
    if kind == "grey16":
        return img.astype(">u2").view(np.uint8).reshape(img.shape[0], -1)
    return img.reshape(img.shape[0], -1)


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _filter_rows(raw, bpp, types):
    """PNG rows filtered with types[y] (PNG specification, section 9)."""
    out = []
    prev = np.zeros(raw.shape[1], np.int32)
    for y, ft in enumerate(types):
        x = raw[y].astype(np.int32)
        a = np.concatenate([np.zeros(bpp, np.int32), x[:-bpp]])
        c = np.concatenate([np.zeros(bpp, np.int32), prev[:-bpp]])
        pred = [0 * x, a, prev, (a + prev) // 2, _paeth(a, prev, c)][ft]
        out.append(np.concatenate([[ft], (x - pred) % 256]).astype(np.uint8))
        prev = x
    return np.stack(out)


def _png(kind, h, w, idat: bytes, interlace=0, depth=None) -> bytes:
    ct, bd, _ = KINDS[kind]
    ihdr = struct.pack(">IIBBBBB", w, h, depth or bd, ct, 0, 0, interlace)
    return png.SIGNATURE + png._chunk(b"IHDR", ihdr) + png._chunk(b"IDAT", idat) + \
        png._chunk(b"IEND", b"")


@pytest.mark.parametrize("optimize", [False, True])
@pytest.mark.parametrize("kind", list(KINDS))
def test_png_reads_pillow_files_as_pillow_does(kind, optimize):
    img = _image(kind)
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, format="PNG", optimize=optimize)
    want = _pillow_grey(buf.getvalue())
    got = png.decode(buf.getvalue())
    assert got.dtype == want.dtype == (np.uint16 if kind == "grey16" else np.uint8)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("filt", [0, 1, 2, 3, 4, "mixed"])
@pytest.mark.parametrize("kind", list(KINDS))
def test_png_unfilters_every_filter_type(kind, filt):
    """Rows filtered by hand with one filter type (or each row a different
    one): the port decodes them to the image and to what Pillow reads."""
    img = _image(kind, seed=1)
    raw = _raw_bytes(img, kind)
    types = [y % 5 for y in range(len(raw))] if filt == "mixed" else [filt] * len(raw)
    data = _png(kind, img.shape[0], img.shape[1],
                zlib.compress(_filter_rows(raw, KINDS[kind][2], types).tobytes()))
    got = png.decode(data)
    np.testing.assert_array_equal(got, _pillow_grey(data))
    if kind in ("grey8", "grey16"):
        np.testing.assert_array_equal(got, img)


def test_png_rejects_what_it_does_not_read(tmp_path):
    """Palette and interlaced files, an unknown filter type and a bad CRC
    raise ValueError naming the file."""
    p = tmp_path / "palette.png"
    Image.fromarray(_image("grey8")).convert("P").save(p)
    with pytest.raises(ValueError, match="palette.png.*palette"):
        png.read(p)
    raw = _raw_bytes(_image("grey8"), "grey8")
    rows = zlib.compress(_filter_rows(raw, 1, [0] * len(raw)).tobytes())
    p = tmp_path / "interlaced.png"
    p.write_bytes(_png("grey8", *raw.shape, rows, interlace=1))
    with pytest.raises(ValueError, match="interlaced.png.*interlaced"):
        png.read(p)
    bad = _filter_rows(raw, 1, [0] * len(raw))
    bad[3, 0] = 7
    with pytest.raises(ValueError, match="row 3 has an unknown filter"):
        png.decode(_png("grey8", *raw.shape, zlib.compress(bad.tobytes())))
    with pytest.raises(ValueError, match="bit depth 16, colour type 2"):
        png.decode(_png("rgb", *raw.shape, rows, depth=16))
    data = bytearray(png.encode(_image("grey8")))
    data[-20] ^= 1
    with pytest.raises(ValueError, match="CRC"):
        png.decode(bytes(data), "x.png")


@pytest.mark.parametrize("kind", list(KINDS))
def test_png_writes_what_pillow_reads(kind, tmp_path):
    img = _image(kind, seed=2)
    p = tmp_path / "out.png"
    png.write(p, img)
    got = np.asarray(Image.open(p))
    np.testing.assert_array_equal(got.astype(img.dtype), img)
    if kind != "grey16":
        np.testing.assert_array_equal(png.read(p), _pillow_grey(p.read_bytes()))


def test_tum_depth_keeps_16_bits(tmp_path):
    """A TUM depth PNG (16-bit, DepthMapFactor 5000) reads back exactly in
    the port.  The JAX package's imread_gray converts it to 8 bits (max
    255, so every depth <= 0.051 m): its fault, left as it is there."""
    ramp = np.linspace(0, 28665, 48 * 64).reshape(48, 64).astype(np.uint16)
    p = str(tmp_path / "depth.png")
    Image.fromarray(ramp).save(p)
    got = datasets.imread(p)
    assert got.dtype == np.uint16
    np.testing.assert_array_equal(got, ramp)
    assert (got.astype(np.float32) / 5000.0).max() == pytest.approx(28665 / 5000.0)
    assert jdatasets.imread_gray(p).max() <= 255
    with pytest.raises(ValueError, match="not 8-bit grey"):
        datasets.imread_gray(p)


def test_imread_formats(tmp_path):
    """imread: .npy as saved, 8- and 16-bit binary PGM, PNG; other
    extensions raise."""
    rng = np.random.default_rng(4)
    g8 = rng.integers(0, 256, (9, 13), np.uint8)
    g16 = rng.integers(0, 65536, (9, 13)).astype(np.uint16)
    np.save(tmp_path / "a.npy", g8)
    (tmp_path / "a.pgm").write_bytes(b"P5\n# c\n13 9\n255\n" + g8.tobytes())
    (tmp_path / "b.pgm").write_bytes(b"P5 13 9 65535\n" + g16.astype(">u2").tobytes())
    png.write(tmp_path / "a.png", g8)
    for name, want in (("a.npy", g8), ("a.pgm", g8), ("b.pgm", g16), ("a.png", g8)):
        got = datasets.imread(str(tmp_path / name))
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError, match="unsupported image format"):
        datasets.imread(str(tmp_path / "a.jpg"))


def test_loaders_match_jax(tmp_path):
    """The six loaders give the JAX package's entries on the same trees."""
    for cam in ("cam0", "cam1"):
        d = tmp_path / "euroc" / "mav0" / cam / "data"
        d.mkdir(parents=True)
        for ns in (1403636579763555584, 1403636579813555456, 1403636579863555584):
            if not (cam == "cam1" and ns == 1403636579863555584):   # a missing right
                (d / f"{ns}.png").write_bytes(b"")
    for name in ("kitti", "tum"):
        (tmp_path / name / "image_0").mkdir(parents=True)
    (tmp_path / "kitti" / "times.txt").write_text("0.0\n1.036e-01\n2.072e-01\n")
    (tmp_path / "tum" / "rgb.txt").write_text("# rgb\n1305031102.175304 rgb/a.png\n"
                                              "1305031102.211214 rgb/b.png x\n")
    assoc = tmp_path / "assoc.txt"
    assoc.write_text("# t rgb t depth\n1305031102.175304 rgb/a.png 1305031102.160407 "
                     "depth/a.png\n\n1305031102.211214 rgb/b.png 1305031102.226738 "
                     "depth/b.png\n")
    calls = [("load_euroc_stereo", (tmp_path / "euroc",)),
             ("load_euroc_mono", (tmp_path / "euroc",)),
             ("load_kitti_stereo", (tmp_path / "kitti",)),
             ("load_kitti_mono", (tmp_path / "kitti",)),
             ("load_tum_mono", (tmp_path / "tum",)),
             ("load_tum_rgbd", (tmp_path / "tum", assoc))]
    for name, args in calls:
        args = [str(a) for a in args]
        want = getattr(jdatasets, name)(*args)
        assert want, name
        assert getattr(datasets, name)(*args) == want, name


def _rect_cases():
    K = np.array([[100.0, 0, 80], [0, 100.0, 60], [0, 0, 1]])
    shift = K.copy()
    shift[0, 2] += 10
    c, s = np.cos(0.02), np.sin(0.02)
    R = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])
    P = np.hstack([K * [[1.02], [1.02], [1]], [[-11.0], [0], [0]]])
    return {"identity": (K, None, np.eye(3), K),
            "shift": (K, None, np.eye(3), shift),
            "radtan_R": (K, np.array([-0.28, 0.07, 1e-4, 1e-5, 0.01]), R, P)}


@pytest.mark.parametrize("case", ["identity", "shift", "radtan_R"])
def test_rectify_bit_equal_to_jax(case):
    K, D, R, P = _rect_cases()[case]
    maps = rectify.init_undistort_rectify_map(K, D, R, P, (120, 160))
    want = jrect.init_undistort_rectify_map(K, D, R, P, (120, 160))
    for a, b in zip(maps, want):
        assert a.dtype == b.dtype == np.float32
        np.testing.assert_array_equal(a, b)
    img = np.random.default_rng(5).integers(0, 256, (120, 160), np.uint8)
    np.testing.assert_array_equal(rectify.remap_bilinear(img, *maps),
                                  jrect.remap_bilinear(img, *want))


def test_stereo_rectifier_on_the_euroc_config_matches_jax():
    """The LEFT.*/RIGHT.* blocks of examples/configs/EuRoC_stereo.yaml, read
    by each package's load_config, rectify to the same bytes; without the
    blocks the images pass through."""
    path = os.path.join(CONFIGS, "EuRoC_stereo.yaml")
    cfg = load_config(path)
    assert cfg.left_rect["height"] == 480 and cfg.left_rect["width"] == 752
    rect, jr = rectify.StereoRectifier(cfg), jrect.StereoRectifier(jax_load_config(path))
    assert rect.enabled
    rng = np.random.default_rng(1)
    left, right = (rng.integers(0, 256, (480, 752), np.uint8) for _ in range(2))
    for a, b in zip(rect.rectify(left, right), jr.rectify(left, right)):
        assert a.dtype == np.uint8 and a.any()
        np.testing.assert_array_equal(a, b)
    plain = rectify.StereoRectifier(load_config(os.path.join(CONFIGS, "KITTI00-02_stereo.yaml")))
    assert not plain.enabled and plain.rectify(left, right)[0] is left


@pytest.mark.parametrize("n_min,n_max", [(9, 16), (9, 14), (12, 16)])
def test_native_fast_lut_matches_tables(n_min, n_max):
    np.testing.assert_array_equal(fast_lut_native(n_min, n_max), fast_lut(n_min, n_max))


def _pgm_column(tmp_path, n=6, h=24, w=32):
    rng = np.random.default_rng(6)
    frames = [rng.integers(0, 256, (h, w), np.uint8) for _ in range(n)]
    paths = []
    for i, f in enumerate(frames):
        p = tmp_path / f"f{i}.pgm"
        p.write_bytes(b"P5\n# test\n%d %d\n255\n" % (w, h) + f.tobytes())
        paths.append(str(p))
    return frames, paths


def test_prefetch_loader_reads_pgm_and_raw_forward(tmp_path):
    frames, paths = _pgm_column(tmp_path)
    with PrefetchLoader(paths, n_threads=2, capacity=3) as loader:
        for i in (0, 1, 2, 4, 5):          # skipping a frame is allowed
            np.testing.assert_array_equal(loader.get(i), frames[i])
        with pytest.raises(IndexError, match="forward only"):
            loader.get(2)
    raws = []
    for i, f in enumerate(frames):
        p = tmp_path / f"r{i}.raw"
        p.write_bytes(f.tobytes())
        raws.append(str(p))
    with PrefetchLoader(raws, height=24, width=32) as loader:
        for i, f in enumerate(frames):
            np.testing.assert_array_equal(loader.get(i), f)
    with pytest.raises(ValueError, match="height and width"):
        PrefetchLoader(raws)
    with pytest.raises(ValueError, match="reads"):
        PrefetchLoader([str(tmp_path / "x.npy")])
    (tmp_path / "bad.pgm").write_bytes(b"P2\n2 2\n255\n0 0 0 0\n")
    (tmp_path / "deep.pgm").write_bytes(b"P5\n2 2\n65535\n" + bytes(8))
    for name, match in (("bad.pgm", "not a binary PGM"), ("deep.pgm", "16-bit PGM")):
        with PrefetchLoader([str(tmp_path / name)]) as loader, \
                pytest.raises(ValueError, match=match):
            loader.get(0)


def test_image_source_dispatches_by_format(tmp_path):
    """A PGM column rides the native ring buffer, PNG and .npy columns the
    thread pool (out-of-order reads included); every frame exact."""
    frames, pgm = _pgm_column(tmp_path)
    pngs, npys = [], []
    for i, f in enumerate(frames):
        pngs.append(str(tmp_path / f"f{i}.png"))
        png.write(pngs[-1], f)
        npys.append(str(tmp_path / f"f{i}.npy"))
        np.save(npys[-1], f)
    with datasets.ImageSource(pgm) as src:
        assert src._native is not None
        for i, f in enumerate(frames):
            np.testing.assert_array_equal(src.get(i), f)
        assert len(src.wait_ms) == len(frames)
    for paths in (pngs, npys):
        with datasets.ImageSource(paths, ahead=3) as src:
            assert src._native is None
            for i in (0, 1, 2, 5, 3, 4):
                np.testing.assert_array_equal(src.get(i), frames[i])
            assert len(src.decode_ms) == 6


class _Frame:
    """What MapStore.add_keyframe reads of a Frame."""

    def __init__(self, frame_id, S=16, seed=0):
        rng = np.random.default_rng(seed)
        self.timestamp = 0.1 * frame_id
        self.frame_id = frame_id
        self.Tcw = np.eye(4, dtype=np.float32)
        self.Tcw[:3, 3] = rng.normal(size=3)
        self.kp_xy = rng.uniform(0, 100, (S, 2)).astype(np.float32)
        self.octave = rng.integers(0, 3, S).astype(np.int32)
        self.angle = rng.uniform(0, 360, S).astype(np.float32)
        self.u_right = np.full(S, -1.0, np.float32)
        self.depth = rng.uniform(1, 5, S).astype(np.float32)
        self.desc = rng.integers(0, 256, (S, 32)).astype(np.uint8)
        self.valid = np.ones(S, bool)
        self.map_points = np.full(S, -1, np.int32)


def _build_map(cls, max_keyframes=8):
    """Four keyframes (rows 0..3) sharing points, a loop edge, row 2
    erased; the same calls on either package's MapStore."""
    m = cls(max_points=64, max_keyframes=max_keyframes, n_slots=16)
    kids = [m.add_keyframe(_Frame(fid, seed=fid)) for fid in (3, 9, 14, 20)]
    rng = np.random.default_rng(7)
    for i in range(12):
        pid = m.add_point(rng.normal(size=3).astype(np.float32) + [0, 0, 5],
                          np.full(32, i, np.uint8), ref_kf=kids[i % 4])
        for k in kids:
            if (i + k) % 3:
                m.add_observation(k, i, pid)
    m.kf_parent[kids[1:]] = kids[:-1]
    m.add_loop_edge(kids[0], kids[3])
    m.erase_keyframe(kids[2])
    return m


def _assert_maps_equal(a, b):
    for name in checkpoint._ARRAYS:
        np.testing.assert_array_equal(getattr(a, name), getattr(b, name), err_msg=name)
    assert a._pt_obs == b._pt_obs and a.loop_edges == b.loop_edges
    assert (a._next_pt, a._next_kf) == (b._next_pt, b._next_kf)


def test_checkpoint_crosses_packages(tmp_path):
    """A map saved by the JAX package loads in the port (kf_seq the rank of
    each live keyframe's frame id) and one saved by the port loads in the
    JAX package: equal tables and observation index both ways."""
    jm, tm = _build_map(JaxMap), _build_map(MapStore)
    assert tm.kf_seq[[0, 1, 3]].tolist() == [0, 1, 3]
    jckpt.save_map(jm, str(tmp_path / "jax.npz"))
    checkpoint.save_map(tm, str(tmp_path / "port.npz"))
    from_jax = checkpoint.load_map(str(tmp_path / "jax.npz"))
    _assert_maps_equal(from_jax, jm)
    assert from_jax.kf_seq[[0, 1, 3]].tolist() == [0, 1, 2] and from_jax._next_kf_seq == 3
    from_port = jckpt.load_map(str(tmp_path / "port.npz"))
    _assert_maps_equal(from_port, tm)
    again = checkpoint.load_map(str(tmp_path / "port.npz"))
    _assert_maps_equal(again, tm)
    np.testing.assert_array_equal(again.kf_seq, tm.kf_seq)
    assert again._next_kf_seq == tm._next_kf_seq == 4


def test_checkpoint_restores_the_keyframe_free_list(tmp_path):
    """The erased row comes back on the free list, so a loaded map at full
    capacity still takes a keyframe, in that row.  The JAX package's load
    leaves the list empty (its fault): no capacity left there."""
    for cls, save in ((MapStore, checkpoint.save_map), (JaxMap, jckpt.save_map)):
        m = _build_map(cls, max_keyframes=4)
        assert m._kf_free == [2] and m.kf_capacity_left()
        save(m, str(tmp_path / "m.npz"))
        loaded = checkpoint.load_map(str(tmp_path / "m.npz"))
        assert loaded._kf_free == [2] and loaded.kf_capacity_left()
        assert loaded.add_keyframe(_Frame(30)) == 2
        assert not jckpt.load_map(str(tmp_path / "m.npz")).kf_capacity_left()


@pytest.mark.parametrize("name", sorted(os.listdir(CONFIGS)))
def test_save_config_round_trips(name, tmp_path):
    """save_config writes every key load_config reads and the LEFT/RIGHT
    blocks: each example config (with a mask path) comes back equal."""
    cfg = load_config(os.path.join(CONFIGS, name))
    cfg.orb.mask_left = str(tmp_path / "a mask.png")
    save_config(cfg, str(tmp_path / "c.yaml"))
    back = load_config(str(tmp_path / "c.yaml"))
    want, got = dataclasses.asdict(cfg), dataclasses.asdict(back)
    rects = [(want.pop(k), got.pop(k)) for k in ("left_rect", "right_rect")]
    assert got == want
    for w, g in rects:
        assert (w is None) == (g is None)
        for k in (w or {}):
            np.testing.assert_array_equal(g[k], w[k])
