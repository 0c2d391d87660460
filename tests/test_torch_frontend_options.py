"""The front-end's reference-coordinate options and the helpers of the
JAX package's surface, the port against the JAX package on the CPU:

- ``OrbFrontend(quantize_level0_coords=True)`` (the reference's int cast
  of level-L keypoints) and ``OrbFrontend(subpixel=False)``: keypoint
  coordinates bit-equal to JAX's from the same pyramid, the integer slot
  fields equal, and descriptors exact on every valid slot against the JAX
  package's CPU path, and equal to the port's own with default options;
- ``hamming_pairs`` exact, and ``hamming_matrix(dtype=)`` exact in int16,
  bfloat16 and int32;
- ``se3_apply``, ``se3_matrix``, ``se3_from_matrix`` and ``se3_retract``
  within 1e-6;
- ``Frame.unproject_stereo`` equal to the batched form and to JAX's, None
  where a slot has no depth; ``Frame.from_arrays(response=)`` kept;
- options of the wrong type raise TypeError naming the option.
"""
import numpy as np
import pytest

pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from jetson_slam_tpu.config import CameraConfig as JaxCamera  # noqa: E402
from jetson_slam_tpu.core.frame import Frame as JaxFrame  # noqa: E402
from jetson_slam_tpu.io.synthetic import make_stereo_sequence  # noqa: E402
from jetson_slam_tpu.ops import hamming as jham  # noqa: E402
from jetson_slam_tpu.ops.frontend import OrbFrontend as JaxFrontend  # noqa: E402
from jetson_slam_tpu.utils import lie as jl  # noqa: E402
from jetson_slam_tpu_torch.config import CameraConfig  # noqa: E402
from jetson_slam_tpu_torch.core.frame import Frame  # noqa: E402
from jetson_slam_tpu_torch.ops import hamming as tham  # noqa: E402
from jetson_slam_tpu_torch.ops.frontend import OrbFrontend  # noqa: E402
from jetson_slam_tpu_torch.utils import lie as tl  # noqa: E402
from tests.test_torch_frontend import use_jax_pyramid  # noqa: E402

torch.set_num_threads(2)


@pytest.mark.parametrize("opts", [dict(quantize_level0_coords=True), dict(subpixel=False)],
                         ids=["quantize_level0_coords", "no_subpixel"])
def test_reference_coordinate_options_match_jax(opts):
    h, w = 240, 320
    seq = make_stereo_sequence(seed=11, n_frames=1, h=h, w=w, n_points=300)
    kw = dict(n_levels=4, scale_factor=1.2, threshold=20, tile_h=16, tile_w=16, **opts)
    jf = JaxFrontend(h, w, **kw)
    tf = OrbFrontend(h, w, device="cpu", **kw)
    assert tf.subpixel == jf.subpixel is False
    use_jax_pyramid(tf, jf)
    rj = jf.extract(seq.lefts[0])
    rt = tf.extract(seq.lefts[0])
    v = np.asarray(rj.valid)
    assert v.sum() > 100
    for f in ("valid", "response", "octave", "lx", "ly", "xs", "ys"):
        assert np.array_equal(np.asarray(getattr(rj, f)), getattr(rt, f).numpy()), f
    scale = tf.slot_scale.numpy()
    want = rt.lx.numpy().astype(np.float32) * scale
    if opts.get("quantize_level0_coords"):
        want = np.floor(want)
        assert np.array_equal(rt.xs.numpy(), np.floor(rt.xs.numpy()))
    assert np.array_equal(rt.xs.numpy(), want)
    assert np.array_equal(np.asarray(rj.desc)[v], rt.desc.numpy()[v])
    # the default keeps the parabola offsets: off the level grid somewhere
    ref = OrbFrontend(h, w, device="cpu", n_levels=4, scale_factor=1.2, threshold=20,
                      tile_h=16, tile_w=16)
    use_jax_pyramid(ref, jf)
    dflt = ref.extract(seq.lefts[0])
    assert not np.array_equal(dflt.xs.numpy()[v], rt.xs.numpy()[v])
    assert np.array_equal(dflt.desc.numpy(), rt.desc.numpy())


def test_hamming_pairs_and_matrix_dtypes_match_jax():
    rng = np.random.default_rng(4)
    a = rng.integers(0, 256, (257, 32), dtype=np.uint8)
    b = rng.integers(0, 256, (257, 32), dtype=np.uint8)
    b[:5] = a[:5]                       # distance 0
    b[5] = ~a[5]                        # distance 256
    want = np.asarray(jham.hamming_pairs(jnp.asarray(a), jnp.asarray(b)))
    got = tham.hamming_pairs(torch.as_tensor(a), torch.as_tensor(b))
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), want)
    assert want[5] == 256 and not want[:5].any()
    full = np.asarray(jham.hamming_matrix(jnp.asarray(a), jnp.asarray(b)))
    for tdt, jdt in ((torch.int32, jnp.int32), (torch.int16, jnp.int16),
                     (torch.bfloat16, jnp.bfloat16)):
        m = tham.hamming_matrix(torch.as_tensor(a), torch.as_tensor(b), dtype=tdt)
        assert m.dtype == tdt
        j = np.asarray(jham.hamming_matrix(jnp.asarray(a), jnp.asarray(b), dtype=jdt))
        assert np.array_equal(m.to(torch.int32).numpy(), j.astype(np.int32))
        assert np.array_equal(m.to(torch.int32).numpy(), full)
    with pytest.raises(TypeError, match="dtype"):
        tham.hamming_matrix(torch.as_tensor(a), torch.as_tensor(b), dtype="int32")


def test_se3_helpers_match_jax():
    rng = np.random.default_rng(8)
    xi0 = (rng.normal(size=(6, 4, 6)) * 0.7).astype(np.float32)
    xi0[0, 0] = 0.0                      # identity
    xi0[0, 1, 3:] = 1e-6                 # Taylor branch
    xi0[0, 2, 3:] = [3.05, 0.0, 0.0]     # rotation near pi
    xi = (rng.normal(size=(6, 4, 6)) * 0.3).astype(np.float32)
    p = rng.normal(size=(6, 4, 3)).astype(np.float32)
    Rj, tj = jl.exp_se3(jnp.asarray(xi0))
    Rt, tt = tl.exp_se3(torch.as_tensor(xi0))

    def close(a, b):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=1e-6, rtol=0)

    close(tl.se3_apply(Rt, tt, torch.as_tensor(p)), jl.se3_apply(Rj, tj, jnp.asarray(p)))
    Tt, Tj = tl.se3_matrix(Rt, tt), jl.se3_matrix(Rj, tj)
    assert Tt.shape == (6, 4, 4, 4)
    close(Tt, Tj)
    for a, b in zip(tl.se3_from_matrix(Tt), jl.se3_from_matrix(Tj)):
        close(a, b)
    for a, b in zip(tl.se3_retract(Rt, tt, torch.as_tensor(xi)),
                    jl.se3_retract(Rj, tj, jnp.asarray(xi))):
        close(a, b)
    R1, t1 = tl.se3_from_matrix(tl.se3_matrix(*tl.se3_retract(Rt, tt, torch.zeros(6, 4, 6))))
    close(R1, Rt)
    close(t1, tt)


def _camera(cls):
    cam = cls()
    cam.fx, cam.fy, cam.cx, cam.cy, cam.bf = 300.0, 298.0, 160.0, 120.0, 30.0
    cam.k1 = cam.k2 = cam.p1 = cam.p2 = cam.k3 = 0.0
    return cam


def test_unproject_stereo_and_response_match_jax():
    rng = np.random.default_rng(6)
    kw = dict(n_levels=3, scale_factor=1.2, threshold=20, tile_h=16, tile_w=16)
    tf = OrbFrontend(120, 160, device="cpu", **kw)
    jf = JaxFrontend(120, 160, **kw)
    S = tf.n_slots_padded
    valid = rng.random(S) < 0.8
    xs = rng.uniform(0, 160, S).astype(np.float32)
    ys = rng.uniform(0, 120, S).astype(np.float32)
    octave = rng.integers(0, 3, S).astype(np.int32)
    angle = rng.uniform(0, 360, S).astype(np.float32)
    response = rng.integers(0, 200, S).astype(np.int32)
    desc = rng.integers(0, 256, (S, 32), dtype=np.uint8)
    depth = rng.uniform(0.5, 20.0, S).astype(np.float32)
    depth[::4] = -1.0
    u_r = np.where(depth > 0, xs - 30.0 / np.maximum(depth, 1e-6), -1.0).astype(np.float32)
    T = np.eye(4, dtype=np.float32)
    R, t = tl.exp_se3(torch.tensor([0.3, -0.2, 0.5, 0.1, -0.05, 0.2]))
    T[:3, :3], T[:3, 3] = R.numpy(), t.numpy()
    fr = Frame.from_arrays(tf, _camera(CameraConfig), 0.0, valid, xs, ys, octave, angle,
                           desc, u_r, depth, response=response)
    jfr = JaxFrame.from_arrays(jf, _camera(JaxCamera), 0.0, valid, xs, ys, octave, angle,
                               response, desc, u_r, depth)
    fr.set_pose(T)
    jfr.set_pose(T)
    assert np.array_equal(fr.response, jfr.response)
    slots = np.arange(S)
    batch = fr.unproject_stereo_batch(slots)
    for s in slots:
        one, ref = fr.unproject_stereo(s), jfr.unproject_stereo(s)
        if depth[s] <= 0:
            assert one is None and ref is None
            continue
        assert np.array_equal(one, batch[s])
        np.testing.assert_allclose(one, ref, atol=1e-5, rtol=1e-6)
    default = Frame.from_arrays(tf, _camera(CameraConfig), 0.0, valid, xs, ys, octave,
                                angle, desc, u_r, depth)
    assert default.response.shape == (S,) and not default.response.any()


@pytest.mark.parametrize("kw,name", [
    (dict(quantize_level0_coords=1), "quantize_level0_coords"),
    (dict(subpixel="no"), "subpixel"),
])
def test_frontend_options_of_the_wrong_type_raise(kw, name):
    with pytest.raises(TypeError, match=name):
        OrbFrontend(120, 160, n_levels=2, tile_h=16, tile_w=16, device="cpu", **kw)
