"""The port's batched stereo front end (``OrbFrontend.frame_step_batch``)
on the CPU.

- B = 4 frames at 120x160 (3 levels, tile 12) equal four ``frame_step``
  calls, every field of both eyes and u_right, depth and best_dist bit for
  bit;
- each kernel wrapper is called once per batch, at the batch shapes: FAST +
  NMS-L over 2B x L canvases, the descriptor over 2B images, the stereo
  costs over B frames;
- against the JAX package's ``frame_step_batch``, the port fed the JAX
  pyramid as tests/test_torch_stereo.py::test_frame_step_matches_jax does:
  u_right and depth within 1e-4, best_dist identical.
"""
import numpy as np
import pytest

pytest.importorskip("jax")
import torch  # noqa: E402

from jetson_slam_tpu.ops.frontend import OrbFrontend as JaxFrontend  # noqa: E402
from jetson_slam_tpu_torch.io.synthetic import make_stereo_sequence  # noqa: E402
from jetson_slam_tpu_torch.ops import frontend, stereo  # noqa: E402
from jetson_slam_tpu_torch.ops.frontend import FrontendResult, OrbFrontend  # noqa: E402
from tests.test_torch_stereo import use_jax_pyramid  # noqa: E402

torch.set_num_threads(2)

B = 4
GEOMETRIES = {"120x160": (120, 160, 3, 12, 5), "160x240": (160, 240, 1, 25, 8)}


def _case(name):
    h, w, levels, tile, seed = GEOMETRIES[name]
    seq = make_stereo_sequence(seed=seed, n_frames=B, h=h, w=w,
                               n_points=300 if h == 120 else 400)
    kw = dict(n_levels=levels, scale_factor=1.2, threshold=20, tile_h=tile, tile_w=tile)
    return seq, kw, (h, w)


@pytest.mark.parametrize("name", list(GEOMETRIES))
def test_batch_equals_single_frames(name):
    seq, kw, (h, w) = _case(name)
    fe = OrbFrontend(h, w, device="cpu", **kw)
    L, R, u, d, dist = fe.frame_step_batch(np.stack(seq.lefts), np.stack(seq.rights),
                                           seq.bf, seq.baseline)
    assert u.shape[0] == d.shape[0] == dist.shape[0] == L.xs.shape[0] == B
    fields = [f.name for f in FrontendResult.__dataclass_fields__.values()]
    n_depth = 0
    for i in range(B):
        l1, r1, u1, d1, dist1 = fe.frame_step(seq.lefts[i], seq.rights[i], seq.bf,
                                              seq.baseline)
        for f in fields:
            assert torch.equal(getattr(L, f)[i], getattr(l1, f)), f
            assert torch.equal(getattr(R, f)[i], getattr(r1, f)), f
        assert torch.equal(u[i], u1) and torch.equal(d[i], d1) and torch.equal(dist[i], dist1)
        n_depth += int((d1 > 0).sum())
    assert n_depth >= 10 * B


def test_each_kernel_is_called_once_per_batch(monkeypatch):
    seq, kw, (h, w) = _case("120x160")
    fe = OrbFrontend(h, w, device="cpu", **kw)
    calls = []

    def spy(name, fn):
        def call(*args, **kwargs):
            calls.append((name, tuple(args[0].shape)))
            return fn(*args, **kwargs)
        return call

    monkeypatch.setattr(frontend, "fast_nms", spy("fast_nms", frontend.fast_nms))
    monkeypatch.setattr(frontend, "orb_descriptor",
                        spy("orb_descriptor", frontend.orb_descriptor))
    monkeypatch.setattr(stereo, "stereo_costs", spy("stereo_costs", stereo.stereo_costs))
    fe.frame_step_batch(np.stack(seq.lefts), np.stack(seq.rights), seq.bf, seq.baseline)
    L = fe.geom.n_levels
    assert calls == [("fast_nms", (2 * B * L, h, w)), ("orb_descriptor", (2 * B, L, h, w)),
                     ("stereo_costs", (B, L, h, w))]


@pytest.mark.parametrize("name", list(GEOMETRIES))
def test_batch_matches_jax(name):
    seq, kw, (h, w) = _case(name)
    jf = JaxFrontend(h, w, **kw)
    tf = OrbFrontend(h, w, device="cpu", **kw)
    use_jax_pyramid(tf, jf)
    lefts, rights = np.stack(seq.lefts), np.stack(seq.rights)
    _, _, u_j, d_j, dist_j = jf.frame_step_batch(lefts, rights, seq.bf, seq.baseline)
    _, _, u_t, d_t, dist_t = tf.frame_step_batch(lefts, rights, seq.bf, seq.baseline)
    np.testing.assert_allclose(u_t.numpy(), np.asarray(u_j), atol=1e-4, rtol=0)
    np.testing.assert_allclose(d_t.numpy(), np.asarray(d_j), atol=1e-4, rtol=0)
    assert np.array_equal(dist_t.numpy(), np.asarray(dist_j))
    assert (d_t.numpy() > 0).sum() >= 10 * B
