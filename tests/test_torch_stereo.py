"""The port's stereo matching against the JAX package on the CPU.

Kernel 3's plain version must give exactly the costs of the Pallas kernel
(interpret mode) on every matched slot; the whole stereo frame step must
give u_right and depth within 1e-4 and identical best distances (the
criteria of tests/test_pallas_stereo.py:62-66).  Both sides read the JAX
package's pyramid, which differs from the port's exact resize by a few
floor flips (tests/test_torch_frontend.py::test_pyramid_bit_exact).
"""
import numpy as np
import pytest

pytest.importorskip("jax")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from jetson_slam_tpu.io.synthetic import make_stereo_sequence  # noqa: E402
from jetson_slam_tpu.ops.bands import MARGIN  # noqa: E402
from jetson_slam_tpu.ops.frontend import OrbFrontend as JaxFrontend  # noqa: E402
from jetson_slam_tpu.ops.pallas_stereo import stereo_costs_pallas  # noqa: E402
from jetson_slam_tpu.ops.stereo import NBR_HALF, PATCH_HALF, _coarse_match  # noqa: E402
from jetson_slam_tpu_torch.ops.cuda_stereo import stereo_costs  # noqa: E402
from jetson_slam_tpu_torch.ops.frontend import OrbFrontend  # noqa: E402
from jetson_slam_tpu_torch.ops.stereo import coarse_match  # noqa: E402

torch.set_num_threads(2)


def use_jax_pyramid(tf, jf):
    """Make the port's front-end read the JAX package's pyramid."""
    pyr = jax.jit(lambda x: jf._pyramid_batch(jf._tables, x))

    def pyramid(imgs_u8):
        levels = pyr(jnp.asarray(imgs_u8.numpy()))
        out = torch.zeros((imgs_u8.shape[0], len(levels)) + tuple(imgs_u8.shape[1:]),
                          dtype=torch.uint8)
        for i, lv in enumerate(levels):
            out[:, i, :lv.shape[1], :lv.shape[2]] = torch.as_tensor(np.asarray(lv))
        return out

    tf.pyramid = pyramid

KW = dict(n_levels=3, scale_factor=1.2, threshold=20, tile_h=12, tile_w=12)


def _pallas_costs(fe, lefts, rights, mbf, min_z):
    """Costs of stereo_costs_pallas with the meta that
    stereo_match_bands_batch_pallas builds (ops/stereo.py:302-324)."""
    T = fe._tables
    B = lefts.shape[0]
    res, _raw, bands = fe._extract_batch_core(
        T, jnp.concatenate([jnp.asarray(lefts), jnp.asarray(rights)], 0))
    L = jax.tree_util.tree_map(lambda a: a[:B], res)
    R = jax.tree_util.tree_map(lambda a: a[B:], res)
    br128 = fe._extract_bands_r128(T, jnp.asarray(rights))
    c = jax.vmap(lambda l, r: _coarse_match(
        l, r, T["scales"], T["inv_scales"], T["widths"], mbf, min_z))(L, R)
    xl, xr, yy, lvl = c["xl"], c["xr"], c["yy"], L.octave
    K = bands.shape[1]
    th = jnp.take(T["lvl_tile_h"], lvl)
    tw = jnp.take(T["lvl_tile_w"], lvl)
    tyr, txr = yy // th, xr // tw
    slot_r = jnp.clip(jnp.take(T["lvl_off"], lvl) + tyr * jnp.take(T["lvl_ntw"], lvl)
                      + txr, 0, K - 1)
    zero = jnp.zeros_like(slot_r)
    meta = jnp.stack([yy - T["band_y0"][None] + (MARGIN - PATCH_HALF),
                      xl - T["band_x0"][None] + (MARGIN - PATCH_HALF), slot_r,
                      yy - tyr * th + (MARGIN - PATCH_HALF),
                      xr - txr * tw + (MARGIN - PATCH_HALF - NBR_HALF),
                      zero, zero, zero], -1).astype(jnp.int32)
    costs = stereo_costs_pallas(bands[:B], br128, meta, fe._max_tiles_w,
                                int(max(fe.geom.tile_h)), int(max(fe.geom.tile_w)),
                                interpret=True)
    return np.asarray(costs), np.asarray(c["matched"])


@pytest.mark.parametrize("h,w", [(120, 160), (123, 173)])
def test_costs_match_pallas_kernel(h, w):
    """Exact costs at an even geometry and at an odd one, whose canvas
    rows are not a multiple of 4 bytes long."""
    seq = make_stereo_sequence(seed=5, n_frames=3, h=h, w=w, n_points=300)
    lefts = np.stack(seq.lefts)
    rights = np.stack(seq.rights)
    mbf, min_z = float(seq.bf), float(seq.baseline)
    jf = JaxFrontend(h, w, **KW)
    ref, matched_ref = _pallas_costs(jf, lefts, rights, jnp.float32(mbf),
                                     jnp.float32(min_z))
    tf = OrbFrontend(h, w, device="cpu", **KW)
    use_jax_pyramid(tf, jf)
    B = lefts.shape[0]
    res, pyr = tf.extract_batch(torch.as_tensor(np.concatenate([lefts, rights])))
    left = res.map(lambda a: a[:B])
    right = res.map(lambda a: a[B:])
    c = coarse_match(left, right, tf.scales, tf.inv_scales, tf.widths, mbf, min_z)
    got = stereo_costs(pyr[:B], pyr[B:], left.octave.to(torch.int32).contiguous(),
                       c["yy"], c["xl"], c["xr"], c["matched"]).numpy()
    matched = c["matched"].numpy()
    assert np.array_equal(matched, matched_ref)
    assert matched.sum() >= 60
    assert np.array_equal(got[matched], ref[matched].astype(np.int32))
    assert not got[~matched].any()


@pytest.mark.parametrize("h,w,levels,tile,seed", [(120, 160, 3, 12, 5),
                                                   (160, 240, 1, 25, 8)])
def test_frame_step_matches_jax(h, w, levels, tile, seed):
    s = make_stereo_sequence(seed=seed, n_frames=2, h=h, w=w,
                             n_points=300 if h == 120 else 400)
    kw = dict(n_levels=levels, scale_factor=1.2, threshold=20, tile_h=tile,
              tile_w=tile)
    jf = JaxFrontend(h, w, **kw)
    tf = OrbFrontend(h, w, device="cpu", **kw)
    use_jax_pyramid(tf, jf)
    for i in range(2):
        _, _, u_j, d_j, dist_j = jf.frame_step(s.lefts[i], s.rights[i], s.bf,
                                               s.baseline)
        _, _, u_t, d_t, dist_t = tf.frame_step(s.lefts[i], s.rights[i], s.bf,
                                               s.baseline)
        np.testing.assert_allclose(u_t.numpy(), np.asarray(u_j), atol=1e-4, rtol=0)
        np.testing.assert_allclose(d_t.numpy(), np.asarray(d_j), atol=1e-4, rtol=0)
        assert np.array_equal(dist_t.numpy(), np.asarray(dist_j))
        assert (d_t.numpy() > 0).sum() >= 10
