"""Writes ``tests/data/noisy_ba_problem.npz``: the noisy local-BA problem of
tests/test_dist_ba.py (5 cameras, 64 points, 10 % gross outliers, seed 0)
with the JAX package's float32 and float64 ``local_ba`` solutions (camera
translations and outlier flags), for ``chip_smoke.py``'s dist_ba phase,
which runs on the card without JAX.

    python tests/jax_ba_reference.py

``tests/test_torch_local_ba.py`` checks that the file equals a fresh run.
"""
import os

import numpy as np

PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                    "noisy_ba_problem.npz")
KEYS = ("Rs", "ts", "fixed", "pts", "e_cam", "e_pt", "obs", "stereo", "inv_sigma2",
        "e_valid")


def reference():
    """The problem's arrays (KEYS, pt_edges, cam = fx fy cx cy bf) and JAX's
    solutions: t32 / out32 in float32, t64 / out64 in float64."""
    import jax
    import jax.numpy as jnp
    from jetson_slam_tpu.core.local_ba import local_ba
    from tests.test_local_ba import BF, CX, CY, FX, FY, make_ba_problem
    prob = make_ba_problem(np.random.default_rng(0), n_cams=5, n_pts=64, pix_noise=0.4,
                           pose_noise=0.06, pt_noise=0.15, outlier_frac=0.1)
    E = len(prob[4])
    args = list(prob[:8]) + [np.ones(E, np.float32), np.ones(E, bool)]
    out = dict(zip(KEYS, args), pt_edges=prob[8],
               cam=np.array([FX, FY, CX, CY, BF], np.float64))
    for bits in (32, 64):
        a = [x.astype(np.float64) if bits == 64 and x.dtype == np.float32 else x
             for x in args]
        with jax.enable_x64(bits == 64):
            _, t, _, outlier = local_ba(*(jnp.asarray(x) for x in a),
                                        jnp.asarray(prob[8]), FX, FY, CX, CY, BF)
        out[f"t{bits}"], out[f"out{bits}"] = np.asarray(t), np.asarray(outlier)
    return out


if __name__ == "__main__":
    import sys
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    import jax
    jax.config.update("jax_platforms", "cpu")
    np.savez(PATH, **reference())
    print(f"wrote {PATH}")
