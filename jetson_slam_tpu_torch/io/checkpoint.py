"""Map checkpoint / resume.

Port of ``jetson_slam_tpu/io/checkpoint.py`` (the reference leaves
SaveMap/LoadMap a TODO, include/System.h:115-117).  The MapStore's numpy
tables go into one compressed .npz with the same fields as the JAX
package's, plus the port's keyframe creation counter ``kf_seq`` and
``_next_kf_seq``, so each package loads a map that the other saved.  On
load the keyframe free list is rebuilt from the tables (the rows below
``_next_kf`` that are not alive); the JAX package's load leaves it empty,
so a resumed session there never recycles its culled rows.  A map saved
by the JAX package has no ``kf_seq``: it is then the rank of each live
keyframe's ``kf_frame_id``, as ``convert.map_store_from_numpy`` derives it.
"""
from __future__ import annotations

import numpy as np

from ..core.map import MapStore

_SCALARS = ("max_points", "max_keyframes", "n_slots", "_next_pt", "_next_kf")
_ARRAYS = (
    "pt_alive", "pt_pos", "pt_normal", "pt_desc", "pt_min_dist",
    "pt_max_dist", "pt_nobs", "pt_visible", "pt_found", "pt_first_kf",
    "pt_ref_kf",
    "kf_alive", "kf_pose", "kf_timestamp", "kf_frame_id", "kf_kp_xy",
    "kf_kp_octave", "kf_kp_angle", "kf_kp_ur", "kf_kp_depth", "kf_desc",
    "kf_kp_valid", "kf_obs", "kf_parent", "kf_first_connection", "kf_gen",
    "pt_gen",
)


def save_map(map_store: MapStore, path: str) -> None:
    """Serialize the full map state to one compressed .npz."""
    payload = {name: getattr(map_store, name) for name in _ARRAYS}
    payload["_scalars"] = np.array(
        [getattr(map_store, s) for s in _SCALARS], np.int64)
    payload["_loop_edges"] = np.array(
        sorted(map_store.loop_edges), np.int64).reshape(-1, 2)
    payload["kf_seq"] = map_store.kf_seq
    payload["_next_kf_seq"] = np.array(map_store._next_kf_seq, np.int64)
    np.savez_compressed(path, **payload)


def load_map(path: str) -> MapStore:
    """Rebuild a MapStore from a map that either package saved."""
    with np.load(path) as data:
        scalars = data["_scalars"]
        m = MapStore(max_points=int(scalars[0]), max_keyframes=int(scalars[1]),
                     n_slots=int(scalars[2]))
        m._next_pt = int(scalars[3])
        m._next_kf = int(scalars[4])
        for name in _ARRAYS:
            if name in data:  # tolerate pre-spanning-tree checkpoints
                setattr(m, name, data[name].copy())
        if "_loop_edges" in data:
            m.loop_edges = {(int(a), int(b)) for a, b in data["_loop_edges"]}
        if "kf_seq" in data:
            m.kf_seq = data["kf_seq"].copy()
            m._next_kf_seq = int(data["_next_kf_seq"])
        else:
            live = np.flatnonzero(m.kf_alive)
            order = live[np.argsort(m.kf_frame_id[live], kind="stable")]
            m.kf_seq[order] = np.arange(len(order))
            m._next_kf_seq = len(order)
    m._kf_free = [int(k) for k in np.flatnonzero(~m.kf_alive[:m._next_kf])]
    m.rebuild_obs_index()
    return m
