"""Carry state from the JAX package's layout into the port's.

The system has no learned weights.  What crosses are the front-end's static
tables, the tracker's per-frame state, the map and the BoW vocabulary;
each function takes numpy arrays (``np.asarray`` of the JAX package's
arrays).  The map stays
in numpy in both packages; the others come back as tensors.
"""
from __future__ import annotations

import numpy as np
import torch

from .bow.vocabulary import Vocabulary
from .core.map import MapStore
from .device import resolve_device
from .ops.frontend import resize_taps


def _t(a, device, dtype=None):
    return torch.as_tensor(np.array(a, dtype=dtype), device=device)


def frontend_tables_from_numpy(d: dict, device="cuda") -> dict:
    """The port's front-end tables from the JAX ``OrbFrontend._tables``
    (each entry a numpy array, or a sequence of them for the per-level
    resize matrices).  Keys of the result name the port's buffers:
    lut, roi, slot_level, slot_scale, ic_masks, pattern, and the two taps
    of every resize row (ylo1, yhi1, ywlo1, ywhi1, xlo1, ...)."""
    dev = resolve_device(device)
    out = {
        "lut": _t(d["lut"], dev, np.uint8),
        "roi": _t(d["roi_l"], dev, np.int32),
        "slot_level": _t(d["slot_level"], dev, np.int32),
        "slot_scale": _t(d["slot_scale"], dev, np.float32),
        # (31, 31, 2) float moment masks -> (2, 31, 31) int32 (exact ints)
        "ic_masks": _t(np.moveaxis(np.asarray(d["wuv2d"]), -1, 0), dev, np.int32),
        "pattern": _t(np.stack([np.asarray(d["pat_x"]), np.asarray(d["pat_y"])], 1),
                      dev, np.float32),
    }
    for i, (wy, wx) in enumerate(zip(d["wy"], d["wx"]), start=1):
        for ax, w in (("y", wy), ("x", wx)):
            out.update({k: _t(v, dev) for k, v in
                        resize_taps(np.asarray(w, np.float32), ax, i).items()})
    return out


_LAST_DTYPES = {"pw": np.float32, "has_pt": bool, "real": bool, "pid": np.int32,
                "octave": np.int32, "angle": np.float32, "desc": np.uint8}
_CAND_DTYPES = {"pos": np.float32, "normal": np.float32, "maxd": np.float32,
                "mind": np.float32, "desc": np.uint8, "alive": bool,
                "pid": np.int32}


def fused_inputs_from_numpy(last_state: dict, cand: dict, device="cuda"):
    """The fused step's last-frame state and local-map candidates (the
    dicts ``fused_track_dispatch`` of the JAX package takes) as the dicts
    of tensors ``core.fused_track.fused_track`` takes."""
    dev = resolve_device(device)
    last = {k: _t(last_state[k], dev, dt) for k, dt in _LAST_DTYPES.items()}
    cands = {k: _t(cand[k], dev, dt) for k, dt in _CAND_DTYPES.items()}
    return last, cands


def map_store_from_numpy(d: dict) -> MapStore:
    """The port's MapStore from the state of a JAX ``MapStore``
    (``vars(map_store)``): every ``pt_*`` and ``kf_*`` array, the
    observation index ``_pt_obs``, ``_kf_free``, ``_next_pt``, ``_next_kf``,
    ``loop_edges`` and ``version``.  The two packages' ``core/map.py`` are
    the same code but for the port's keyframe creation counter ``kf_seq``,
    which a JAX map lacks: it is then the rank of each live keyframe's
    ``kf_frame_id``.  Otherwise this is a deep copy; callbacks
    (``erase_hooks``) do not cross."""
    m = MapStore(max_points=len(d["pt_alive"]), max_keyframes=len(d["kf_alive"]),
                 n_slots=np.shape(d["kf_obs"])[1])
    for k, v in d.items():
        if k.startswith(("pt_", "kf_")):
            ref = getattr(m, k)
            setattr(m, k, np.array(v, dtype=ref.dtype).reshape(ref.shape))
    m._pt_obs = {int(p): {int(k): int(s) for k, s in obs.items()}
                 for p, obs in d["_pt_obs"].items()}
    m._kf_free = [int(k) for k in d["_kf_free"]]
    m._next_pt = int(d["_next_pt"])
    m._next_kf = int(d["_next_kf"])
    if "kf_seq" not in d:
        live = np.flatnonzero(m.kf_alive)
        order = live[np.argsort(m.kf_frame_id[live], kind="stable")]
        m.kf_seq[order] = np.arange(len(order))
    m._next_kf_seq = int(d.get("_next_kf_seq", m.kf_seq.max() + 1))
    m.loop_edges = set(d["loop_edges"])
    m.version = int(d["version"])
    return m


def vocabulary_from_numpy(d: dict) -> Vocabulary:
    """The port's Vocabulary from the state of a JAX ``Vocabulary``
    (``vars(vocabulary)``): k, L, the children, centroid, leaf, word-id,
    weight and node-level arrays.  Both packages keep the tree in numpy, so
    this is a copy."""
    return Vocabulary(int(d["k"]), int(d["L"]),
                      np.array(d["children"], np.int32),
                      np.array(d["centroids"], np.uint8),
                      np.array(d["is_leaf"], bool),
                      np.array(d["word_id"], np.int32),
                      np.array(d["weights"], np.float32),
                      np.array(d["node_level"], np.int32),
                      scoring=d.get("scoring", "l1"))
