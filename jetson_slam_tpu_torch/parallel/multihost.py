"""Cross-process support: the process group, the tracker -> mapper keyframe
handoff and a key-value channel.

Port of ``jetson_slam_tpu/parallel/multihost.py``.  The reference is one
process (three threads sharing one address space, System.cpp:97-111); here
the roles may split across processes and hosts:

- a tracker process owns the camera stream and its card;
- a mapper process owns local mapping and BA on another card or host;
- the keyframe handoff is a serialized MapStore delta (the rows of the
  keyframes and of the points they observe), sent once over the store's
  key-value channel, while bundle adjustment runs over the process group
  (``parallel/dist_ba.py``), every rank holding a shard.

``initialize`` builds the store (a ``TCPStore`` that rank 0 hosts, or a
``FileStore`` for a ``file://`` path) and the default process group on it;
the key-value calls use the same store.  The delta keeps the JAX package's
``.npz`` fields (``K_*``, ``P_*``, ``kids``, ``pids``) and adds ``K_kf_seq``,
so a delta that the JAX package wrote applies here.
"""
from __future__ import annotations

import datetime
import io

import numpy as np
import torch.distributed as dist

# the store that initialize() built, for kv_put_bytes / kv_get_bytes
_store = None


def initialize(coordinator: str, num_processes: int, process_id: int,
               backend=None, timeout_s: float = 600.0):
    """The default process group of ``num_processes`` ranks on a store at
    ``coordinator``: ``host:port`` (a TCPStore that rank 0 hosts) or
    ``file://PATH`` (a FileStore).  ``backend`` is torch's: "nccl", "gloo",
    or None for gloo on CPU tensors and NCCL on CUDA ones.  A second call
    in the same process returns the store of the first.  Returns the
    store."""
    global _store
    if dist.is_initialized():
        if _store is None:
            raise RuntimeError("the process group was initialized without this module's "
                               "store; kv_put_bytes / kv_get_bytes need initialize()")
        return _store
    timeout = datetime.timedelta(seconds=timeout_s)
    if coordinator.startswith("file://"):
        store = dist.FileStore(coordinator[len("file://"):], num_processes)
    else:
        host, port = coordinator.rsplit(":", 1)
        store = dist.TCPStore(host, int(port), num_processes,
                              is_master=process_id == 0, timeout=timeout)
    dist.init_process_group(backend=backend, store=store, rank=process_id,
                            world_size=num_processes, timeout=timeout)
    _store = store
    return store


def global_group():
    """The group of every process (the JAX package's ``global_mesh``)."""
    return dist.group.WORLD


# ------------------------------------------------------------ map deltas
_KF_FIELDS = ("kf_pose", "kf_timestamp", "kf_frame_id", "kf_kp_xy",
              "kf_kp_octave", "kf_kp_angle", "kf_kp_ur", "kf_kp_depth",
              "kf_desc", "kf_kp_valid", "kf_obs", "kf_parent",
              "kf_first_connection", "kf_gen")
_PT_FIELDS = ("pt_pos", "pt_normal", "pt_desc", "pt_min_dist", "pt_max_dist",
              "pt_nobs", "pt_visible", "pt_found", "pt_first_kf",
              "pt_ref_kf", "pt_gen")


def serialize_kf_delta(m, kids) -> bytes:
    """The rows that keyframes ``kids`` contribute: their own rows, their
    creation counters and every live point they observe.  Rows keep their
    indices (both sides hold the same capacities), so applying is a row
    write."""
    kids = np.asarray(kids, np.int64)
    obs = m.kf_obs[kids]
    pids = np.unique(obs[obs >= 0])
    pids = pids[m.pt_alive[pids]] if len(pids) else pids
    payload = {"kids": kids, "pids": pids, "K_kf_seq": m.kf_seq[kids]}
    for f in _KF_FIELDS:
        payload["K_" + f] = getattr(m, f)[kids]
    for f in _PT_FIELDS:
        payload["P_" + f] = getattr(m, f)[pids]
    buf = io.BytesIO()
    np.savez_compressed(buf, **payload)
    return buf.getvalue()


def apply_kf_delta(m, blob: bytes):
    """Write a ``serialize_kf_delta`` payload into ``m`` (same capacities)
    and leave a map that works: the rows written and marked alive, the
    high-water marks advanced, the applied rows out of the keyframe free
    list and the rows skipped below the new mark in it, the creation
    counters carried (for a JAX delta, which has none, the new rows take
    the next counters in ``kf_frame_id`` order, as ``io/checkpoint.py``
    derives them), the observation index rebuilt from ``kf_obs`` and the
    map's version bumped.  Returns (kids, pids)."""
    with np.load(io.BytesIO(blob), allow_pickle=False) as data:
        kids = data["kids"].astype(np.int64)
        pids = data["pids"].astype(np.int64)
        if data["K_kf_obs"].shape[1:] != m.kf_obs.shape[1:]:
            raise ValueError(f"delta of {data['K_kf_obs'].shape[1]} slots per keyframe; "
                             f"the map holds {m.n_slots}")
        fresh = kids[~m.kf_alive[kids]]
        for f in _KF_FIELDS:
            getattr(m, f)[kids] = data["K_" + f]
        for f in _PT_FIELDS:
            getattr(m, f)[pids] = data["P_" + f]
        if "K_kf_seq" in data:
            m.kf_seq[kids] = data["K_kf_seq"]
        else:
            order = fresh[np.argsort(m.kf_frame_id[fresh], kind="stable")]
            m.kf_seq[order] = m._next_kf_seq + np.arange(len(order))
    m.kf_alive[kids] = True
    m.pt_alive[pids] = True
    old_next = m._next_kf
    m._next_kf = max(m._next_kf, int(kids.max()) + 1 if len(kids) else 0)
    if len(pids):
        m._next_pt = max(m._next_pt, int(pids.max()) + 1)
    if len(kids):
        m._next_kf_seq = max(m._next_kf_seq, int(m.kf_seq[kids].max()) + 1)
    applied = set(kids.tolist())
    m._kf_free = [k for k in m._kf_free if k not in applied] + [
        int(k) for k in range(old_next, m._next_kf) if not m.kf_alive[k]]
    m.rebuild_obs_index()
    m.version += 1
    return kids, pids


# ------------------------------------------------------- key-value channel
def _kv_store():
    if _store is None:
        raise RuntimeError("initialize() has not run in this process")
    return _store


def kv_put_bytes(key: str, blob: bytes):
    """Publish bytes under ``key`` on the store: the tracker -> mapper
    channel.  Unlike a collective, the receiver may wait for it however
    long the sender takes."""
    _kv_store().set("kv/" + key, blob)


def kv_get_bytes(key: str, timeout_ms: int = 600_000) -> bytes:
    """The bytes under ``key``, waiting up to ``timeout_ms`` for a sender
    to publish them."""
    store = _kv_store()
    store.wait(["kv/" + key], datetime.timedelta(milliseconds=timeout_ms))
    return bytes(store.get("kv/" + key))
