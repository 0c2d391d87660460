"""Cross-host SLAM worker: a tracker process hands its keyframes to a mapper
process, and both solve a bundle adjustment sharded over them.

Port of ``examples/cross_host_worker.py``.  Run one instance per process
(on one host, or one per host):

    python -m jetson_slam_tpu_torch.cli.cross_host_worker COORDINATOR N_PROCS PROC_ID \\
        [--device cuda|cpu] [--backend gloo|nccl] [--settings YAML] [--frames 16]

COORDINATOR is ``host:port`` (a TCPStore hosted by process 0) or
``file://PATH`` (a FileStore on a shared file system).  Process 0, the
tracker, tracks a synthetic stereo arc with local BA off (its keyframe
poses keep their drift), serializes the MapStore delta of its keyframes
(``parallel/multihost.serialize_kf_delta``) and publishes it on the
store.  The other processes, the mappers, apply it into a fresh MapStore
and check its observation index against ``kf_obs``.  Each process then
prepares the local BA problem of the newest keyframe from its own map;
the mappers check the tracker's digest of that problem over the store, and
every process solves it with ``DistBA`` over the whole group.  A gloo group
may carry CUDA tensors: that is how two processes share one card.

Without ``--settings`` the scene is the JAX worker's (320x240, 3 levels,
tile 16); with it, the settings file's geometry, rendered with its fx and
baseline.  Each process prints one ``CROSS_HOST_STATS {json}`` line (the
delta's bytes, the ms to serialize, send, receive and apply it, the
problem's digest, the median reprojection chi2 before and after) and
``CROSS_HOST_OK <rank>`` when every check passed.
"""
from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np


def reproj_chi2(prep, Rs, ts, pts, fx, fy, cx, cy, bf):
    """Median squared reprojection error of the problem's real edges."""
    e = slice(0, prep["E"])
    e_cam, e_pt = prep["e_cam"][e], prep["e_pt"][e]
    obs, stereo = prep["obs_arr"][e], prep["is_stereo"][e]
    pc = np.einsum("eij,ej->ei", Rs[e_cam], pts[e_pt]) + ts[e_cam]
    z = np.maximum(pc[:, 2], 1e-6)
    u = fx * pc[:, 0] / z + cx
    v = fy * pc[:, 1] / z + cy
    r = np.stack([obs[:, 0] - u, obs[:, 1] - v,
                  np.where(stereo, obs[:, 2] - (u - bf / z), 0.0)], 1)
    return float(np.median((r ** 2).sum(1)))


def obs_index_agrees(m) -> bool:
    """The observation index and kf_obs hold the same (point, keyframe,
    slot) triples, for every live point."""
    kfs = m.keyframe_ids()
    ks, slots = np.nonzero(m.kf_obs[kfs] >= 0)
    table = {(int(m.kf_obs[kfs[k], s]), int(kfs[k]), int(s)) for k, s in zip(ks, slots)}
    index = {(pid, kf, s) for pid, obs in m._pt_obs.items() if m.pt_alive[pid]
             for kf, s in obs.items()}
    live = {t for t in table if m.pt_alive[t[0]]}
    return len(live) > 0 and index == live


def session(settings, n_frames: int, render: bool):
    """The config and, when ``render``, the synthetic arc (only the tracker
    needs its frames): the JAX worker's scene, or the settings file's
    geometry rendered with its fx and baseline.  The principal point is
    the renderer's, the image centre."""
    from ..config import SLAMConfig, load_config
    from ..io.synthetic import make_stereo_sequence
    if settings:
        cfg = load_config(settings)
        c = cfg.camera
        scene = dict(seed=7, h=c.height, w=c.width, fx=c.fx, baseline=c.bf / c.fx)
    else:
        cfg = SLAMConfig()
        c = cfg.camera
        scene = dict(seed=23, h=240, w=320, fx=300.0, baseline=0.4)
        c.fx = c.fy = scene["fx"]
        c.width, c.height, c.bf = 320, 240, scene["fx"] * scene["baseline"]
        c.k1 = c.k2 = c.p1 = c.p2 = 0.0
        c.th_depth = 40.0
        cfg.orb.n_levels, cfg.orb.tile_h, cfg.orb.tile_w = 3, 16, 16
        cfg.max_map_points, cfg.max_keyframes = 16384, 64
    c.cx, c.cy = scene["w"] / 2.0, scene["h"] / 2.0
    seq = (make_stereo_sequence(n_frames=n_frames, trajectory="arc", n_points=900, **scene)
           if render else None)
    return cfg, seq


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("coordinator")
    ap.add_argument("n_procs", type=int)
    ap.add_argument("proc_id", type=int)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--backend", default=None)
    ap.add_argument("--settings", default=None)
    ap.add_argument("--frames", type=int, default=16)
    ns = ap.parse_args(argv)
    import torch.distributed as dist
    from ..device import resolve_device
    from ..parallel import multihost as mh
    dev = resolve_device(ns.device)
    rank = ns.proc_id
    mh.initialize(ns.coordinator, ns.n_procs, rank, backend=ns.backend)
    try:
        return run(ns, dev)
    finally:
        dist.destroy_process_group()


def run(ns, dev) -> dict:
    from ..core.frame import Frame
    from ..core.map import MapStore
    from ..models.slam import SlamSystem
    from ..parallel import multihost as mh
    from ..parallel.dist_ba import DistBA, problem_digest
    rank = ns.proc_id
    cfg, seq = session(ns.settings, ns.frames, render=rank == 0)
    c = cfg.camera
    Frame._next_id = 0
    # every process builds the same modules; only process 0 tracks
    slam = SlamSystem(cfg, sensor="stereo", enable_ba=False, device=dev)
    stats = {"rank": rank}
    if rank == 0:
        for i in range(len(seq.lefts)):
            slam.track_stereo(seq.lefts[i], seq.rights[i], seq.timestamps[i])
        m = slam.map
        kids = m.keyframe_ids()
        if len(kids) < 2:
            raise RuntimeError(f"the tracker made {len(kids)} keyframes; 2 are needed")
        t0 = time.perf_counter()
        blob = mh.serialize_kf_delta(m, kids)
        t1 = time.perf_counter()
        # the mappers wait for the delta however long tracking takes (a
        # collective would time out instead)
        mh.kv_put_bytes("kf_delta/0", blob)
        stats.update(serialize_ms=(t1 - t0) * 1e3,
                     put_ms=(time.perf_counter() - t1) * 1e3)
        print(f"[tracker] {len(kids)} keyframes, delta {len(blob)} bytes", flush=True)
    else:
        t0 = time.perf_counter()
        blob = mh.kv_get_bytes("kf_delta/0")
        t1 = time.perf_counter()
        m = MapStore(max_points=cfg.max_map_points, max_keyframes=cfg.max_keyframes,
                     n_slots=slam.frontend.n_slots_padded)
        kids, pids = mh.apply_kf_delta(m, blob)
        stats.update(get_ms=(t1 - t0) * 1e3, apply_ms=(time.perf_counter() - t1) * 1e3,
                     obs_index_ok=obs_index_agrees(m))
        print(f"[mapper] applied delta: {len(kids)} kfs, {len(pids)} pts", flush=True)
        if not stats["obs_index_ok"]:
            raise RuntimeError("the applied map's observation index disagrees with kf_obs")
    stats["delta_bytes"] = len(blob)

    # every process prepares the newest keyframe's problem from its own map
    mapper = slam.local_mapper
    mapper.map = m
    live = m.keyframe_ids()
    newest = int(live[np.argmax(m.kf_seq[live])])
    prep = mapper._lba_prepare(newest)
    if prep is None:
        raise RuntimeError(f"keyframe {newest} gives no local BA problem")
    digest = problem_digest(*(prep[k] for k in (
        "cams", "fixed", "Rs", "ts", "pt_pos", "e_cam", "e_pt", "obs_arr", "is_stereo",
        "inv_s2", "e_valid", "pt_edges")))
    if rank == 0:
        mh.kv_put_bytes("digest/0", json.dumps(digest).encode())
    else:
        d0 = json.loads(mh.kv_get_bytes("digest/0"))
        if d0 != digest:
            raise RuntimeError(f"problem digest {digest} differs from the tracker's {d0}")
    print(f"[{rank}] problem digest consistent: {digest}", flush=True)

    solver = DistBA(mh.global_group(), its1=3, its2=3, device=dev)
    t0 = time.perf_counter()
    R2, t2, p2, _ = solver.solve(
        *(prep[k] for k in ("Rs", "ts", "fixed", "pt_pos", "e_cam", "e_pt", "obs_arr",
                            "is_stereo", "inv_s2", "e_valid")),
        c.fx, c.fy, c.cx, c.cy, c.bf)
    stats["solve_ms"] = (time.perf_counter() - t0) * 1e3
    chi0 = reproj_chi2(prep, prep["Rs"], prep["ts"], prep["pt_pos"], c.fx, c.fy, c.cx,
                       c.cy, c.bf)
    chi1 = reproj_chi2(prep, R2, t2, p2, c.fx, c.fy, c.cx, c.cy, c.bf)
    stats.update(digest=digest, chi2_before=chi0, chi2_after=chi1,
                 n_procs=ns.n_procs, **solver.stats)
    print("CROSS_HOST_STATS " + json.dumps(stats), flush=True)
    if not (np.isfinite(R2).all() and np.isfinite(t2).all()):
        raise RuntimeError("the distributed BA gave non-finite poses")
    # the poses start near the optimum (tracking ran a pose LM per frame),
    # so the LM, which lowers the weighted robust cost, may move this
    # unweighted median within the noise: the gate is that it stays
    # sub-pixel (the solver's parity is tests/test_torch_dist_ba.py's)
    if chi1 > max(2.0 * chi0, 1.0):
        raise RuntimeError(f"median chi2 {chi0:.4f} -> {chi1:.4f}")
    print(f"CROSS_HOST_OK {rank}", flush=True)
    return stats


if __name__ == "__main__":
    main(sys.argv[1:])
