"""Local mapping: map-point culling, triangulation, fusion, local BA and
keyframe culling.

Port of ``jetson_slam_tpu/core/local_mapping.py`` (spec src/LocalMapping.cpp),
run once per inserted keyframe, synchronously (``process_pending``) or on
the worker thread of ``core/pipeline.py``:

- MapPointCulling (LocalMapping.cpp:176-211): found ratio < 0.25, or <= 3
  observations two keyframes after creation; survivors graduate after 3.
- CreateNewMapPoints (:213-458): triangulation against the 10 best
  covisible keyframes, epipolar-gated matching, parallax against stereo
  depth, reprojection and scale gates.
- SearchInNeighbors (:460-540): the two-way fuse with th = 3.
- LocalBundleAdjustment through ``core/local_ba.py`` (5 + 10 iterations),
  split into prepare (map reads), solve (device only) and commit (map
  writes) so the async worker can solve without the map lock and drop a
  solution that a new keyframe made stale.
- KeyFrameCulling (:638-702): a covisible keyframe goes when more than 90 %
  of its close points are seen at least 3 times elsewhere at the same or a
  finer scale.

The map stays in numpy on the host.  The device work (epipolar matching,
triangulation, the fuse searches, the LM solve) runs on the mapper's own
CUDA stream, a side stream beside the tracker's, and its results reach the
host with one blocking copy per batch (``frame.pull``), which waits on that
stream alone, before anything touches the map.  Each stage is a
``mapping.*`` profiler range.  That device may be another than the
tracker's (``mapping_device``): nothing but numpy crosses from the tracker,
so every tensor the mapper makes is made on its own device.  Local BA may
be sharded over a process group (``mesh``, ``parallel/dist_ba.py``).
"""
from __future__ import annotations

import contextlib

import numpy as np
import torch
import torch.distributed as dist

from . import matcher
from .frame import pull
from .local_ba import local_ba
from .map import MapStore
from .triangulation import epipolar_match, fundamental_matrix, triangulate_pairs
from ..device import resolve_device
from ..utils.lie import project_so3_np
from ..utils.profiling import count, span


def _bucket(n: int, lo: int = 16) -> int:
    """Round a dynamic count up to a power-of-two bucket (>= lo).  The JAX
    package pads to buckets so XLA compiles once per bucket; the port keeps
    the same buckets so the padded problems are identical array for array
    (and the card's allocator sees few distinct sizes)."""
    return max(lo, 1 << int(max(np.ceil(np.log2(max(n, 1))), 0)))


def check_distribution_options(mapping_device=None, mesh=None):
    """Raise TypeError, naming the option, for a ``mapping_device`` that is
    not a torch.device or a device name, or a ``mesh`` that is not a
    torch.distributed ProcessGroup."""
    if mapping_device is not None and not isinstance(mapping_device, (str, torch.device)):
        raise TypeError(f"mapping_device must be a torch.device or a device name, "
                        f"not {type(mapping_device).__name__}")
    if mesh is not None and not isinstance(mesh, dist.ProcessGroup):
        raise TypeError(f"mesh must be a torch.distributed ProcessGroup, not "
                        f"{type(mesh).__name__}")


def fuse_into(m: MapStore, cam, geom, device, kid, pids, deferred=None):
    """ORBmatcher::Fuse (ORBmatcher.cpp:812-962) with th = 3: fuse the
    points pids into keyframe kid.  Used by the mapper's SearchInNeighbors
    and by the loop closer's duplicate fusion.  ``deferred``: as in
    fuse_commit."""
    out = fuse_dispatch(m, cam, geom, device, kid, pids)
    if out is None:
        return
    _, idx, sel = out
    fuse_commit(m, kid, idx, pull([sel])[0], deferred)


def fuse_dispatch(m: MapStore, cam, geom, device, kid, pids):
    """Queue the frustum check and projection search of one fuse target;
    returns (kid, padded pid table, selection tensor) without waiting."""
    pids = pids[m.pt_alive[pids]] if len(pids) else pids
    if len(pids) == 0:
        return None

    def t(a):
        return torch.as_tensor(np.ascontiguousarray(a), device=device)

    cap = max(128, 1 << int(np.ceil(np.log2(len(pids)))))
    pad = cap - len(pids)
    idx = np.concatenate([pids, np.zeros(pad, pids.dtype)])
    alive = np.concatenate([np.ones(len(pids), bool), np.zeros(pad, bool)])
    ok, u, v, invz, lvl, vcos = matcher.frustum_check(
        t(m.pt_pos[idx]), t(m.pt_normal[idx]),
        t(m.pt_max_dist[idx]), t(m.pt_min_dist[idx]),
        t(m.kf_pose[kid, :3, :3]), t(m.kf_pose[kid, :3, 3]),
        t(m.camera_center(kid)), cam.fx, cam.fy, cam.cx, cam.cy,
        0.0, float(geom.widths[0]), 0.0, float(geom.heights[0]), geom.n_levels,
        float(np.log(geom.scale_factor)), 0.5, t(alive))
    sel = matcher.search_by_projection_points(
        u, v, u - cam.bf * invz, lvl, vcos, ok, t(m.pt_desc[idx]),
        t(m.kf_kp_xy[kid]), t(m.kf_kp_octave[kid]),
        t(m.kf_desc[kid]), t(m.kf_kp_valid[kid]),
        t(m.kf_kp_ur[kid]),
        # the fuse also looks at slots that hold a point already
        torch.ones(m.n_slots, dtype=torch.bool, device=device),
        3.0, t(np.asarray(geom.scales, np.float32)), geom.n_levels,
        nn_ratio=1.0, fuse=True)
    return kid, idx, sel


def fuse_commit(m: MapStore, kid, idx, sel, deferred=None):
    """Apply one fuse target's selection (from fuse_dispatch) to the map.
    ``deferred``: a list that takes the survivors' descriptor refreshes
    (MapStore.replace_point) for one batch later; None refreshes each at
    once."""
    for slot in np.flatnonzero(sel >= 0):
        pid = int(idx[sel[slot]])
        if not m.pt_alive[pid]:
            continue
        existing = m.kf_obs[kid, slot]
        if existing >= 0:
            if existing == pid or not m.pt_alive[existing]:
                continue
            # keep the more-observed point (ORBmatcher.cpp:941-951)
            if m.pt_nobs[existing] > m.pt_nobs[pid]:
                m.replace_point(pid, int(existing), deferred)
            else:
                m.replace_point(int(existing), pid, deferred)
        else:
            m.add_observation(kid, slot, pid)


class LocalMapper:
    # the reference's LocalMapping thread is busy for a few frame times per
    # keyframe, which throttles the tracker's keyframe rate
    # (LocalMapping::AcceptKeyFrames); run synchronously, a one-frame
    # countdown stands in for it
    BUSY_FRAMES = 1

    def __init__(self, map_store: MapStore, cam, geom, device, sensor="stereo",
                 run_ba=True, mapping_device=None, mesh=None):
        """``device`` is the tracker's.  ``mapping_device`` (a torch.device
        or its name) places the mapper's device work (triangulation, the
        fuse searches, local BA and its stream) there instead, the multi-card
        counterpart of the reference's LocalMapping thread
        (System.cpp:98-99).  ``mesh`` (a torch.distributed ProcessGroup) of
        more than one rank solves local BA landmark-sharded over it
        (``parallel/dist_ba.py``); of one rank it is the plain solve."""
        check_distribution_options(mapping_device, mesh)
        self.map = map_store
        self.cam = cam
        self.geom = geom
        self.device = resolve_device(device if mapping_device is None else mapping_device)
        self.sensor = sensor
        self.run_ba = run_ba
        self._dist_ba = None
        if mesh is not None and dist.get_world_size(mesh) > 1:
            from ..parallel.dist_ba import DistBA
            self._dist_ba = DistBA(mesh, device=self.device)
        # the mapper's device work runs on its own stream, beside the
        # tracker's (the JAX package's device_ctx)
        self.stream = (torch.cuda.Stream(self.device)
                       if self.device.type == "cuda" else None)
        self.queue: list[int] = []
        self._busy = 0
        self.recent_points: list[tuple[int, int]] = []  # (pid, birth_kf)
        self.scale_factors = np.asarray(geom.scales, np.float32)
        self.sigma2 = (self.scale_factors ** 2).astype(np.float32)
        self.inv_sigma2 = (1.0 / self.sigma2).astype(np.float32)
        self._abort_ba = False

    @property
    def K(self):
        """The camera matrix, from the current intrinsics (they change with
        SlamSystem.change_calibration)."""
        c = self.cam
        return np.array([[c.fx, 0, c.cx], [0, c.fy, c.cy], [0, 0, 1]], np.float32)

    def _t(self, a):
        """A host array as a tensor on the mapper's device."""
        return torch.as_tensor(np.ascontiguousarray(a), device=self.device)

    # -- the tracker's protocol (LocalMapping::AcceptKeyFrames and friends)
    def accepting(self):
        return self._busy == 0

    def tick(self):
        """Called once per tracked frame."""
        self._busy = max(0, self._busy - 1)

    def interrupt_ba(self):
        self._abort_ba = True

    def queue_len(self):
        return len(self.queue) + self._busy

    def insert_keyframe(self, kid: int):
        self.queue.append(kid)
        self._busy = self.BUSY_FRAMES

    # ------------------------------------------------------------------
    def process_pending(self):
        """Drain the keyframe queue; returns the processed keyframe ids."""
        done = []
        while self.queue:
            kid = self.queue.pop(0)
            self.process_keyframe(kid)
            done.append(kid)
        return done

    def device_ctx(self):
        """Context that puts this thread's device work on the mapper's
        stream (a no-op on the CPU)."""
        if self.stream is None:
            return contextlib.nullcontext()
        return torch.cuda.stream(self.stream)

    @span("mapping.keyframe")
    def process_keyframe(self, kid: int, lock=contextlib.nullcontext()):
        """Every stage for one keyframe.  ``lock`` (the async worker's map
        lock) is taken stage by stage so the tracker can interleave; the
        local BA solve runs without it, and its solution is dropped when a
        keyframe arrived meanwhile and set abort-BA (Optimizer.cpp:577-580).
        The fuse, BA and keyframe culling run only on an empty queue
        (LocalMapping::Run)."""
        with self.device_ctx():
            with lock:
                # first-connection parent (ProcessNewKeyFrame ->
                # UpdateConnections, LocalMapping.cpp:169-171)
                self.map.update_spanning_tree(kid)
                self._register_new_points(kid)
                self.cull_map_points(kid)
            with lock:
                self.create_new_map_points(kid)
            with lock:
                if not self.queue:
                    self.search_in_neighbors(kid)
            prep = None
            with lock:
                if not self.queue:
                    self._abort_ba = False
                    if self.run_ba and self.map.n_keyframes() > 2:
                        prep = self._lba_prepare(kid)
            if prep is not None:
                sol = self._lba_solve(prep)
                with lock:
                    if not self._abort_ba:
                        self._lba_commit(prep, sol)
            with lock:
                if not self.queue:
                    self.cull_keyframes(kid)
                self.map.version += 1

    def _register_new_points(self, kid):
        obs = self.map.kf_obs[kid]
        for slot in np.flatnonzero(obs >= 0):
            pid = int(obs[slot])
            if self.map.pt_first_kf[pid] == kid:
                self.recent_points.append((pid, kid))

    # ------------------------------------------------------- culling
    @span("mapping.cull_points")
    def cull_map_points(self, kid):
        """LocalMapping::MapPointCulling (LocalMapping.cpp:176-211)."""
        m = self.map
        th_obs = 2 if self.sensor == "mono" else 3
        keep = []
        for pid, birth in self.recent_points:
            if not m.pt_alive[pid]:
                continue
            found_ratio = m.pt_found[pid] / max(m.pt_visible[pid], 1)
            age = kid - birth
            if found_ratio < 0.25:
                m.erase_point(pid)
            elif age >= 2 and m.pt_nobs[pid] <= th_obs:
                m.erase_point(pid)
            elif age >= 3:
                continue  # graduated
            else:
                keep.append((pid, birth))
        self.recent_points = keep

    # ------------------------------------------------- triangulation
    @span("mapping.triangulate")
    def create_new_map_points(self, kid):
        """LocalMapping::CreateNewMapPoints (LocalMapping.cpp:213-458), in
        three phases: every neighbour's epipolar match is queued and pulled
        in one batch, then every triangulation likewise, then the new points
        are registered on the host."""
        m = self.map
        cam = self.cam
        neighbors, _ = m.covisible_keyframes(kid, n=20 if self.sensor == "mono" else 10)
        if len(neighbors) == 0:
            return
        R1 = m.kf_pose[kid, :3, :3]
        t1 = m.kf_pose[kid, :3, 3]
        c1 = m.camera_center(kid)
        ratio_factor = 1.5 * self.geom.scale_factor
        free1 = m.kf_kp_valid[kid] & (m.kf_obs[kid] < 0)
        sigma2 = self._t(self.sigma2)
        kf1 = (self._t(m.kf_desc[kid]), self._t(free1), self._t(m.kf_kp_angle[kid]),
               self._t(m.kf_kp_xy[kid]))

        # ---- phase A: queue every epipolar match, one pull
        cand, pending = [], []
        for kid2 in neighbors:
            kid2 = int(kid2)
            c2 = m.camera_center(kid2)
            baseline = float(np.linalg.norm(c2 - c1))
            if self.sensor != "mono":
                if baseline < cam.bf / cam.fx:
                    continue
            else:
                med_depth = self._scene_median_depth(kid2)
                if med_depth <= 0 or baseline / med_depth < 0.01:
                    continue
            R2 = m.kf_pose[kid2, :3, :3]
            t2 = m.kf_pose[kid2, :3, 3]
            F12 = fundamental_matrix(R1, t1, R2, t2, self.K)
            # epipole of kf1's centre in image 2
            cc = R2 @ c1 + t2
            ex = cam.fx * cc[0] / max(cc[2], 1e-9) + cam.cx
            ey = cam.fy * cc[1] / max(cc[2], 1e-9) + cam.cy
            free2 = m.kf_kp_valid[kid2] & (m.kf_obs[kid2] < 0)
            pending.append(epipolar_match(
                *kf1, self._t(m.kf_desc[kid2]), self._t(free2),
                self._t(m.kf_kp_angle[kid2]), self._t(m.kf_kp_xy[kid2]),
                self._t(F12), sigma2, self._t(m.kf_kp_octave[kid2]),
                float(ex), float(ey), sigma2))
            cand.append((kid2, R2, t2))
        if not pending:
            return
        matches = pull(pending)

        # ---- phase B: queue every triangulation, one pull; free1 is not
        # updated between neighbours (a slot claimed twice is resolved in
        # phase C by the kf_obs check, like the reference's AddMapPoint order)
        tri = []
        for (kid2, R2, t2), match in zip(cand, matches):
            s1 = np.flatnonzero((match >= 0) & free1)
            n = len(s1)
            if n == 0:
                continue
            s2 = match[s1]
            # pad the pair batch to a bucket (repeating entry 0); the padded
            # outputs are sliced off in phase C
            cap = _bucket(n, 64)
            s1p = np.concatenate([s1, np.full(cap - n, s1[0], s1.dtype)])
            s2p = np.concatenate([s2, np.full(cap - n, s2[0], s2.dtype)])
            xy1 = m.kf_kp_xy[kid, s1p]
            xy2 = m.kf_kp_xy[kid2, s2p]
            x1n = np.stack([(xy1[:, 0] - cam.cx) / cam.fx,
                            (xy1[:, 1] - cam.cy) / cam.fy,
                            np.ones(cap, np.float32)], axis=1).astype(np.float32)
            x2n = np.stack([(xy2[:, 0] - cam.cx) / cam.fx,
                            (xy2[:, 1] - cam.cy) / cam.fy,
                            np.ones(cap, np.float32)], axis=1).astype(np.float32)
            out = triangulate_pairs(
                self._t(R1).expand(cap, 3, 3), self._t(t1).expand(cap, 3),
                self._t(R2).expand(cap, 3, 3), self._t(t2).expand(cap, 3),
                self._t(x1n), self._t(x2n),
                self._t(m.kf_kp_ur[kid, s1p]), self._t(m.kf_kp_ur[kid2, s2p]),
                self._t(m.kf_kp_depth[kid, s1p]), self._t(m.kf_kp_depth[kid2, s2p]),
                self._t(xy1), self._t(xy2),
                self._t(self.sigma2[m.kf_kp_octave[kid, s1p]]),
                self._t(self.sigma2[m.kf_kp_octave[kid2, s2p]]),
                cam.fx, cam.fy, cam.cx, cam.cy, cam.bf, float(ratio_factor))
            tri.append((kid2, s1, s2, n, out))
        if not tri:
            return
        pulled = pull([a for t in tri for a in t[-1]])

        # ---- phase C: register the new points on the host, then refresh
        # their descriptors, normals and depth bounds in one batch
        self._refresh_points(self._add_triangulated(kid, tri, pulled))

    def _add_triangulated(self, kid, tri, pulled):
        """Phase C's loop: a point for each triangulated pair whose two slots
        are still free, in order, with its two observations; returns the new
        pids.  Nothing here reads a point's descriptor, normal or depth
        bounds, and a new point's observations are fixed once it is
        registered (a later pair cannot take a held slot), so refreshing
        them after the loop equals refreshing each as it is made."""
        m = self.map
        new = []
        for i_t, (kid2, s1, s2, n, _) in enumerate(tri):
            pts = pulled[2 * i_t][:n]
            ok = pulled[2 * i_t + 1][:n]
            for i in np.flatnonzero(ok):
                sl1, sl2 = int(s1[i]), int(s2[i])
                if m.kf_obs[kid, sl1] >= 0 or m.kf_obs[kid2, sl2] >= 0:
                    continue
                pid = m.add_point(pts[i], m.kf_desc[kid, sl1], kid)
                m.add_observation(kid, sl1, pid)
                m.add_observation(kid2, sl2, pid)
                new.append(pid)
                self.recent_points.append((pid, kid))
        return np.asarray(new, np.int64)

    def _refresh_points(self, pids):
        """MapStore.refresh_points over pids, as one span, counted."""
        if len(pids) == 0:
            return
        with span("mapping.refresh_points"):
            count("mapping.points_refreshed", len(pids))
            self.map.refresh_points(pids, self.scale_factors, self.geom.n_levels)

    def _refresh_descriptors(self, deferred):
        """MapStore.refresh_descriptors over the refreshes the fuse commits
        left, as one span, counted."""
        if not deferred:
            return
        with span("mapping.refresh_points"):
            count("mapping.points_refreshed", len(deferred))
            self.map.refresh_descriptors(deferred)

    def _scene_median_depth(self, kid):
        """KeyFrame::ComputeSceneMedianDepth (KeyFrame.cpp:637)."""
        m = self.map
        obs = m.kf_obs[kid]
        pids = obs[obs >= 0]
        pids = pids[m.pt_alive[pids]]
        if len(pids) == 0:
            return -1.0
        R = m.kf_pose[kid, :3, :3]
        t = m.kf_pose[kid, :3, 3]
        return float(np.median((m.pt_pos[pids] @ R[2]) + t[2]))

    # --------------------------------------------------------- fusion
    @span("mapping.fuse")
    def search_in_neighbors(self, kid):
        """LocalMapping::SearchInNeighbors (LocalMapping.cpp:460-540): the
        keyframe's points fused into its first and second neighbours, then
        theirs into it, through the fuse gates of the projection search."""
        m = self.map
        neighbors, _ = m.covisible_keyframes(kid, n=10)
        targets = set()
        for nk in neighbors:
            targets.add(int(nk))
            n2, _ = m.covisible_keyframes(int(nk), n=5)
            for nn in n2:
                if int(nn) != kid:
                    targets.add(int(nn))
        # forward fuses: queued for every target, pulled in one batch, so
        # candidate selection sees the map before the fuse; the commit loop
        # re-checks liveness, so a point replaced by an earlier target's
        # fuse is skipped, as in the reference's sequential ORBmatcher::Fuse
        my_pids = np.unique(m.kf_obs[kid][m.kf_obs[kid] >= 0])
        pending = [p for p in (fuse_dispatch(m, self.cam, self.geom, self.device,
                                             tk, my_pids) for tk in targets)
                   if p is not None]
        pulled = pull([p[2] for p in pending])
        # the commits read no descriptor, so the survivors' descriptor
        # refreshes wait for one batch: before the fuse back into kid,
        # whose search reads them, and before the closing refresh, which
        # overwrites those of kid's points
        deferred = []
        for (tk, idx, _), sel in zip(pending, pulled):
            fuse_commit(m, tk, idx, sel, deferred)
        self._refresh_descriptors(deferred)
        back_pids = []
        for tk in targets:
            o = m.kf_obs[tk]
            back_pids.append(o[o >= 0])
        if back_pids:
            fuse_into(m, self.cam, self.geom, self.device, kid,
                      np.unique(np.concatenate(back_pids)), deferred)
            self._refresh_descriptors(deferred)
        # refresh the descriptors and normals of the keyframe's points
        pids = np.unique(m.kf_obs[kid][m.kf_obs[kid] >= 0])
        self._refresh_points(pids[m.pt_alive[pids]])

    # ------------------------------------------------------ local BA
    # Optimizer::LocalBundleAdjustment (Optimizer.cpp:458-784) in three
    # steps: prepare (map reads), solve (device only), commit (map writes)
    @span("mapping.lba_prepare")
    def _lba_prepare(self, kid):
        """The padded local BA problem of keyframe kid, read from the map,
        or None when it has too few points, edges or free cameras."""
        m = self.map
        local, _ = m.covisible_keyframes(kid, n=None, min_weight=1)
        local = np.concatenate([[kid], local]).astype(np.int64)
        local_set = np.zeros(m.max_keyframes, bool)
        local_set[local] = True
        obs = m.kf_obs[local]
        pids = np.unique(obs[obs >= 0])
        pids = pids[m.pt_alive[pids]]
        if len(pids) < 10:
            return None
        in_pts = np.zeros(m.max_points, bool)
        in_pts[pids] = True
        # fixed cameras: the other keyframes observing these points
        Kact = m._next_kf
        tab = m.kf_obs[:Kact]
        sees = np.zeros(m.max_keyframes, bool)
        sees[:Kact] = (in_pts[np.where(tab >= 0, tab, 0)] & (tab >= 0)).any(1)
        fixed_kfs = np.flatnonzero(sees & m.kf_alive & ~local_set)
        cams = np.concatenate([local, fixed_kfs])
        # keyframe 0 stays fixed even when local (Optimizer.cpp:527), which
        # anchors the gauge at the map origin
        fixed = np.concatenate([local == 0, np.ones(len(fixed_kfs), bool)])
        if len(local) == 1 or (~fixed).sum() < 1:
            return None
        if fixed.sum() == 0:
            fixed[np.argmin(cams)] = True  # no frontier: anchor the oldest
        pt_of = {int(p): i for i, p in enumerate(pids)}

        e_cam, e_pt, e_slot, e_kf = [], [], [], []
        for ci, k in enumerate(cams):
            o = m.kf_obs[k]
            for slot in np.flatnonzero(o >= 0):
                pid = o[slot]
                if in_pts[pid]:
                    e_cam.append(ci)
                    e_pt.append(pt_of[int(pid)])
                    e_slot.append(slot)
                    e_kf.append(int(k))
        E = len(e_cam)
        if E < 20:
            return None
        e_cam = np.array(e_cam, np.int32)
        e_pt = np.array(e_pt, np.int32)
        e_slot = np.array(e_slot, np.int64)
        e_kf = np.array(e_kf, np.int64)
        kp_ur = m.kf_kp_ur[e_kf, e_slot]
        obs_arr = np.stack([
            m.kf_kp_xy[e_kf, e_slot, 0], m.kf_kp_xy[e_kf, e_slot, 1],
            np.where(kp_ur >= 0, kp_ur, 0.0)], axis=1).astype(np.float32)
        is_stereo = kp_ur >= 0
        inv_s2 = self.inv_sigma2[m.kf_kp_octave[e_kf, e_slot]]

        P = len(pids)
        deg = np.bincount(e_pt, minlength=P)
        # pad every dimension to a bucket: padded cameras are fixed identity
        # blocks, padded points edge-free lam * I blocks, padded edges carry
        # e_valid = False and weigh nothing
        C_real = len(cams)
        C_pad = _bucket(C_real, 8)
        P_pad = _bucket(P, 64)
        E_pad = _bucket(E, 256)
        D = _bucket(int(deg.max()), 4)
        pt_edges = np.full((P_pad, D), -1, np.int32)
        fill = np.zeros(P, np.int32)
        for e in range(E):
            p = e_pt[e]
            pt_edges[p, fill[p]] = e
            fill[p] += 1

        Rs = np.tile(np.eye(3, dtype=np.float32), (C_pad, 1, 1))
        ts = np.zeros((C_pad, 3), np.float32)
        Rs[:C_real] = m.kf_pose[cams, :3, :3]
        ts[:C_real] = m.kf_pose[cams, :3, 3]
        fixed_p = np.ones(C_pad, bool)
        fixed_p[:C_real] = fixed
        pt_pos = np.zeros((P_pad, 3), np.float32)
        pt_pos[:P] = m.pt_pos[pids]

        def padE(a, fillv=0):
            out = np.full((E_pad,) + a.shape[1:], fillv, a.dtype)
            out[:E] = a
            return out

        return dict(cams=cams, fixed=fixed_p, pids=pids, Rs=Rs, ts=ts,
                    pt_pos=pt_pos, e_cam=padE(e_cam), e_pt=padE(e_pt),
                    e_slot=e_slot, e_kf=e_kf, obs_arr=padE(obs_arr),
                    is_stereo=padE(is_stereo), inv_s2=padE(inv_s2, 1.0),
                    e_valid=padE(np.ones(E, bool)), pt_edges=pt_edges, E=E)

    @span("mapping.lba_solve")
    def _lba_solve(self, prep):
        """The LM solve on the prepared snapshot, on the device; reads and
        writes no map state, so it may run without the map lock.  With a
        mesh of several ranks it is sharded over them; every rank must then
        solve the same problem (DistBA checks it)."""
        cam = self.cam
        if self._dist_ba is not None:
            return self._dist_ba.solve(
                *(prep[k] for k in ("Rs", "ts", "fixed", "pt_pos", "e_cam", "e_pt",
                                    "obs_arr", "is_stereo", "inv_s2", "e_valid")),
                cam.fx, cam.fy, cam.cx, cam.cy, cam.bf)
        return pull(local_ba(
            *(self._t(prep[k]) for k in (
                "Rs", "ts", "fixed", "pt_pos", "e_cam", "e_pt", "obs_arr",
                "is_stereo", "inv_s2", "e_valid", "pt_edges")),
            cam.fx, cam.fy, cam.cx, cam.cy, cam.bf))

    @span("mapping.lba_commit")
    def _lba_commit(self, prep, sol):
        """Write the solved poses, points and outliers back into the map."""
        m = self.map
        R2, t2, p2, outlier = sol
        cams, fixed, pids = prep["cams"], prep["fixed"], prep["pids"]
        for i, k in enumerate(cams):
            if not fixed[i]:
                m.kf_pose[k, :3, :3] = project_so3_np(R2[i])
                m.kf_pose[k, :3, 3] = t2[i]
        m.pt_pos[pids] = p2[:len(pids)]
        for e in np.flatnonzero(outlier[:prep["E"]]):
            m.erase_observation(int(prep["e_kf"][e]), int(prep["e_slot"][e]))

    # -------------------------------------------------- keyframe culling
    @span("mapping.cull_keyframes")
    def cull_keyframes(self, kid):
        """LocalMapping::KeyFrameCulling (LocalMapping.cpp:638-702)."""
        m = self.map
        neighbors, _ = m.covisible_keyframes(kid, n=None, min_weight=1)
        for k in neighbors:
            k = int(k)
            if k == 0:  # the first keyframe is never culled
                continue
            obs = m.kf_obs[k]
            slots = np.flatnonzero(obs >= 0)
            if len(slots) == 0:
                continue
            pids = obs[slots]
            alive = m.pt_alive[pids]
            slots, pids = slots[alive], pids[alive]
            if len(slots) == 0:
                continue
            # stereo: only points with a valid close depth count
            if self.sensor != "mono":
                d = m.kf_kp_depth[k, slots]
                near = (d > 0) & (d < self.cam.th_depth * self.cam.bf / self.cam.fx)
                slots, pids = slots[near], pids[near]
            if len(slots) == 0:
                continue
            n_redundant = 0
            my_lvl = m.kf_kp_octave[k, slots]
            for s, pid, lv in zip(slots, pids, my_lvl):
                kfs, sl2 = m.observations_of(int(pid))
                other = kfs != k
                if other.sum() < 3:
                    continue
                fine = m.kf_kp_octave[kfs[other], sl2[other]] <= lv + 1
                if fine.sum() >= 3:
                    n_redundant += 1
            if n_redundant > 0.9 * len(slots):
                m.erase_keyframe(k)
