"""Map store: struct-of-arrays replacement for Map/MapPoint/KeyFrame graphs.

The reference keeps the map as pointer graphs guarded by mutexes
(src/Map.cpp, src/MapPoint.cpp, src/KeyFrame.cpp).  Here the map is a set of
capacity-padded NumPy SoA tables with alive masks — host-side bookkeeping
feeding fixed-shape device batches (SURVEY.md §7.1 "Map state").  Covisibility
is derived from the observation table on demand rather than maintained as a
mutable weighted graph (KeyFrame::UpdateConnections semantics,
KeyFrame.cpp:293-360).
"""
from __future__ import annotations

import dataclasses
import itertools

import numpy as np

COVIS_TH = 15  # reference KeyFrame.cpp:334
# set bits of every byte value: Hamming distances from the XOR of packed
# descriptors without unpacking them, where numpy (before 2.0) has no
# bitwise_count
POPCOUNT8 = np.array([bin(b).count("1") for b in range(256)], np.uint8)
# largest XOR block one step of _distinctive_descriptors builds (bytes)
_XOR_BLOCK = 1 << 22


class MapStore:
    def __init__(self, max_points=65536, max_keyframes=512, n_slots=4096):
        P, K, S = max_points, max_keyframes, n_slots
        self.max_points, self.max_keyframes, self.n_slots = P, K, S

        # ---- map points ----
        self.pt_alive = np.zeros(P, bool)
        self.pt_pos = np.zeros((P, 3), np.float32)
        self.pt_normal = np.zeros((P, 3), np.float32)
        self.pt_desc = np.zeros((P, 32), np.uint8)
        self.pt_min_dist = np.zeros(P, np.float32)
        self.pt_max_dist = np.zeros(P, np.float32)
        self.pt_nobs = np.zeros(P, np.int32)
        self.pt_visible = np.ones(P, np.int32)   # MapPoint::mnVisible (init 1)
        self.pt_found = np.ones(P, np.int32)     # MapPoint::mnFound (init 1)
        self.pt_first_kf = np.full(P, -1, np.int32)
        self.pt_ref_kf = np.full(P, -1, np.int32)
        # per-slot generation counter, bumped on every (re)allocation:
        # _alloc_pt recycles culled pids, so holders of a pid across an
        # unlocked window (the fused tracking step's dispatch/pull,
        # core/tracking.py) compare generations to detect reuse
        self.pt_gen = np.zeros(P, np.int64)
        self._next_pt = 0

        # ---- keyframes ----
        self.kf_alive = np.zeros(K, bool)
        self.kf_pose = np.tile(np.eye(4, dtype=np.float32), (K, 1, 1))  # Tcw
        self.kf_timestamp = np.zeros(K, np.float64)
        self.kf_frame_id = np.zeros(K, np.int64)
        self.kf_kp_xy = np.zeros((K, S, 2), np.float32)   # undistorted level-0
        self.kf_kp_octave = np.zeros((K, S), np.int32)
        self.kf_kp_angle = np.zeros((K, S), np.float32)
        self.kf_kp_ur = np.full((K, S), -1.0, np.float32)
        self.kf_kp_depth = np.full((K, S), -1.0, np.float32)
        self.kf_desc = np.zeros((K, S, 32), np.uint8)
        self.kf_kp_valid = np.zeros((K, S), bool)
        self.kf_obs = np.full((K, S), -1, np.int32)       # slot -> point id
        # spanning tree (KeyFrame::mpParent / mspChildrens, KeyFrame.h:75-85):
        # parent = top covisible KF at first connection update; surgically
        # reassigned on erase (SetBadFlag).  Loop edges (mspLoopEdges) persist
        # across loop events and keep feeding the essential graph.
        self.kf_parent = np.full(K, -1, np.int32)
        self.kf_first_connection = np.ones(K, bool)
        self.loop_edges: set = set()   # undirected (min_kid, max_kid) pairs
        # keyframe row recycling: erase_keyframe frees the row; add_keyframe
        # reuses freed rows before growing the high-water mark _next_kf, so a
        # long sequence that allocates-then-culls never exhausts the table
        # (the reference's KeyFrames simply live on the heap,
        # KeyFrame.cpp:456-548).  kf_gen bumps on every (re)allocation —
        # holders of a kid across an unlocked window compare generations,
        # mirroring pt_gen.
        self.kf_gen = np.zeros(K, np.int64)
        self._kf_free: list = []
        self._next_kf = 0
        # creation order of the keyframe in each row (KeyFrame::mnId): rows
        # are recycled, so only this counter says which keyframe is newer
        self.kf_seq = np.full(K, -1, np.int64)
        self._next_kf_seq = 0
        # callbacks fired at the end of erase_keyframe(kid) — the keyframe
        # database and other id-keyed side tables must drop their entry
        # before the row can be recycled
        self.erase_hooks: list = []
        # incremental observation index: pid -> {kf: slot}.  kf_obs stays the
        # source of truth for batched reads; the index makes per-point
        # lookups (observations_of / erase_point) O(#obs) instead of a full
        # (K, S) scan, which dominated keyframe creation
        self._pt_obs: dict = {}
        # coarse change counter: bumped by the mapper/loop-closer after a
        # batch of mutations (keyframe processed, loop corrected, GBA
        # committed).  Consumers holding device copies of map data (the
        # tracker's speculated candidate set) re-upload only when it moved.
        self.version = 0

    # ------------------------------------------------------------- points
    def add_point(self, pos, desc, ref_kf, normal=None, min_dist=0.0, max_dist=1.0):
        pid = self._alloc_pt()
        self.pt_gen[pid] += 1
        self.pt_alive[pid] = True
        self.pt_pos[pid] = pos
        self.pt_desc[pid] = desc
        self.pt_normal[pid] = normal if normal is not None else (0, 0, 1)
        self.pt_min_dist[pid] = min_dist
        self.pt_max_dist[pid] = max_dist
        self.pt_nobs[pid] = 0
        self.pt_visible[pid] = 1
        self.pt_found[pid] = 1
        self.pt_first_kf[pid] = ref_kf
        self.pt_ref_kf[pid] = ref_kf
        return pid

    def _alloc_pt(self):
        # linear scan from cursor; wraps once (free-list light)
        P = self.max_points
        for _ in range(P):
            pid = self._next_pt
            self._next_pt = (self._next_pt + 1) % P
            if not self.pt_alive[pid]:
                return pid
        raise RuntimeError("map point capacity exhausted")

    def _alloc_pts_batch(self, n):
        """n free rows in cursor order (same policy as _alloc_pt, one
        vectorized scan instead of n linear ones)."""
        P = self.max_points
        free = np.flatnonzero(~self.pt_alive)
        if len(free) < n:
            raise RuntimeError("map point capacity exhausted")
        # rotate so allocation continues from the cursor, like _alloc_pt
        k = np.searchsorted(free, self._next_pt)
        free = np.concatenate([free[k:], free[:k]])[:n]
        self._next_pt = (int(free[-1]) + 1) % P
        return free

    def add_points_batch(self, kid, slots, positions, scale_factors,
                         n_levels):
        """Create ONE new single-observation map point per (kid, slot) —
        the CreateNewKeyFrame close-point spawn (Tracking.cpp:1301-1332) —
        with every per-point field written vectorized.  Equivalent to
        add_point + add_observation + init_point_single_obs per slot
        (which cost ~17 ms/keyframe of host loops at ~200 points).
        Returns the new pids aligned with `slots`."""
        slots = np.asarray(slots, np.int64)
        n = len(slots)
        if n == 0:
            return np.zeros(0, np.int64)
        pids = self._alloc_pts_batch(n)
        self.pt_gen[pids] += 1
        self.pt_alive[pids] = True
        self.pt_pos[pids] = positions
        self.pt_desc[pids] = self.kf_desc[kid, slots]
        self.pt_visible[pids] = 1
        self.pt_found[pids] = 1
        self.pt_first_kf[pids] = kid
        self.pt_ref_kf[pids] = kid
        # single-obs normal/depth (init_point_single_obs, vectorized)
        center = self.camera_center(kid)
        nvec = positions - center[None, :]
        d = np.maximum(np.linalg.norm(nvec, axis=1), 1e-9)
        self.pt_normal[pids] = nvec / d[:, None]
        sf = np.asarray(scale_factors, np.float32)
        lv = self.kf_kp_octave[kid, slots]
        self.pt_max_dist[pids] = d * sf[lv]
        self.pt_min_dist[pids] = self.pt_max_dist[pids] / sf[n_levels - 1]
        # observations: displace any stale pid the slot still referenced
        # (dead or zero-obs points pass the caller's create filter), then
        # write the fresh ones
        for slot in slots[self.kf_obs[kid, slots] >= 0]:
            old = int(self.kf_obs[kid, slot])
            self._pt_obs.get(old, {}).pop(int(kid), None)
        self.kf_obs[kid, slots] = pids
        stereo = self.kf_kp_ur[kid, slots] >= 0
        self.pt_nobs[pids] = np.where(stereo, 2, 1)
        for pid, slot in zip(pids, slots):
            self._pt_obs[int(pid)] = {int(kid): int(slot)}
        return pids

    def add_observation(self, kf, slot, pid):
        old = self.kf_obs[kf, slot]
        if old == pid:
            return
        if old >= 0:
            self._pt_obs.get(int(old), {}).pop(int(kf), None)
        # one observation per (point, keyframe), like MapPoint::mObservations
        # being a map<KeyFrame*, idx>: displace any previous slot of pid in kf
        obs = self._pt_obs.setdefault(int(pid), {})
        prev_slot = obs.get(int(kf))
        if prev_slot is not None and prev_slot != int(slot):
            self.kf_obs[kf, prev_slot] = -1
            self.pt_nobs[pid] -= 2 if self.kf_kp_ur[kf, prev_slot] >= 0 else 1
        self.kf_obs[kf, slot] = pid
        obs[int(kf)] = int(slot)
        # stereo observations count twice (MapPoint::AddObservation semantics)
        self.pt_nobs[pid] += 2 if self.kf_kp_ur[kf, slot] >= 0 else 1

    def erase_observation(self, kf, slot):
        pid = self.kf_obs[kf, slot]
        if pid < 0:
            return
        self.kf_obs[kf, slot] = -1
        self._pt_obs.get(int(pid), {}).pop(int(kf), None)
        self.pt_nobs[pid] -= 2 if self.kf_kp_ur[kf, slot] >= 0 else 1
        # MapPoint::EraseObservation: die below 2 observations
        if self.pt_nobs[pid] <= 2 and self.pt_alive[pid]:
            self.erase_point(pid)

    def erase_point(self, pid):
        self.pt_alive[pid] = False
        for k, s in self._pt_obs.pop(int(pid), {}).items():
            self.kf_obs[k, s] = -1

    def observations_of(self, pid):
        """Returns (kf_ids, slots) observing pid."""
        obs = self._pt_obs.get(int(pid), {})
        if not obs:
            return (np.array([], np.int64), np.array([], np.int64))
        kfs = np.fromiter(obs.keys(), np.int64, len(obs))
        slots = np.fromiter(obs.values(), np.int64, len(obs))
        order = np.argsort(kfs)
        return kfs[order], slots[order]

    def rebuild_obs_index(self):
        """Recompute the pid->{kf: slot} index from kf_obs (checkpoint load)."""
        self._pt_obs = {}
        for k, s in zip(*np.nonzero(self.kf_obs >= 0)):
            self._pt_obs.setdefault(int(self.kf_obs[k, s]), {})[int(k)] = int(s)

    def replace_point(self, old, new, deferred=None):
        """MapPoint::Replace — forward observations, merge counters, then
        refresh the survivor's descriptor.  With ``deferred`` (a list) that
        refresh is left to ``refresh_descriptors(deferred)``: the survivor
        goes on the list with its observations as they stand."""
        if old == new:
            return
        kfs, slots = self.observations_of(old)
        new_obs = self._pt_obs.setdefault(int(new), {})
        for k, s in zip(kfs, slots):
            if int(k) not in new_obs:
                self.kf_obs[k, s] = new
                new_obs[int(k)] = int(s)
                self.pt_nobs[new] += 2 if self.kf_kp_ur[k, s] >= 0 else 1
            else:
                self.kf_obs[k, s] = -1
        self._pt_obs.pop(int(old), None)
        self.pt_visible[new] += self.pt_visible[old]
        self.pt_found[new] += self.pt_found[old]
        self.pt_alive[old] = False
        if deferred is None:
            self.compute_distinctive_descriptor(new)
        else:
            deferred.append((int(new), dict(new_obs)))

    def compute_distinctive_descriptor(self, pid):
        """Min-median-Hamming among observing keyframes' descriptors
        (MapPoint::ComputeDistinctiveDescriptors)."""
        kfs, slots = self.observations_of(pid)
        if len(kfs) == 0:
            return
        descs = self.kf_desc[kfs, slots]  # (M, 32)
        if len(descs) == 1:
            self.pt_desc[pid] = descs[0]
            return
        bits = np.unpackbits(descs[:, None, :] ^ descs[None, :, :], axis=-1)
        dist = bits.sum(-1)  # (M, M)
        medians = np.median(dist, axis=1)
        self.pt_desc[pid] = descs[int(np.argmin(medians))]

    def init_point_single_obs(self, pid, kid, slot, scale_factors, n_levels):
        """O(1) fast path for a just-created point with exactly ONE observing
        keyframe: equivalent to compute_distinctive_descriptor (the single
        descriptor wins) + update_normal_and_depth, without observations_of's
        full (K, S) table scan — that scan made keyframe creation O(points x
        K x S)."""
        pos = self.pt_pos[pid]
        center = self.camera_center(kid)
        n = pos - center
        d = float(np.linalg.norm(n))
        self.pt_normal[pid] = n / max(d, 1e-9)
        level = int(self.kf_kp_octave[kid, slot])
        self.pt_max_dist[pid] = d * scale_factors[level]
        self.pt_min_dist[pid] = self.pt_max_dist[pid] / scale_factors[n_levels - 1]
        self.pt_desc[pid] = self.kf_desc[kid, slot]
        self.pt_ref_kf[pid] = kid

    def update_normal_and_depth(self, pid, scale_factors, n_levels):
        """MapPoint::UpdateNormalAndDepth."""
        kfs, slots = self.observations_of(pid)
        if len(kfs) == 0 or self.pt_ref_kf[pid] < 0:
            return
        pos = self.pt_pos[pid]
        centers = -np.einsum("kij,ki->kj", self.kf_pose[kfs, :3, :3].transpose(0, 2, 1),
                             self.kf_pose[kfs, :3, 3])
        normals = pos[None] - centers
        norms = np.linalg.norm(normals, axis=1, keepdims=True)
        normals = normals / np.maximum(norms, 1e-9)
        self.pt_normal[pid] = normals.mean(axis=0)
        ref = self.pt_ref_kf[pid]
        if not self.kf_alive[ref]:
            ref = kfs[0]
            self.pt_ref_kf[pid] = ref
        ref_center = -self.kf_pose[ref, :3, :3].T @ self.kf_pose[ref, :3, 3]
        dist = float(np.linalg.norm(pos - ref_center))
        ref_slot = slots[kfs == ref]
        level = int(self.kf_kp_octave[ref, ref_slot[0]]) if len(ref_slot) else 0
        sf = scale_factors[level]
        self.pt_max_dist[pid] = dist * sf
        self.pt_min_dist[pid] = self.pt_max_dist[pid] / scale_factors[n_levels - 1]

    def refresh_points(self, pids, scale_factors, n_levels):
        """compute_distinctive_descriptor then update_normal_and_depth for
        every point of pids (duplicates once), as array operations over the
        set, with the per-point pair's results bit for bit.  A point's
        refresh reads only its own observations and row and writes only its
        own row, so the order of the points does not matter.
        ``scale_factors`` is the float32 array the mapper holds.

        The points are grouped by their observation count M, so each group
        is a dense (G, M) block: np.median and argmin keep their exact
        semantics (the mean of the middle pair for even M, the first index
        on ties) with no padding, and every floating-point step is the same
        numpy operation on the same layout as in the per-point pair."""
        pids = np.unique(np.asarray(pids, np.int64))
        empty = {}
        obs = [self._pt_obs.get(p, empty) for p in pids.tolist()]
        groups, kfs, slots = self._observation_groups(obs)
        if not groups:
            return
        descs = self.kf_desc[kfs, slots]
        # the keyframes' centres once, by update_normal_and_depth's two
        # expressions: the observers' for the normal, the reference's for
        # the depth bounds
        rows = np.arange(self._next_kf)
        centers = -np.einsum("kij,ki->kj", self.kf_pose[rows, :3, :3].transpose(0, 2, 1),
                             self.kf_pose[rows, :3, 3])
        ref_centers = np.array([self.camera_center(k) for k in rows.tolist()])
        sf = np.asarray(scale_factors, np.float32)
        for sel, at in groups:
            self._distinctive_descriptors(pids[sel], descs[at])
            keep = self.pt_ref_kf[pids[sel]] >= 0
            if keep.any():
                self._normals_and_depth(pids[sel[keep]], kfs[at[keep]], slots[at[keep]],
                                        centers, ref_centers, sf, n_levels)

    def refresh_descriptors(self, deferred):
        """The descriptor refreshes that replace_point left on ``deferred``
        (and empties it), each as compute_distinctive_descriptor made it
        when it was left: from the observations recorded then, which later
        commits may have added to.  A point left more than once keeps its
        last refresh that had observations, as the per-point writes leave
        it.  Exact while nothing has read those points' descriptors since
        they were left."""
        last = {pid: obs for pid, obs in deferred if obs}
        deferred.clear()
        groups, kfs, slots = self._observation_groups(list(last.values()))
        pids = np.fromiter(last, np.int64, len(last))
        descs = self.kf_desc[kfs, slots]
        for sel, at in groups:
            self._distinctive_descriptors(pids[sel], descs[at])

    def _observation_groups(self, obs):
        """Every point's observations in one pass (obs: one {kf: slot} per
        point), each point's in keyframe order as observations_of gives
        them (argmin's ties depend on it), grouped by their count M.
        Returns ([(points of the group, (G, M) index into kfs and slots)],
        kfs, slots)."""
        counts = np.fromiter(map(len, obs), np.int64, len(obs))
        n = int(counts.sum())
        kfs = np.fromiter(itertools.chain.from_iterable(obs), np.int64, n)
        slots = np.fromiter(itertools.chain.from_iterable(o.values() for o in obs),
                            np.int64, n)
        order = np.argsort(np.repeat(np.arange(len(obs)), counts)
                           * self.max_keyframes + kfs)
        starts = np.cumsum(counts) - counts
        groups = []
        for M in np.unique(counts[counts > 0]).tolist():
            sel = np.flatnonzero(counts == M)
            groups.append((sel, starts[sel][:, None] + np.arange(M)))
        return groups, kfs[order], slots[order]

    def _distinctive_descriptors(self, pids, descs):
        """compute_distinctive_descriptor for G points of M observations
        each (descs: (G, M, 32)), in blocks of at most _XOR_BLOCK bytes of
        XOR."""
        G, M = descs.shape[:2]
        best = np.zeros(G, np.int64)
        if M > 1:
            words = np.ascontiguousarray(descs).view(np.uint64)     # (G, M, 4)
            step = max(1, _XOR_BLOCK // (M * M * 32))
            for i in range(0, G, step):
                w = words[i:i + step]
                x = w[:, :, None, :] ^ w[:, None, :, :]
                bits = (np.bitwise_count(x) if hasattr(np, "bitwise_count")
                        else POPCOUNT8[x.view(np.uint8)])
                dist = bits.sum(-1, dtype=np.int64)               # (g, M, M)
                best[i:i + step] = np.argmin(np.median(dist, axis=2), axis=1)
        self.pt_desc[pids] = descs[np.arange(G), best]

    def _normals_and_depth(self, pids, kfs, slots, centers, ref_centers, sf, n_levels):
        """update_normal_and_depth for G points of M observations each, all
        with a reference keyframe (kfs, slots: (G, M), keyframe order)."""
        pos = self.pt_pos[pids]
        normals = pos[:, None] - centers[kfs]
        norms = np.linalg.norm(normals, axis=2, keepdims=True)
        normals = normals / np.maximum(norms, 1e-9)
        self.pt_normal[pids] = normals.mean(axis=1)
        # a dead reference falls back to the first observer
        ref = self.pt_ref_kf[pids]
        ref = np.where(self.kf_alive[ref], ref, kfs[:, 0]).astype(np.int32)
        self.pt_ref_kf[pids] = ref
        diff = pos - ref_centers[ref]
        # one np.dot per row, as np.linalg.norm of a vector takes it
        dist = np.sqrt(np.matmul(diff[:, None, :], diff[:, :, None])[:, 0, 0])
        hit = kfs == ref[:, None]
        j = hit.argmax(axis=1)
        level = np.where(hit.any(axis=1),
                         self.kf_kp_octave[ref, slots[np.arange(len(pids)), j]], 0)
        self.pt_max_dist[pids] = dist * sf[level]
        self.pt_min_dist[pids] = self.pt_max_dist[pids] / sf[n_levels - 1]

    # --------------------------------------------------------- keyframes
    def add_keyframe(self, frame):
        """Snapshot a Frame (core/frame.py) into the keyframe table."""
        if self._kf_free:
            kid = self._kf_free.pop()
            # scrub the recycled row (fresh rows are zero-initialized)
            self.kf_kp_valid[kid] = False
            self.kf_obs[kid] = -1
            self.kf_kp_ur[kid] = -1.0
            self.kf_kp_depth[kid] = -1.0
            self.kf_parent[kid] = -1
            self.kf_first_connection[kid] = True
        else:
            kid = self._next_kf
            if kid >= self.max_keyframes:
                raise RuntimeError("keyframe capacity exhausted")
            self._next_kf += 1
        self.kf_gen[kid] += 1
        self.kf_seq[kid] = self._next_kf_seq
        self._next_kf_seq += 1
        self.kf_alive[kid] = True
        self.kf_pose[kid] = frame.Tcw
        self.kf_timestamp[kid] = frame.timestamp
        self.kf_frame_id[kid] = frame.frame_id
        S = min(self.n_slots, len(frame.kp_xy))
        self.kf_kp_xy[kid, :S] = frame.kp_xy[:S]
        self.kf_kp_octave[kid, :S] = frame.octave[:S]
        self.kf_kp_angle[kid, :S] = frame.angle[:S]
        self.kf_kp_ur[kid, :S] = frame.u_right[:S]
        self.kf_kp_depth[kid, :S] = frame.depth[:S]
        self.kf_desc[kid, :S] = frame.desc[:S]
        self.kf_kp_valid[kid, :S] = frame.valid[:S]
        obs = frame.map_points[:S].copy()
        self.kf_obs[kid, :S] = np.where(frame.valid[:S], obs, -1)
        for slot in np.flatnonzero(self.kf_obs[kid] >= 0):
            pid = self.kf_obs[kid, slot]
            if self.pt_alive[pid]:
                obs = self._pt_obs.setdefault(int(pid), {})
                if int(kid) in obs:  # duplicate slot for pid in this KF: drop
                    self.kf_obs[kid, slot] = -1
                    continue
                self.pt_nobs[pid] += 2 if self.kf_kp_ur[kid, slot] >= 0 else 1
                obs[int(kid)] = int(slot)
            else:
                self.kf_obs[kid, slot] = -1
        return kid

    def update_spanning_tree(self, kid):
        """First-connection parent assignment (KeyFrame::UpdateConnections,
        KeyFrame.cpp:373-381: parent = the top covisible keyframe)."""
        if kid == 0 or not self.kf_first_connection[kid]:
            return
        w = self.covisibility_weights(kid)
        w[kid:] = 0  # parent must precede the child (acyclic by construction)
        best = int(np.argmax(w))
        if w[best] > 0:
            self.kf_parent[kid] = best
            self.kf_first_connection[kid] = False

    def children_of(self, kid):
        return np.flatnonzero((self.kf_parent == kid) & self.kf_alive)

    def add_loop_edge(self, a, b):
        """KeyFrame::AddLoopEdge both ways (KeyFrame.cpp:404-410)."""
        self.loop_edges.add((min(int(a), int(b)), max(int(a), int(b))))

    def has_loop_edges(self, kid):
        return any(kid in e for e in self.loop_edges)

    def erase_keyframe(self, kid, force=False):
        """KeyFrame::SetBadFlag (KeyFrame.cpp:456-548): drop observations,
        then reassign this keyframe's children to new parents — iteratively
        pick the (child, parent-candidate) pair with the highest covisibility
        weight, the adopted child joining the candidate set; leftovers fall
        back to the erased keyframe's own parent.

        force=True bypasses the id-0 / loop-edge protection (used only to
        roll back a just-created keyframe on failed initialization)."""
        if not force and (kid == 0 or self.has_loop_edges(kid)):
            return  # mnId==0 / loop-edge keyframes are never erased
        for slot in np.flatnonzero(self.kf_obs[kid] >= 0):
            self.erase_observation(kid, slot)

        parent = int(self.kf_parent[kid])
        candidates = {parent} if parent >= 0 and self.kf_alive[parent] else set()
        children = set(int(c) for c in self.children_of(kid))
        while children and candidates:
            best_w, best_c, best_p = 0, -1, -1
            for c in children:
                w = self.covisibility_weights(c)
                # candidate must be among the child's connected keyframes
                # (GetVectorCovisibleKeyFrames ~ weight >= COVIS_TH)
                for p in candidates:
                    if w[p] >= COVIS_TH and w[p] > best_w:
                        best_w, best_c, best_p = int(w[p]), c, p
            if best_c < 0:
                break
            self.kf_parent[best_c] = best_p
            candidates.add(best_c)
            children.discard(best_c)
        for c in children:  # KeyFrame.cpp:535-539
            self.kf_parent[c] = parent
        self.kf_alive[kid] = False
        # points whose reference keyframe dies re-anchor to their first
        # remaining observer (MapPoint::UpdateNormalAndDepth picks a live
        # observation lazily in the reference; with row recycling the lazy
        # check would see the RECYCLED keyframe as alive, so re-anchor now)
        for pid in np.flatnonzero((self.pt_ref_kf == kid) & self.pt_alive):
            kfs, _ = self.observations_of(int(pid))
            self.pt_ref_kf[pid] = int(kfs[0]) if len(kfs) else -1
        for hook in self.erase_hooks:
            hook(int(kid))
        self._kf_free.append(int(kid))

    def kf_capacity_left(self) -> bool:
        """True if add_keyframe can allocate (a free recycled row exists or
        the high-water mark has headroom)."""
        return bool(self._kf_free) or self._next_kf < self.max_keyframes

    def keyframe_ids(self):
        return np.flatnonzero(self.kf_alive)

    def n_keyframes(self):
        return int(self.kf_alive.sum())

    def n_points(self):
        return int(self.pt_alive.sum())

    def camera_center(self, kid):
        R = self.kf_pose[kid, :3, :3]
        t = self.kf_pose[kid, :3, 3]
        return -R.T @ t

    # ------------------------------------------------------- covisibility
    def covisibility_weights(self, kid):
        """#shared map points between kid and every other keyframe: (K,) int32.

        Scans only the ALLOCATED keyframe rows (ids are never reused, so
        [0, _next_kf) covers every live row) — against the full capacity-
        padded table this host scan dominated the per-frame covisibility
        votes."""
        K = self._next_kf
        obs = self.kf_obs[kid]
        pids = obs[obs >= 0]
        w = np.zeros(self.max_keyframes, np.int32)
        if len(pids) == 0 or K == 0:
            return w
        seen = np.zeros(self.max_points, bool)
        seen[pids] = True
        tab = self.kf_obs[:K]
        shared = seen[np.where(tab >= 0, tab, 0)] & (tab >= 0)
        w[:K] = shared.sum(axis=1).astype(np.int32)
        w[kid] = 0
        w[:K][~self.kf_alive[:K]] = 0
        return w

    def covisible_keyframes(self, kid, n=None, min_weight=COVIS_TH):
        w = self.covisibility_weights(kid)
        ids = np.flatnonzero(w >= min_weight)
        ids = ids[np.argsort(-w[ids], kind="stable")]
        if n is not None:
            ids = ids[:n]
        if len(ids) == 0:  # KeyFrame::UpdateConnections: keep the best anyway
            best = int(np.argmax(w))
            if w[best] > 0:
                ids = np.array([best])
        return ids, w

    def covisible_neighbors_batch(self, kids, n=10, min_weight=COVIS_TH):
        """covisible_keyframes for MANY keyframes in one (B, K, S) pass.

        The per-frame local-keyframe vote expands the top-20 keyframes'
        neighbors (Tracking::UpdateLocalKeyFrames); calling
        covisible_keyframes per keyframe costs 20 full kf_obs scans — this
        batches them into one gather.  Returns a list of np arrays (same
        contract as covisible_keyframes[0], incl. the best-anyway
        fallback)."""
        kids = np.asarray(kids, np.int64)
        B = len(kids)
        if B == 0:
            return []
        K = self._next_kf
        obs_rows = self.kf_obs[kids]                      # (B, S)
        valid = obs_rows >= 0
        seen = np.zeros((B, self.max_points), bool)
        seen[np.repeat(np.arange(B), valid.sum(1)), obs_rows[valid]] = True
        tab = self.kf_obs[:K]                             # allocated rows only
        mask = tab >= 0
        w = np.zeros((B, self.max_keyframes), np.int32)
        w[:, :K] = (seen[:, np.where(mask, tab, 0)] & mask[None]).sum(-1)
        w[np.arange(B), kids] = 0
        w[:, :K][:, ~self.kf_alive[:K]] = 0
        out = []
        for b in range(B):
            ids = np.flatnonzero(w[b] >= min_weight)
            ids = ids[np.argsort(-w[b][ids], kind="stable")][:n]
            if len(ids) == 0:
                best = int(np.argmax(w[b]))
                ids = np.array([best]) if w[b][best] > 0 \
                    else np.array([], np.int64)
            out.append(ids)
        return out

    def tracked_points_in_kf(self, kid, min_obs):
        """KeyFrame::TrackedMapPoints(minObs)."""
        obs = self.kf_obs[kid]
        pids = obs[obs >= 0]
        pids = pids[self.pt_alive[pids]]
        if min_obs <= 0:
            return len(pids)
        return int((self.pt_nobs[pids] >= min_obs).sum())
