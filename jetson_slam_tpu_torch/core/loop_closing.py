"""Loop closing: detection, Sim3 computation, loop correction, global BA.

Port of ``jetson_slam_tpu/core/loop_closing.py``, the replacement for
src/LoopClosing.cpp:
- `detect_loop`     <- LoopClosing::DetectLoop (:108-234): min covisible BoW
  score, database query, 3-consecutive covisibility-group consistency.
- `compute_sim3`    <- LoopClosing::ComputeSim3 (:236-405): per-candidate
  brute-force matches -> Sim3 RANSAC -> guided projection >= threshold.
- `correct_loop`    <- LoopClosing::CorrectLoop (:407-590): Sim3 propagation
  over the current covisibility group, duplicate fusion, essential-graph
  optimization (core/pose_graph.py), then full BA.
The reference runs this as a thread polling a queue (:62-89); here it is a
stage invoked per mapped keyframe, after local mapping, synchronously or on
the async mapping worker.

The graph bookkeeping is host numpy on the MapStore, as in the JAX
package; the matchers, the Sim(3) RANSAC and LM, the pose graph and the
global BA run on the closer's device, each result read back with one
``pull``.  The Sim(3) RANSAC draws its minimal samples from a
``torch.Generator`` on the device, seeded once with 0 and advanced once
per candidate that reaches RANSAC (``_sim3_sample``), where the JAX
package splits a PRNG key.  The asynchronous global BA solves on a
transient thread with its own CUDA stream; the snapshot and the solution
cross as numpy, and the commit takes the map lock.  Over a process group
(``mesh``) the global BA is sharded by ``parallel/dist_ba.py`` on a group
of the closer's own.
"""
from __future__ import annotations

import contextlib
import importlib
import threading

import numpy as np
import torch
import torch.distributed as dist

from ..bow.database import KeyFrameDatabase
from ..utils.lie import project_so3_np
from ..utils.profiling import span
from . import matcher
from .frame import pull
from .local_ba import local_ba
from .local_mapping import _bucket, check_distribution_options, fuse_into
from .map import MapStore
from .optimizer import sim3_optimization
from .pnp_solver import draw_samples
from .pose_graph import pose_graph_optimize
from .sim3_solver import sim3_ransac

COVIS_CONSISTENCY_TH = 3  # reference LoopClosing.cpp:48


class LoopCloser:
    SIM3_HYPOTHESES = 128

    def __init__(self, map_store: MapStore, database: KeyFrameDatabase, cam,
                 geom, device, sensor="stereo", run_gba=True, mesh=None):
        """``mesh`` (a torch.distributed ProcessGroup) of more than one rank
        solves the full-map BA landmark-sharded over a group of its own,
        made here with ``dist.new_group`` over the mesh's ranks: the async
        GBA runs on its own thread, and on the mapper's group its
        collectives would interleave with local BA's in another order on
        each rank.  Every rank must build its LoopCloser in the same order
        (``new_group`` is a collective call)."""
        check_distribution_options(mesh=mesh)
        self._dist_ba = None
        if mesh is not None and dist.get_world_size(mesh) > 1:
            from ..parallel.dist_ba import DistBA
            group = dist.new_group(ranks=dist.get_process_group_ranks(mesh),
                                   backend=dist.get_backend(mesh))
            self._dist_ba = DistBA(group, device=device)
        self.map = map_store
        self.db = database
        self.cam = cam
        self.geom = geom
        self.device = torch.device(device)
        self.sensor = sensor
        self.run_gba = run_gba
        self.consistent_groups: list[tuple[set, int]] = []
        # culled keyframes must leave the BoW database before their row can
        # be recycled (KeyFrameDatabase::erase on SetBadFlag in the reference)
        map_store.erase_hooks.append(self._on_kf_erased)
        # async GBA: set async_gba=True (and gba_lock to the map lock) to
        # run the post-loop full BA on a transient thread with catch-up
        # correction, like the reference's mpThreadGBA
        self.async_gba = False
        self.gba_lock = None
        self._gba_threads: list[threading.Thread] = []
        self.gba_launched = 0      # asynchronous GBAs started
        self.gba_dropped = 0       # ... whose commit a later loop made stale
        # every correct_loop starts a new generation; a GBA solved for an
        # older one is dropped at its commit (mnFullBAIdx)
        self._loop_gen = 0
        # creation counter (MapStore.kf_seq) of the last loop's keyframe:
        # rows are recycled, so the spacing gate counts keyframes created
        self.last_loop_seq = -1
        self.sigma2 = np.asarray(geom.scales, np.float32) ** 2
        self.n_loops_closed = 0
        self._gen = torch.Generator(device=self.device)
        self._gen.manual_seed(0)
        # The forward-mode rule of an op in exp_sim3 runs through a
        # torch._refs wrapper that imports torch._dynamo on its first call:
        # left to sim3_optimization, that import would stall the first loop
        # closure (8 s on the H100 machine's host, chip_smoke.py's
        # LoopProbe).  Import it once here, when the session is built.
        importlib.import_module("torch._dynamo")
        # the async GBA's own stream, beside the tracker's and the mapper's
        self._gba_stream = (torch.cuda.Stream(self.device)
                            if self.device.type == "cuda" else None)

    def _t(self, a):
        """A host array as a tensor on the closer's device."""
        return torch.as_tensor(np.ascontiguousarray(a), device=self.device)

    def _sim3_sample(self, n_valid: int):
        """Minimal samples of one Sim(3) RANSAC: (H, 3) positions into the
        pool of n_valid matches (reduced modulo n_valid by the solver)."""
        return draw_samples(self._gen, (self.SIM3_HYPOTHESES, 3), self.device)

    def join_gba(self, timeout: float = 120.0):
        """Wait for every asynchronous GBA still running, an abandoned one
        included (System.cpp:326 waits for mpThreadGBA)."""
        for t in self._gba_threads:
            t.join(timeout=timeout)
        self._gba_threads = [t for t in self._gba_threads if t.is_alive()]

    # ------------------------------------------------------------------
    @span("mapping.loop_closing")
    def process_keyframe(self, kid: int):
        """Returns True if a loop was detected and corrected."""
        with span("mapping.loop_detect"):
            self.db.add(kid, self._kf_descs(kid))
            seq = int(self.map.kf_seq[kid])
            if self.map.n_keyframes() < 10 or seq < self.last_loop_seq + 10:
                return False
            candidates = self.detect_loop(kid)
        if len(candidates) == 0:
            return False
        ok, loop_kf, s, R, t, matched = self.compute_sim3(kid, candidates)
        if not ok:
            return False
        self.correct_loop(kid, loop_kf, s, R, t, matched)
        self.last_loop_seq = seq
        self.n_loops_closed += 1
        return True

    def _on_kf_erased(self, kid: int):
        if self.db is not None and self.db.has[kid]:
            self.db.erase(kid)

    def _kf_descs(self, kid):
        m = self.map
        sel = m.kf_kp_valid[kid]
        return m.kf_desc[kid][sel]

    # ------------------------------------------------------------------
    def detect_loop(self, kid):
        """LoopClosing::DetectLoop (:108-234)."""
        m = self.map
        neigh, w = m.covisible_keyframes(kid, n=None)
        # Under the async pipeline the tracker may have inserted a NEWER
        # covisible keyframe that this worker has not processed yet, so it
        # has no BoW vector in the database.  The reference never sees this
        # state because BoW is computed before covisibility edges exist
        # (LocalMapping::ProcessNewKeyFrame, LocalMapping.cpp:134-174:
        # ComputeBoW precedes UpdateConnections); here covisibility derives
        # live from kf_obs, so skip not-yet-added neighbors explicitly.
        min_score = 1.0
        for nk in neigh:
            if not self.db.has[int(nk)]:
                continue
            s = self.db.score(kid, int(nk))
            min_score = min(min_score, s)
        cand = self.db.detect_loop_candidates(kid, min_score, neigh, m)
        if len(cand) == 0:
            self.consistent_groups = []
            return []
        # covisibility-group temporal consistency >= 3 (one batched
        # covisibility pass for all candidates)
        consistent_enough = []
        new_groups = []
        neighborhoods = m.covisible_neighbors_batch(cand, n=10)
        for c, gn in zip(cand, neighborhoods):
            group = {int(c)}
            group.update(int(x) for x in gn)
            best_consistency = 0
            for prev_group, count in self.consistent_groups:
                if group & prev_group:
                    best_consistency = max(best_consistency, count + 1)
            new_groups.append((group, best_consistency))
            if best_consistency >= COVIS_CONSISTENCY_TH:
                consistent_enough.append(int(c))
        self.consistent_groups = new_groups
        return consistent_enough

    # ------------------------------------------------------------------
    @span("mapping.loop_sim3")
    def compute_sim3(self, kid, candidates):
        """LoopClosing::ComputeSim3 (:236-405).

        Per candidate: brute-force matches (>= 20) -> Sim3 RANSAC (>= 20
        inliers) -> SearchBySim3 mutual-projection enrichment
        (ORBmatcher.cpp:1089-1313, th=7.5) -> Sim3 LM refinement on the
        enriched set (>= 20 inliers) -> guided projection of the loop
        region's map points under the corrected pose, accepting only with
        >= 40 TOTAL matches (LoopClosing.cpp:355-390).

        Returns (ok, loop_kf, s, R, t, matched) where matched maps current-KF
        slots to loop-region point ids (the reference's
        mvpCurrentMatchedPoints, consumed by correct_loop).
        """
        m = self.map
        fix_scale = self.sensor != "mono"
        cam = (self.cam.fx, self.cam.fy, self.cam.cx, self.cam.cy)
        # vocabulary node ids at levelsup bucket the SearchByBoW candidates
        # (ORBmatcher.cpp:155-165 FeatureVector iteration)
        node_kid = None
        if self.db is not None:
            _, _, node_kid = self.db.vocab.transform(m.kf_desc[kid])
            node_kid = self._t(node_kid)

        def cam_pts(kf, pids):
            return m.pt_pos[pids] @ m.kf_pose[kf, :3, :3].T + m.kf_pose[kf, :3, 3]

        for cand in candidates:
            node_cand = None
            if self.db is not None:
                _, _, node_cand = self.db.vocab.transform(m.kf_desc[cand])
                node_cand = self._t(node_cand)
            match, = pull([matcher.match_brute_force(
                self._t(m.kf_desc[kid]),
                self._t(m.kf_kp_valid[kid] & (m.kf_obs[kid] >= 0)),
                self._t(m.kf_kp_angle[kid]),
                self._t(m.kf_desc[cand]),
                self._t(m.kf_kp_valid[cand] & (m.kf_obs[cand] >= 0)),
                self._t(m.kf_kp_angle[cand]), nn_ratio=0.75,
                node_a=node_kid, node_b=node_cand)[0]])
            slots1 = np.flatnonzero(match >= 0)
            if len(slots1) < 20:
                continue
            slots2 = match[slots1]
            p1 = m.kf_obs[kid, slots1]
            p2 = m.kf_obs[cand, slots2]
            good = (p1 >= 0) & (p2 >= 0)
            good[good] &= m.pt_alive[p1[good]] & m.pt_alive[p2[good]]
            if good.sum() < 20:
                continue
            slots1, slots2 = slots1[good], slots2[good]
            P1 = cam_pts(kid, p1[good])
            P2 = cam_pts(cand, p2[good])
            N = len(P1)
            th1 = 9.210 * self.sigma2[m.kf_kp_octave[kid, slots1]]
            th2 = 9.210 * self.sigma2[m.kf_kp_octave[cand, slots2]]
            s, R, t, inl, n_inl = pull(sim3_ransac(
                self._t(P1.astype(np.float32)), self._t(P2.astype(np.float32)),
                torch.ones(N, dtype=torch.bool, device=self.device), cam, cam,
                self._t(th1), self._t(th2), self._sim3_sample(N),
                fix_scale=fix_scale))
            if int(n_inl) < 20:
                continue
            # SearchBySim3 enrichment: RANSAC's S maps CURRENT-cam points
            # into the CANDIDATE frame (p_cand = s R p_cur + t), i.e. S21 in
            # the reference's (1=current, 2=candidate) convention; invert it
            # for the S12 the matcher expects.
            s_np = float(s)
            s12 = 1.0 / s_np
            R12 = R.T
            t12 = -(R12 @ t) / s_np
            already1 = np.zeros(m.n_slots, bool)
            already2 = np.zeros(m.n_slots, bool)
            already1[slots1[inl]] = True
            already2[slots2[inl]] = True
            enrich = self._search_by_sim3(kid, cand, s12, R12, t12, already1,
                                          already2)
            # merged pair list: RANSAC inliers + mutually-agreed enrichments
            e1 = np.flatnonzero(enrich >= 0)
            slots1 = np.concatenate([slots1[inl], e1]).astype(np.int64)
            slots2 = np.concatenate([slots2[inl], enrich[e1]]).astype(np.int64)
            if len(slots1) < 20:
                continue
            p1 = m.kf_obs[kid, slots1]
            p2 = m.kf_obs[cand, slots2]
            P1 = cam_pts(kid, p1)
            P2 = cam_pts(cand, p2)
            # Sim3 LM refinement on the enriched matches
            # (Optimizer::OptimizeSim3, Optimizer.cpp:1051-1248).
            # sim3_optimization refines S mapping its SECOND point set into
            # its FIRST (q1 = s R p2 + t), so the candidate set rides first
            # to keep the same current->candidate transform throughout.
            obs1 = m.kf_kp_xy[kid, slots1]
            obs2 = m.kf_kp_xy[cand, slots2]
            inv1 = 1.0 / self.sigma2[m.kf_kp_octave[kid, slots1]]
            inv2 = 1.0 / self.sigma2[m.kf_kp_octave[cand, slots2]]
            s, R, t, inl, n_inl = pull(sim3_optimization(
                self._t(P2.astype(np.float32)), self._t(P1.astype(np.float32)),
                self._t(obs2.astype(np.float32)), self._t(obs1.astype(np.float32)),
                self._t(inv2.astype(np.float32)), self._t(inv1.astype(np.float32)),
                torch.ones(len(slots1), dtype=torch.bool, device=self.device),
                float(s), self._t(R), self._t(t),
                self.cam.fx, self.cam.fy, self.cam.cx, self.cam.cy,
                fix_scale=fix_scale))
            if int(n_inl) < 20:
                continue
            matched = {int(sl): int(pid)
                       for sl, pid in zip(slots1[inl], p2[inl])}
            # guided projection over the loop region under the corrected
            # pose; >= 40 TOTAL gate (LoopClosing.cpp:355-390)
            s_np = float(s)
            found = self._guided_loop_matches(kid, int(cand), s_np, R, t,
                                              matched)
            total = len(matched) + len(found)
            if total < 40:
                continue
            matched.update(found)
            return True, int(cand), s_np, R, t, matched
        return False, -1, 1.0, np.eye(3), np.zeros(3), {}

    def _search_by_sim3(self, kid, cand, s12, R12, t12, already1, already2):
        """Host-side wrapper building the dense slot arrays for
        matcher.search_by_sim3; returns the per-KF1-slot match as numpy."""
        m = self.map
        g = self.geom

        def side(kf, already):
            obs = m.kf_obs[kf]
            safe = np.maximum(obs, 0)
            has = (obs >= 0) & m.pt_alive[safe] & ~already & m.kf_kp_valid[kf]
            return tuple(self._t(a) for a in (
                m.kf_kp_xy[kf], m.kf_kp_octave[kf], m.kf_desc[kf],
                m.kf_kp_valid[kf], m.pt_pos[safe], m.pt_desc[safe], has,
                m.pt_min_dist[safe], m.pt_max_dist[safe]))

        return pull([matcher.search_by_sim3(
            *side(kid, already1), *side(cand, already2),
            self._t(m.kf_pose[kid, :3, :3]), self._t(m.kf_pose[kid, :3, 3]),
            self._t(m.kf_pose[cand, :3, :3]), self._t(m.kf_pose[cand, :3, 3]),
            float(s12), self._t(np.asarray(R12, np.float32)),
            self._t(np.asarray(t12, np.float32)),
            7.5, self._t(np.asarray(g.scales, np.float32)), g.n_levels,
            0.0, float(g.widths[0]), 0.0, float(g.heights[0]),
            self.cam.fx, self.cam.fy, self.cam.cx, self.cam.cy,
            float(np.log(g.scale_factor)))])[0]

    def _corrected_pose(self, loop_kf, s, R, t):
        """Corrected world->current SE3 from the loop KF pose and the
        current->loop Sim3 (LoopClosing.cpp:432-440 mg2oScw semantics)."""
        m = self.map
        R_lw = m.kf_pose[loop_kf, :3, :3]
        t_lw = m.kf_pose[loop_kf, :3, 3]
        si, Ri, ti = 1.0 / s, R.T, -(R.T @ t) / s
        R_cw = Ri @ R_lw
        t_cw = si * (Ri @ t_lw) + ti
        return R_cw, t_cw

    def _guided_loop_matches(self, kid, loop_kf, s, R, t, matched):
        """SearchByProjection(KeyFrame*, Scw, loop points, ...) with th=10
        (LoopClosing.cpp:380): project every map point observed by the loop
        KF and its covisible neighbors into the current KF under the
        corrected pose.  Returns {current slot: loop pid} for NEW matches."""
        m = self.map
        g = self.geom
        loop_group, _ = m.covisible_keyframes(loop_kf, n=None)
        loop_kids = np.concatenate([[loop_kf], loop_group]).astype(np.int64)
        obs = m.kf_obs[loop_kids]
        pids = np.unique(obs[obs >= 0])
        pids = pids[m.pt_alive[pids]]
        pids = pids[~np.isin(pids, list(matched.values()))]
        if len(pids) == 0:
            return {}
        R_cw, t_cw = self._corrected_pose(loop_kf, s, R, t)
        Ow = -R_cw.T @ t_cw
        f32 = lambda a: self._t(np.asarray(a, np.float32))
        ok, u, v, invz, lvl, vcos = matcher.frustum_check(
            self._t(m.pt_pos[pids]), self._t(m.pt_normal[pids]),
            self._t(m.pt_max_dist[pids]), self._t(m.pt_min_dist[pids]),
            f32(R_cw), f32(t_cw), f32(Ow),
            self.cam.fx, self.cam.fy, self.cam.cx, self.cam.cy,
            0.0, float(g.widths[0]), 0.0, float(g.heights[0]),
            g.n_levels, float(np.log(g.scale_factor)), 0.5,
            torch.ones(len(pids), dtype=torch.bool, device=self.device))
        cur_free = np.ones(m.n_slots, bool)
        cur_free[list(matched.keys())] = False
        sel, = pull([matcher.search_loop_projection(
            u, v, lvl, ok, self._t(m.pt_desc[pids]),
            self._t(m.kf_kp_xy[kid]), self._t(m.kf_kp_octave[kid]),
            self._t(m.kf_desc[kid]), self._t(m.kf_kp_valid[kid]),
            self._t(cur_free), 10.0, f32(g.scales))])
        return {int(slot): int(pids[sel[slot]])
                for slot in np.flatnonzero(sel >= 0)}

    # ------------------------------------------------------------------
    @span("mapping.loop_correct")
    def correct_loop(self, kid, loop_kf, s, R, t, matched=None):
        """LoopClosing::CorrectLoop (:407-590).

        (s, R, t) maps current-KF camera coords into loop-KF camera coords.
        The corrected world->current pose is that Sim3 inverted composed with
        the loop-KF pose; we propagate the correction delta over the current
        covisible group, attach the matched loop points, fuse duplicates,
        persist the loop edge, optimize the essential graph (measurements
        from PRE-correction poses), then run full BA (the reference spawns a
        GBA thread; synchronous here unless an AsyncGBA runner is attached).

        matched: {current slot: loop pid} from compute_sim3
        (mvpCurrentMatchedPoints) — those points replace/extend the current
        KF's associations before fusion (LoopClosing.cpp:522-538).
        """
        m = self.map
        # a GBA still solving was set up before this correction: it stops
        # at its next LM iteration, its commit is dropped, and a new GBA
        # follows this one (LoopClosing.cpp's mbStopGBA / mnFullBAIdx)
        self._loop_gen += 1
        # snapshot EVERY keyframe pose before the correction: the essential
        # graph measures its non-loop edges from these (the reference's
        # NonCorrectedSim3 for the group; unchanged poses for the rest,
        # Optimizer.cpp:888-950)
        pre_poses = m.kf_pose.copy()

        R_cw_new, t_cw_new = self._corrected_pose(loop_kf, s, R, t)

        T_old = m.kf_pose[kid].copy()
        R_old, t_old = T_old[:3, :3], T_old[:3, 3]

        # propagate delta to the covisible group (reference :447-520)
        group, _ = m.covisible_keyframes(kid, n=None, min_weight=1)
        group = np.concatenate([[kid], group]).astype(np.int64)
        corrected = {}
        for k in group:
            R_kw = m.kf_pose[k, :3, :3]
            t_kw = m.kf_pose[k, :3, 3]
            # T_kc = T_kw * T_cw_old^-1 ; corrected T_kw' = T_kc * S_cw_new
            R_kc = R_kw @ R_old.T
            t_kc = t_kw - R_kc @ t_old
            R_new = R_kc @ R_cw_new
            t_new = R_kc @ t_cw_new + t_kc
            corrected[int(k)] = (R_new, t_new)
        # correct the group's map points with their KF's old->new transform;
        # first observer in group order wins (the reference's mnCorrectedByKF
        # stamp, LoopClosing.cpp:462-480).  One batched transform per group
        # keyframe — at 50k points the per-point Python loop this replaces
        # stalled the worker for seconds.
        owner = np.full(m.max_points, -1, np.int64)
        owned = []
        for k in group:
            obs = m.kf_obs[k]
            pids = obs[obs >= 0]
            pids = pids[m.pt_alive[pids]]
            fresh = pids[owner[pids] < 0]
            owner[fresh] = k
            owned.append(fresh)
        for k, pids in zip(group, owned):
            if len(pids) == 0:
                continue
            R_new, t_new = corrected[int(k)]
            R_kw = m.kf_pose[k, :3, :3]
            t_kw = m.kf_pose[k, :3, 3]
            pc = m.pt_pos[pids] @ R_kw.T + t_kw
            m.pt_pos[pids] = (pc - t_new) @ R_new
        for k in group:
            R_new, t_new = corrected[int(k)]
            m.kf_pose[k, :3, :3] = project_so3_np(R_new)
            m.kf_pose[k, :3, 3] = t_new

        # attach the matched loop points to the current keyframe: loop point
        # replaces the slot's existing point (LoopClosing.cpp:522-538)
        for slot, lpid in (matched or {}).items():
            if not m.pt_alive[lpid]:
                continue
            cur_pid = m.kf_obs[kid, slot]
            if cur_pid >= 0 and m.pt_alive[cur_pid] and cur_pid != lpid:
                m.replace_point(int(cur_pid), int(lpid))
            elif cur_pid < 0:
                m.add_observation(kid, slot, int(lpid))

        # fuse duplicated points between loop region and current region
        loop_group, _ = m.covisible_keyframes(loop_kf, n=10)
        loop_pids = []
        for k in np.concatenate([[loop_kf], loop_group]).astype(np.int64):
            o = m.kf_obs[k]
            loop_pids.append(o[o >= 0])
        if loop_pids:
            loop_pids = np.unique(np.concatenate(loop_pids))
            for k in group:
                fuse_into(m, self.cam, self.geom, self.device, int(k), loop_pids)

        # persist the loop edge (KeyFrame::AddLoopEdge both ways,
        # LoopClosing.cpp:617-618): it survives into every later essential
        # graph solve and protects both keyframes from culling
        m.add_loop_edge(kid, loop_kf)

        # essential graph optimization over all alive keyframes
        self._optimize_essential_graph(kid, loop_kf, pre_poses,
                                       set(int(k) for k in group))
        m.version += 1
        if self.run_gba:
            if self.async_gba:
                # reference: transient GBA thread; mapping continues and
                # gets caught up at commit (LoopClosing.cpp:650-754)
                self.launch_async_gba(lock=self.gba_lock)
            else:
                self.global_bundle_adjustment()

    # ------------------------------------------------------------------
    def _essential_edges(self, kids):
        """Essential-graph edge set (Optimizer::OptimizeEssentialGraph,
        Optimizer.cpp:888-990): spanning-tree edges, persisted loop edges,
        and strong covisibility edges (weight >= 100).  Returns a list of
        (i, j, kind) index pairs with kind in {"tree", "loop", "covis"}."""
        m = self.map
        pos = {int(k): i for i, k in enumerate(kids)}
        edges = {}

        def add(a, b, kind):
            key = (min(a, b), max(a, b))
            if key not in edges:
                edges[key] = kind

        # persisted loop edges first (KeyFrame::GetLoopEdges) so a pair that
        # is both a tree and a loop edge keeps the loop label
        for a, b in m.loop_edges:
            if a in pos and b in pos:
                add(pos[a], pos[b], "loop")
        # spanning tree (KeyFrame::GetParent)
        for k in kids:
            p = int(m.kf_parent[k])
            if p >= 0 and p in pos:
                add(pos[int(k)], pos[p], "tree")
        # strong covisibility edges
        for k in kids:
            w = m.covisibility_weights(int(k))
            for k2 in np.flatnonzero(w >= 100):
                if int(k2) in pos and int(k2) != int(k):
                    add(pos[int(k)], pos[int(k2)], "covis")
        return [(a, b, kind) for (a, b), kind in sorted(edges.items())]

    def _optimize_essential_graph(self, kid, loop_kf, pre_poses=None,
                                  group=None):
        """pre_poses: kf_pose snapshot from BEFORE the Sim3 propagation —
        non-loop edges measure their relative poses from it (the reference's
        NonCorrectedSim3 path).  The new loop-closure constraints (the
        kid<->loop_kf edge and fresh current-group <-> loop-region
        connections) measure from the CORRECTED poses, so they pull the rest
        of the graph toward the corrected geometry."""
        m = self.map
        kids = m.keyframe_ids()
        K = len(kids)
        if K < 3:
            return
        if pre_poses is None:
            pre_poses = m.kf_pose
        if group is None:
            group = {int(kid)}
        pos = {int(k): i for i, k in enumerate(kids)}
        loop_group, _ = m.covisible_keyframes(loop_kf, n=None)
        loop_set = {int(loop_kf)} | {int(x) for x in loop_group} - group
        edges = self._essential_edges(kids)
        cur_loop_edge = (min(pos[kid], pos[loop_kf]),
                         max(pos[kid], pos[loop_kf]))
        if not any((a, b) == cur_loop_edge for a, b, _ in edges):
            edges.append((*cur_loop_edge, "loop"))
        Rs = m.kf_pose[kids, :3, :3].astype(np.float32)
        ts = m.kf_pose[kids, :3, 3].astype(np.float32)
        ss = np.ones(K, np.float32)
        kid_of = {i: int(k) for i, k in enumerate(kids)}

        def rel_inverse(Ra, ta, Rb, tb):
            R_ij = Ra @ Rb.T
            t_ij = ta - R_ij @ tb
            return R_ij.T, -(R_ij.T @ t_ij)

        e_i, e_j, mi_R, mi_t, mi_s = [], [], [], [], []
        for a, b, kind in edges:
            ka, kb = kid_of[a], kid_of[b]
            # loop-closure constraints (the new edge, plus any edge bridging
            # the corrected group and the loop region) measure from the
            # corrected poses; everything else from the pre-correction snapshot
            bridges = ((ka in group) != (kb in group)) and \
                (ka in loop_set or kb in loop_set or (a, b) == cur_loop_edge)
            src = m.kf_pose if bridges or (a, b) == cur_loop_edge else pre_poses
            Ri, ti_ = src[ka, :3, :3], src[ka, :3, 3]
            Rj, tj_ = src[kb, :3, :3], src[kb, :3, 3]
            iR, it = rel_inverse(Ri, ti_, Rj, tj_)
            e_i.append(a); e_j.append(b)
            mi_R.append(iR); mi_t.append(it); mi_s.append(1.0)
        e_i = np.array(e_i, np.int32)
        e_j = np.array(e_j, np.int32)
        fixed = np.zeros(K, bool)
        fixed[pos[loop_kf]] = True
        s2, R2, t2 = pull(pose_graph_optimize(
            self._t(ss), self._t(Rs), self._t(ts), self._t(fixed),
            self._t(e_i), self._t(e_j), self._t(np.array(mi_s, np.float32)),
            self._t(np.stack(mi_R).astype(np.float32)),
            self._t(np.stack(mi_t).astype(np.float32)),
            torch.ones(len(e_i), dtype=torch.bool, device=self.device),
            n_iters=20, fix_scale=self.sensor != "mono"))
        # apply with point correction via reference keyframes
        self._apply_corrected_poses(kids, R2, t2, s2)

    def _apply_corrected_poses(self, kids, R2, t2, s2):
        m = self.map
        old_R = m.kf_pose[kids, :3, :3].copy()
        old_t = m.kf_pose[kids, :3, 3].copy()
        pos_of = np.full(m.max_keyframes, -1, np.int64)
        pos_of[kids] = np.arange(len(kids))
        # move every point with its reference KF's old->new transform, one
        # batched einsum (the per-point loop was O(points) host time per
        # loop event); points whose ref fell outside the solve re-anchor to
        # their first observer (rare — erase_keyframe re-anchors eagerly)
        alive = np.flatnonzero(m.pt_alive)
        ref = m.pt_ref_kf[alive].astype(np.int64)
        idx = np.where(ref >= 0, pos_of[np.maximum(ref, 0)], -1)
        for j in np.flatnonzero(idx < 0):
            kfs, _ = m.observations_of(int(alive[j]))
            if len(kfs):
                idx[j] = pos_of[int(kfs[0])]
        sel = idx >= 0
        pids, i = alive[sel], idx[sel]
        pc = np.einsum("nij,nj->ni", old_R[i], m.pt_pos[pids]) + old_t[i]
        # Sim3 inverse: p_w = (1/s) R^T (p_c - t); s == 1 for stereo
        m.pt_pos[pids] = np.einsum("nji,nj->ni", R2[i], pc - t2[i]) \
            / s2[i][:, None]
        for i, k in enumerate(kids):
            m.kf_pose[k, :3, :3] = project_so3_np(R2[i])
            m.kf_pose[k, :3, 3] = t2[i]

    # ------------------------------------------------------------------
    def global_bundle_adjustment(self, its=10):
        """Optimizer::GlobalBundleAdjustemnt via the Schur LM (full map),
        synchronous: prepare -> solve -> commit in place."""
        prep = self._gba_prepare(its)
        if prep is None:
            return
        sol = self._gba_solve(prep)
        self._gba_commit(prep, sol)

    def launch_async_gba(self, its=10, lock=None):
        """The reference's transient GBA thread
        (LoopClosing::RunGlobalBundleAdjustment, LoopClosing.cpp:650-754):
        snapshot the problem now (the caller holds the map lock), solve on a
        separate thread and its own CUDA stream WITHOUT the lock so mapping
        and tracking go on, then commit under the lock with spanning-tree
        catch-up of the keyframes and points created during the solve.
        A GBA set up before the latest correct_loop is abandoned
        (LoopClosing's mbStopGBA): its solve stops at the next LM iteration,
        and its commit is dropped.  Returns the started Thread, or None when
        the problem is too small or a GBA of the latest correction still
        runs."""
        gen = self._loop_gen
        self._gba_threads = [t for t in self._gba_threads if t.is_alive()]
        if any(t.loop_gen == gen for t in self._gba_threads):
            return None
        prep = self._gba_prepare(its)
        if prep is None:
            return None
        prep["loop_gen"] = gen
        lock = lock if lock is not None else contextlib.nullcontext()
        stream = self._gba_stream

        def run():
            ctx = (torch.cuda.stream(stream) if stream is not None
                   else contextlib.nullcontext())
            # a sharded solve is entered on every rank, and its agreed stop
            # flag ends a stale one; a rank may not skip it alone
            if gen != self._loop_gen and self._dist_ba is None:
                self.gba_dropped += 1
                return
            with ctx:
                sol = self._gba_solve(prep)   # device work, no map access
            with lock:
                if gen == self._loop_gen:
                    self._gba_commit(prep, sol)
                else:
                    self.gba_dropped += 1

        t = threading.Thread(target=run, name="gba", daemon=True)
        t.loop_gen = gen
        self._gba_threads.append(t)
        self.gba_launched += 1
        t.start()
        return t

    @span("mapping.gba")
    def _gba_prepare(self, its=10):
        """Snapshot the full-map BA problem (call under the map lock)."""
        m = self.map
        kids = m.keyframe_ids()
        pids = np.flatnonzero(m.pt_alive)
        if len(kids) < 3 or len(pids) < 30:
            return None
        # vectorized edge-list build (one (K, S) pass, no Python loops)
        pos_p_of = np.full(m.max_points, -1, np.int64)
        pos_p_of[pids] = np.arange(len(pids))
        rows = m.kf_obs[kids]                              # (K, S)
        has = rows >= 0
        has[has] = m.pt_alive[rows[has]]
        kk, e_slot = np.nonzero(has)
        E = len(kk)
        if E < 50:
            return
        e_cam = kk.astype(np.int32)
        e_pt = pos_p_of[rows[kk, e_slot]].astype(np.int32)
        e_kf = kids[kk]
        kp_ur = m.kf_kp_ur[e_kf, e_slot]
        obs_arr = np.stack([
            m.kf_kp_xy[e_kf, e_slot, 0], m.kf_kp_xy[e_kf, e_slot, 1],
            np.where(kp_ur >= 0, kp_ur, 0.0)], 1).astype(np.float32)
        inv_s2 = (1.0 / self.sigma2)[m.kf_kp_octave[e_kf, e_slot]]
        # bucket every problem dimension (see local_mapping._bucket)
        C_real, P = len(kids), len(pids)
        C_pad = _bucket(C_real, 8)
        P_pad = _bucket(P, 64)
        E_pad = _bucket(E, 256)
        deg = np.bincount(e_pt, minlength=P)
        D = _bucket(int(deg.max()), 4)
        pt_edges = np.full((P_pad, D), -1, np.int32)
        # ranked scatter: edges sorted by point, each edge's rank within its
        # point = position in the row (replaces the per-edge Python fill)
        order = np.argsort(e_pt, kind="stable")
        ep_sorted = e_pt[order]
        starts = np.concatenate([[0], np.cumsum(deg)[:-1]])
        rank = np.arange(E) - starts[ep_sorted]
        pt_edges[ep_sorted, rank] = order.astype(np.int32)
        fixed = np.ones(C_pad, bool)
        fixed[1:C_real] = False
        Rs = np.tile(np.eye(3, dtype=np.float32), (C_pad, 1, 1))
        ts = np.zeros((C_pad, 3), np.float32)
        Rs[:C_real] = m.kf_pose[kids, :3, :3]
        ts[:C_real] = m.kf_pose[kids, :3, 3]
        pt_pos = np.zeros((P_pad, 3), np.float32)
        pt_pos[:P] = m.pt_pos[pids]

        def padE(a, fillv=0):
            out = np.full((E_pad,) + a.shape[1:], fillv, a.dtype)
            out[:E] = a
            return out

        return dict(kids=kids, pids=pids, fixed=fixed, Rs=Rs, ts=ts,
                    pt_pos=pt_pos, e_cam=padE(e_cam), e_pt=padE(e_pt),
                    obs_arr=padE(obs_arr), is_stereo=padE(kp_ur >= 0),
                    inv_s2=padE(inv_s2.astype(np.float32), 1.0),
                    e_valid=padE(np.ones(E, bool)), pt_edges=pt_edges,
                    its=its, P=P,
                    # snapshot watermark: keyframes/points allocated after
                    # this need catch-up correction at commit
                    next_kf=m._next_kf,
                    pt_gen=m.pt_gen[pids].copy())

    @span("mapping.gba")
    def _gba_solve(self, prep):
        """The device LM over the snapshot; touches no map state.  An
        asynchronous one (its snapshot carries ``loop_gen``) stops early
        once a later correct_loop has made the snapshot stale."""
        gen = prep.get("loop_gen")
        stop = None if gen is None else (lambda: self._loop_gen != gen)
        if self._dist_ba is not None:
            return self._dist_ba.solve(
                *(prep[k] for k in ("Rs", "ts", "fixed", "pt_pos", "e_cam", "e_pt",
                                    "obs_arr", "is_stereo", "inv_s2", "e_valid")),
                self.cam.fx, self.cam.fy, self.cam.cx, self.cam.cy, self.cam.bf,
                its1=5, its2=prep["its"], stop=stop)[:3]
        R2, t2, p2, _ = pull(local_ba(
            *(self._t(prep[k]) for k in (
                "Rs", "ts", "fixed", "pt_pos", "e_cam", "e_pt", "obs_arr",
                "is_stereo", "inv_s2", "e_valid", "pt_edges")),
            self.cam.fx, self.cam.fy, self.cam.cx, self.cam.cy,
            self.cam.bf, its1=5, its2=prep["its"], stop=stop))
        return R2, t2, p2

    @span("mapping.gba")
    def _gba_commit(self, prep, sol):
        """Write the solved poses/points back and catch up everything
        created while the solve ran (LoopClosing.cpp:698-754): keyframes
        outside the snapshot inherit their spanning-tree ancestor's
        old->new correction; points outside it move with their reference
        keyframe."""
        m = self.map
        R2, t2, p2 = sol
        kids, pids, fixed = prep["kids"], prep["pids"], prep["fixed"]
        P = prep["P"]
        in_gba = np.zeros(m.max_keyframes, bool)
        in_gba[kids] = True
        old_R = m.kf_pose[kids, :3, :3].copy()
        old_t = m.kf_pose[kids, :3, 3].copy()
        pos_c = {int(k): i for i, k in enumerate(kids)}

        def corrected(i):
            if fixed[i]:
                return m.kf_pose[kids[i], :3, :3], m.kf_pose[kids[i], :3, 3]
            return R2[i], t2[i]

        # keyframes created during the solve: T_new = T_child * T_anc_old^-1
        # * T_anc_new via the nearest spanning-tree ancestor in the snapshot
        for k in m.keyframe_ids():
            if in_gba[k]:
                continue
            anc = int(m.kf_parent[k])
            hops = 0
            while anc >= 0 and not in_gba[anc] and hops < 64:
                anc = int(m.kf_parent[anc])
                hops += 1
            if anc < 0 or not in_gba[anc]:
                continue
            i = pos_c[anc]
            Ra_new, ta_new = corrected(i)
            T_ck_R = m.kf_pose[k, :3, :3] @ old_R[i].T
            T_ck_t = m.kf_pose[k, :3, 3] - T_ck_R @ old_t[i]
            m.kf_pose[k, :3, :3] = project_so3_np(T_ck_R @ Ra_new)
            m.kf_pose[k, :3, 3] = T_ck_R @ ta_new + T_ck_t

        # points created (or re-allocated) during the solve: move with
        # their reference keyframe's old->new transform
        gen_ok = np.zeros(m.max_points, bool)
        gen_ok[pids] = m.pt_gen[pids] == prep["pt_gen"]
        for pid in np.flatnonzero(m.pt_alive & ~gen_ok):
            ref = int(m.pt_ref_kf[pid])
            if ref not in pos_c:
                continue
            i = pos_c[ref]
            Rn, tn = corrected(i)
            pc = old_R[i] @ m.pt_pos[pid] + old_t[i]
            m.pt_pos[pid] = Rn.T @ (pc - tn)

        # snapshot members: write solved values (skipping recycled pids)
        for i, k in enumerate(kids):
            if not fixed[i] and m.kf_alive[k]:
                m.kf_pose[k, :3, :3] = project_so3_np(R2[i])
                m.kf_pose[k, :3, 3] = t2[i]
        keep = m.pt_alive[pids] & gen_ok[pids]
        m.pt_pos[pids[keep]] = p2[:P][keep]
        m.version += 1
