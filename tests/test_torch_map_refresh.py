"""MapStore.refresh_points, the batched refresh of map points, against the
per-point pair it replaces (compute_distinctive_descriptor then
update_normal_and_depth), bit for bit:

- on hand-made maps that hold every case the grouping by observation
  count has to get right: M = 1, 2, odd and even, over 20; ties among the
  median Hamming distances (descriptors drawn from a pool of three); a
  reference keyframe that is dead, and one that does not observe the
  point; a point with no reference keyframe and one with no observations;
  observations registered out of keyframe order; duplicate pids;
- MapStore.refresh_descriptors, the fuse commits' descriptor refreshes
  left by replace_point for one batch, against replace_point refreshing
  at once, over a run of replacements and added observations (a survivor
  observed again after its refresh, replaced into twice, left with no
  observations);
- on the maps of port sessions on the CPU (stereo and RGB-D), over every
  live point;
- stage by stage: from a snapshot of a session's map before one of its
  keyframes, create_new_map_points then search_in_neighbors on two copies,
  one with the batched refreshes and one with the per-point ones restored:
  every pt_* and kf_* array, the observation index and the mapper's recent
  points equal.
"""
import copy

import numpy as np
import pytest
import torch

from jetson_slam_tpu_torch.config import SLAMConfig
from jetson_slam_tpu_torch.core.frame import Frame
from jetson_slam_tpu_torch.core.local_mapping import LocalMapper
from jetson_slam_tpu_torch.core.map import MapStore
from jetson_slam_tpu_torch.io.synthetic import make_stereo_sequence
from jetson_slam_tpu_torch.models.slam import SlamSystem
from jetson_slam_tpu_torch.utils import profiling

torch.set_num_threads(2)

SF = (1.2 ** np.arange(8)).astype(np.float32)
N_LEVELS = 8
REFRESHED = ("pt_desc", "pt_normal", "pt_max_dist", "pt_min_dist", "pt_ref_kf")
COUNTS = (0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 12, 16, 21, 24, 33, 40)


def _copy(m):
    """A deep copy of a map without its callbacks (a session's keyframe
    database hangs on erase_hooks)."""
    out = MapStore.__new__(MapStore)
    out.__dict__.update({k: copy.deepcopy(v) for k, v in vars(m).items()
                         if k != "erase_hooks"})
    out.erase_hooks = []
    return out


def _per_point(m, pids, sf=SF, n_levels=N_LEVELS):
    for pid in pids:
        m.compute_distinctive_descriptor(int(pid))
        m.update_normal_and_depth(int(pid), sf, n_levels)


def _rotation(rng):
    w = rng.normal(size=3) * rng.uniform(0.05, 1.5)
    th = np.linalg.norm(w)
    k = np.array([[0, -w[2], w[1]], [w[2], 0, -w[0]], [-w[1], w[0], 0]]) / th
    return np.eye(3) + np.sin(th) * k + (1 - np.cos(th)) * k @ k


def _hand_map(seed, n_kf=44, n_slots=96):
    """Keyframes with random poses, octaves and stereo flags, descriptors
    from a pool of three (ties) or random; four points for each count in
    COUNTS, observations added in random keyframe order; then some
    keyframes die, a point's reference is taken off its observers and one
    point loses its reference.  Returns the map and its special points."""
    rng = np.random.default_rng(seed)
    m = MapStore(max_points=512, max_keyframes=n_kf + 4, n_slots=n_slots)
    pool = rng.integers(0, 256, (3, 32), dtype=np.uint8)
    for k in range(n_kf):
        m.kf_alive[k] = True
        m.kf_pose[k, :3, :3] = _rotation(rng)
        m.kf_pose[k, :3, 3] = rng.normal(size=3) * 2
        m.kf_kp_octave[k] = rng.integers(0, N_LEVELS, n_slots)
        m.kf_kp_ur[k] = np.where(rng.random(n_slots) < 0.5, 100.0, -1.0)
        m.kf_kp_valid[k] = True
        if k % 2:
            m.kf_desc[k] = pool[rng.integers(0, 3, n_slots)]
        else:
            m.kf_desc[k] = rng.integers(0, 256, (n_slots, 32), dtype=np.uint8)
    m._next_kf = n_kf
    free = [list(rng.permutation(n_slots)) for _ in range(n_kf)]
    pids = []
    for M in COUNTS:
        for _ in range(4):
            kfs = rng.choice(n_kf, M, replace=False)
            ref = int(kfs[0]) if M else int(rng.integers(n_kf))
            pid = m.add_point(rng.normal(size=3).astype(np.float32) * 5,
                              pool[0], ref)
            for k in kfs:
                m.add_observation(int(k), int(free[k].pop()), pid)
            pids.append(pid)
    pids = np.asarray(pids)
    # dead reference keyframes: kill two keyframes without touching the
    # points' references (update_normal_and_depth falls back to the first
    # observer), one of them observing nothing any more
    for dead in (n_kf - 1, n_kf - 2):
        m.kf_alive[dead] = False
    observed_by = {int(p): set(m._pt_obs.get(int(p), {})) for p in pids}
    last = n_kf - 1
    for p in pids:
        if last in observed_by[int(p)]:
            m.erase_observation(last, m._pt_obs[int(p)][last])
    many = [p for p in pids if len(observed_by[int(p)]) >= 3]
    m.pt_ref_kf[many[0]] = last
    m.pt_ref_kf[many[1]] = n_kf - 2
    # a live reference that does not observe the point (level 0)
    outsider = next(k for k in range(n_kf - 2) if k not in observed_by[int(many[2])])
    m.pt_ref_kf[many[2]] = outsider
    # no reference keyframe: the descriptor is refreshed, the rest is not
    m.pt_ref_kf[many[3]] = -1
    return m, dict(dead_ref=many[:2], outsider=many[2], no_ref=many[3])


def _assert_refreshed_alike(a, b, names=REFRESHED):
    for name in names:
        assert np.array_equal(getattr(a, name), getattr(b, name)), name


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_refresh_points_equals_the_per_point_pair_on_hand_made_maps(seed):
    m, special = _hand_map(seed)
    pids = np.flatnonzero(m.pt_alive)
    counts = {len(m._pt_obs.get(int(p), {})) for p in pids}
    assert {0, 1, 2}.issubset(counts) and max(counts) > 20
    assert any(c % 2 for c in counts if c > 2) and any(c % 2 == 0 for c in counts if c > 2)
    # duplicates, out of order
    query = np.concatenate([pids[::-1], pids[::3], special["dead_ref"]])
    batched, per_point = _copy(m), _copy(m)
    batched.refresh_points(query, SF, N_LEVELS)
    _per_point(per_point, query)
    _assert_refreshed_alike(batched, per_point)
    # the cases were exercised: the dead references moved to the first
    # observer, the point without a reference kept it, and the refresh
    # changed the rows it should
    for p in special["dead_ref"]:
        first = min(m._pt_obs[int(p)])
        assert batched.pt_ref_kf[p] == first != m.pt_ref_kf[p]
    assert batched.pt_ref_kf[special["no_ref"]] == -1
    assert np.array_equal(batched.pt_normal[special["no_ref"]],
                          m.pt_normal[special["no_ref"]])
    assert not np.array_equal(batched.pt_normal, m.pt_normal)
    assert not np.array_equal(batched.pt_desc, m.pt_desc)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_deferred_descriptor_refreshes_equal_replace_point_at_once(seed):
    m, _ = _hand_map(seed)
    rng = np.random.default_rng(100 + seed)
    at_once, batched = _copy(m), _copy(m)
    deferred = []
    live = [int(p) for p in np.flatnonzero(m.pt_alive)]
    observed_again = 0
    for _ in range(60):
        old, new = (int(p) for p in rng.choice(live, 2, replace=False))
        live.remove(old)
        at_once.replace_point(old, new)
        batched.replace_point(old, new, deferred)
        # the survivor observed again after its refresh: the batch must
        # use the observations of the moment it was left
        kf = int(rng.integers(40))
        free = np.flatnonzero(at_once.kf_obs[kf] < 0)
        if kf not in at_once._pt_obs[new] and len(free) and rng.random() < 0.5:
            slot = int(free[rng.integers(len(free))])
            for mm in (at_once, batched):
                mm.add_observation(kf, slot, new)
            observed_again += 1
    survivors = [e[0] for e in deferred]
    assert len(set(survivors)) < len(survivors)          # some replaced into twice
    assert observed_again > 0
    batched.refresh_descriptors(deferred)
    assert deferred == []
    for name, v in vars(at_once).items():
        if name.startswith(("pt_", "kf_")):
            assert np.array_equal(getattr(batched, name), v), name
    assert batched._pt_obs == at_once._pt_obs


def test_refresh_points_without_numpy_bitwise_count(monkeypatch):
    """The byte table that stands in for np.bitwise_count (numpy < 2.0)."""
    m, _ = _hand_map(0)
    pids = np.flatnonzero(m.pt_alive)
    batched, per_point = _copy(m), _copy(m)
    monkeypatch.delattr(np, "bitwise_count", raising=False)
    batched.refresh_points(pids, SF, N_LEVELS)
    _per_point(per_point, pids)
    _assert_refreshed_alike(batched, per_point)


def test_refresh_points_with_nothing_to_refresh():
    m, _ = _hand_map(5)
    lonely = [p for p in np.flatnonzero(m.pt_alive) if not m._pt_obs.get(int(p))]
    assert lonely
    before = copy.deepcopy(m)
    m.refresh_points(np.asarray(lonely), SF, N_LEVELS)
    m.refresh_points(np.zeros(0, np.int64), SF, N_LEVELS)
    # a survivor left with no observations keeps its descriptor
    m.refresh_descriptors([(int(lonely[0]), {})])
    m.refresh_descriptors([])
    _assert_refreshed_alike(m, before)


# ---------------------------------------------------------------- sessions
def _stereo_config(seq):
    cfg = SLAMConfig()
    c = cfg.camera
    c.fx, c.fy, c.cx, c.cy, c.bf = seq.fx, seq.fy, seq.cx, seq.cy, seq.bf
    c.width, c.height = 320, 240
    c.k1 = c.k2 = c.p1 = c.p2 = 0.0
    c.th_depth = 40.0
    cfg.orb.n_levels = 3
    cfg.orb.tile_h = cfg.orb.tile_w = 16
    cfg.orb.th_fast_max = 15
    cfg.max_map_points = 16384
    cfg.max_keyframes = 64
    return cfg


def _rgbd_config(seq):
    """A denser RGB-D front end (tiles of 10, 4 levels): more slots and
    points a keyframe than the stereo size."""
    cfg = _stereo_config(seq)
    cfg.orb.n_levels, cfg.orb.tile_h, cfg.orb.tile_w = 4, 10, 10
    return cfg


def _session(sensor, n_frames):
    """A port session with synchronous mapping on the CPU; returns the
    system and a snapshot of the map and the mapper's recent points before
    each keyframe it mapped."""
    seq = make_stereo_sequence(seed=7, n_frames=n_frames, h=240, w=320,
                               trajectory="arc", n_points=900,
                               with_depth=sensor == "rgbd")
    snaps = []
    orig = LocalMapper.process_keyframe

    def process(self, kid, *args, **kw):
        snaps.append(dict(kid=kid, map=_copy(self.map),
                          recent=list(self.recent_points)))
        return orig(self, kid, *args, **kw)

    mp = pytest.MonkeyPatch()
    mp.setattr(LocalMapper, "process_keyframe", process)
    try:
        Frame._next_id = 0
        cfg = (_rgbd_config if sensor == "rgbd" else _stereo_config)(seq)
        slam = SlamSystem(cfg, sensor=sensor, device="cpu")
        for i in range(n_frames):
            if sensor == "rgbd":
                slam.track_rgbd(seq.lefts[i], seq.depths[i], seq.timestamps[i])
            else:
                slam.track_stereo(seq.lefts[i], seq.rights[i], seq.timestamps[i])
    finally:
        mp.undo()
    return slam, snaps


@pytest.fixture(scope="module", params=[("stereo", 20), ("rgbd", 12)], ids=["stereo", "rgbd"])
def session(request):
    sensor, n_frames = request.param
    return sensor, *_session(sensor, n_frames)


def test_refresh_points_equals_the_per_point_pair_on_a_session_map(session):
    _, slam, _ = session
    m = slam.map
    pids = np.flatnonzero(m.pt_alive)
    counts = np.array([len(m._pt_obs.get(int(p), {})) for p in pids])
    assert len(pids) > 200 and len(np.unique(counts)) >= 4
    batched, per_point = _copy(m), _copy(m)
    batched.refresh_points(pids, slam.local_mapper.scale_factors, slam.frontend.geom.n_levels)
    _per_point(per_point, pids, slam.local_mapper.scale_factors, slam.frontend.geom.n_levels)
    _assert_refreshed_alike(batched, per_point)


def _per_point_add_triangulated(self, kid, tri, pulled):
    """Phase C of create_new_map_points with each new point refreshed as it
    is made, by the per-point pair: the loop before the batch."""
    m = self.map
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
            m.compute_distinctive_descriptor(pid)
            m.update_normal_and_depth(pid, self.scale_factors, self.geom.n_levels)
            self.recent_points.append((pid, kid))
    return np.zeros(0, np.int64)


def _per_point_refresh(mapper, kid, stage):
    """The mapper's refresh as the per-point loops had it, whatever pids
    the batched stage passes: nothing after phase C (each point was
    refreshed as it was made), and in the fuse every live point of the
    keyframe."""
    def refresh(pids):
        if stage[0] == "search_in_neighbors":
            m = mapper.map
            for pid in np.unique(m.kf_obs[kid][m.kf_obs[kid] >= 0]):
                if m.pt_alive[pid]:
                    _per_point(m, [pid], mapper.scale_factors, mapper.geom.n_levels)
    return refresh


def _at_once(m):
    """replace_point refreshing the survivor's descriptor at once, as the
    fuse commits did before their refreshes were batched."""
    def replace_point(old, new, deferred=None):
        MapStore.replace_point(m, old, new)
    return replace_point


def test_mapping_stages_equal_the_per_point_loops(session):
    sensor, slam, snaps = session
    # the latest keyframe whose fuse had neighbours to work with
    snap = [s for s in snaps if s["map"].n_keyframes() >= 4][-1]
    kid = snap["kid"]
    mappers, stage = [], [None]
    for per_point in (False, True):
        mapper = LocalMapper(_copy(snap["map"]), slam.config.camera,
                             slam.frontend.geom, "cpu", sensor=sensor)
        if per_point:
            mapper._add_triangulated = _per_point_add_triangulated.__get__(mapper)
            mapper._refresh_points = _per_point_refresh(mapper, kid, stage)
            mapper.map.replace_point = _at_once(mapper.map)
        mapper.recent_points = list(snap["recent"])
        mapper.map.update_spanning_tree(kid)
        mapper._register_new_points(kid)
        mapper.cull_map_points(kid)
        mappers.append(mapper)
    profiling.RECORDER.reset()
    n_points = mappers[0].map.n_points()
    for stage[0] in ("create_new_map_points", "search_in_neighbors"):
        for mapper in mappers:
            getattr(mapper, stage[0])(kid)
        if stage[0] == "create_new_map_points":
            assert mappers[0].map.n_points() > n_points
        a, b = (mp.map for mp in mappers)
        for name, v in vars(b).items():
            if name.startswith(("pt_", "kf_")):
                assert np.array_equal(getattr(a, name), v), (stage[0], name)
        assert a._pt_obs == b._pt_obs, stage[0]
        assert mappers[0].recent_points == mappers[1].recent_points, stage[0]
    # the batches, each counted: the new points, then the commits'
    # descriptors and the keyframe's points in the fuse
    recs = list(profiling.RECORDER.records)
    spans = [r for r in recs if r.kind == "span" and r.name == "mapping.refresh_points"]
    counts = [r.value for r in recs if r.kind == "count"
              and r.name == "mapping.points_refreshed"]
    assert len(spans) == len(counts) >= 3 and min(counts) > 0
