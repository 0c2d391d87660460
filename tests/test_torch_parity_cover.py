"""Behaviours the JAX suite checks in tests/test_aux_subsystems.py and
tests/test_fused_track.py, run in the port and in the JAX package on the
CPU with the same inputs and held to the same outcome:

- ``covisible_neighbors_batch`` equals ``covisible_keyframes`` per
  keyframe, dead keyframes excluded, and the port's lists equal JAX's;
- keyframe rows recycle over 20 churn rounds of a table of 8 (more than
  2x its capacity): the same rows, generations and erase-hook calls;
- a keyframe table of 6 saturates on the first 20 frames of a 40-frame
  sequence without raising
  (the capacity gate of ``Tracker._need_new_keyframe``): the same states
  and keyframes created as JAX's;
- a pid culled and reallocated while the fused step runs without the map
  lock: the association dropped, the same victim and dropped slots;
- a teleport velocity: the fused step fails its gates, the frame is
  recovered by the reference-keyframe path with ``fused_frames``
  unchanged, in both;
- pipelined tracking (``pipeline_depth=2``, the first 12 frames of the
  25-frame arc): every map point a finished
  frame holds reprojects near its keypoint (median < 3 px, > 90 % within
  10 px), and the per-call states equal JAX's.

JAX's sessions run in this process's JAX child (``torch_sessions``),
on the same rendered frames.
"""
import numpy as np
import pytest

pytest.importorskip("jax")
import torch  # noqa: E402

from tests.torch_sessions import config, jax_session, stereo_frames  # noqa: E402

torch.set_num_threads(2)


# frames fed, of tests/test_aux_subsystems.py's 40 (the table of 6 is full
# from frame 15) and of tests/test_fused_track.py's 25
SATURATION_FRAMES = 20
PIPELINED_FRAMES = 12


def _modules(jax_package):
    if jax_package:
        from jetson_slam_tpu.config import SLAMConfig
        from jetson_slam_tpu.core.frame import Frame
        from jetson_slam_tpu.core.map import MapStore
        from jetson_slam_tpu.models.slam import SlamSystem
        return SLAMConfig, Frame, MapStore, SlamSystem, {}
    from jetson_slam_tpu_torch.config import SLAMConfig
    from jetson_slam_tpu_torch.core.frame import Frame
    from jetson_slam_tpu_torch.core.map import MapStore
    from jetson_slam_tpu_torch.models.slam import SlamSystem
    return SLAMConfig, Frame, MapStore, SlamSystem, dict(device="cpu")


def _system(jax_package, seq, **kw):
    SLAMConfig, Frame, _, SlamSystem, dev = _modules(jax_package)
    Frame._next_id = 0
    return SlamSystem(config(SLAMConfig(), seq), sensor="stereo", **dev, **kw)


class _F:
    """A stand-in frame for MapStore.add_keyframe."""

    def __init__(self, S):
        self.timestamp, self.frame_id = 0.0, 0
        self.Tcw = np.eye(4, dtype=np.float32)
        self.kp_xy = np.zeros((S, 2), np.float32)
        self.octave = np.zeros(S, np.int32)
        self.angle = np.zeros(S, np.float32)
        self.u_right = np.full(S, -1.0, np.float32)
        self.depth = np.full(S, -1.0, np.float32)
        self.desc = np.zeros((S, 32), np.uint8)
        self.valid = np.ones(S, bool)
        self.map_points = np.full(S, -1, np.int32)


# ---------------------------------------------------------------- map store
def covisibility(jax_package):
    MapStore = _modules(jax_package)[2]
    rng = np.random.default_rng(3)
    m = MapStore(max_points=256, max_keyframes=12, n_slots=32)
    kids = [m.add_keyframe(_F(32)) for _ in range(8)]
    pids = [m.add_point(np.zeros(3, np.float32), np.zeros(32, np.uint8), 0)
            for _ in range(120)]
    for k in kids:
        for slot, pid in enumerate(rng.choice(pids, size=24, replace=False)):
            m.add_observation(k, slot, int(pid))
    m.erase_keyframe(kids[-1])
    alive = kids[:-1]
    batch = m.covisible_neighbors_batch(alive, n=5)
    single = [m.covisible_keyframes(int(k), n=5)[0] for k in alive]
    return [list(map(int, b)) for b in batch], [list(map(int, s)) for s in single]


def test_covisible_neighbors_batch_matches_per_kf_and_jax():
    batch, single = covisibility(False)
    assert batch == single
    assert (batch, single) == covisibility(True)
    assert all(len(b) == 1 for b in batch)     # the best-anyway fallback


def recycling(jax_package):
    MapStore = _modules(jax_package)[2]
    m = MapStore(max_points=256, max_keyframes=8, n_slots=16)
    erased = []
    m.erase_hooks.append(erased.append)
    m.add_keyframe(_F(16))                 # the protected anchor
    live = [m.add_keyframe(_F(16)) for _ in range(5)]
    rows, gens, refs = [], [], []
    for _ in range(20):
        victim = live.pop(0)
        pid = m.add_point(np.zeros(3, np.float32), np.zeros(32, np.uint8), ref_kf=victim)
        m.add_observation(victim, 0, pid)
        m.erase_keyframe(victim)
        assert not m.kf_alive[victim] and erased[-1] == victim
        refs.append(int(m.pt_ref_kf[pid]) if m.pt_alive[pid] else -2)
        k = m.add_keyframe(_F(16))
        rows.append(int(k))
        gens.append(int(m.kf_gen[k]))
        live.append(k)
    return dict(rows=rows, gens=gens, refs=refs, erased=list(map(int, erased)),
                next_kf=int(m._next_kf), n_kf=int(m.n_keyframes()), total=6 + 20,
                cap=int(m.max_keyframes))


def test_keyframe_rows_recycle_as_jax():
    port = recycling(False)
    assert port["total"] > 2 * port["cap"]
    assert port["next_kf"] <= port["cap"] and port["n_kf"] == 6
    assert all(r != e for r, e in zip(port["refs"], port["erased"]))
    assert port == recycling(True)


# ----------------------------------------------------------------- sessions
def saturation(jax_package):
    SLAMConfig, Frame, _, SlamSystem, dev = _modules(jax_package)
    n = SATURATION_FRAMES
    seq = stereo_frames(11, 40, range(n), n_points=500, h=120, w=160)
    cfg = SLAMConfig()
    c = cfg.camera
    c.fx, c.fy, c.cx, c.cy, c.bf = seq.fx, seq.fy, seq.cx, seq.cy, seq.bf
    c.width, c.height = 160, 120
    c.k1 = c.k2 = c.p1 = c.p2 = 0.0
    c.th_depth = 40.0
    cfg.orb.n_levels, cfg.orb.tile_h, cfg.orb.tile_w = 3, 12, 12
    cfg.max_map_points, cfg.max_keyframes = 8192, 6
    Frame._next_id = 0
    slam = SlamSystem(cfg, sensor="stereo", **dev)
    states, created, capacity_left = [], [], []
    for i in range(n):
        states.append(slam.track_stereo(seq.lefts[i], seq.rights[i], seq.timestamps[i])[0].name)
        created.append(int(slam.map.kf_gen.sum()))
        capacity_left.append(bool(slam.map.kf_capacity_left()))
    slam.shutdown()
    return dict(states=states, created=created, capacity_left=capacity_left,
                next_kf=int(slam.map._next_kf))


def pid_reuse(jax_package):
    seq = stereo_frames(17, 10, range(7))
    slam = _system(jax_package, seq)
    tr = slam.tracker
    for i in range(6):
        slam.track_stereo(seq.lefts[i], seq.rights[i], seq.timestamps[i])
    imgs, t = (seq.lefts[6], seq.rights[6]), seq.timestamps[6]
    if jax_package:
        frame, fz = tr._dispatch_fused(imgs, t, "stereo")
    else:
        frame, fz = tr._finish_fused(tr._begin_fused(imgs, t))
    m = slam.map
    cur = np.flatnonzero(fz.sel >= 0)
    victim = int(tr._spec_pid[fz.sel[cur[0]]])
    matched = np.flatnonzero((fz.sel >= 0) & (tr._spec_pid[np.maximum(fz.sel, 0)] == victim))
    m.erase_point(victim)
    m._next_pt = victim               # _alloc_pt recycles exactly this row
    new_pid = m.add_point(np.array([99.0, 99.0, 99.0], np.float32),
                          np.zeros(32, np.uint8), 0)
    state, frame = tr._track_locked(frame, fz)
    slam.shutdown()
    return dict(state=state.name, victim=victim, new_pid=int(new_pid),
                matched=list(map(int, matched)),
                holds_victim=bool(np.any(frame.map_points == victim)),
                n_sel=int(len(cur)))


def teleport(jax_package):
    seq = stereo_frames(13, 12, range(9))
    slam = _system(jax_package, seq)
    states = [slam.track_stereo(seq.lefts[i], seq.rights[i], seq.timestamps[i])[0].name
              for i in range(8)]
    tr = slam.tracker
    before = int(tr.fused_frames)
    bad = np.eye(4, dtype=np.float32)
    bad[:3, 3] = (5.0, 5.0, 5.0)
    tr.velocity = bad
    state, _ = slam.track_stereo(seq.lefts[8], seq.rights[8], seq.timestamps[8])
    slam.shutdown()
    return dict(states=states + [state.name], before=before, after=int(tr.fused_frames))


def pipelined(jax_package):
    seq = stereo_frames(11, 25, range(PIPELINED_FRAMES))
    slam = _system(jax_package, seq, pipeline_depth=2)
    frames, states = [], []
    for i in range(PIPELINED_FRAMES):
        state, frame = slam.track_stereo(seq.lefts[i], seq.rights[i], seq.timestamps[i])
        states.append(state.name)
        if frame is not None:
            frames.append(frame)
    slam.tracker.flush_pipeline()
    slam.shutdown()
    m, cam = slam.map, slam.config.camera
    errs = []
    for f in frames:
        if not f.pose_set:
            continue
        has = (f.map_points >= 0) & m.pt_alive[np.maximum(f.map_points, 0)]
        if not has.any():
            continue
        pc = (f.Rcw @ m.pt_pos[f.map_points[has]].T).T + f.tcw
        z = np.maximum(pc[:, 2], 1e-6)
        u = cam.fx * pc[:, 0] / z + cam.cx
        v = cam.fy * pc[:, 1] / z + cam.cy
        errs.append(np.hypot(u - f.kp_xy[has, 0], v - f.kp_xy[has, 1]))
    err = np.concatenate(errs)
    return dict(states=states, checked=int(len(err)), median=float(np.median(err)),
                within10=float((err < 10.0).mean()), fused=int(slam.tracker.fused_frames))


SESSIONS = {"saturation": saturation, "pid_reuse": pid_reuse, "teleport": teleport,
            "pipelined": pipelined}


@pytest.fixture(scope="module")
def jax_ref():
    """JAX's session of each scenario, asked of the JAX child at the first
    test that needs one; each entry waits for its value."""
    return {name: jax_session(fn, True) for name, fn in SESSIONS.items()}


def test_keyframe_capacity_saturation_as_jax(jax_ref):
    port = saturation(False)
    ref = jax_ref["saturation"]()
    print(f"port {port}\njax  {ref}")
    assert port["next_kf"] <= 6
    assert not all(port["capacity_left"])          # the table did fill
    assert port == ref


def test_pid_reuse_in_the_unlocked_window_is_dropped_as_jax(jax_ref):
    port = pid_reuse(False)
    ref = jax_ref["pid_reuse"]()
    print(f"port {port}\njax  {ref}")
    assert port["state"] == "OK" and port["new_pid"] == port["victim"]
    assert not port["holds_victim"] and port["matched"]
    assert port == ref


def test_teleport_falls_back_with_fused_frames_unchanged_as_jax(jax_ref):
    port = teleport(False)
    ref = jax_ref["teleport"]()
    print(f"port {port}\njax  {ref}")
    assert port["states"] == ["OK"] * 9
    assert port["before"] > 0 and port["after"] == port["before"]
    assert port == ref


def test_pipelined_associations_reproject_as_jax(jax_ref):
    port = pipelined(False)
    ref = jax_ref["pipelined"]()
    print(f"port {port}\njax  {ref}")
    for r in (port, ref):
        assert r["checked"] > 200
        assert r["median"] < 3.0
        assert r["within10"] > 0.9
    assert port["states"] == ref["states"]
    assert port["fused"] == ref["fused"]
