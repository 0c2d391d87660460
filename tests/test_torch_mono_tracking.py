"""Monocular tracking's weakly held directions, on the CPU, and the
initializer's and relocalization's spans and counters.

- The pose LM: a mono frame of 32 far points (30 to 60 units deep, as a
  map whose scale has grown puts them) against a narrow field of view
  holds its pose weakly: ten float32 iterations a round stop up to 3e-5
  from float64 along the valley (the reference computed in float32
  shows it).  ``pose_optimization`` solves in float64 and lands within
  1e-6 of ``benchmark/reference/pose.py`` in float64, the intrinsics
  rounded to float32 in both as the fused step stages them.
- The local BA: a mono problem (three keyframes 0.02 apart, the first
  fixed, every point seen by all three, no depth) leaves the scale free;
  damped by ``lam * I`` alone its solve multiplied the scale by 1.6 to 8.7
  on these seeds.  Damped by the blocks' diagonals it holds the points'
  median distance within 5 % and the second camera's baseline within
  25 %.  The JAX package keeps ``lam * I`` (``tests/test_torch_sensors.py``
  states where the two packages part).
- A reduced mono session (tests/test_sensors_e2e.py's 14-frame sequence,
  synchronous mapping): no frame lost after the initialization, and the
  map's scale held (a local BA damped by ``lam * I`` took the points' median
  distance from 1.02 to 2.17 within 11 frames); the tracker records its
  initializer attempts and relocalizations (``utils/profiling.RECORDER``).
"""
import numpy as np
import pytest
import torch

from benchmark.reference import pose as ref_pose
from jetson_slam_tpu_torch.config import SLAMConfig
from jetson_slam_tpu_torch.core.frame import Frame
from jetson_slam_tpu_torch.core.local_ba import local_ba
from jetson_slam_tpu_torch.core.optimizer import pose_optimization
from jetson_slam_tpu_torch.io.synthetic import make_stereo_sequence
from jetson_slam_tpu_torch.models.slam import SlamSystem
from jetson_slam_tpu_torch.utils.lie import exp_se3
from jetson_slam_tpu_torch.utils.profiling import RECORDER

torch.set_num_threads(2)

# EuRoC cam0 (examples/configs/EuRoC_mono.yaml)
FX, FY, CX, CY = 458.654, 457.296, 367.215, 248.375


def _centre(R, t):
    return -np.asarray(R, np.float64).T @ np.asarray(t, np.float64)


def _weak_pose_problem(seed, n=32):
    """n far points seen by one mono camera, the observations noisy by 0.7
    px and the start 0.002 rad and 0.05 units off; float32 arrays."""
    rng = np.random.default_rng(seed)
    z = rng.uniform(30.0, 60.0, n)
    pc = np.stack([rng.uniform(-0.25, 0.25, n) * z, rng.uniform(-0.15, 0.15, n) * z, z], 1)
    R = exp_se3(torch.as_tensor(rng.normal(size=6) * [5, 5, 5, 0.3, 0.3, 0.3]))[0].numpy()
    t = rng.normal(size=3) * 20
    pw = (pc - t) @ R
    uv = np.stack([FX * pc[:, 0] / z + CX, FY * pc[:, 1] / z + CY], 1)
    uv += rng.normal(size=(n, 2)) * 0.7
    dR, dt = exp_se3(torch.as_tensor(rng.normal(size=6) * np.repeat([0.05, 0.002], 3)))
    R0, t0 = dR.numpy() @ R, dR.numpy() @ t + dt.numpy()
    inv_s2 = 1.0 / 1.2 ** (2 * rng.integers(0, 4, n))
    f32 = lambda a: np.asarray(a, np.float32)  # noqa: E731
    return (f32(R0), f32(t0), f32(pw), f32(uv), f32(-np.ones(n)), f32(inv_s2),
            np.ones(n, bool))


@pytest.mark.parametrize("seed", [4, 5, 9])
def test_pose_lm_on_a_weakly_held_mono_frame_lands_on_float64(seed):
    args = _weak_pose_problem(seed)
    cam = [float(np.float32(v)) for v in (FX, FY, CX, CY, 0.0)]
    R64, t64, inl64, margin = ref_pose.pose_optimization(*args, *cam, dtype=torch.float64)
    R32, t32, _, _ = ref_pose.pose_optimization(*args, *cam, dtype=torch.float32)
    c64 = _centre(R64, t64)
    assert margin > 0.1      # no observation near its gate: the rounding alone
    assert np.linalg.norm(_centre(R32, t32) - c64) > 1e-5   # weakly held
    R, t, inl, n = pose_optimization(*(torch.as_tensor(a) for a in args), *cam)
    assert R.dtype == t.dtype == torch.float32
    assert np.array_equal(inl.numpy(), inl64) and int(n) == int(inl64.sum())
    assert np.linalg.norm(_centre(R.numpy(), t.numpy()) - c64) < 1e-6


def _mono_ba_problem(seed, n_cams=3, n_pts=150, base=0.02):
    """Keyframes base apart along x (the first fixed at the origin), n_pts
    points 0.7 to 1.6 deep seen by every keyframe, mono edges with 0.5 px
    noise; the free cameras and the points start perturbed.  Returns the
    local_ba arguments (float32) and the true second camera's centre."""
    rng = np.random.default_rng(seed)
    z = rng.uniform(0.7, 1.6, n_pts)
    pts = np.stack([rng.uniform(-0.5, 0.5, n_pts) * z, rng.uniform(-0.4, 0.4, n_pts) * z, z], 1)
    Rs, ts = [], []
    for k in range(n_cams):
        R, t = exp_se3(torch.tensor([-base * k, 0.0, 0.0, 0.0, 0.01 * k, 0.0],
                                    dtype=torch.float64))
        Rs.append(R.numpy())
        ts.append(t.numpy())
    e_cam, e_pt, obs = [], [], []
    for c in range(n_cams):
        pc = pts @ Rs[c].T + ts[c]
        u = 300.0 * pc[:, 0] / pc[:, 2] + 160.0
        v = 300.0 * pc[:, 1] / pc[:, 2] + 120.0
        for p in range(n_pts):
            e_cam.append(c)
            e_pt.append(p)
            obs.append([u[p] + rng.normal() * 0.5, v[p] + rng.normal() * 0.5, 0.0])
    E = len(e_cam)
    pt_edges = np.full((n_pts, n_cams), -1, np.int32)
    for e in range(E):
        pt_edges[e_pt[e], e_cam[e]] = e
    Rs_i, ts_i = np.stack(Rs), np.stack(ts)
    for k in range(1, n_cams):
        dR, dt = exp_se3(torch.as_tensor(rng.normal(size=6) * 0.002))
        Rs_i[k], ts_i[k] = dR.numpy() @ Rs_i[k], dR.numpy() @ ts_i[k] + dt.numpy()
    pts_i = pts + rng.normal(size=pts.shape) * 0.02
    fixed = np.zeros(n_cams, bool)
    fixed[0] = True
    f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32))  # noqa: E731
    args = (f32(Rs_i), f32(ts_i), torch.as_tensor(fixed), f32(pts_i),
            torch.as_tensor(np.array(e_cam, np.int32)), torch.as_tensor(np.array(e_pt, np.int32)),
            f32(obs), torch.zeros(E, dtype=torch.bool), torch.ones(E), torch.ones(E, dtype=torch.bool),
            torch.as_tensor(pt_edges))
    return args, _centre(Rs[1], ts[1])


@pytest.mark.parametrize("seed", [0, 2, 5])
def test_mono_local_ba_holds_the_free_scale(seed):
    args, c1 = _mono_ba_problem(seed)
    med0 = np.median(np.linalg.norm(args[3].numpy(), axis=1))
    R, t, p, outlier = local_ba(*args, 300.0, 300.0, 160.0, 120.0, 0.0)
    scale = np.median(np.linalg.norm(p.numpy(), axis=1)) / med0
    assert abs(scale - 1.0) < 0.05, scale
    base = np.linalg.norm(_centre(R[1].numpy(), t[1].numpy()))
    assert abs(base / np.linalg.norm(c1) - 1.0) < 0.25, base
    assert not outlier.any()


def _session_config(seq):
    """tests/test_sensors_e2e.py's mono geometry (320x240, 4 levels, tile 16)."""
    cfg = SLAMConfig()
    c = cfg.camera
    c.fx, c.fy, c.cx, c.cy, c.bf = seq.fx, seq.fy, seq.cx, seq.cy, seq.bf
    c.width, c.height = 320, 240
    c.k1 = c.k2 = c.p1 = c.p2 = c.k3 = 0.0
    cfg.orb.n_levels, cfg.orb.tile_h, cfg.orb.tile_w = 4, 16, 16
    return cfg


def _counts(records):
    out = {}
    for r in records:
        if r.kind == "count":
            out[r.name] = out.get(r.name, 0) + r.value
    return out


def test_mono_session_keeps_its_scale_and_records_init_and_relocalization():
    seq = make_stereo_sequence(seed=6, n_frames=14, h=240, w=320)
    Frame._next_id = 0
    slam = SlamSystem(_session_config(seq), sensor="mono", device="cpu")
    RECORDER.reset()
    states, med = [], []
    m = slam.map
    for img, ts in zip(seq.lefts, seq.timestamps):
        state, _ = slam.track_monocular(img, ts)
        states.append(state.name)
        alive = np.flatnonzero(m.pt_alive)
        med.append(np.median(np.linalg.norm(m.pt_pos[alive], axis=1)) if len(alive) else 0.0)
    first = states.index("OK")
    assert 1 <= first <= 3 and states[first:] == ["OK"] * (len(states) - first), states
    # the initializer's unit median depth, held by the local BAs that follow
    assert max(abs(v / med[first] - 1.0) for v in med[first:]) < 0.15, med
    counts = _counts(RECORDER.records)
    attempts = [r for r in RECORDER.records if r.kind == "span" and r.name == "init.attempt"]
    assert counts["init.frames"] == first + 1
    assert counts["init.attempts"] == len(attempts) >= 1 and counts["init.accepted"] == 1
    assert all(r.end > r.start for r in attempts)
    assert "tracking.lost" not in counts and "slice.relocalize" not in {
        r.name for r in RECORDER.records}
    # two blind frames: the first loses track, the second relocalizes
    # without success; then a mapped view relocalizes
    t = seq.timestamps[-1]
    blind = np.zeros_like(seq.lefts[0])
    for k in (1, 2):
        state, _ = slam.track_monocular(blind, t + 0.05 * k)
        assert state.name == "LOST"
    state, _ = slam.track_monocular(seq.lefts[-1], t + 0.15)
    slam.shutdown()
    counts = _counts(RECORDER.records)
    relocs = [r for r in RECORDER.records if r.kind == "span" and r.name == "slice.relocalize"]
    assert state.name == "OK" and counts["reloc.succeeded"] == 1
    assert counts["tracking.lost"] == 2 and len(relocs) == 2
    assert counts["init.frames"] == first + 1       # not counted again after a loss
