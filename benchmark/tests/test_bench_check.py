"""The output check at small sizes on the CPU: the result line's keys, the
program passing its limits, the bfloat16 control failing them, a run that
checked nothing coming out not correct, and a run with the timed path
broken underneath coming out not correct, once for each fault a cell can
have (the searches' matches dropped or given to the wrong points among
them; for mono, the initializer's pose, a first point or its choice of
model altered).  The mono cell is added as files to a copy of the
benchmark (``bench_small.install_mono``)."""
import json

import numpy as np
import pytest
import torch

from benchmark import harness
from benchmark.check import COUNTS, MONO_COUNTS, MONO_NAMES, NAMES, numbers_of
from benchmark.tests.bench_small import MONO, install_mono, run_small

CELLS = ["euroc_stereo.mapping", "tum_rgbd.room"]
# the test cell's limit of init_gap: the program reads 3.7e-05 at the small
# size on the CPU, the bfloat16 control inf
INIT_LIMIT = 1e-3


def _cell(cell, tmp_path, monkeypatch):
    if cell == MONO:
        install_mono(tmp_path, monkeypatch, INIT_LIMIT)
    return cell


def test_result_line_keys():
    r = run_small("euroc_stereo.mapping")
    assert list(r) == ["correct", "attempted", "failed", "metrics", "device", "checked"]
    assert set(r["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}
    assert set(r["metrics"]) == {"frames_per_s", "pose_ms_p95", "ate_m", "setup_s"}
    assert set(r["checked"]) == set(NAMES)
    assert all(set(v) == {"value", "limit"} for v in r["checked"].values())


@pytest.mark.parametrize("cell", CELLS + [MONO])
def test_program_passes_and_control_fails(cell, tmp_path, monkeypatch):
    r = run_small(_cell(cell, tmp_path, monkeypatch), control=True)
    run = harness.LAST_RUN
    names, counts = numbers_of(run.config["sensor"])
    assert r["correct"], r["checked"]
    # a mono session's first frame is the initializer's reference frame
    assert r["failed"] == (1 if cell == MONO else 0)
    assert all(run.control[k] > 0 for k in counts), run.control
    limits = {k: v["limit"] for k, v in r["checked"].items()}
    assert set(limits) == set(names)
    assert any(run.control[k] > limits[k] for k in names), run.control
    assert not run.control_correct
    if cell == MONO:
        assert run.control["init_gap"] > INIT_LIMIT


@pytest.mark.parametrize("sensor", ["stereo", "rgbd", "mono"])
def test_nothing_checked_is_not_correct(sensor):
    names, counts = numbers_of(sensor)
    numbers = dict.fromkeys(names + counts, 0.0)
    limits = dict.fromkeys(names, 1.0)
    assert not harness.within(numbers, limits, sensor)
    assert harness.within({**numbers, **dict.fromkeys(counts, 1)}, limits, sensor)
    if sensor == "mono":    # no initializer call checked
        assert not harness.within({**numbers, **dict.fromkeys(COUNTS, 1)}, limits, sensor)


@pytest.mark.parametrize("cell", CELLS)
def test_stereo_and_rgbd_check_unchanged(cell):
    """The mono branch leaves the other sensors' numbers, counts, limits
    and checked block as they were."""
    assert NAMES == ("kp_gap_px", "desc_bits", "depth_gap", "match_diff", "pose_gap_m",
                     "tri_gap")
    assert COUNTS == ("frames_checked", "matches_checked", "stages_checked",
                      "points_checked")
    assert MONO_NAMES == NAMES + ("init_gap",)
    assert MONO_COUNTS == COUNTS + ("inits_checked",)
    limits = json.loads((harness.BENCH / "limits" / f"{cell}.json").read_text())
    assert limits == {"kp_gap_px": 0.01, "desc_bits": 0.0005, "depth_gap": 0.001,
                      "match_diff": 0.01, "pose_gap_m": 0.001, "tri_gap": 0.002}
    r = run_small(cell)
    run = harness.LAST_RUN
    assert numbers_of(run.config["sensor"]) == (NAMES, COUNTS)
    assert list(r["checked"]) == list(NAMES)
    assert r["checked"] == {k: {"value": r["checked"][k]["value"], "limit": limits[k]}
                            for k in NAMES}
    assert not run.inits and "inits_checked" not in run.judge.judge(run.frames, [], [])


@pytest.fixture
def fault(monkeypatch):
    from jetson_slam_tpu_torch.core import fused_track
    from jetson_slam_tpu_torch.core.initializer import MonoInitializer
    from jetson_slam_tpu_torch.core.map import MapStore
    from jetson_slam_tpu_torch.core.tracking import Tracker
    from jetson_slam_tpu_torch.ops.frontend import OrbFrontend

    def plant(kind):
        if kind == "state_unchanged":
            orig = Tracker._finish_fused

            def finish(tracker, pending):
                frame, fz = orig(tracker, pending)
                fz.R2, fz.t2 = fz.R1.copy(), fz.t1.copy()   # LM returns its start
                return frame, fz
            monkeypatch.setattr(Tracker, "_finish_fused", finish)
        elif kind == "half_batch":
            orig = OrbFrontend.frame_step

            def frame_step(fe, left, right, mbf, min_z):
                return orig(fe, left, left, mbf, min_z)     # the right eye left out
            monkeypatch.setattr(OrbFrontend, "frame_step", frame_step)
        elif kind == "answer_altered":
            orig = Tracker._finish_fused

            def finish(tracker, pending):
                frame, fz = orig(tracker, pending)
                i = int(np.flatnonzero(frame.valid)[0])
                frame.kp_xy_raw[i, 0] += 0.25               # one keypoint moved
                return frame, fz
            monkeypatch.setattr(Tracker, "_finish_fused", finish)
        elif kind == "matches_dropped":
            orig = fused_track.motion_model_track

            def motion_model_track(*a, **kw):
                m, *rest = orig(*a, **kw)
                keep = torch.cumsum((m >= 0).to(torch.int64), 0) % 2 == 1
                return (torch.where(keep, m, torch.full_like(m, -1)), *rest)
            monkeypatch.setattr(fused_track, "motion_model_track", motion_model_track)
        elif kind == "matches_misassigned":
            orig = fused_track.local_map_track

            def local_map_track(*a, **kw):
                ok, sel, *rest = orig(*a, **kw)
                idx = torch.nonzero(sel >= 0)[:, 0]
                sel = sel.clone()
                sel[idx] = sel[idx.roll(1)]        # each match takes its neighbour's point
                return (ok, sel, *rest)
            monkeypatch.setattr(fused_track, "local_map_track", local_map_track)
        elif kind == "point_altered":
            orig = MapStore.add_point

            def add_point(m, pos, *a, **kw):
                return orig(m, np.asarray(pos) * 1.01, *a, **kw)
            monkeypatch.setattr(MapStore, "add_point", add_point)
        elif kind == "init_rotation":
            orig = MonoInitializer.initialize

            def initialize(init, kp1, kp2, valid):
                ok, R, t, X, good = orig(init, kp1, kp2, valid)
                if ok:          # the initial pose turned by 0.01 rad
                    c, s = np.cos(0.01), np.sin(0.01)
                    R = (np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]]) @ R).astype(R.dtype)
                return ok, R, t, X, good
            monkeypatch.setattr(MonoInitializer, "initialize", initialize)
        elif kind == "init_point":
            orig = MonoInitializer.initialize

            def initialize(init, kp1, kp2, valid):
                ok, R, t, X, good = orig(init, kp1, kp2, valid)
                if ok:          # one first point 5 % farther out
                    X = X.copy()
                    X[np.flatnonzero(good)[0]] *= 1.05
                return ok, R, t, X, good
            monkeypatch.setattr(MonoInitializer, "initialize", initialize)
        elif kind == "init_model":
            orig = MonoInitializer.hypotheses

            def hypotheses(init, p1, p2, valid, sample):
                sh, H, sf, F = orig(init, p1, p2, valid, sample)
                use_h = float(sh.max()) / float(sh.max() + sf.max()) > 0.40
                # the other model wins the choice
                return sh, H, (sf * 100.0 if use_h else sf * 1e-3), F
            monkeypatch.setattr(MonoInitializer, "hypotheses", hypotheses)
    return plant


@pytest.mark.parametrize("cell,kind", [
    ("euroc_stereo.mapping", "state_unchanged"),
    ("euroc_stereo.mapping", "half_batch"),
    ("euroc_stereo.mapping", "answer_altered"),
    ("euroc_stereo.mapping", "point_altered"),
    ("euroc_stereo.mapping", "matches_dropped"),
    ("euroc_stereo.mapping", "matches_misassigned"),
    ("tum_rgbd.room", "state_unchanged"),
    ("tum_rgbd.room", "answer_altered"),
    ("tum_rgbd.room", "matches_misassigned"),
    (MONO, "state_unchanged"),
    (MONO, "init_rotation"),
    (MONO, "init_point"),
    (MONO, "init_model"),
])
def test_fault_is_not_correct(cell, kind, fault, tmp_path, monkeypatch):
    fault(kind)
    r = run_small(_cell(cell, tmp_path, monkeypatch))
    assert not r["correct"], r["checked"]
    if kind.startswith("init"):
        assert r["checked"]["init_gap"]["value"] > INIT_LIMIT, r["checked"]
