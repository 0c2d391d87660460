"""The output check at small sizes on the CPU: the result line's keys, the
program passing its limits, the bfloat16 control failing them, a run that
checked nothing coming out not correct, and a run with the timed path
broken underneath coming out not correct, once for each fault a cell can
have (the searches' matches dropped or given to the wrong points among
them)."""
import numpy as np
import pytest
import torch

from benchmark import harness
from benchmark.check import COUNTS, NAMES
from benchmark.tests.bench_small import run_small

CELLS = ["euroc_stereo.mapping", "tum_rgbd.room"]


def test_result_line_keys():
    r = run_small("euroc_stereo.mapping")
    assert list(r) == ["correct", "attempted", "failed", "metrics", "device", "checked"]
    assert set(r["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}
    assert set(r["metrics"]) == {"frames_per_s", "pose_ms_p95", "ate_m", "setup_s"}
    assert set(r["checked"]) == set(NAMES)
    assert all(set(v) == {"value", "limit"} for v in r["checked"].values())


@pytest.mark.parametrize("cell", CELLS)
def test_program_passes_and_control_fails(cell):
    r = run_small(cell, control=True)
    run = harness.LAST_RUN
    assert r["correct"], r["checked"]
    assert r["failed"] == 0
    assert all(run.control[k] > 0 for k in COUNTS), run.control
    limits = {k: v["limit"] for k, v in r["checked"].items()}
    assert any(run.control[k] > limits[k] for k in NAMES), run.control
    assert not run.control_correct


def test_nothing_checked_is_not_correct():
    numbers = dict.fromkeys(NAMES + COUNTS, 0.0)
    limits = dict.fromkeys(NAMES, 1.0)
    assert not harness.within(numbers, limits)
    assert harness.within({**numbers, **dict.fromkeys(COUNTS, 1)}, limits)


@pytest.fixture
def fault(monkeypatch):
    from jetson_slam_tpu_torch.core import fused_track
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
])
def test_fault_is_not_correct(cell, kind, fault):
    fault(kind)
    r = run_small(cell)
    assert not r["correct"], r["checked"]
