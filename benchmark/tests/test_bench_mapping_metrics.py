"""The local-mapping metrics that read the program's spans and counters:
the fuse's and the triangulation's wall ms and the points refreshed in
batches, each per keyframe mapped in the window, read only from records
that started inside it, and None where there is nothing to read (the
counter on a program that keeps none)."""
from types import SimpleNamespace

import pytest

from benchmark import harness
from jetson_slam_tpu_torch.utils import profiling
from jetson_slam_tpu_torch.utils.profiling import Record, Recorder

NEW = ("mapping.fuse_ms_per_keyframe", "mapping.triangulate_ms_per_keyframe",
       "mapping.points_refreshed_per_keyframe")
MS = 1_000_000
T0, T_END = 1_000 * MS, 2_000 * MS      # the window on perf_counter
WORKER = 2


def _run():
    return SimpleNamespace(t0=T0 * 1e-9, t_end=T_END * 1e-9, fed=[{}] * 4)


def _span(rec, name, start_ms, ms, parent=0):
    sid = len(rec.records) + 1
    rec._push(Record("span", name, int(start_ms * MS), int((start_ms + ms) * MS),
                     WORKER, sid, parent, None, None))
    return sid


def _keyframe(rec, start_ms, refreshed=True):
    """One keyframe mapped: triangulate 40 ms, fuse 100 ms, each with a
    refresh batch of 30 and 500 points inside it."""
    kf = _span(rec, "mapping.keyframe", start_ms, 300)
    for name, at, ms, n in (("mapping.triangulate", 10, 40, 30),
                            ("mapping.fuse", 60, 100, 500)):
        stage = _span(rec, name, start_ms + at, ms, parent=kf)
        if refreshed:
            _span(rec, "mapping.refresh_points", start_ms + at + ms - 5, 4, parent=stage)
            rec._push(Record("count", "mapping.points_refreshed",
                             int((start_ms + at + ms - 5) * MS),
                             int((start_ms + at + ms - 5) * MS), WORKER, 0, 0, None, n))


def _read(name, run):
    return harness.load_module("metrics", name).read(run)


@pytest.fixture
def recorder(monkeypatch):
    rec = Recorder()
    monkeypatch.setattr(profiling, "RECORDER", rec)
    return rec


def test_mapping_metrics_read_only_the_window(recorder):
    _keyframe(recorder, 500)         # set-up
    _keyframe(recorder, 1100)
    _keyframe(recorder, 1500)
    _keyframe(recorder, 2100)        # after the window
    want = {"mapping.fuse_ms_per_keyframe": 100.0,
            "mapping.triangulate_ms_per_keyframe": 40.0,
            "mapping.points_refreshed_per_keyframe": 530.0}
    for name in NEW:
        assert _read(name, _run()) == pytest.approx(want[name]), name


def test_mapping_metrics_read_none_where_there_is_nothing(recorder, monkeypatch):
    for name in NEW:
        assert _read(name, _run()) is None, name
    # keyframes mapped by a program without the counter (the per-point
    # refresh): the stage times read, the counter does not
    _keyframe(recorder, 1100, refreshed=False)
    assert _read("mapping.fuse_ms_per_keyframe", _run()) == pytest.approx(100.0)
    assert _read("mapping.triangulate_ms_per_keyframe", _run()) == pytest.approx(40.0)
    assert _read("mapping.points_refreshed_per_keyframe", _run()) is None
    monkeypatch.delattr(profiling, "RECORDER")
    for name in NEW:
        assert _read(name, _run()) is None, name


def test_the_new_metrics_are_declared():
    bench = harness.load_json(harness.REPO / "BENCHMARK.json")
    declared = {m["name"]: m for m in bench["per_layer"]}
    for name in NEW:
        m = declared[name]
        assert m["layer"] == "local mapping" and m["moves"] == "frames_per_s"
        assert set(m["workloads"]) == {w["name"] for w in bench["workloads"]}
