"""The mono cell's per-layer metrics that read the program's initializer and
relocalization records: the initializer's ms an attempt and the frames fed
before it succeeded, the share of the frames after it not tracked OK, and
relocalization's ms per frame fed; each from the records that started
inside the window, None where the program keeps none of them (the parent
of this benchmark's mono cell).  A small run of ``euroc_mono.flight`` on
the CPU reads all four."""
from types import SimpleNamespace

import pytest

from benchmark import harness
from benchmark.tests.bench_small import small
from jetson_slam_tpu_torch.utils import profiling
from jetson_slam_tpu_torch.utils.profiling import Record, Recorder

NEW = ("initializer.ms_per_attempt", "initializer.frames_to_init", "tracker.lost_pct",
       "relocalization.ms_per_frame")
CELL = "euroc_mono.flight"
MS = 1_000_000
T0, T_END = 1_000 * MS, 2_000 * MS      # the window on perf_counter
TRACKER = 1


def _run(n_fed=25):
    return SimpleNamespace(t0=T0 * 1e-9, t_end=T_END * 1e-9, fed=[{}] * n_fed)


def _span(rec, name, start_ms, ms):
    rec._push(Record("span", name, int(start_ms * MS), int((start_ms + ms) * MS),
                     TRACKER, len(rec.records) + 1, 0, None, None))


def _count(rec, name, at_ms, n=1):
    rec._push(Record("count", name, int(at_ms * MS), int(at_ms * MS), TRACKER, 0, 0, None, n))


def _session(rec, start_ms, lost=3):
    """A session from ``start_ms``: 5 frames fed before the initializer
    accepts at its 3rd attempt (20, 30 and 40 ms), then ``lost`` frames lost,
    each relocalized in 100 ms but the first."""
    for k in range(5):
        _count(rec, "init.frames", start_ms + 10 * k)
    for k, ms in enumerate((20, 30, 40)):
        _count(rec, "init.attempts", start_ms + 12 + 10 * k)
        _span(rec, "init.attempt", start_ms + 12 + 10 * k, ms)
    _count(rec, "init.accepted", start_ms + 60)
    for k in range(lost):
        _count(rec, "tracking.lost", start_ms + 200 + 100 * k)
        if k:
            _span(rec, "slice.relocalize", start_ms + 200 + 100 * k, 100)


def _read(name, run):
    return harness.load_module("metrics", name).read(run)


@pytest.fixture
def recorder(monkeypatch):
    rec = Recorder()
    monkeypatch.setattr(profiling, "RECORDER", rec)
    return rec


def test_mono_metrics_read_only_the_window(recorder):
    _session(recorder, 100)         # the warm session, in set-up
    _session(recorder, 1100)
    _session(recorder, 2100)        # after the window
    want = {"initializer.ms_per_attempt": 30.0, "initializer.frames_to_init": 5.0,
            "tracker.lost_pct": 100.0 * 3 / (25 - 5),
            "relocalization.ms_per_frame": 200.0 / 25}
    for name in NEW:
        assert _read(name, _run()) == pytest.approx(want[name]), name


def test_a_window_without_a_loss_reads_zero_lost_and_no_relocalization(recorder):
    _session(recorder, 1100, lost=0)
    assert _read("tracker.lost_pct", _run()) == 0.0
    assert _read("relocalization.ms_per_frame", _run()) == 0.0


def test_mono_metrics_read_none_where_there_is_nothing(recorder, monkeypatch):
    for name in NEW:
        assert _read(name, _run()) is None, name
    # a program without the initializer's and the loss's records (the
    # parent of the mono cell): its other records in the window read
    # nothing here
    _span(recorder, "slice.track", 1100, 50)
    _count(recorder, "keyframes.wanted", 1150)
    for name in NEW:
        assert _read(name, _run()) is None, name
    monkeypatch.delattr(profiling, "RECORDER")
    for name in NEW:
        assert _read(name, _run()) is None, name


def test_the_mono_metrics_are_declared_for_the_mono_cell():
    bench = harness.load_json(harness.REPO / "BENCHMARK.json")
    declared = {m["name"]: m for m in bench["per_layer"]}
    layers = {"initializer.ms_per_attempt": "mono initializer",
              "initializer.frames_to_init": "mono initializer",
              "tracker.lost_pct": "tracker host", "relocalization.ms_per_frame": "relocalization"}
    for name in NEW:
        m = declared[name]
        assert m["layer"] == layers[name] and m["moves"] == "frames_per_s"
        assert m["workloads"] == [CELL]
    cell = {w["name"]: w for w in bench["workloads"]}[CELL]
    assert cell["config"] == "euroc_mono" and cell["chips"] == 1
    assert harness.load_json(harness.BENCH / "configs" / "euroc_mono.json")["sensor"] == "mono"
    # the async cells' ATE (Sim(3) for mono) and the lock wait's loop share
    for name in ("trajectory.ate_m_live", "tracker.lock_wait_loop_pct"):
        assert declared[name]["workloads"] == ["tum_rgbd.room", CELL], name


def test_a_small_mono_run_reads_all_four():
    """The mono cell at the small size with its per-layer metrics (the
    host and program ones; no device trace on the CPU)."""
    ov = small(CELL)
    r = harness.run_cell(CELL, 3, 20.0, True, device="cpu", overrides=ov, render_workers=1)
    got = r["metrics"]
    for name in NEW + ("trajectory.ate_m_live",):
        assert name in got, (name, sorted(got))
    assert got["initializer.frames_to_init"]["value"] >= 2
    assert got["initializer.ms_per_attempt"]["value"] > 0
    assert 0.0 <= got["tracker.lost_pct"]["value"] <= 100.0
    assert got["relocalization.ms_per_frame"]["value"] >= 0.0
