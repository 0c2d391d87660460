"""The per-layer metrics that read the program's own spans and counters
(``benchmark/program_records.py``): each reads only the records that
started inside the window, and None where the run has nothing to read."""
from types import SimpleNamespace

import pytest

from benchmark import harness
from jetson_slam_tpu_torch.utils import profiling
from jetson_slam_tpu_torch.utils.profiling import Record, Recorder

NEW = ("tracker.lock_wait_ms_per_frame", "tracker.lock_wait_loop_pct",
       "tracker.off_cpu_ms_per_frame", "fused_step.pull_wait_ms_per_frame",
       "fused_step.frontend_device_ms", "fused_step.motion_model_device_ms",
       "fused_step.local_map_device_ms", "async_worker.queue_wait_ms_per_keyframe",
       "async_worker.refused_pct")
MS = 1_000_000
T0 = 1_000 * MS          # the window: 1000 ms to 2000 ms on perf_counter
T_END = 2_000 * MS
TRACKER, WORKER = 1, 2


def _run(n_fed=4):
    return SimpleNamespace(t0=T0 * 1e-9, t_end=T_END * 1e-9, fed=[{}] * n_fed)


def _span(rec, name, start_ms, ms, thread=TRACKER, parent=0, cpu_ms=None, value=None):
    sid = len(rec.records) + 1
    cpu = None if cpu_ms is None else int(cpu_ms * MS)
    rec._push(Record("span", name, int(start_ms * MS), int((start_ms + ms) * MS),
                     thread, sid, parent, cpu, value))
    return sid


def _events(rec, start_ms):
    """One window's worth of records from ``start_ms``: two frames' track
    calls, their waits and pulls, stage times, a keyframe's queue wait and
    the keyframe counters."""
    for k in range(2):
        t = start_ms + 100 * k
        tr = _span(rec, "slice.track", t, 50, cpu_ms=20)
        holder = ("mapping.loop_closing", "mapping.loop_sim3") if k == 0 else \
            ("mapping.keyframe", "mapping.fuse")
        _span(rec, "slice.map_lock_wait", t + 1, 10, parent=tr, cpu_ms=1, value=holder)
        _span(rec, "slice.pull", t + 20, 4, parent=tr, cpu_ms=1)
        for name, ns in (("stage.frontend", 3 + k), ("stage.motion_model", 5 + k),
                         ("stage.local_map", 7 + k)):
            rec._push(Record("device", name, int((t + 30) * MS), int((t + 30) * MS),
                             TRACKER, 0, 0, None, ns * MS))
    _span(rec, "mapping.queue_wait", start_ms + 5, 30, thread=WORKER)
    for name, n in (("keyframes.wanted", 4), ("keyframes.refused", 1)):
        rec._push(Record("count", name, int((start_ms + 60) * MS),
                         int((start_ms + 60) * MS), TRACKER, 0, 0, None, n))


def _read(name, run):
    return harness.load_module("metrics", name).read(run)


@pytest.fixture
def recorder(monkeypatch):
    rec = Recorder()
    monkeypatch.setattr(profiling, "RECORDER", rec)
    return rec


def test_metrics_read_only_the_window(recorder):
    _events(recorder, 500)        # before the window: set-up, the warm session
    _events(recorder, 1200)       # inside it
    _events(recorder, 2100)       # after it: the traced frames, the flush
    run = _run(n_fed=4)
    want = {
        "tracker.lock_wait_ms_per_frame": 20 / 4,
        "tracker.lock_wait_loop_pct": 50.0,
        # (50 - 20) per track call, less (10 - 1) and (4 - 1) of its waits
        "tracker.off_cpu_ms_per_frame": 2 * (30 - 9 - 3) / 4,
        "fused_step.pull_wait_ms_per_frame": 8 / 4,
        "fused_step.frontend_device_ms": 3.5,
        "fused_step.motion_model_device_ms": 5.5,
        "fused_step.local_map_device_ms": 7.5,
        "async_worker.queue_wait_ms_per_keyframe": 30.0,
        "async_worker.refused_pct": 25.0,
    }
    for name in NEW:
        assert _read(name, run) == pytest.approx(want[name]), name


def test_metrics_read_none_where_there_is_nothing(recorder, monkeypatch):
    run = _run()
    for name in NEW:
        assert _read(name, run) is None, name
    _events(recorder, 2100)       # only after the window
    for name in NEW:
        assert _read(name, run) is None, name
    # a window with track calls but no waits, stages or keyframes
    _span(recorder, "slice.track", 1500, 40, cpu_ms=40)
    assert _read("tracker.lock_wait_ms_per_frame", run) == 0.0
    assert _read("tracker.off_cpu_ms_per_frame", run) == 0.0
    for name in ("tracker.lock_wait_loop_pct", "fused_step.frontend_device_ms",
                 "async_worker.queue_wait_ms_per_keyframe", "async_worker.refused_pct"):
        assert _read(name, run) is None, name
    # a program that keeps no recorder (the port before it had one)
    monkeypatch.delattr(profiling, "RECORDER")
    for name in NEW:
        assert _read(name, run) is None, name


def test_a_ring_that_lost_part_of_the_window_reads_none(monkeypatch):
    rec = Recorder(ring=4)
    monkeypatch.setattr(profiling, "RECORDER", rec)
    _events(rec, 1200)
    assert rec.dropped > 0 and rec.records[0].start > T0
    for name in NEW:
        assert _read(name, _run()) is None, name
