"""The program's own spans and counters (``jetson_slam_tpu_torch.utils.
profiling.RECORDER``), as the per-layer metrics that read them see them.

``window(run)`` keeps the records that started inside the measured window,
``run.t0`` to ``run.t_end`` on ``time.perf_counter``: not set-up, the warm
session, the traced frames after the window or the flush at its close.  A
program that keeps no recorder, or whose ring has lost part of the window,
gives None, and so does every metric that reads it: the metric is then left
out of the result line.
"""
from __future__ import annotations

import statistics

# the loop closer's spans: a lock wait whose holder had one open waited on
# loop closing (its detection, Sim(3), correction, or the global BA)
LOOP_SPANS = ("mapping.loop_closing", "mapping.gba")


def window(run):
    try:
        from jetson_slam_tpu_torch.utils.profiling import RECORDER
    except ImportError:
        return None
    t0, t1 = run.t0 * 1e9, run.t_end * 1e9
    records = list(RECORDER.records)
    if not records or (RECORDER.dropped and records[0].start > t0):
        return None
    return [r for r in records if t0 <= r.start <= t1]


def spans(records, name):
    return [r for r in records if r.kind == "span" and r.name == name]


def wall_ms(records) -> float:
    return sum(r.end - r.start for r in records) * 1e-6


def off_cpu_ms(records) -> float:
    """Wall time less the thread's CPU time, over spans that carry it."""
    return sum(r.end - r.start - r.cpu for r in records if r.cpu is not None) * 1e-6


def per_frame(run, ms):
    return ms / len(run.fed) if run.fed else None


def tracked(run):
    """The window's records where the tracker recorded its calls, else
    None (a program without the tracker's spans)."""
    recs = window(run)
    if recs is None or not spans(recs, "slice.track"):
        return None
    return recs


def total(records, name) -> int:
    return sum(r.value for r in records if r.kind == "count" and r.name == name)


def device_median_ms(run, name):
    """Median over the window's fused frames of one stage's device time."""
    recs = window(run)
    if recs is None:
        return None
    ns = [r.value for r in recs if r.kind == "device" and r.name == name]
    return statistics.median(ns) * 1e-6 if ns else None


def held_by_loop(rec) -> bool:
    return any(name in LOOP_SPANS for name in rec.value or ())
