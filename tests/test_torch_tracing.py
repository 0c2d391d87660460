"""The port's span recorder (``utils/profiling.py``) and the spans and
counters it keeps inside the tracker, the fused step and the async worker.

- nested spans on two threads: parents, self time, thread CPU time;
- the traced map lock: RLock semantics under ``Condition.wait``/``notify``
  across threads, and a wait recorded with the holder's open spans;
- the recorder's clock mapped onto the profiler's epoch clock;
- the fused step's stage stamps at ``pipeline_depth=2``, each frame's own;
- a busy async worker: the tracker's refused keyframes, the queue waits;
- ``enable(False)`` records nothing; the ring is bounded.

Sessions run on the CPU at 320x240 with the port's own renderer.
"""
import functools
import threading
import time

import numpy as np
import pytest
import torch

from jetson_slam_tpu_torch.utils import profiling
from jetson_slam_tpu_torch.utils.profiling import RECORDER, Recorder, TracedLock, span


def _mine(since: int, thread: int | None = None):
    """Records that started after ``since`` (perf_counter_ns), on
    ``thread`` when given."""
    return [r for r in list(RECORDER.records) if r.start >= since
            and (thread is None or r.thread == thread)]


@functools.lru_cache(maxsize=None)
def _sequence(n_frames: int, **kw):
    from jetson_slam_tpu_torch.io.synthetic import make_stereo_sequence
    kw = {"seed": 2, "n_points": 700, **kw}
    return make_stereo_sequence(n_frames=n_frames, h=240, w=320, **kw)


def _system(seq, **kw):
    from jetson_slam_tpu_torch.config import SLAMConfig
    from jetson_slam_tpu_torch.core.frame import Frame
    from jetson_slam_tpu_torch.models.slam import SlamSystem
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
    Frame._next_id = 0
    return SlamSystem(cfg, sensor="stereo", device="cpu", **kw)


def test_nested_spans_on_two_threads_give_parent_and_self_time():
    t0 = time.perf_counter_ns()
    barrier = threading.Barrier(2)
    idents = {}

    def work(tag):
        idents[tag] = threading.get_ident()
        barrier.wait()
        with span(f"slice.outer_{tag}"):
            time.sleep(0.02)
            with span(f"slice.inner_{tag}"):
                time.sleep(0.03)

    threads = [threading.Thread(target=work, args=(t,)) for t in "ab"]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    for tag in "ab":
        recs = {r.name: r for r in _mine(t0, idents[tag])}
        outer, inner = recs[f"slice.outer_{tag}"], recs[f"slice.inner_{tag}"]
        assert outer.parent == 0 and inner.parent == outer.id
        assert outer.start <= inner.start <= inner.end <= outer.end
        self_ms = (outer.end - outer.start - (inner.end - inner.start)) * 1e-6
        assert 19.0 <= self_ms < 40.0
        assert (inner.end - inner.start) * 1e-6 >= 29.0
        # thread CPU time on the thread's top-level span only; sleeping
        # takes almost none of it
        assert outer.cpu is not None and inner.cpu is None
        assert outer.cpu < (outer.end - outer.start) / 2
    assert idents["a"] != idents["b"]
    assert RECORDER.stats("slice.inner_a")["count"] >= 1


def test_traced_lock_keeps_rlock_semantics_and_tags_the_holder():
    lock = TracedLock()
    cond = threading.Condition(lock)
    items, got = [], []
    held, go = threading.Event(), threading.Event()
    t0 = time.perf_counter_ns()

    def consumer():
        with cond:
            while not items:
                cond.wait(timeout=5)
            got.append(items.pop())

    def holder():
        with span("mapping.loop_closing"), span("mapping.loop_sim3"):
            with lock:
                with lock:                # re-entrant
                    held.set()
                    go.wait(5)
                    time.sleep(0.05)

    c = threading.Thread(target=consumer)
    c.start()
    time.sleep(0.05)                      # the consumer waits on the condition
    with cond:
        assert lock._is_owned()
        items.append(7)
        cond.notify()
    c.join(5)
    assert got == [7] and not c.is_alive()
    assert not lock._is_owned()
    with pytest.raises(RuntimeError):
        lock.release()
    h = threading.Thread(target=holder)
    h.start()
    assert held.wait(5)
    assert not lock.acquire(blocking=False)
    go.set()
    with lock.waiting_as("slice.map_lock_wait"):   # blocks on the holder
        assert lock._is_owned()
    h.join(5)
    me = threading.get_ident()
    waits = [r for r in _mine(t0, me) if r.name == "slice.map_lock_wait"]
    assert len(waits) == 1
    w = waits[0]
    assert w.value == ("mapping.loop_closing", "mapping.loop_sim3")
    assert (w.end - w.start) * 1e-6 >= 40.0 and w.cpu is not None
    # an acquisition that did not wait records nothing
    n = len(_mine(t0, me))
    with lock:
        pass
    assert len(_mine(t0, me)) == n


def test_span_start_maps_onto_the_profilers_epoch_clock():
    from torch.profiler import ProfilerActivity, profile
    t0 = time.perf_counter_ns()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(3):   # the first range pays the profiler's set-up
            with span("slice.epoch_check"):
                time.sleep(0.005)
    events = sorted((e for e in prof.profiler.kineto_results.events()
                     if e.name() == "slice.epoch_check"), key=lambda e: e.start_ns())
    recs = [r for r in _mine(t0, threading.get_ident()) if r.name == "slice.epoch_check"]
    assert len(events) == len(recs) == 3
    gap_ms = abs(RECORDER.to_epoch_ns(recs[-1].start) - events[-1].start_ns()) * 1e-6
    assert gap_ms < 1.0, gap_ms


def test_stage_stamps_are_each_frames_own_at_pipeline_depth_2():
    from jetson_slam_tpu_torch.core.fused_track import STAGES
    seq = _sequence(10)
    slam = _system(seq, enable_mapping=False, pipeline_depth=2)
    tr = slam.tracker
    finish, stamps = tr._finish_fused, []

    def keep(pending):
        frame, fz = finish(pending)
        stamps.append((frame.timestamp, fz.stamps.copy()))
        return frame, fz

    tr._finish_fused = keep
    t0 = time.perf_counter_ns()
    for i in range(10):
        slam.track_stereo(seq.lefts[i], seq.rights[i], seq.timestamps[i])
    slam.shutdown()
    assert len(stamps) >= 6, len(stamps)
    ts = [t for t, _ in stamps]
    assert ts == sorted(ts) and len(set(ts)) == len(ts)
    prev_end = None
    for _, st in stamps:
        assert st.dtype == np.int64 and st.shape == (len(STAGES) + 1,)
        assert np.all(np.diff(st) > 0)             # monotonic inside the frame
        if prev_end is not None:
            assert st[0] > prev_end                 # after the frame before it
        prev_end = st[-1]
    dev = [r for r in _mine(t0, threading.get_ident()) if r.kind == "device"]
    assert [r.name for r in dev] == list(STAGES) * len(stamps)
    for j, (_, st) in enumerate(stamps):
        durs = [r.value for r in dev[3 * j:3 * j + 3]]
        assert durs == [int(v) for v in np.diff(st)]
        assert sum(durs) == st[-1] - st[0]
    track = [r for r in _mine(t0) if r.name == "slice.track"]
    assert len(track) == 10 and all(r.parent == 0 and r.cpu is not None for r in track)
    pulls = [r for r in _mine(t0) if r.name == "slice.pull"]
    assert len(pulls) == len(stamps) and all(r.cpu is not None for r in pulls)


def test_a_busy_worker_makes_the_session_refuse_keyframes():
    # a fifth of the ring lap in 14 frames: the tracker wants a keyframe
    # every third frame while the map cannot grow
    seq = _sequence(14, seed=3, trajectory="circle", n_points=1200, laps=0.2)
    slam = _system(seq, async_mapping=True)
    pipe = slam.pipeline
    assert isinstance(pipe.lock, TracedLock)
    release, holding = threading.Event(), threading.Event()
    calls = []
    me = threading.get_ident()

    def held(kid, lock):
        # the worker takes the map lock for a while, then is held away
        # from it until the session ends: the keyframes the tracker makes
        # queue behind the first
        calls.append(kid)
        with span("mapping.keyframe"):
            with lock, span("mapping.lba_commit"):
                holding.set()
                deadline = time.monotonic() + 30
                while not release.is_set() and time.monotonic() < deadline and \
                        "slice.map_lock_wait" not in RECORDER.open_spans(me):
                    time.sleep(0.005)       # until the tracker waits for it
            assert release.wait(60)

    slam.local_mapper.process_keyframe = held
    t0 = time.perf_counter_ns()
    try:
        for i in range(14):
            slam.track_stereo(seq.lefts[i], seq.rights[i], seq.timestamps[i])
            if i == 0:      # the next frame finds the worker holding the lock
                assert holding.wait(10)
    finally:
        release.set()
        slam.shutdown()
    recs = _mine(t0)
    n = {name: sum(r.value for r in recs if r.kind == "count" and r.name == name)
         for name in ("keyframes.wanted", "keyframes.refused")}
    # three wait behind the one held, then a busy mapper refuses
    assert n["keyframes.refused"] >= 1, n
    assert n["keyframes.wanted"] == n["keyframes.refused"] + 3, n
    # the tracker waited for the worker while it held the lock, inside a
    # track call, the wait tagged with the worker's open spans
    waits = [r for r in recs if r.name == "slice.map_lock_wait" and r.thread == me]
    assert waits and all(r.parent != 0 for r in waits)
    assert ("mapping.keyframe", "mapping.lba_commit") in [r.value for r in waits]
    queued = [r for r in recs if r.name == "mapping.queue_wait"]
    assert len(queued) == len(calls) == int(slam.map.n_keyframes())
    assert all(r.thread != me and r.parent == 0 for r in queued)
    # the keyframes that queued behind the held worker waited for it
    assert max(r.end - r.start for r in queued) * 1e-6 > 100.0


def test_enable_false_records_nothing_and_keeps_the_ranges():
    from torch.profiler import ProfilerActivity, profile
    lock = TracedLock()
    n0, d0 = len(RECORDER.records), RECORDER.dropped
    profiling.enable(False)
    try:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            with span("slice.off_check"):
                pass
        profiling.count("keyframes.wanted")
        RECORDER.device("stage.frontend", 5)
        RECORDER.end(RECORDER.begin("mapping.queue_wait"))
        holder = threading.Thread(target=lambda: (lock.acquire(), time.sleep(0.05),
                                                  lock.release()))
        holder.start()
        time.sleep(0.01)
        with lock:
            pass
        holder.join()
        assert len(RECORDER.records) == n0 and RECORDER.dropped == d0
        assert any(e.name() == "slice.off_check"
                   for e in prof.profiler.kineto_results.events())
    finally:
        profiling.enable(True)
    with span("slice.on_check"):
        pass
    assert RECORDER.records[-1].name == "slice.on_check"


def test_the_ring_and_the_samples_are_bounded():
    rec = Recorder(ring=8, keep=3)
    for i in range(20):
        rec.count("keyframes.wanted", i)
    assert len(rec.records) == 8 and rec.dropped == 12
    assert [r.value for r in rec.records] == list(range(12, 20))
    for ns in (1_000_000, 2_000_000, 3_000_000, 4_000_000):
        rec.device("stage.frontend", ns)
    st = rec.stats("stage.frontend")
    assert st["count"] == 3 and st["median_ms"] == 3.0
    t = rec.begin("mapping.queue_wait")
    out = []
    th = threading.Thread(target=lambda: out.append(rec.end(t)))
    th.start()
    th.join()
    last = rec.records[-1]
    assert last.name == "mapping.queue_wait" and last.parent == 0 and last.end >= last.start
    rec.reset()
    assert not rec.records and rec.dropped == 0


def test_stamp_writes_the_host_clock_on_the_cpu_and_checks_its_buffer():
    from jetson_slam_tpu_torch.ops.cuda_stamp import stamp
    buf = torch.zeros(4, dtype=torch.int64)
    before = time.perf_counter_ns()
    for i in range(4):
        stamp(buf, i)
    assert before <= int(buf[0]) <= int(buf[1]) <= int(buf[3]) <= time.perf_counter_ns()
    with pytest.raises(ValueError, match="int64"):
        stamp(torch.zeros(4, dtype=torch.int32), 0)
    with pytest.raises(ValueError, match="slot"):
        stamp(buf, 4)
    with pytest.raises(ValueError, match="device"):
        stamp(buf.to("meta"), 0)


def test_spans_and_the_traced_lock_under_thread_switching_stress():
    """Eight threads, switching every microsecond, each nesting spans and
    incrementing a shared count under the traced lock (re-entered, and
    under a Condition): no update is lost, every span's parent is the
    enclosing span of its own thread, and the lock ends free."""
    import sys
    lock = TracedLock()
    cond = threading.Condition(lock)
    box = {"n": 0}
    n_threads, n_iter = 8, 200
    t0 = time.perf_counter_ns()
    idents = set()

    def work():
        idents.add(threading.get_ident())
        for _ in range(n_iter):
            with span("slice.stress_outer"):
                with lock, span("slice.stress_inner"):
                    with cond:
                        v = box["n"]
                        box["n"] = v + 1
                        cond.notify_all()

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert box["n"] == n_threads * n_iter
    assert lock._owner is None and lock._count == 0 and lock.acquire(blocking=False)
    lock.release()
    recs = [r for r in _mine(t0) if r.thread in idents]
    outer = {r.id: r for r in recs if r.name == "slice.stress_outer"}
    inner = [r for r in recs if r.name == "slice.stress_inner"]
    assert len(outer) == len(inner) == n_threads * n_iter
    for r in inner:
        p = outer[r.parent]
        assert p.thread == r.thread and p.start <= r.start <= r.end <= p.end
    waits = [r for r in recs if r.name == "mapping.map_lock_wait"]
    assert all(outer[r.parent].thread == r.thread for r in waits)
    assert len({r.id for r in recs if r.kind == "span"}) == \
        len([r for r in recs if r.kind == "span"])
