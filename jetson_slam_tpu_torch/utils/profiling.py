"""Wall-clock and device tracing utilities.

Port of ``jetson_slam_tpu/utils/profiling.py``; replaces the reference's
``tictoc`` (include/tictoc.hpp:7-43) and its CUDA-event twin
(include/tictoc_cuda.hpp):

- ``TicToc``: a steady-clock stopwatch with named scopes and aggregate
  statistics (count / total / mean / median ms).  ``scope(name, sync=...)``
  synchronises the current CUDA stream of each given tensor's device before
  it stops the clock: kernel launches return before the card finishes.
- ``trace``: ``torch.profiler`` around a block (CPU, and CUDA when the
  card is there), written as a Chrome trace into a directory.
- ``RECORDER``: the process-wide span recorder, a ``TicToc`` whose spans
  also go to a bounded ring of records.  ``span(name)`` (a context manager
  and a decorator) opens the ``torch.profiler`` range ``name`` and records
  the span: its start and end on ``time.perf_counter_ns()``, its thread,
  its parent span on that thread and, on a thread's top-level spans and the
  waits, the thread's CPU time.  ``count(name, n)`` records a counter
  event, ``device(name, ns)`` a duration measured on the device.
  ``enable(False)`` stops the recording and leaves the ranges.
- ``TracedLock``: the map lock, a re-entrant lock that records each
  acquisition that has to wait, tagged with the spans the holder has open.
"""
from __future__ import annotations

import contextlib
import functools
import itertools
import os
import statistics
import threading
import time
from collections import defaultdict, deque
from typing import NamedTuple

import torch
from torch.profiler import record_function


def _sync(tensors) -> None:
    if isinstance(tensors, torch.Tensor):
        tensors = (tensors,)
    for dev in {t.device for t in tensors if t.device.type == "cuda"}:
        torch.cuda.current_stream(dev).synchronize()


class TicToc:
    """Named stopwatch registry with aggregate statistics."""

    def __init__(self, keep: int | None = None):
        """keep: the samples kept per name (the newest), or None for all."""
        self._samples = defaultdict(list if keep is None
                                    else functools.partial(deque, maxlen=keep))
        self._open = {}

    def tic(self, name: str = "default"):
        self._open[name] = time.perf_counter()

    def toc(self, name: str = "default") -> float:
        """Returns elapsed ms since tic(name) and records the sample."""
        dt = (time.perf_counter() - self._open.pop(name)) * 1e3
        self._samples[name].append(dt)
        return dt

    @contextlib.contextmanager
    def scope(self, name: str, sync=None):
        """Time a block; with ``sync`` (a tensor or a sequence of tensors),
        the work queued on their devices' current CUDA streams is finished
        before the clock stops."""
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if sync is not None:
                _sync(sync)
            self._samples[name].append((time.perf_counter() - t0) * 1e3)

    def stats(self, name: str) -> dict:
        s = self._samples[name]
        if not s:
            return {"count": 0}
        return {
            "count": len(s),
            "total_ms": sum(s),
            "mean_ms": sum(s) / len(s),
            "median_ms": statistics.median(s),
            "min_ms": min(s),
            "max_ms": max(s),
        }

    def report(self) -> str:
        lines = []
        for name in sorted(self._samples):
            st = self.stats(name)
            lines.append(
                f"{name:32s} n={st['count']:6d}  mean={st['mean_ms']:8.3f} ms"
                f"  median={st['median_ms']:8.3f} ms  total={st['total_ms']:10.1f} ms")
        return "\n".join(lines)

    def reset(self):
        self._samples.clear()
        self._open.clear()


@contextlib.contextmanager
def trace(log_dir: str):
    """``torch.profiler`` over a block, CPU and (with a card) CUDA
    activity; on exit the Chrome trace is written to
    ``log_dir/trace.json`` (view it in Perfetto or chrome://tracing).
    Yields the profiler, whose ``key_averages()`` tabulate the block."""
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


# ------------------------------------------------------------ span recorder
RING = 1 << 16      # records kept: 15 minutes at 60 to 80 records a second


class Record(NamedTuple):
    """One record of the recorder's ring.  ``kind``: "span", "count" or
    "device".  ``start``, ``end``: ``time.perf_counter_ns()`` (a count's
    and a device duration's are the moment it was recorded).  ``thread``:
    the ident of the thread that recorded it.  ``id``: the span's number;
    ``parent``: the enclosing span's on that thread, 0 at top level (and
    for a span that ends on another thread than it began).  ``cpu``: the
    thread's CPU ns over the span, on top-level spans and waits only, else
    None.  ``value``: a count's n, a device duration's ns, a lock wait's
    holder spans (the names the holding thread had open, outermost first),
    else None."""
    kind: str
    name: str
    start: int
    end: int
    thread: int
    id: int
    parent: int
    cpu: int | None
    value: object


def _record(*fields) -> Record:
    """A Record from its fields in order, without the argument handling of
    ``Record(...)``, which costs about half a microsecond a record."""
    return tuple.__new__(Record, fields)


class Recorder(TicToc):
    """The process-wide recorder: a ``TicToc`` (each span's ms go to its
    name's samples, the newest ``keep`` kept) whose spans, counters and
    device durations also go to a ring of the newest ``ring`` records."""

    def __init__(self, ring: int = RING, keep: int = 4096):
        super().__init__(keep=keep)
        self.records: deque = deque(maxlen=ring)
        self.enabled = True
        self.dropped = 0            # records pushed out of the ring
        self._stacks: dict = {}     # thread ident -> its open spans
        self._ids = itertools.count(1)
        # one reading of both clocks: maps a span onto the profiler's
        # Unix-epoch clock, and so onto the device trace
        self.clock = (time.perf_counter_ns(), time.time_ns())

    def to_epoch_ns(self, t: int) -> int:
        """A ``perf_counter_ns`` time on the Unix-epoch clock."""
        return t - self.clock[0] + self.clock[1]

    def _push(self, rec: Record):
        if len(self.records) == self.records.maxlen:
            self.dropped += 1
        self.records.append(rec)

    def open(self, name: str, cpu: bool = False) -> tuple:
        """Open a span on this thread; ``close`` ends it."""
        tid = threading.get_ident()
        stack = self._stacks.get(tid)
        if stack is None:
            stack = self._stacks[tid] = []
        parent = stack[-1][1] if stack else 0
        tcpu = time.thread_time_ns() if cpu or not stack else None
        sp = (name, next(self._ids), parent, tcpu, time.perf_counter_ns())
        stack.append(sp)
        return sp

    def close(self, sp: tuple, value=None):
        end = time.perf_counter_ns()
        name, sid, parent, tcpu, start = sp
        cpu = None if tcpu is None else time.thread_time_ns() - tcpu
        tid = threading.get_ident()
        stack = self._stacks[tid]
        stack.pop()
        if not stack:
            del self._stacks[tid]
        self._push(_record("span", name, start, end, tid, sid, parent, cpu, value))
        self._samples[name].append((end - start) * 1e-6)

    def open_spans(self, thread: int | None) -> tuple:
        """The names of the spans ``thread`` has open, outermost first."""
        stack = self._stacks.get(thread) if thread is not None else None
        return tuple(sp[0] for sp in list(stack or ()))

    def begin(self, name: str) -> tuple | None:
        """Start a span that may end on another thread (``end``); it opens
        no profiler range."""
        return (name, time.perf_counter_ns()) if self.enabled else None

    def end(self, token: tuple | None):
        if token is None or not self.enabled:
            return
        name, start = token
        end = time.perf_counter_ns()
        self._push(_record("span", name, start, end, threading.get_ident(),
                           next(self._ids), 0, None, None))
        self._samples[name].append((end - start) * 1e-6)

    def count(self, name: str, n: int = 1):
        if self.enabled:
            t = time.perf_counter_ns()
            self._push(_record("count", name, t, t, threading.get_ident(), 0, 0,
                               None, n))

    def device(self, name: str, ns: int):
        """A duration measured on the device, recorded now."""
        if self.enabled:
            t = time.perf_counter_ns()
            self._push(_record("device", name, t, t, threading.get_ident(), 0, 0,
                               None, int(ns)))
            self._samples[name].append(ns * 1e-6)

    def reset(self):
        super().reset()
        self.records.clear()
        self.dropped = 0


RECORDER = Recorder()


def enable(on: bool = True):
    """Switch the recording on or off; the profiler ranges stay."""
    RECORDER.enabled = bool(on)


def count(name: str, n: int = 1):
    """Record a counter event ``name`` of ``n``."""
    RECORDER.count(name, n)


class span:
    """``with span(name):`` or ``@span(name)``: the ``torch.profiler``
    range ``name``, and with the recording on a span record of it.
    ``cpu``: record the thread's CPU time (a thread's top-level spans
    record it always).  ``value``: kept in the record."""

    __slots__ = ("name", "cpu", "value", "_rf", "_sp")

    def __init__(self, name: str, cpu: bool = False, value=None):
        self.name, self.cpu, self.value = name, cpu, value

    def __enter__(self):
        self._rf = record_function(self.name)
        self._rf.__enter__()
        self._sp = RECORDER.open(self.name, self.cpu) if RECORDER.enabled else None
        return self

    def __exit__(self, *exc):
        if self._sp is not None:
            RECORDER.close(self._sp, self.value)
        self._rf.__exit__(*exc)
        return False

    def __call__(self, fn):
        """As a decorator: a fresh span around every call, so threads
        share none."""
        name, cpu = self.name, self.cpu

        @functools.wraps(fn)
        def run(*args, **kwargs):
            with span(name, cpu):
                return fn(*args, **kwargs)
        return run


class TracedLock:
    """A re-entrant lock (``threading.RLock``) that records every
    acquisition that has to wait: a span ``wait_span`` around the wait,
    with the thread's CPU time, its value the names of the spans the
    holding thread had open when the wait began.  An acquisition that does
    not wait costs one non-blocking acquire more.  ``threading.Condition``
    takes it as its lock.  ``waiting_as(name)`` is a handle on the same
    lock whose waits are recorded as ``name``."""

    def __init__(self, wait_span: str = "mapping.map_lock_wait"):
        self._lock = threading.RLock()
        self._owner = None      # ident of the holding thread
        self._count = 0
        self.wait_span = wait_span

    def acquire(self, blocking: bool = True, timeout: float = -1, wait_span=None):
        if self._lock.acquire(False):
            self._took()
            return True
        if not blocking:
            return False
        holder = RECORDER.open_spans(self._owner)
        with span(wait_span or self.wait_span, cpu=True, value=holder):
            if not self._lock.acquire(True, timeout):
                return False
            self._took()    # the holder is known before the wait's record
        return True

    def _took(self):
        self._owner = threading.get_ident()
        self._count += 1

    def release(self):
        if not self._lock._is_owned():
            raise RuntimeError("cannot release un-acquired lock")
        self._count -= 1
        if self._count == 0:
            self._owner = None
        self._lock.release()

    def __enter__(self):
        return self.acquire()

    def __exit__(self, *exc):
        self.release()

    # threading.Condition's hooks
    def _is_owned(self):
        return self._lock._is_owned()

    def _release_save(self):
        mine = (self._owner, self._count)
        self._owner, self._count = None, 0
        return self._lock._release_save(), mine

    def _acquire_restore(self, saved):
        inner, (owner, n) = saved
        self._lock._acquire_restore(inner)
        self._owner, self._count = owner, n

    def waiting_as(self, wait_span: str) -> "_LockHandle":
        return _LockHandle(self, wait_span)


class _LockHandle:
    """A TracedLock whose waits are recorded under another span name."""

    def __init__(self, lock: TracedLock, wait_span: str):
        self.lock, self.wait_span = lock, wait_span

    def acquire(self, blocking: bool = True, timeout: float = -1):
        return self.lock.acquire(blocking, timeout, self.wait_span)

    def release(self):
        self.lock.release()

    def __enter__(self):
        return self.acquire()

    def __exit__(self, *exc):
        self.lock.release()
