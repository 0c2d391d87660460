"""Async tracking / mapping pipeline.

Port of ``jetson_slam_tpu/core/pipeline.py``.  The reference runs Tracking
on the caller's thread and LocalMapping on its own (System.cpp:97-111),
coordinated by a keyframe queue (LocalMapping.h:111,117), the mbAbortBA
interrupt (LocalMapping.cpp:120-125) and the map mutex (Map.h:68).  Here a
worker thread drains the keyframe queue and runs the mapping stages while
the tracker keeps taking frames.

One shared re-entrant lock plays Map::mMutexMapUpdate (a
``profiling.TracedLock``, which records every acquisition that waits, by
the spans its holder has open): the tracker holds it for the
map part of a frame, the worker runs ``LocalMapper.process_keyframe`` with
it, which takes it stage by stage and solves local BA without it.  The
mapper's device work goes to its own CUDA stream (``LocalMapper.device_ctx``,
entered by ``process_keyframe`` on the worker's thread), on the mapper's
device (``mapping_device``, else the tracker's), so it overlaps the
tracker's stream.  The two threads share no tensors: map data
crosses only as numpy, under the lock.  With a loop closer the worker runs
it after each keyframe it mapped that is still alive, under the lock and
on the mapper's stream (LoopClosing's own thread in the reference).  An
exception on the worker is re-raised on the tracker's thread at its next
call into the pipeline.  Each keyframe's time in the queue, from
``insert_keyframe`` to the worker's pop, is the span ``mapping.queue_wait``.
"""
from __future__ import annotations

import threading
import time

from ..utils.profiling import RECORDER, TracedLock


class AsyncMappingPipeline:
    """The Tracker's ``local_mapper`` handle with the LocalMapper protocol
    (insert_keyframe / tick / accepting / interrupt_ba / queue_len), the
    work done on a daemon worker thread (LocalMapping::Run,
    LocalMapping.cpp:53-114)."""

    def __init__(self, mapper, loop_closer=None,
                 lock=None):
        """lock: the map lock (a TracedLock or a threading.RLock); by
        default a new TracedLock."""
        self.mapper = mapper
        self.loop_closer = loop_closer
        self.lock = lock if lock is not None else TracedLock()
        self._cond = threading.Condition(self.lock)
        self._queue: list[int] = []
        self._queued: dict = {}     # kid -> its mapping.queue_wait token
        self._processing = False
        self._stop = False
        self._error: BaseException | None = None
        self._thread = threading.Thread(target=self._run, name="local-mapping",
                                        daemon=True)
        self._thread.start()

    # ---- the tracker's protocol (the LocalMapper's)
    def insert_keyframe(self, kid: int):
        self._reraise()
        with self._cond:
            self._queue.append(kid)
            self._queued[kid] = RECORDER.begin("mapping.queue_wait")
            # LocalMapping::InsertKeyFrame sets mbAbortBA (LocalMapping.cpp:120)
            self.mapper.interrupt_ba()
            self._cond.notify()

    def tick(self):
        """Once per tracked frame: surfaces a worker error."""
        self._reraise()

    def accepting(self):
        with self.lock:
            return not self._queue and not self._processing

    def interrupt_ba(self):
        self.mapper.interrupt_ba()

    def queue_len(self):
        """LocalMapping::KeyframesInQueue: the keyframes waiting, not the
        one being mapped (ProcessNewKeyFrame pops it first); a busy mapper
        takes a new keyframe while fewer than 3 wait."""
        with self.lock:
            return len(self._queue)

    # -------------------------------------------------------------- worker
    def _run(self):
        m = self.mapper
        while True:
            with self._cond:
                while not self._queue and not self._stop:
                    self._cond.wait(timeout=0.05)
                if self._stop and not self._queue:
                    return
                kid = self._queue.pop(0)
                RECORDER.end(self._queued.pop(kid, None))
                self._processing = True
                # the backlog, for the mapper's "skip BA when backed up"
                # (LocalMapping::Run runs BA only on an empty queue)
                m.queue = self._queue
            try:
                # the synchronous mapper's own stages, with the map lock taken
                # stage by stage; unlike the JAX package's worker it also
                # sets the keyframe's spanning-tree parent and bumps the
                # map's version
                m.process_keyframe(kid, self.lock)
                if self.loop_closer is not None:
                    with m.device_ctx(), self.lock:
                        if m.map.kf_alive[kid]:
                            self.loop_closer.process_keyframe(kid)
            except BaseException as e:  # re-raised on the tracker's thread
                self._error = e
            finally:
                with self._cond:
                    self._processing = False
                    self._cond.notify_all()

    # ----------------------------------------------------------- lifecycle
    def drain(self, timeout: float = 60.0):
        """Block until the queue is empty and the worker idle; re-raises a
        worker error."""
        deadline = time.monotonic() + timeout
        with self._cond:
            while (self._queue or self._processing) and time.monotonic() < deadline:
                self._cond.wait(timeout=0.05)
        self._reraise()

    def shutdown(self, timeout: float = 60.0):
        """Drain, then stop and join the worker, even when draining raised."""
        try:
            self.drain(timeout)
        finally:
            with self._cond:
                self._stop = True
                self._cond.notify_all()
            self._thread.join(timeout=5.0)
        self._reraise()

    def _reraise(self):
        if self._error is not None:
            e, self._error = self._error, None
            raise e
