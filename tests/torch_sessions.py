"""What the port-against-JAX session tests share (tests/test_torch_adversarial.py,
tests/test_torch_classic.py, tests/test_torch_parity_cover.py):

- ``config``: the 320x240 stereo configuration of the JAX suite's
  whole-run tests (3 levels, tile 16, no lens);
- ``stereo_frames``: a synthetic sequence of the JAX package's
  ``make_stereo_sequence`` with only the frames a test feeds rendered
  (the others None), once per process: the same numpy images go through
  both packages;
- ``jax_session``: the JAX package's sessions, run in two spawned
  children per test process, which take them in turn, beside the port's
  sessions here.  The children share JAX's persistent compilation cache
  in a temporary directory (removed when the process exits), so a
  session that a SlamSystem compiles again reuses the programs of the
  ones before.
"""
import atexit
import functools
import multiprocessing
import os
import shutil
import tempfile
import traceback

import numpy as np


def config(cfg, seq, w=320, h=240):
    c = cfg.camera
    c.fx, c.fy, c.cx, c.cy, c.bf = seq.fx, seq.fy, seq.cx, seq.cy, seq.bf
    c.width, c.height = w, h
    c.k1 = c.k2 = c.p1 = c.p2 = 0.0
    c.th_depth = 40.0
    cfg.orb.n_levels = 3
    cfg.orb.tile_h = cfg.orb.tile_w = 16
    cfg.orb.th_fast_max = 15
    cfg.max_map_points = 16384
    cfg.max_keyframes = 64
    return cfg


@functools.lru_cache(maxsize=None)
def _sequence(seed, n_frames, n_points, h, w):
    from jetson_slam_tpu.io import synthetic
    seq = synthetic.make_stereo_sequence(seed=seed, n_frames=n_frames, h=2, w=2,
                                         n_points=1)
    seq.cx, seq.cy = w / 2.0, h / 2.0
    seq.lefts, seq.rights = [None] * n_frames, [None] * n_frames
    seq.scene = synthetic.make_scene(np.random.default_rng(seed), n_points=n_points)
    return seq


def stereo_frames(seed, n_frames, fed, n_points=900, h=240, w=320):
    """make_stereo_sequence(seed, n_frames, h, w, "arc", n_points=n_points)
    with the frames of ``fed`` rendered (once per process) and the others
    None: the poses depend on n_frames alone and the scene on seed and
    n_points, so each frame fed is the sequence's own."""
    from jetson_slam_tpu.io import synthetic
    seq = _sequence(seed, n_frames, n_points, h, w)
    T_rl = np.eye(4)
    T_rl[0, 3] = -seq.baseline
    for i in sorted(set(fed)):
        if seq.lefts[i] is None:
            T_cw = np.linalg.inv(seq.poses_twc[i])
            args = (seq.fx, seq.fy, seq.cx, seq.cy, h, w)
            seq.lefts[i] = synthetic.render(seq.scene, T_cw, *args)
            seq.rights[i] = synthetic.render(seq.scene, T_rl @ T_cw, *args)
    return seq


def _serve(conn, cache):
    os.environ.setdefault("TF_CPP_MIN_LOG_LEVEL", "3")
    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_compilation_cache_dir", cache)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)
    try:
        while True:
            try:
                fn, args = conn.recv()
            except EOFError:
                break
            try:
                conn.send((True, fn(*args)))
            except BaseException:
                conn.send((False, traceback.format_exc()))
    finally:
        conn.close()


class JaxChild:
    """A spawned process that runs fn(*args) for each ``submit`` in turn;
    ``result(i)`` waits for the i-th.  fn must be at a module's top level.
    The process keeps JAX's compilation cache in the directory ``cache``."""

    def __init__(self, cache):
        ctx = multiprocessing.get_context("spawn")
        self._conn, child_conn = ctx.Pipe()
        self._proc = ctx.Process(target=_serve, args=(child_conn, cache), daemon=True)
        self._proc.start()
        child_conn.close()
        self._sent, self._got = 0, []

    def submit(self, fn, *args):
        self._conn.send((fn, args))
        self._sent += 1
        return self._sent - 1

    def result(self, i):
        while len(self._got) <= i:
            if not self._conn.poll(1.0):
                if not self._proc.is_alive() and not self._conn.poll(0):
                    raise RuntimeError(f"the JAX child exited with {self._proc.exitcode}")
                continue
            self._got.append(self._conn.recv())
        ok, value = self._got[i]
        if not ok:
            raise RuntimeError(f"the JAX session failed:\n{value}")
        return value

    def close(self):
        self._conn.close()           # the child reads EOF and exits
        self._proc.join(30)
        if self._proc.is_alive():
            self._proc.kill()
            self._proc.join()


N_CHILDREN = 2
_POOL = []


def _close_pool(cache):
    for child in _POOL:
        child.close()
    shutil.rmtree(cache, ignore_errors=True)


def jax_session(fn, *args):
    """fn(*args) in one of this process's JAX children, which take the
    sessions asked in turn; returns a callable that waits for the value."""
    if not _POOL:
        cache = tempfile.mkdtemp(prefix="jax-compile-cache-")
        _POOL.extend(JaxChild(cache) for _ in range(N_CHILDREN))
        atexit.register(_close_pool, cache)
    child = min(_POOL, key=lambda c: c._sent)
    return functools.partial(child.result, child.submit(fn, *args))
