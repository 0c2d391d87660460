"""The port's cross-process keyframe handoff against the JAX package on the
CPU.

A JAX session (tests/test_multihost.py's scene, 10 frames, local BA off)
runs in a spawned child beside the port's tests; its map comes over with
``convert.map_store_from_numpy``.

- the delta round trip port -> port: the applied rows equal the source's,
  the observation index agrees with ``kf_obs``, no applied row is left in
  the keyframe free list and the rows skipped below the new mark are in
  it, the creation counters ``kf_seq`` carried;
- a delta that JAX's ``serialize_kf_delta`` wrote applies in the port
  (``kf_seq`` then derived from ``kf_frame_id``);
- JAX's ``apply_kf_delta`` leaves the observation index empty, the port's
  rebuilds it;
- ``cli/cross_host_worker.py`` as 2 gloo processes on the CPU over a
  FileStore (12 frames, smaller than JAX's slow-marked
  tests/test_multihost.py);
- ``initialize`` is idempotent, and ``kv_get_bytes`` of a key nobody
  publishes times out.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest

pytest.importorskip("jax")
import torch  # noqa: E402

from jetson_slam_tpu_torch.convert import map_store_from_numpy  # noqa: E402
from jetson_slam_tpu_torch.core.map import MapStore  # noqa: E402
from jetson_slam_tpu_torch.parallel import multihost as mh  # noqa: E402
from tests.test_torch_dist_ba import run_ranks  # noqa: E402
from tests.test_torch_solvers import InChild  # noqa: E402

torch.set_num_threads(2)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_STATE = ("_pt_obs", "_kf_free", "_next_pt", "_next_kf", "loop_edges", "version")


def _jax_session():
    """The JAX session's map state, its delta blob of every keyframe, and
    the observation index of that blob applied into a fresh JAX map."""
    from jetson_slam_tpu.core.map import MapStore as JaxMapStore
    from jetson_slam_tpu.io.synthetic import make_stereo_sequence
    from jetson_slam_tpu.parallel import multihost as jmh
    from tests.test_slam_e2e import make_system
    seq = make_stereo_sequence(seed=23, n_frames=10, h=240, w=320, n_points=900,
                               trajectory="arc")
    slam = make_system(seq, enable_ba=False)
    for i in range(len(seq.lefts)):
        slam.track_stereo(seq.lefts[i], seq.rights[i], seq.timestamps[i])
    m = slam.map
    blob = jmh.serialize_kf_delta(m, m.keyframe_ids())
    fresh = JaxMapStore(max_points=m.max_points, max_keyframes=m.max_keyframes,
                        n_slots=m.n_slots)
    jmh.apply_kf_delta(fresh, blob)
    state = {k: v for k, v in vars(m).items()
             if k.startswith(("pt_", "kf_")) or k in _STATE}
    return state, blob, fresh._pt_obs


@pytest.fixture(scope="module", autouse=True)
def jax_child():
    child = InChild(_jax_session).start()
    yield child
    child.close()


@pytest.fixture(scope="module")
def jax_run(jax_child):
    return jax_child.result()


def _fresh(m):
    return MapStore(max_points=m.max_points, max_keyframes=m.max_keyframes,
                    n_slots=m.n_slots)


def obs_triples(m):
    """(index triples, kf_obs triples) of the live points."""
    index = {(pid, kf, s) for pid, obs in m._pt_obs.items() if m.pt_alive[pid]
             for kf, s in obs.items()}
    ks, slots = np.nonzero(m.kf_obs >= 0)
    table = {(int(m.kf_obs[k, s]), int(k), int(s)) for k, s in zip(ks, slots)
             if m.pt_alive[m.kf_obs[k, s]]}
    return index, table


def _rows_equal(dst, src, kids, pids):
    for f in mh._KF_FIELDS:
        assert np.array_equal(getattr(dst, f)[kids], getattr(src, f)[kids]), f
    for f in mh._PT_FIELDS:
        assert np.array_equal(getattr(dst, f)[pids], getattr(src, f)[pids]), f
    assert dst.kf_alive[kids].all() and dst.pt_alive[pids].all()


# ------------------------------------------------------------------- tests
def test_cross_host_worker_two_processes_on_the_cpu(tmp_path):
    store = tmp_path / "store"
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="2")
    cmd = [sys.executable, "-m", "jetson_slam_tpu_torch.cli.cross_host_worker",
           f"file://{store}", "2"]
    procs = [subprocess.Popen(cmd + [str(r), "--device", "cpu", "--backend", "gloo",
                                     "--frames", "12"],
                              cwd=REPO, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True) for r in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=240)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    stats = []
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"process {r} exited {p.returncode}:\n{out}"
        assert f"CROSS_HOST_OK {r}" in out, out
        line = [s for s in out.splitlines() if s.startswith("CROSS_HOST_STATS ")][-1]
        stats.append(json.loads(line.split(" ", 1)[1]))
    assert "applied delta" in outs[1] and "problem digest consistent" in outs[1]
    assert stats[1]["obs_index_ok"] is True
    assert stats[0]["digest"] == stats[1]["digest"]
    assert stats[0]["delta_bytes"] == stats[1]["delta_bytes"] > 0
    assert stats[0]["lm_collectives"] == 2 * stats[0]["lm_iterations"] == 12


def test_delta_round_trip_port_to_port(jax_run):
    src = map_store_from_numpy(jax_run[0])
    kids = src.keyframe_ids()
    assert len(kids) >= 3
    dst = _fresh(src)
    # the receiver had freed two of the rows the delta brings
    dst._next_kf = int(kids.max()) + 1
    dst._kf_free = [int(kids[0]), int(kids[-1])]
    applied_kids, pids = mh.apply_kf_delta(dst, mh.serialize_kf_delta(src, kids))
    assert np.array_equal(applied_kids, kids) and len(pids) > 50
    _rows_equal(dst, src, kids, pids)
    index, table = obs_triples(dst)
    assert index == table and len(index) > 100
    assert not set(dst._kf_free) & set(kids.tolist())
    assert np.array_equal(dst.kf_seq[kids], src.kf_seq[kids])
    assert dst._next_kf_seq == src.kf_seq[kids].max() + 1
    assert dst.version == 1


def test_delta_of_some_keyframes_frees_the_skipped_rows(jax_run):
    src = map_store_from_numpy(jax_run[0])
    kids = src.keyframe_ids()[1::2]
    dst = _fresh(src)
    mh.apply_kf_delta(dst, mh.serialize_kf_delta(src, kids))
    assert dst._next_kf == kids.max() + 1
    assert sorted(dst._kf_free) == sorted(set(range(dst._next_kf)) - set(kids.tolist()))
    index, table = obs_triples(dst)
    assert index == table


def test_jax_delta_applies_in_the_port(jax_run):
    state, blob, _ = jax_run
    src = map_store_from_numpy(state)
    dst = _fresh(src)
    kids, pids = mh.apply_kf_delta(dst, blob)
    _rows_equal(dst, src, kids, pids)
    # no K_kf_seq in a JAX blob: the counters follow kf_frame_id
    assert np.array_equal(np.argsort(dst.kf_seq[kids]), np.argsort(dst.kf_frame_id[kids]))
    assert sorted(dst.kf_seq[kids]) == list(range(len(kids)))
    index, table = obs_triples(dst)
    assert index == table


def test_jax_apply_leaves_the_obs_index_empty_the_port_rebuilds_it(jax_run):
    """JAX's apply_kf_delta never rebuilds _pt_obs
    (jetson_slam_tpu/parallel/multihost.py:103), so every observations_of()
    on the receiver is empty; the port's apply rebuilds it."""
    state, blob, jax_index = jax_run
    assert jax_index == {}
    dst = _fresh(map_store_from_numpy(state))
    _, pids = mh.apply_kf_delta(dst, blob)
    # every point of the delta is seen by a keyframe of the delta
    assert all(len(dst.observations_of(int(p))[0]) >= 1 for p in pids)


def _initialize_twice(rank, store_path):
    store = mh.initialize("file://" + store_path, 1, 0)
    try:
        mh.kv_get_bytes("nobody", timeout_ms=200)
        timed_out = False
    except RuntimeError:
        timed_out = True
    mh.kv_put_bytes("k", b"\x00\xffz")
    return store is mh._store, timed_out, mh.kv_get_bytes("k", 1000)


def test_initialize_is_idempotent_and_kv_get_times_out(tmp_path):
    (same, timed_out, value), = run_ranks(_initialize_twice, tmp_path,
                                          str(tmp_path / "unused"), world=1)
    assert same and timed_out and value == b"\x00\xffz"
