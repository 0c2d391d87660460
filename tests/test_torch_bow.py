"""The port's BoW vocabulary and keyframe database against the JAX package
on the CPU:

- ``Vocabulary.train`` builds the same tree for the same seed, array for
  array;
- the bundled small and 10k vocabularies load from the port's own
  ``data/`` into the same arrays, without writing a sidecar there, and
  give identical words, weights and nodes (``transform``), sparse and
  dense BoW vectors and scores;
- the DBoW2 text format round-trips;
- on a hand-built map of three places, both databases return identical
  loop and relocalization candidates.
"""
import os

import numpy as np
import pytest

pytest.importorskip("jax")
import torch  # noqa: E402

from jetson_slam_tpu.bow import database as jdb  # noqa: E402
from jetson_slam_tpu.bow import vocabulary as jvoc  # noqa: E402
from jetson_slam_tpu.core.map import MapStore as JaxMapStore  # noqa: E402
from jetson_slam_tpu_torch.bow import database as tdb  # noqa: E402
from jetson_slam_tpu_torch.bow import vocabulary as tvoc  # noqa: E402
from jetson_slam_tpu_torch.convert import vocabulary_from_numpy  # noqa: E402
from jetson_slam_tpu_torch.core.map import MapStore  # noqa: E402

torch.set_num_threads(2)

ARRAYS = ("children", "centroids", "is_leaf", "word_id", "weights", "node_level")


def _same_tree(a, b):
    assert (a.k, a.L, a.n_words) == (b.k, b.L, b.n_words)
    for name in ARRAYS:
        x, y = getattr(a, name), getattr(b, name)
        assert x.dtype == y.dtype and np.array_equal(x, y), name


def _descriptors(seed, n_centres=40, per=30, flip=0.08):
    """Clustered binary descriptors: noisy copies of random centres."""
    rng = np.random.default_rng(seed)
    centres = rng.integers(0, 256, (n_centres, 32), dtype=np.uint8)
    bits = np.unpackbits(np.repeat(centres, per, 0), axis=1)
    bits ^= (rng.random(bits.shape) < flip).astype(np.uint8)
    return np.packbits(bits, axis=1)


@pytest.mark.parametrize("k,L", [(6, 3), (4, 2)])
def test_train_builds_the_same_tree(k, L):
    descs = _descriptors(0)
    _same_tree(tvoc.Vocabulary.train(descs, k=k, L=L, seed=0),
               jvoc.Vocabulary.train(descs, k=k, L=L, seed=0))


@pytest.mark.parametrize("name", ["small", "10k"])
def test_bundled_vocabulary_matches_jax(name):
    data = os.path.join(os.path.dirname(tvoc.__file__), os.pardir, "data")
    before = sorted(os.listdir(data))
    tvoc._BUNDLED_CACHE.pop(name, None)
    t = tvoc.bundled_vocabulary(name)
    assert sorted(os.listdir(data)) == before       # no sidecar written
    j = jvoc.bundled_vocabulary(name)
    _same_tree(t, j)
    descs = np.concatenate([_descriptors(1),
                            np.random.default_rng(2).integers(0, 256, (300, 32),
                                                              dtype=np.uint8)])
    for levelsup in (2, 1):
        for a, b in zip(t.transform(descs, levelsup), j.transform(descs, levelsup)):
            assert a.dtype == b.dtype and np.array_equal(a, b)
    for a, b in zip(t.sparse_bow(descs), j.sparse_bow(descs)):
        assert np.array_equal(a, b)
    assert np.array_equal(t.bow_vector(descs[:500]), j.bow_vector(descs[:500]))
    assert t.l1_score(t.bow_vector(descs[:300]), t.bow_vector(descs[300:600])) == \
        j.l1_score(j.bow_vector(descs[:300]), j.bow_vector(descs[300:600]))


def test_l1_score_matrix_matches_jax():
    v = jvoc.bundled_vocabulary("small")
    V = np.stack([v.bow_vector(_descriptors(s, 10, 20)) for s in range(5)])
    want = np.asarray(jvoc.Vocabulary.l1_score_matrix(V[:3], V))
    got = tvoc.Vocabulary.l1_score_matrix(torch.as_tensor(V[:3]), torch.as_tensor(V))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=0)
    assert np.allclose(np.diag(got.numpy()), 1.0, atol=1e-6)


def test_text_format_round_trips(tmp_path):
    voc = tvoc.Vocabulary.train(_descriptors(3), k=5, L=3, seed=1)
    for name in ("voc.txt", "voc.txt.gz"):
        path = str(tmp_path / name)
        voc.save_text(path)
        back = tvoc.Vocabulary.load_text(path, cache=False)
        descs = _descriptors(4)
        for a, b in zip(voc.transform(descs), back.transform(descs)):
            assert np.array_equal(a, b)
        np.testing.assert_allclose(back.weights, voc.weights, rtol=1e-6)


def test_vocabulary_from_numpy_copies_the_tree():
    j = jvoc.Vocabulary.train(_descriptors(5), k=6, L=3, seed=0)
    _same_tree(vocabulary_from_numpy(vars(j)), j)


def _places_map(map_cls, seed=0):
    """Three places, each seen by three keyframes that share its points
    (so they are covisible); every keyframe also holds its own clutter."""
    rng = np.random.default_rng(seed)
    m = map_cls(max_points=2048, max_keyframes=16, n_slots=256)
    places = [_descriptors(10 + p, n_centres=60, per=1, flip=0.0) for p in range(3)]
    for p, descs in enumerate(places):
        pids = [m.add_point(np.array([p, 0.0, 5.0], np.float32), d, 0) for d in descs]
        for _ in range(3):
            kid = m._next_kf
            m._next_kf += 1
            m.kf_alive[kid] = True
            m.kf_pose[kid] = np.eye(4, dtype=np.float32)
            noisy = np.unpackbits(descs, axis=1)
            noisy ^= (rng.random(noisy.shape) < 0.03).astype(np.uint8)
            kd = np.concatenate([np.packbits(noisy, axis=1),
                                 rng.integers(0, 256, (40, 32), dtype=np.uint8)])
            m.kf_desc[kid, :len(kd)] = kd
            m.kf_kp_valid[kid, :len(kd)] = True
            for slot, pid in enumerate(pids):
                m.add_observation(kid, slot, pid)
    return m, places


@pytest.mark.parametrize("name", ["small", "10k"])
def test_database_candidates_match_jax(name):
    jv = jvoc.bundled_vocabulary(name)
    tv = tvoc.bundled_vocabulary(name)
    jm, places = _places_map(JaxMapStore)
    tm, _ = _places_map(MapStore)
    jd = jdb.KeyFrameDatabase(jv, max_keyframes=16)
    td = tdb.KeyFrameDatabase(tv, max_keyframes=16)
    for kid in jm.keyframe_ids():
        for d, m in ((jd, jm), (td, tm)):
            d.add(kid, m.kf_desc[kid][m.kf_kp_valid[kid]])
    for kid in jm.keyframe_ids():
        neigh_j, _ = jm.covisible_keyframes(kid, n=None)
        neigh_t, _ = tm.covisible_keyframes(kid, n=None)
        assert np.array_equal(neigh_j, neigh_t)
        assert td.score(kid, int(neigh_t[0])) == jd.score(kid, int(neigh_j[0]))
        want = jd.detect_loop_candidates(kid, 0.0, neigh_j, jm)
        got = td.detect_loop_candidates(kid, 0.0, neigh_t, tm)
        assert np.array_equal(got, want)
    rng = np.random.default_rng(7)
    for p, descs in enumerate(places):
        q = np.unpackbits(descs, axis=1)
        q ^= (rng.random(q.shape) < 0.05).astype(np.uint8)
        q = np.packbits(q, axis=1)
        want = jd.detect_relocalization_candidates(q, jm)
        got = td.detect_relocalization_candidates(q, tm)
        assert np.array_equal(got, want)
        assert len(got) and set(got) <= {3 * p, 3 * p + 1, 3 * p + 2}
    jd.erase(4)
    td.erase(4)
    assert np.array_equal(td.detect_relocalization_candidates(places[1], tm),
                          jd.detect_relocalization_candidates(places[1], jm))
