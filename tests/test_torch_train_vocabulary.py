"""The port's vocabulary trainer (``cli/train_vocabulary.py``) against the
JAX tool's ``Vocabulary.train`` on the CPU: the descriptors the port's
front-end collects from one synthetic scene go through both trainers with
the same seed and settings, and the trees are equal (children, centroids,
leaves, words, levels and idf weights); the file the tool writes loads
with ``Vocabulary.load_text`` into the tree JAX's own save and load give.
"""
import numpy as np
import pytest

pytest.importorskip("jax")
import torch  # noqa: E402

from jetson_slam_tpu.bow.vocabulary import Vocabulary as JaxVocabulary  # noqa: E402
from jetson_slam_tpu_torch.bow.vocabulary import Vocabulary  # noqa: E402
from jetson_slam_tpu_torch.cli import train_vocabulary  # noqa: E402

torch.set_num_threads(2)

FIELDS = ("children", "centroids", "is_leaf", "word_id", "weights", "node_level")


def _same_tree(a, b):
    assert (a.k, a.L, a.n_words) == (b.k, b.L, b.n_words)
    for f in FIELDS:
        assert np.array_equal(np.asarray(getattr(a, f)), np.asarray(getattr(b, f))), f


def test_trainer_matches_jax_train_and_loads(tmp_path):
    out = tmp_path / "voc.txt.gz"
    voc = train_vocabulary.main(["--out", str(out), "--k", "5", "--L", "3", "--scenes", "1",
                                 "--frames", "2", "--device", "cpu"])
    descs = train_vocabulary.collect_descriptors(1, 2, device="cpu")
    assert descs.dtype == np.uint8 and descs.shape[1] == 32 and len(descs) > 1000
    ref = JaxVocabulary.train(descs, k=5, L=3, seed=0)
    _same_tree(voc, ref)
    assert voc.n_words > 25
    loaded = Vocabulary.load_text(str(out), cache=False)
    ref_path = tmp_path / "jax.txt.gz"
    ref.save_text(str(ref_path))
    _same_tree(loaded, JaxVocabulary.load_text(str(ref_path), cache=False))


def test_trainer_defaults_are_the_bundled_tree_shape():
    ns = train_vocabulary.parse_args(["--out", "v.txt"])
    assert (ns.k, ns.L, ns.scenes, ns.frames, ns.device) == (10, 4, 40, 6, "cuda")
