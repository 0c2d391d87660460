"""Train a BoW vocabulary from the port's own ORB descriptors: the
counterpart of ``examples/train_vocabulary.py``, on the card.

The reference loads a pre-trained DBoW2 ORBvoc.txt at startup
(System.cpp:72-79); the package bundles vocabularies trained on
descriptors that its front-end extracts from synthetic scenes of every
geometry the generator has (arc, line, circle, orbit; a corpus of one
geometry leaves the others' textures out and loop recall on them drops).
The defaults give a k=10, L=4 tree (10,000 leaf words), as the bundled
``vocab_10k.txt.gz``.

Usage:
  python -m jetson_slam_tpu_torch.cli.train_vocabulary --out vocab.txt.gz
      [--k 10] [--L 4] [--scenes 40] [--frames 6] [--device cuda]

``--device cpu`` runs the front-end's plain PyTorch versions on the CPU.
The result is written in the DBoW2 text format (``Vocabulary.save_text``;
gzip for a ``.gz`` path) and loads with ``Vocabulary.load_text``.
"""
from __future__ import annotations

import argparse
import time

import numpy as np

TRAJECTORIES = ("arc", "line", "circle", "orbit")


def collect_descriptors(n_scenes=40, frames_per_scene=6, h=240, w=320,
                        device="cuda") -> np.ndarray:
    """The valid descriptors (N, 32) uint8 of both eyes of every frame of
    ``n_scenes`` synthetic scenes (seed 100 + scene, 1200 points, the
    trajectories in turn), in the order scene, frame, left then right.
    Each scene's images go through one batched extraction."""
    import torch
    from ..io.synthetic import make_stereo_sequence
    from ..ops.frontend import OrbFrontend
    fe = OrbFrontend(h, w, n_levels=4, scale_factor=1.2, threshold=15,
                     tile_h=12, tile_w=12, device=device)
    descs = []
    for s in range(n_scenes):
        seq = make_stereo_sequence(seed=100 + s, n_frames=frames_per_scene, h=h, w=w,
                                   n_points=1200,
                                   trajectory=TRAJECTORIES[s % len(TRAJECTORIES)])
        imgs = np.stack([im for i in range(frames_per_scene)
                         for im in (seq.lefts[i], seq.rights[i])])
        res, _ = fe.extract_batch(torch.as_tensor(imgs, device=fe.device))
        valid, desc = res.valid.cpu().numpy(), res.desc.cpu().numpy()
        descs += [d[v] for d, v in zip(desc, valid)]
        print(f"scene {s + 1}/{n_scenes}: {sum(len(d) for d in descs)} descriptors",
              flush=True)
    return np.concatenate(descs)


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", required=True, help="output path (.txt or .txt.gz)")
    ap.add_argument("--k", type=int, default=10, help="branching factor")
    ap.add_argument("--L", type=int, default=4, help="depth levels")
    ap.add_argument("--scenes", type=int, default=40)
    ap.add_argument("--frames", type=int, default=6, help="frames per scene")
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def main(argv=None):
    """Collect, train and save; returns the trained Vocabulary."""
    from ..bow.vocabulary import Vocabulary
    ns = parse_args(argv)
    t0 = time.perf_counter()
    descs = collect_descriptors(ns.scenes, ns.frames, device=ns.device)
    print(f"collected {len(descs)} descriptors in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    voc = Vocabulary.train(descs, k=ns.k, L=ns.L, seed=0)
    print(f"trained k={ns.k} L={ns.L}: {voc.n_words} words in "
          f"{time.perf_counter() - t0:.1f} s")
    voc.save_text(ns.out)
    print(f"saved to {ns.out}")
    return voc


if __name__ == "__main__":
    main()
