"""EuRoC replay-and-gate of the port: run rectified stereo SLAM over a EuRoC
sequence, score ATE against a golden trajectory, emit ONE JSON verdict.
The counterpart of ``examples/euroc_gate.py``.

  # a EuRoC sequence and a golden trajectory (TUM format, s or ns stamps):
  python -m jetson_slam_tpu_torch.cli.euroc_gate run examples/configs/EuRoC.yaml \\
      /data/euroc/MH_01_easy --golden CameraTrajectory_MH01.txt

  # self-test on synthetic data written in the EuRoC directory layout:
  python -m jetson_slam_tpu_torch.cli.euroc_gate make-synthetic /tmp/fake_mh01 --frames 40
  python -m jetson_slam_tpu_torch.cli.euroc_gate run /tmp/fake_mh01/settings.yaml \\
      /tmp/fake_mh01 --golden /tmp/fake_mh01/groundtruth_tum.txt

  # a harder stand-in (exposure jitter + noise + motion blur + occluders):
  python -m jetson_slam_tpu_torch.cli.euroc_gate make-synthetic /tmp/fake_hard --degrade

Verdict JSON: {"seq", "frames", "tracked_frac", "ate_rmse_m", "gate_m",
"pass", "median_track_ms", "device"}, written to --out and printed on
stdout.  --device (default cuda) picks the card or the CPU.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

class Degrader:
    """Photometric + occlusion degradation: per-frame exposure jitter,
    gaussian noise, horizontal motion blur, and moving dark occluders."""

    def __init__(self, seed=0, noise=6.0, blur_max=4, n_occluders=2):
        self.rng = np.random.default_rng(seed)
        self.noise = noise
        self.blur_max = blur_max
        self.n_occluders = n_occluders

    def __call__(self, img):
        rng = self.rng
        f = img.astype(np.float32)
        f = f * rng.uniform(0.7, 1.15) + rng.uniform(-15, 25)   # exposure
        k = int(rng.integers(1, self.blur_max + 1))             # motion blur
        if k > 1:
            ker = np.ones(k, np.float32) / k
            f = np.apply_along_axis(
                lambda r: np.convolve(r, ker, mode="same"), 1, f)
        f += rng.normal(0, self.noise, img.shape)               # sensor noise
        h, w = img.shape
        for _ in range(self.n_occluders):                       # occluders
            oh = int(rng.integers(h // 12, h // 5))
            ow = int(rng.integers(w // 12, w // 5))
            y = int(rng.integers(0, h - oh))
            x = int(rng.integers(0, w - ow))
            f[y:y + oh, x:x + ow] = rng.uniform(0, 30)
        return np.clip(f, 0, 255).astype(np.uint8)


def make_synthetic(out_dir, frames=40, degrade=False, seed=3):
    """The arc (320x240, 900 points) as a EuRoC tree of PNGs, with its
    settings.yaml and its ground truth (ns stamps) in TUM format."""
    from ..config import SLAMConfig, save_config
    from ..io.synthetic import make_stereo_sequence, write_euroc_stereo
    from ..io.trajectory import save_trajectory_tum

    seq = make_stereo_sequence(seed=seed, n_frames=frames, h=240, w=320,
                               trajectory="arc", n_points=900)
    deg = Degrader(seed=seed) if degrade else (lambda x: x)
    pairs = [(deg(left), deg(right)) for left, right in zip(seq.lefts, seq.rights)]
    ts_ns = write_euroc_stereo(out_dir, [p[0] for p in pairs], [p[1] for p in pairs],
                               seq.timestamps)
    save_trajectory_tum(os.path.join(out_dir, "groundtruth_tum.txt"),
                        ts_ns, list(seq.poses_twc))
    cfg = SLAMConfig()
    c = cfg.camera
    c.fx, c.fy, c.cx, c.cy, c.bf = seq.fx, seq.fy, seq.cx, seq.cy, seq.bf
    c.k1 = c.k2 = c.p1 = c.p2 = 0.0
    c.width, c.height, c.fps, c.th_depth = 320, 240, 20.0, 40.0
    cfg.orb.n_levels, cfg.orb.tile_h, cfg.orb.tile_w = 4, 16, 16
    save_config(cfg, os.path.join(out_dir, "settings.yaml"))
    print(f"synthetic EuRoC-layout sequence written to {out_dir}")
    return out_dir


def run_gate(settings, seq_dir, golden, gate_m, vocab_name, max_frames,
             out_path, async_mapping=False, device="cuda"):
    from ..config import load_config
    from ..core.tracking import TrackingState
    from ..io import datasets
    from ..io.evaluation import ate_rmse
    from ..io.rectify import StereoRectifier
    from ..io.trajectory import load_trajectory_tum
    from ..models.slam import SlamSystem

    cfg = load_config(settings)
    entries = datasets.load_euroc_stereo(seq_dir)
    if max_frames:
        entries = entries[:max_frames]
    if not entries:
        raise SystemExit(f"no EuRoC stereo frames under {seq_dir}")
    vocab = None
    if vocab_name:
        from ..bow.vocabulary import Vocabulary, bundled_names, bundled_vocabulary
        vocab = bundled_vocabulary(vocab_name) if vocab_name in bundled_names() \
            else Vocabulary.load_text(vocab_name)
    rect = StereoRectifier(cfg)
    slam = SlamSystem(cfg, sensor="stereo", vocabulary=vocab,
                      async_mapping=async_mapping, device=device)
    times, ok_frames = [], 0
    for i, e in enumerate(entries):
        left, right = rect.rectify(datasets.imread_gray(e[1]), datasets.imread_gray(e[2]))
        t0 = time.perf_counter()
        state, _ = slam.track_stereo(left, right, e[0])
        times.append(time.perf_counter() - t0)
        ok_frames += state == TrackingState.OK
        if i % 50 == 0:
            print(f"frame {i}/{len(entries)}: state={state.name}", file=sys.stderr)
    slam.shutdown()
    est_ts, est_p = slam.camera_trajectory()
    gt_ts, gt_p = load_trajectory_tum(golden)
    gt_ts = np.asarray(gt_ts, np.float64)
    if gt_ts.max(initial=0) > 1e14:      # golden stores EuRoC nanoseconds
        gt_ts = gt_ts * 1e-9
    est_ts = np.asarray(est_ts, np.float64)
    if est_ts.max(initial=0) > 1e14:
        est_ts = est_ts * 1e-9
    ate = float(ate_rmse(est_ts, np.asarray(est_p), gt_ts, np.asarray(gt_p),
                         max_dt=0.05))
    verdict = {
        "seq": os.path.abspath(seq_dir),
        "frames": len(entries),
        "tracked_frac": round(ok_frames / len(entries), 4),
        "ate_rmse_m": round(ate, 5),
        "gate_m": gate_m,
        "pass": bool(ate < gate_m and ok_frames > 0.8 * len(entries)),
        "median_track_ms": round(float(np.median(times)) * 1e3, 2),
        "device": str(slam.frontend.device),
    }
    line = json.dumps(verdict)
    print(line)
    if out_path:
        with open(out_path, "w") as f:
            f.write(line + "\n")
    return verdict


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m jetson_slam_tpu_torch.cli.euroc_gate")
    sub = ap.add_subparsers(dest="cmd", required=True)
    g = sub.add_parser("run")
    g.add_argument("settings")
    g.add_argument("seq_dir")
    g.add_argument("--golden", required=True,
                   help="golden trajectory, TUM format (s or EuRoC ns stamps)")
    g.add_argument("--gate-m", type=float, default=0.12,
                   help="ATE RMSE pass threshold in meters (the reference's "
                        "EuRoC MH01 stereo lands well under this)")
    g.add_argument("--vocab", default="")
    g.add_argument("--max-frames", type=int, default=0)
    g.add_argument("--async", dest="async_mapping", action="store_true")
    g.add_argument("--device", default="cuda")
    g.add_argument("--out", default="EUROC_GATE.json")
    m = sub.add_parser("make-synthetic")
    m.add_argument("out_dir")
    m.add_argument("--frames", type=int, default=40)
    m.add_argument("--degrade", action="store_true")
    m.add_argument("--seed", type=int, default=3)
    ns = ap.parse_args(argv)
    if ns.cmd == "make-synthetic":
        return make_synthetic(ns.out_dir, ns.frames, ns.degrade, ns.seed)
    return run_gate(ns.settings, ns.seq_dir, ns.golden, ns.gate_m, ns.vocab,
                    ns.max_frames, ns.out, ns.async_mapping, ns.device)


if __name__ == "__main__":
    main()
