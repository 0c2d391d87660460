"""Dataset command-line tool of the port: the counterpart of
``examples/run_slam.py`` (the reference's Examples/ mains stereo_euroc.cpp,
stereo_kitti.cpp, rgbd_tum.cpp, mono_{tum,kitti,euroc}.cpp), on the card.

Usage:
  python -m jetson_slam_tpu_torch.cli.run_slam stereo-euroc <settings.yaml> <seq_dir> [--out traj.txt]
  python -m jetson_slam_tpu_torch.cli.run_slam stereo-kitti <settings.yaml> <seq_dir> [--out traj.txt]
  python -m jetson_slam_tpu_torch.cli.run_slam rgbd-tum     <settings.yaml> <seq_dir> <assoc.txt> [--out traj.txt]
  python -m jetson_slam_tpu_torch.cli.run_slam mono-tum     <settings.yaml> <seq_dir> [--out traj.txt]
  python -m jetson_slam_tpu_torch.cli.run_slam mono-kitti   <settings.yaml> <seq_dir> [--out traj.txt]
  python -m jetson_slam_tpu_torch.cli.run_slam mono-euroc   <settings.yaml> <seq_dir> [--out traj.txt]
  python -m jetson_slam_tpu_torch.cli.run_slam synthetic    [--frames N] [--out traj.txt]

Flags: --device (default cuda; cpu runs the plain PyTorch versions),
--async (mapping and loop closing on a worker thread), --pipeline N
(fused tracking steps in flight; N > 0 also prewarms the fused step's
graphs, ``SlamSystem(prewarm=True)``), --vocab small|10k|PATH (BoW
relocalization and loop closing), --no-ba, --viewer DIR (PNG frame and map
renders), --live-viewer PORT, --kitti-format, --max-frames N,
--save-map PATH (the map after the run) and --load-map PATH (resume: the
first frame relocalizes against the loaded map).

Images are decoded ahead of the tracker (``io.datasets.ImageSource``),
stereo pairs rectified from the YAML's LEFT.*/RIGHT.* blocks
(``io.rectify``), and TUM depth, 16-bit, divided by ``DepthMapFactor``.
Prints per-frame and median/mean tracking times like the reference mains
(stereo_euroc.cpp:186-195).  ``main`` returns a summary of the run.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

MODES = ("stereo-euroc", "stereo-kitti", "rgbd-tum", "mono-tum", "mono-kitti",
         "mono-euroc", "stereo-live", "synthetic")


def run(slam, entries, loader, ns, mode="stereo") -> dict:
    """Track every entry (``loader(i, entry) -> (t, images)``), shut the
    session down, print the timings, and save the map and the trajectory if
    asked.  Returns the session, its states, the ms of each call (no device
    sync), the window ms per frame (first frame to the end of shutdown, I/O
    included) and the ms of the map's load and save."""
    from ..viz import Viewer
    viewer = Viewer(out_dir=ns.viewer, tile_h=slam.config.orb.tile_h,
                    tile_w=slam.config.orb.tile_w) if ns.viewer else None
    live = None
    if ns.live_viewer:
        from ..viz.live_server import LiveViewer
        live = LiveViewer(slam, port=ns.live_viewer, tile_h=slam.config.orb.tile_h,
                          tile_w=slam.config.orb.tile_w)
        print(f"live viewer: http://127.0.0.1:{live.port}/")
    summary = {"slam": slam}
    if ns.load_map:
        t0 = time.perf_counter()
        slam.load_map(ns.load_map)
        summary["load_ms"] = (time.perf_counter() - t0) * 1e3
        print(f"map loaded from {ns.load_map} in {summary['load_ms']:.1f} ms: "
              f"{slam.map.n_keyframes()} keyframes, {slam.map.n_points()} points")
    track = {"stereo": slam.track_stereo, "rgbd": slam.track_rgbd,
             "mono": slam.track_monocular}[mode]
    if ns.max_frames:
        entries = entries[:ns.max_frames]
    times, states = [], []
    t_start = time.perf_counter()
    try:
        for i, entry in enumerate(entries):
            t, imgs = loader(i, entry)
            t0 = time.perf_counter()
            state, frame = track(*imgs, t)
            dt = time.perf_counter() - t0
            times.append(dt)
            states.append(state)
            if viewer is not None:
                viewer.update(slam, imgs[0], frame)
            if live is not None:
                live.update(slam, imgs[0], frame)
            if i % 20 == 0:
                print(f"frame {i}: {dt*1e3:.1f} ms  state={state.name}")
        slam.shutdown()
        if slam.frontend.device.type == "cuda":
            torch.cuda.synchronize(slam.frontend.device)
    finally:
        if live is not None:
            live.close()
    window_s = time.perf_counter() - t_start
    times = np.array(times)
    print(f"median tracking time: {np.median(times)*1e3:.2f} ms")
    print(f"mean tracking time:   {times.mean()*1e3:.2f} ms")
    print(f"fused fast-path frames: {slam.tracker.fused_frames}/{len(times)}")
    if ns.save_map:
        t0 = time.perf_counter()
        slam.save_map(ns.save_map)
        summary["save_ms"] = (time.perf_counter() - t0) * 1e3
        print(f"map saved to {ns.save_map} in {summary['save_ms']:.1f} ms")
    if ns.out:
        if ns.kitti_format:
            slam.save_trajectory_kitti(ns.out)
        else:
            slam.save_trajectory_tum(ns.out)
        print(f"trajectory saved to {ns.out}")
    summary.update(states=states, track_ms=times * 1e3,
                   window_ms_per_frame=window_s * 1e3 / max(len(times), 1))
    return summary


def parse_args(argv=None):
    ap = argparse.ArgumentParser(prog="python -m jetson_slam_tpu_torch.cli.run_slam")
    ap.add_argument("mode", choices=MODES)
    ap.add_argument("args", nargs="*")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default="CameraTrajectory.txt")
    ap.add_argument("--frames", type=int, default=60)
    ap.add_argument("--max-frames", type=int, default=0)
    ap.add_argument("--no-ba", action="store_true")
    ap.add_argument("--async", dest="async_mapping", action="store_true")
    ap.add_argument("--pipeline", type=int, default=0,
                    help="fused-tracking pipeline depth (frames in flight)")
    ap.add_argument("--viewer", default="", help="PNG output directory")
    ap.add_argument("--live-viewer", type=int, default=0, metavar="PORT",
                    help="serve a live interactive browser view of the "
                         "session on this port (viz/live_server.py)")
    ap.add_argument("--kitti-format", action="store_true")
    ap.add_argument("--vocab", default="",
                    help="'small' / '10k' (bundled) or a DBoW2-format "
                         "vocabulary path, enabling loop closing")
    ap.add_argument("--save-map", default="", metavar="PATH",
                    help="save the map here after the run")
    ap.add_argument("--load-map", default="", metavar="PATH",
                    help="resume from this saved map: the first frame "
                         "relocalizes against it")
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    from ..config import SLAMConfig, load_config
    from ..io import datasets
    from ..io.rectify import StereoRectifier
    from ..models.slam import SlamSystem

    ns = parse_args(argv)
    vocab = None
    if ns.vocab:
        from ..bow.vocabulary import Vocabulary, bundled_names, bundled_vocabulary
        vocab = bundled_vocabulary(ns.vocab) if ns.vocab in bundled_names() \
            else Vocabulary.load_text(ns.vocab)

    def system(cfg, sensor):
        return SlamSystem(cfg, sensor=sensor, enable_ba=not ns.no_ba,
                          pipeline_depth=ns.pipeline, async_mapping=ns.async_mapping,
                          prewarm=ns.pipeline > 0, vocabulary=vocab, device=ns.device)

    if ns.mode == "synthetic":
        from ..io.evaluation import ate_rmse
        from ..io.synthetic import make_stereo_sequence
        seq = make_stereo_sequence(seed=0, n_frames=ns.frames, h=240, w=320)
        cfg = SLAMConfig()
        c = cfg.camera
        c.fx, c.fy, c.cx, c.cy, c.bf = seq.fx, seq.fy, seq.cx, seq.cy, seq.bf
        c.width, c.height = 320, 240
        c.k1 = c.k2 = c.p1 = c.p2 = 0.0
        cfg.orb.n_levels, cfg.orb.tile_h, cfg.orb.tile_w = 4, 16, 16
        slam = system(cfg, "stereo")
        out = run(slam, list(range(ns.frames)),
                  lambda i, e: (seq.timestamps[i], (seq.lefts[i], seq.rights[i])), ns)
        est_ts, est_p = slam.camera_trajectory()
        if len(est_p) >= 3:
            ate = ate_rmse(np.asarray(est_ts), np.asarray(est_p), seq.timestamps,
                           seq.poses_twc)
            print(f"ATE RMSE vs ground truth: {ate:.4f} m")
        return out

    if ns.mode == "stereo-live":
        raise SystemExit("stereo-live: live V4L capture (stereo_live.cpp) is not "
                         "part of this package; replay a recorded sequence instead")

    cfg = load_config(ns.args[0])
    if ns.mode.startswith("mono-"):
        loaders = {"mono-tum": datasets.load_tum_mono,
                   "mono-kitti": datasets.load_kitti_mono,
                   "mono-euroc": datasets.load_euroc_mono}
        entries = loaders[ns.mode](ns.args[1])
        slam = system(cfg, "mono")
        with datasets.ImageSource([e[1] for e in entries]) as src:
            out = run(slam, entries, lambda i, e: (e[0], (src.get(i),)), ns, mode="mono")
        out["sources"] = (src,)
        return out

    if ns.mode == "rgbd-tum":
        entries = datasets.load_tum_rgbd(ns.args[1], ns.args[2])
        slam = system(cfg, "rgbd")
        factor = cfg.camera.depth_map_factor

        def loader(i, e):
            depth = src_d.get(i)
            if depth.dtype != np.uint16:
                raise ValueError(f"{e[2]}: a TUM depth image is 16-bit, not {depth.dtype}")
            return e[0], (src_rgb.get(i), depth.astype(np.float32) / factor)
        with datasets.ImageSource([e[1] for e in entries]) as src_rgb, \
                datasets.ImageSource([e[2] for e in entries]) as src_d:
            out = run(slam, entries, loader, ns, mode="rgbd")
        out["sources"] = (src_rgb, src_d)
        return out

    rect = StereoRectifier(cfg)
    if ns.mode == "stereo-euroc":
        entries = datasets.load_euroc_stereo(ns.args[1])
    else:
        entries = datasets.load_kitti_stereo(ns.args[1])
    slam = system(cfg, "stereo")
    rect_ms = []

    def loader(i, e):
        left, right = src_l.get(i), src_r.get(i)
        t0 = time.perf_counter()
        pair = rect.rectify(left, right)
        rect_ms.append((time.perf_counter() - t0) * 1e3)
        return e[0], pair
    with datasets.ImageSource([e[1] for e in entries]) as src_l, \
            datasets.ImageSource([e[2] for e in entries]) as src_r:
        out = run(slam, entries, loader, ns)
    out["sources"] = (src_l, src_r)
    out["rectify_ms"] = rect_ms
    return out


if __name__ == "__main__":
    main()
