"""The JAX package (and, with --port, the PyTorch port) on the CPU on
chip_smoke.py's RGB-D and mono cells and its stereo mapping cell
(``slice_mapping``, or with --classic ``slice_classic_mapping``): the same
configs, lens models and lens-warped synthetic arcs, so the card's
numbers have a reference.

    python tests/jax_sensor_reference.py rgbd mono stereo [--frames N]
        [--seed S] [--no-lens] [--classic] [--port]

Prints, per sensor and package, the first OK frame, frames OK, fused
frames, the aligned ATE (SE(3) for RGB-D, Sim(3) for mono) and the
keyframes created and alive.  The stereo cell is EuRoC_stereo.yaml on
chip_smoke.py's 40-frame arc (seed 7, mapping on, synchronous;
--classic sets ``tracker.fused = False``).  It runs the full geometry
(640x480 and 752x480) on the CPU: a few seconds per frame and about 1.2 GB per
process.  --frames feeds the first N frames of the 40-frame arc (default:
chip_smoke.SENSOR_FRAMES).
"""
import argparse
import os
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import numpy as np  # noqa: E402


def run(slam, sensor, seq, greys, depths, n):
    states = []
    for i in range(n):
        if sensor == "stereo":
            state, _ = slam.track_stereo(seq.lefts[i], seq.rights[i], seq.timestamps[i])
        elif sensor == "rgbd":
            state, _ = slam.track_rgbd(greys[i], depths[i], seq.timestamps[i])
        else:
            state, _ = slam.track_monocular(greys[i], seq.timestamps[i])
        states.append(state.name)
    slam.shutdown()
    return states


def main(argv):
    ap = argparse.ArgumentParser()
    ap.add_argument("sensors", nargs="+", choices=["rgbd", "mono", "stereo"])
    ap.add_argument("--frames", type=int)
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--no-lens", action="store_true")
    ap.add_argument("--classic", action="store_true")
    ap.add_argument("--port", action="store_true")
    args = ap.parse_args(argv)
    import jax
    import torch
    jax.config.update("jax_platforms", "cpu")
    torch.set_num_threads(2)
    import chip_smoke
    from jetson_slam_tpu.config import load_config as jax_load_config
    from jetson_slam_tpu.core.frame import Frame as JaxFrame
    from jetson_slam_tpu.models.slam import SlamSystem as JaxSlam
    from jetson_slam_tpu_torch.core.frame import Frame
    from jetson_slam_tpu_torch.io.evaluation import ate_rmse
    from jetson_slam_tpu_torch.models.slam import SlamSystem

    for sensor in args.sensors:
        if sensor == "stereo":
            cfg, seq = chip_smoke.make_config_and_sequence()
            greys, depths, n = seq.lefts, None, args.frames or len(seq.lefts)
            jcfg = jax_load_config(os.path.join(REPO, "examples", "configs",
                                                "EuRoC_stereo.yaml"))
        else:
            cfg, seq, greys, depths = chip_smoke.sensor_config_and_sequence(sensor, args.seed)
            n = args.frames or chip_smoke.SENSOR_FRAMES[sensor]
            jcfg = jax_load_config(os.path.join(REPO, "examples", "configs",
                                                chip_smoke.SENSOR_CONFIGS[sensor]))
        for c in (cfg.camera, jcfg.camera):
            if sensor != "stereo":
                c.fy = seq.fy
            c.cx, c.cy = seq.cx, seq.cy
            if args.no_lens:
                c.k1 = c.k2 = c.p1 = c.p2 = c.k3 = 0.0
        if args.no_lens:
            greys, depths = seq.lefts, seq.depths
        runs = [("jax", lambda: JaxSlam(jcfg, sensor=sensor), JaxFrame)]
        if args.port:
            runs.append(("port", lambda: SlamSystem(cfg, sensor=sensor, device="cpu"),
                         Frame))
        for name, build, frame_cls in runs:
            frame_cls._next_id = 0
            slam = build()
            slam.tracker.fused = not args.classic
            states = run(slam, sensor, seq, greys, depths, n)
            ts, poses = slam.camera_trajectory()
            ate = ate_rmse(np.asarray(ts), np.asarray(poses), seq.timestamps,
                           seq.poses_twc, with_scale=sensor == "mono")
            m = slam.map
            first = states.index("OK") if "OK" in states else None
            seed = 7 if sensor == "stereo" else args.seed
            print(f"{name} {sensor} seed {seed}, {n} frames"
                  f"{', tracker.fused=False' if args.classic else ''}"
                  f"{', no lens' if args.no_lens else ''}: first_ok_frame={first} "
                  f"ok={states.count('OK')} fused={slam.tracker.fused_frames} "
                  f"ate_m={ate:.6f} ({'Sim(3)' if sensor == 'mono' else 'SE(3)'}) "
                  f"keyframes created={int(m.kf_gen.sum())} alive={m.n_keyframes()}",
                  flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
