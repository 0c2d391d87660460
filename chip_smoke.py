"""Chip smoke run of the PyTorch / CUDA port on one NVIDIA card.

    python3 chip_smoke.py

1. prints the card's name and power limit, then builds the three CUDA
   kernels from ``jetson_slam_tpu_torch/csrc`` (one ``nvcc`` per source, all
   started together) and prints the build time; builds the PNG unfilter
   (``csrc/png_unfilter.c``) and the native prefetch loader
   (``native/loader.cpp``) with the host compilers and holds the native
   FAST LUT against ``ops/tables.fast_lut``; counts the level pixels of
   the card's pyramid that differ from a float64 numpy resize (must be 0);
2. drives the slice: ``SlamSystem(EuRoC_stereo.yaml, sensor="stereo",
   enable_mapping=False)`` on a 40-frame synthetic arc at EuRoC geometry,
   with the kernels' launch counters set to 0 just before and read just
   after; requires every frame OK, all but 5 frames through the fused step,
   ATE < 0.05 m and at least one launch of each kernel per frame.  It runs
   before any torch.profiler session, since once the profiler has run in a
   process every later launch costs the host more.  ``phase
   slice_classic`` repeats it with ``tracker.fused = False`` (the staged
   path on every frame), requiring no fused frame and no speculated
   candidates instead of the fused frames;
3. drives the mapping-on slice: ``SlamSystem(EuRoC_stereo.yaml,
   sensor="stereo")`` on the same arc, synchronously (``phase
   slice_mapping``) and with ``async_mapping=True, pipeline_depth=2``
   (``phase slice_async``, on the first 20 frames, then ``shutdown()``),
   each with the launch counters set to 0 just before and read just
   after; requires every frame OK, all but 5 frames fused, ATE < 0.05 m, >= 3 keyframes alive, a local BA
   with a free camera, a consistent observation index and a launch of each
   kernel per frame; prints the window ms per frame (from the first call
   to the end of ``shutdown()``, over all frames and over those after 5
   warm calls), the ms per call (no device sync, so the worker's stream
   and the frames in flight keep overlapping), keyframes created and
   culled, live points, local BAs and the mapping ms per keyframe by
   stage.  ``phase slice_classic_mapping`` repeats the synchronous session
   with ``tracker.fused = False``, and a line then sets both classic
   phases' ms per frame beside slice's and slice_mapping's.  All run
   before any torch.profiler session;
4. drives relocalization and loop closing, each session with the launch
   counters set to 0 just before and read just after, and a launch of
   each kernel per frame required: ``phase slice_reloc`` tracks 20 frames
   of the arc (mapping on, sync), feeds 3 black frames (LOST) and then
   frame 15 until OK, at most 3 attempts, within 0.05 m of its tracked
   pose, once without a vocabulary (the rotating candidate window) and
   once with the bundled 10k vocabulary (``slice_reloc_vocab10k``),
   printing each relocalization's ms, candidates and n_match / n_final;
   ``phase slice_loop`` runs the 84-frame 1.3-lap circle of
   tests/test_loop_fuzz.py at EuRoC geometry with the bundled 10k
   vocabulary, synchronously and async with ``pipeline_depth=2`` and the
   global BA on its own thread (``slice_loop_async``); requires a closed loop, every frame OK, a
   consistent map and ATE < 0.05 m, and prints the window ms per frame and
   the ms of every compute_sim3, correct_loop and global BA.  Both run
   before any torch.profiler session;
4b. drives the RGB-D and mono sensors, mapping on, synchronous, each with
   the launch counters set to 0 just before and read just after:
   ``phase slice_rgbd`` on ``TUM1_rgbd.yaml`` (640x480, tile 15) and
   ``phase slice_mono`` on ``EuRoC_mono.yaml`` (752x480, tile 30), on the
   first 20 frames of the 40-frame arc, rendered with the config's fx and
   warped by its lens model (``sensor_config_and_sequence``); RGB-D
   requires every frame OK, all but 5 frames fused, SE(3)-aligned ATE < 0.05 m and >= 3 keyframes alive, mono
   the initialization within 10 frames, every frame OK from there,
   Sim(3)-aligned ATE < 0.15 m and a fused frame, and its accepted
   initializer call, repeated on the CPU with the same matches and minimal
   samples, the same best SH and SF (rtol 1e-4), model, good points, R and
   t (1e-4) and points (1e-3 relative); both a consistent map, fast_nms
   and orb_descriptor launched once per frame fed and stereo_costs never.
   Both run before any torch.profiler session;
4b''. ``phase fused_graph``: the fused step as the tracker runs it, one
   CUDA graph per candidate bucket (``core/fused_track.FusedStep``),
   against the same step run eagerly.  For the stereo, RGB-D and mono
   cells a mapping-off session of 10 frames records its last fused
   dispatch; a new FusedStep captures every bucket from 128 to 2048
   (``prewarm_fused``), and on the recorded inputs cut or padded to each
   bucket the replay must equal the eager step (integers exact, floats
   within 1e-6 relative, the largest difference printed) and launch each
   kernel of the mode exactly once, and again when the buckets replay in
   the reverse of their capture order (they share one memory pool).
   Prints each bucket's capture ms, the pool's growth and the host ms per
   frame of the eager step and of the replay (dispatch to pull, median).  The recorded bucket also runs
   on the CPU with the kernels' plain versions: slots, keypoints,
   responses and descriptors equal to the replay's, angles within 1e-3
   degrees.  Every session phase runs its fused frames through these
   graphs (``graphs`` line: buckets captured, capture ms, replays), and
   ``slice_async`` is prewarmed as ``cli.run_slam`` does for a pipeline;
4b'. the adversarial sequences of tests/test_adversarial.py on the arc,
   mapping on, synchronous, each with the launch counters set to 0 just
   before and read just after and a launch of each kernel per frame
   required (``phase adversarial_*``): the illumination ramped 0.55x ->
   1.45x over the 40 frames (> 80 % OK, ATE < 0.08 m); frames 15..20 of
   the first 36 with their contrast crushed to 20 %, the bundled 10k
   vocabulary (frames 24.. OK); frame 0 fed 15 times (OK, drift <
   0.01 m); frames 0..9 then 16..25 (the last 6 OK).  ``phase
   descriptor_fuzz`` runs the arc with each descriptor bit flipped with
   probability 3.4/256 on the card (a seeded torch.Generator): every
   frame OK, ATE < 0.05 m and within 0.01 m of slice_mapping's.  Each
   prints its states, ATE (drift), window ms per frame and seconds;
4c. runs the port's command-line tool on files on disk, each run with
   the launch counters set to 0 just before and read just after, before
   any torch.profiler session: ``phase dataset_euroc`` writes the first 20
   frames of the arc as a EuRoC tree of PNGs at 752x480 (``io/png.py``), each eye warped
   by EuRoC_stereo.yaml's LEFT.D / RIGHT.D, with a settings file whose
   LEFT/RIGHT blocks (K = P = the render intrinsics, those D, R = I) make
   rectification undo the warp and a mask.left PNG blanking a 40-px band,
   and runs ``cli.run_slam.main(["stereo-euroc", ..., "--vocab", "10k",
   "--save-map", ...])`` in process; requires every frame OK, SE(3) ATE < 0.05 m
   on the written trajectory, no valid keypoint more than 2 px inside the
   band and one launch of each kernel per frame fed and per graph
   warm-up (a captured bucket's one eager run); then a fresh session
   loads the saved map (LOST, its free keyframe rows those of the saved
   map) and relocalizes on frame 15 within 3 attempts, within 0.05 m of
   the pose tracked there.  ``phase dataset_tum_rgbd`` writes slice_rgbd's
   20 lens-warped frames as a TUM tree (8-bit RGB PNGs, 16-bit depth at
   DepthMapFactor 5000, an association file) and runs ``rgbd-tum``;
   requires every frame OK, ATE < 0.05 m, a median keypoint depth > 0.5 m, and
   fast_nms and orb_descriptor once per frame and per graph warm-up,
   stereo_costs never.  Both
   print the host decode ms per frame per image, the rectify ms (EuRoC),
   the ms per call, the window ms per frame and (EuRoC) the map's save
   and load ms, its bytes and the relocalization after the load;
4d. the batched front end and distribution, before any torch.profiler
   session, each phase's seconds printed: ``phase frontend_batch`` runs
   ``frame_step_batch`` on frames 0..3 of the arc and requires it equal
   to four ``frame_step`` calls (integers and floats exact), one launch of
   each kernel per batch and each kernel equal to its plain version at
   the batch shapes (64 canvases, B = 8 descriptors, B = 4 stereo costs),
   and prints the ms per batch and per frame against four single calls
   (host clock around a device sync, median of 20); ``phase dist_ba``
   saves the slice_loop map's global BA problem under ``build/`` and
   solves it in process with ``local_ba``, with DistBA on 2 gloo ranks
   sharing the card (CUDA tensors) and on NCCL at world size 1, each
   DistBA within 5e-3 m of the in-process camera centres, >= 98 % of the
   edges classified alike, the gauge camera unmoved and the median
   reprojection chi2 no more than 0.1 % above the in-process solve's,
   printing the ms per solve and the collectives per LM iteration; it
   then solves tests/test_dist_ba.py's noisy 10 %-outlier problem
   (``tests/data/noisy_ba_problem.npz``, with the JAX package's
   solutions) by ``local_ba`` on the card in float32 and float64, and
   requires float32 within 1e-4 m of float64 and JAX's outlier classes;
   ``phase cross_host`` runs ``cli/cross_host_worker.py`` as 2 gloo ranks
   on the card at EuRoC geometry and requires both to print
   CROSS_HOST_OK, equal problem digests and, on rank 1, an observation
   index that agrees with kf_obs, printing the delta's bytes and the ms to
   serialize, send and apply it; ``phase mapping_device`` runs the
   slice_mapping session on frames 0..19 with ``mapping_device="cpu"``
   and requires every frame OK, ATE < 0.05 m, every local BA solved on
   the CPU and one launch of each kernel per frame and per graph
   warm-up, printing the mapping
   ms per keyframe; ``phase dist_mapper`` runs ``SlamSystem(mesh=group)``
   on 2 gloo ranks on the same frames and requires every local BA through
   DistBA, equal trajectories on both ranks, every frame OK and ATE <
   0.05 m.  Ranks are this script run as ``--child NAME WORLD STORE
   BACKEND AFTER RANK ...`` on a FileStore under ``build/``, each writing
   its output to a log there; a child's non-zero exit fails its phase.
   The NCCL rank of dist_ba and the ranks of dist_mapper start early and
   wait for a file (AFTER) before their work, so their start-up overlaps
   the phases before them but no solve or session shares the card.
   After the launch floor, ``phase frontend_batch_kernels`` prints each
   kernel's device time at the batch shapes;
5. holds each kernel against its plain PyTorch version on the card, at the
   EuRoC shapes (752x480, 8 levels, tile 30), on the pyramid canvases of a
   rendered frame and on uniform-random canvases: FAST+NMS-L bit-equal,
   masked and unmasked, at n_max 14 and 16; descriptors identical on every
   valid slot and angles equal (error 0), on the real and random cases and
   on keypoints at the ROI's edge, 20 px from the level border, on every
   level; stereo costs equal on every slot, on the real coarse match and
   on random windows, windows at each level's bounds, windows reaching
   past the canvas edge, all slots matched and none matched.  Each
   kernel's time is its device time from torch.profiler (median over 50
   launches after warm-up, the kernel's own entries by name), printed
   beside the mean of those entries, the CUDA-event time of 50 launches
   queued back to back behind a sleep kernel, over 50, so no host time
   between launches enters it, and the launch floor: the same timing of a
   one-element fill kernel.  The plain versions are timed with one event
   pair per call (median of 10 or 20), host time included;
6. holds the kernels against their plain versions at three more
   geometries, on a rendered input and on random canvases (``phase
   geometry_*``): KITTI 00-02 (``KITTI00-02_stereo.yaml``: 1241x376, 1
   level, tile 25, FAST 9..14 at threshold 60), where the right eye's
   stack starts at 8 mod 16 and no row is 16-byte aligned, a frame pair
   through all three kernels; the RGB-D and mono cells' geometries
   (640x480 at tile 15, 752x480 at tile 30), one lens-warped frame
   (B = 1) through the two kernels of the one-eye front end.  FAST+NMS-L
   bit-equal, descriptors identical with angle error 0, stereo costs
   equal; each kernel's ``max_abs_err`` takes the largest difference of
   every geometry;
7. profiles four steady-state frames of a fresh session, prewarmed in the
   foreground (torch.profiler: launches, graph launches, one per fused
   frame required, copies, device busy time per frame, host ms of each
   ``slice.*`` range: host prep, staging, replay, pull, bookkeeping) and
   counts where one more frame synchronises the host with the card, then
   profiles the step run eagerly on that frame's inputs for the device ms
   of its stages (a replay is one range); then profiles a mapping-on
   session over a window that processes keyframes (host and device ms of
   each ``mapping.*`` span, kernel launches and synchronising calls per
   keyframe) and counts where one keyframe's mapping synchronises; then
   counts the kernel launches and the synchronising calls (by source line)
   of one relocalization in each ``slice_reloc`` session;
8. prints ``{"kernels": [...]}`` (launches from the mapping-on slice) and,
   as the last line, ``{"ok": true, "device": {...}}``.

Any failed check raises, so the script exits non-zero.  Without CUDA, or
without the rest of the repository beside it, it exits non-zero and prints
no result.  ``--profile-out PATH`` writes the profiler's full tables to
PATH.  ``--mapping-modes`` adds, after ``slice_async``, the mapping-on
session async without pipelining, synchronous with ``pipeline_depth=2``,
and synchronous again (the spread), to tell what the async worker costs
the tracker from what pipelining does.
"""
from __future__ import annotations

import dataclasses
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np

HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory (NVIDIA data sheet)
ALU_OPS_PER_S = 67e12       # H100 SXM float32 outside the tensor cores,
                            # used as the peak of the kernels' 32-bit ALU ops
H, W = 480, 752
REPO = os.path.dirname(os.path.abspath(__file__))


def gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout
    return out.strip().splitlines()[0]


def time_ms(fn, n=50, warm=3) -> float:
    """Median of n CUDA-event pairs, each around one call of fn.  Used for
    the plain versions only: the host's time inside the call lands between
    the two events."""
    import torch
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    evs = []
    for _ in range(n):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        evs.append((a, b))
    torch.cuda.synchronize()
    return statistics.median(a.elapsed_time(b) for a, b in evs)


def kernel_ms(fn, kernel: str, n=50, warm=3) -> dict:
    """Device time of one launch of a hand kernel, without the host's
    launch gap.  After warm-up, fn runs n times under torch.profiler; the
    device entries whose name holds ``kernel`` give the median per launch
    (``ms``) and their summed device time over their count (``mean_ms``).
    The profiler can drop entries of a run, so a run that kept fewer than
    90 % of them is repeated, up to three runs, and the fullest is used
    (``n_prof`` entries).  Beside them, ``b2b_ms`` is the CUDA-event time
    of n launches queued back to back behind a sleep kernel, over n, and
    ``enqueue_ms`` the host time it took to queue them (b2b_ms holds no
    host gap while enqueue_ms stays under the sleep, about 10 ms)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    durs = []
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        got = [e.time_range.elapsed_us() for e in prof.events()
               if e.device_type == DeviceType.CUDA and kernel in e.name]
        durs = max(durs, got, key=len)
        if len(durs) >= 0.9 * n:
            break
    check(len(durs) >= n // 2, f"{kernel}: {len(durs)} of {n} launches in the profile")
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(20_000_000)
    t0 = time.perf_counter()
    a.record()
    for _ in range(n):
        fn()
    b.record()
    enqueue_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    return dict(ms=statistics.median(durs) / 1e3, mean_ms=statistics.fmean(durs) / 1e3,
                n_prof=len(durs), b2b_ms=a.elapsed_time(b) / n, enqueue_ms=enqueue_ms)


def launch_floor() -> dict:
    """``kernel_ms`` of a one-element fill kernel: the device time that any
    launch takes, whatever its work."""
    import torch
    z = torch.empty(1, device="cuda")
    return kernel_ms(z.zero_, "FillFunctor")


def timing_line(name: str, t: dict, plain_ms: float, b_ms: float, b_by: str,
                floor: dict) -> str:
    return (f"  {name} ms={t['ms']:.5f} (profiler median of {t['n_prof']}) "
            f"mean_ms={t['mean_ms']:.5f} "
            f"b2b_ms={t['b2b_ms']:.5f} (enqueue {t['enqueue_ms']:.2f} ms) "
            f"floor_ms={floor['ms']:.5f} "
            f"plain_ms={plain_ms:.4f} bound_ms={b_ms:.6f} ({b_by}) "
            f"ms/bound={t['ms'] / b_ms:.2f}")


def bound(n_bytes: float, n_ops: float):
    t_b = n_bytes / HBM_BYTES_PER_S * 1e3
    t_o = n_ops / ALU_OPS_PER_S * 1e3
    return (t_b, "bytes") if t_b >= t_o else (t_o, "operations")


def check(cond: bool, what: str):
    if not cond:
        raise AssertionError(what)
    print(f"  ok: {what}")


def fast_equal(fe, stack, lut, mask, what: str) -> int:
    """Kernel 1 against its plain version on one stack; returns the max
    abs difference (raw or nms)."""
    import torch
    from jetson_slam_tpu_torch.ops.cuda_frontend import fast_nms, fast_nms_plain
    rk, nk = fast_nms(stack, fe.roi, lut, fe.threshold, mask)
    rp, np_ = fast_nms_plain(stack, fe.roi, lut, fe.threshold, mask)
    torch.cuda.synchronize()
    check(torch.equal(rk, rp) and torch.equal(nk, np_),
          f"raw and nms bit-equal ({what}, {int((nk > 0).sum())} NMS-L maxima)")
    return max(int((rk - rp).abs().max()), int((nk - np_).abs().max()))


def random_keypoints(fe, rng, B: int):
    """(kx, ky, ks) int32 (B, K): a random in-ROI keypoint in every slot."""
    lvl = fe.slot_level.cpu().numpy()
    hw = fe.level_hw.cpu().numpy()[lvl]
    K = lvl.shape[0]
    ky = rng.integers(20, hw[:, 0] - 20, (B, K)).astype(np.int32)
    kx = rng.integers(20, hw[:, 1] - 20, (B, K)).astype(np.int32)
    ks = rng.integers(0, 3, (B, K)).astype(np.int32)
    return kx, ky, ks


def desc_equal(fe, pyr, kx, ky, ks, what: str) -> float:
    """Kernel 2 against its plain version: descriptors identical on every
    valid slot, zeros elsewhere, angle error 0; returns the angle error."""
    from jetson_slam_tpu_torch.ops.cuda_descriptor import (orb_descriptor,
                                                           orb_descriptor_plain)
    tabs = (fe.slot_level, fe.level_hw, fe.pattern, fe.gauss, fe.ic_masks)
    dk, ak = orb_descriptor(pyr, kx, ky, ks, *tabs)
    dp, ap = orb_descriptor_plain(pyr, kx, ky, ks, *tabs)
    v = (ks > 0).cpu().numpy()
    ham = np.unpackbits((dk.cpu().numpy() ^ dp.cpu().numpy())[v], axis=1).sum(1)
    aerr = float((ak - ap).abs().max())
    print(f"  {what}: {int(v.sum())} valid slots, {int((ham > 0).sum())} with a "
          f"differing bit, max angle err {aerr:.3g} deg")
    check(aerr == 0.0, f"angle equal on every slot ({what})")
    check(not ham.any(), f"desc identical on all {int(v.sum())} valid slots ({what})")
    check(not dk.cpu().numpy()[~v].any(), f"invalid slots hold zeros ({what})")
    return aerr


def costs_equal(args, what: str) -> int:
    """Kernel 3 against its plain version on every slot, matched or not
    (the plain version gives 0 where unmatched); returns the max abs
    difference."""
    import torch
    from jetson_slam_tpu_torch.ops.cuda_stereo import stereo_costs, stereo_costs_plain
    ck = stereo_costs(*args)
    cp = stereo_costs_plain(*args)
    m = args[-1]
    check(torch.equal(ck, cp),
          f"costs equal on all {m.numel()} slots, {int(m.sum())} matched ({what})")
    return int((ck - cp).abs().max())


def numpy_pyramid_f64(img_u8: np.ndarray, fe):
    """The pyramid with the float32 weights applied in float64."""
    from jetson_slam_tpu_torch.ops.frontend import _resize_weights
    g = fe.geom
    out = [img_u8]
    f0 = img_u8.astype(np.float64)
    for i in range(1, g.n_levels):
        wy = _resize_weights(H, g.heights[i], g.scales[i]).astype(np.float64)
        wx = _resize_weights(W, g.widths[i], g.scales[i]).astype(np.float64)
        out.append(np.floor(wy @ (f0 @ wx.T)).astype(np.uint8))
    return out


def make_config_and_sequence():
    from jetson_slam_tpu_torch.config import load_config
    from jetson_slam_tpu_torch.io.synthetic import make_stereo_sequence
    cfg = load_config(os.path.join(REPO, "examples", "configs", "EuRoC_stereo.yaml"))
    seq = make_stereo_sequence(seed=7, n_frames=40, h=H, w=W, fx=435.2047,
                               baseline=0.110076, trajectory="arc", n_points=900)
    cfg.camera.cx, cfg.camera.cy = seq.cx, seq.cy
    return cfg, seq


SENSOR_CONFIGS = {"rgbd": "TUM1_rgbd.yaml", "mono": "EuRoC_mono.yaml"}
# frames fed to each sensor phase: mono takes the first half of the arc.
# Over the whole arc the JAX package's own mono session drifts to a
# Sim(3)-aligned ATE of 0.220 m (0.177 m the port's, both on the CPU),
# beyond the 0.15 m gate of tests/test_sensors_e2e.py; over the first 20
# frames JAX's is 0.008 m (PERF.md, section 4)
# (RGB-D: the first 20 of 40, to keep the call inside its time limit)
SENSOR_FRAMES = {"rgbd": 20, "mono": 20}
# the frames of slice_async and of the dataset phases: the first 20 of the
# 40 rendered, to keep the call inside its time limit
ASYNC_FRAMES = DATASET_FRAMES = 20


def sensor_config_and_sequence(sensor: str, seed: int = 7, n_frames: int = 40):
    """The RGB-D or mono cell: its config at its own geometry, lens model
    kept, and 40 frames of the arc rendered pinhole with the config's fx
    (fy = fx, cx and cy at the image centre, written back into the config),
    then warped by the lens: the grey image bilinear, the depth nearest
    (``io.synthetic.warp_lens``).  Returns (cfg, seq, grey images, depth
    images or None)."""
    from jetson_slam_tpu_torch.config import load_config
    from jetson_slam_tpu_torch.io.synthetic import make_stereo_sequence, warp_lens
    cfg = load_config(os.path.join(REPO, "examples", "configs", SENSOR_CONFIGS[sensor]))
    c = cfg.camera
    seq = make_stereo_sequence(seed=seed, n_frames=n_frames, h=c.height, w=c.width, fx=c.fx,
                               baseline=c.bf / c.fx, trajectory="arc", n_points=900,
                               with_depth=sensor == "rgbd")
    c.fy, c.cx, c.cy = seq.fy, seq.cx, seq.cy
    greys = [warp_lens(im, c, order=1) for im in seq.lefts]
    depths = [warp_lens(d, c, order=0) for d in seq.depths] if sensor == "rgbd" else None
    return cfg, seq, greys, depths


def frontend_of(cfg):
    from jetson_slam_tpu_torch.ops.frontend import OrbFrontend
    o = cfg.orb
    return OrbFrontend(cfg.camera.height, cfg.camera.width, n_levels=o.n_levels,
                       scale_factor=o.scale_factor, fast_n_min=o.fast_n_min,
                       fast_n_max=o.fast_n_max, threshold=o.th_fast_max,
                       tile_h=o.tile_h, tile_w=o.tile_w, device="cuda")


# ----------------------------------------------------------------- kernels
def phase_pyramid(fe, seq):
    import torch
    print("phase pyramid: card vs numpy float64 resize")
    imgs = np.stack([seq.lefts[0], seq.rights[0]])
    pyr = fe.pyramid(torch.as_tensor(imgs, device="cuda")).cpu().numpy()
    g = fe.geom
    flips = 0
    for b in range(2):
        ref64 = numpy_pyramid_f64(imgs[b], fe)
        for i in range(g.n_levels):
            lv = pyr[b, i, :g.heights[i], :g.widths[i]]
            flips += int((lv != ref64[i]).sum())
    print(f"  pyramid_flips_vs_f64_resize={flips}")
    check(flips == 0, "pyramid equals the float64 resize on every level pixel")
    return pyr


def phase_fast(fe, pyr_np, rng, floor):
    import torch
    from jetson_slam_tpu_torch.ops import tables
    from jetson_slam_tpu_torch.ops.cuda_frontend import fast_nms, fast_nms_plain
    print("phase fast_nms: kernel vs plain")
    g = fe.geom
    L = g.n_levels
    real = torch.as_tensor(pyr_np.reshape(2 * L, H, W), device="cuda")
    rand = torch.as_tensor(rng.integers(0, 256, (2 * L, H, W), dtype=np.uint8),
                           device="cuda")
    mask = np.zeros((L, H, W), np.uint8)
    for i in range(L):
        h, w = g.heights[i], g.widths[i]
        mask[i, h // 8:h - h // 8, w // 6:w - w // 6] = 1
    mask_t = torch.as_tensor(mask, device="cuda")
    err = 0
    for n_max in (14, 16):
        lut = torch.as_tensor(tables.fast_lut(9, n_max).astype(np.uint8), device="cuda")
        for name, stack in (("real", real), ("random", rand)):
            for m in (None, mask_t):
                err = max(err, fast_equal(
                    fe, stack, lut, m, f"{name}, n_max={n_max}, "
                    f"{'masked' if m is not None else 'unmasked'}"))
    t = kernel_ms(lambda: fast_nms(real, fe.roi, fe.lut, fe.threshold), "fast_nms_kernel")
    plain_ms = time_ms(lambda: fast_nms_plain(real, fe.roi, fe.lut, fe.threshold), n=20)
    n_pix = real.numel()
    roi_pix = 2 * sum((g.heights[i] - 40) * (g.widths[i] - 40) for i in range(L))
    n_bytes = n_pix + 65536 + fe.roi.numel() * 4 + 2 * 4 * n_pix
    # per ROI pixel: 16 ring reads x (sub, abs, add, 2 compares, 2 ors);
    # per pixel: 8 neighbour maxima + 2 compares
    n_ops = 112 * roi_pix + 10 * n_pix
    b_ms, b_by = bound(n_bytes, n_ops)
    print(timing_line("fast_nms", t, plain_ms, b_ms, b_by, floor))
    return dict(name="fast_nms", route="cuda",
                source="jetson_slam_tpu_torch/csrc/fast_nms.cu",
                replaces="jetson_slam_tpu/ops/pallas_frontend.py:232",
                max_abs_err=float(err), ms=t["ms"], plain_ms=plain_ms,
                bound_ms=b_ms, bound_by=b_by, library_ms=None)


def phase_descriptor(fe, seq, rng, floor):
    import torch
    from jetson_slam_tpu_torch.ops.cuda_descriptor import (orb_descriptor,
                                                           orb_descriptor_plain)
    print("phase orb_descriptor: kernel vs plain")
    imgs = torch.as_tensor(np.stack([seq.lefts[0], seq.rights[0]]), device="cuda")
    res, pyr = fe.extract_batch(imgs)
    tabs = (fe.slot_level, fe.level_hw, fe.pattern, fe.gauss, fe.ic_masks)
    # random canvases with random in-ROI keypoints in every slot
    rpyr = torch.as_tensor(rng.integers(0, 256, tuple(pyr.shape), dtype=np.uint8),
                           device="cuda")
    rkx, rky, rks = random_keypoints(fe, rng, 2)
    # valid keypoints on the ROI's edge, 20 px from the true level border, on
    # every level: rBRIEF then samples pixels within 3 px of the border
    hw = fe.level_hw.cpu().numpy()[fe.slot_level.cpu().numpy()]
    side = rng.integers(0, 4, rky.shape)
    eky = np.where(side == 0, 20, np.where(side == 1, hw[:, 0] - 21, rky)).astype(np.int32)
    ekx = np.where(side == 2, 20, np.where(side == 3, hw[:, 1] - 21, rkx)).astype(np.int32)
    t = lambda a: torch.as_tensor(a, device="cuda")  # noqa: E731
    cases = (("real", pyr, res.lx, res.ly, res.response),
             ("random", rpyr, t(rkx), t(rky), t(rks)),
             ("roi_edge", pyr, t(ekx), t(eky), t(np.ones(rky.shape, np.int32))))
    err = max(desc_equal(fe, p, kx, ky, ks, name) for name, p, kx, ky, ks in cases)
    kx, ky, ks = res.lx.contiguous(), res.ly.contiguous(), res.response.contiguous()
    tk = kernel_ms(lambda: orb_descriptor(pyr, kx, ky, ks, *tabs), "orb_descriptor_kernel")
    plain_ms = time_ms(lambda: orb_descriptor_plain(pyr, kx, ky, ks, *tabs), n=10)
    n_valid = int((ks > 0).sum())
    n_bytes = pyr.numel() + 3 * 4 * ks.numel() + 36 * ks.numel()
    # per valid slot: x blur 45x39x7 and y blur 39x39x7 (mul + add), IC
    # moments 31x31x2 (mul + add), 512 rotated points (4 mul + 2 add) and
    # 256 compares
    n_ops = n_valid * (45 * 39 * 14 + 39 * 39 * 14 + 31 * 31 * 4 + 512 * 6 + 256)
    b_ms, b_by = bound(n_bytes, n_ops)
    print(timing_line("orb_descriptor", tk, plain_ms, b_ms, b_by, floor)
          + f" ({n_valid} valid slots)")
    return dict(name="orb_descriptor", route="cuda",
                source="jetson_slam_tpu_torch/csrc/orb_descriptor.cu",
                replaces="jetson_slam_tpu/ops/pallas_descriptor.py:214",
                max_abs_err=err, ms=tk["ms"], plain_ms=plain_ms, bound_ms=b_ms,
                bound_by=b_by, library_ms=None), res, pyr


def stereo_args(fe, cfg, res, pyr, B=1):
    """Kernel 3's inputs on the main path: the coarse match of B frames'
    left slots (images 0..B-1) and right slots (images B..2B-1)."""
    import torch
    from jetson_slam_tpu_torch.ops.stereo import coarse_match
    cam = cfg.camera
    left = res.map(lambda a: a[:B])
    right = res.map(lambda a: a[B:2 * B])
    c = coarse_match(left, right, fe.scales, fe.inv_scales, fe.widths, cam.bf,
                     cam.bf / cam.fx)
    lvl = left.octave.to(torch.int32).contiguous()
    return (pyr[:B], pyr[B:2 * B], lvl, c["yy"], c["xl"], c["xr"], c["matched"])


def random_windows(fe, lvl, rng):
    """(yy, xl, xr) int32 (1, K): windows inside each slot's level."""
    hw = fe.level_hw.cpu().numpy()[lvl.cpu().numpy()]
    h, w = hw[..., 0], hw[..., 1]
    return tuple(rng.integers(lo, hi).astype(np.int32)
                 for lo, hi in ((5, h - 5), (5, w - 5), (10, w - 10)))


def phase_stereo(fe, cfg, res, pyr, rng, floor):
    import torch
    from jetson_slam_tpu_torch.ops.cuda_stereo import stereo_costs, stereo_costs_plain
    print("phase stereo_costs: kernel vs plain")
    args = stereo_args(fe, cfg, res, pyr)
    lvl = args[2]
    K = lvl.shape[1]
    H0, W0 = pyr.shape[2:]
    hw = fe.level_hw.cpu().numpy()[lvl.cpu().numpy()]
    h, w = hw[..., 0], hw[..., 1]
    either = lambda a, b: np.where(rng.random((1, K)) < 0.5, a, b).astype(np.int32)  # noqa: E731
    inside = random_windows(fe, lvl, rng)
    # strips and rows exactly at each slot's level bounds
    edge = (either(5, h - 6), inside[1], either(10, w - 11))
    # windows reaching past the canvas: xr within 10 of column 0 or W0 - 1,
    # yy within 5 of row 0 or H0 - 1, xl anywhere on the canvas
    past = (either(rng.integers(0, 5, (1, K)), rng.integers(H0 - 5, H0, (1, K))),
            rng.integers(0, W0, (1, K)).astype(np.int32),
            either(rng.integers(0, 10, (1, K)), rng.integers(W0 - 10, W0, (1, K))))
    rpyr = torch.as_tensor(rng.integers(0, 256, tuple(pyr.shape), dtype=np.uint8),
                           device="cuda")
    t = lambda a: torch.as_tensor(a, device="cuda")  # noqa: E731
    half = t(rng.random((1, K)) < 0.5)
    inside = tuple(map(t, inside))
    rand = (rpyr[0:1], rpyr[1:2], lvl)
    cases = (("real", args),
             ("random", rand + inside + (half,)),
             ("level_edge", args[:3] + tuple(map(t, edge)) + (half,)),
             ("canvas_edge", rand + tuple(map(t, past)) + (half,)),
             ("all_matched", rand + inside + (torch.ones_like(half),)),
             ("all_unmatched", rand + inside + (torch.zeros_like(half),)))
    err = max(costs_equal(a, name) for name, a in cases)
    tk = kernel_ms(lambda: stereo_costs(*args), "stereo_costs_kernel")
    plain_ms = time_ms(lambda: stereo_costs_plain(*args), n=20)
    n_m = int(args[-1].sum())
    n_bytes = n_m * (121 + 231) + K * (4 * 4 + 1) + K * 11 * 4
    n_ops = n_m * 121 * 11 * 3
    b_ms, b_by = bound(n_bytes, n_ops)
    print(timing_line("stereo_costs", tk, plain_ms, b_ms, b_by, floor)
          + f" ({n_m} matched slots)")
    return dict(name="stereo_costs", route="cuda",
                source="jetson_slam_tpu_torch/csrc/stereo_costs.cu",
                replaces="jetson_slam_tpu/ops/pallas_stereo.py:168",
                max_abs_err=float(err), ms=tk["ms"], plain_ms=plain_ms,
                bound_ms=b_ms, bound_by=b_by, library_ms=None)


GEOMETRIES = {"kitti": "KITTI00-02_stereo.yaml", "rgbd": SENSOR_CONFIGS["rgbd"],
              "mono": SENSOR_CONFIGS["mono"]}


def phase_geometry(name: str, rng):
    """The kernels against their plain versions at one more geometry, on a
    rendered frame and on random canvases, as that geometry's main path
    feeds them: KITTI 00-02 (1241x376, 1 level, tile 25), whose rows are
    not 16-byte aligned, a stereo pair and all three kernels; the RGB-D and
    mono cells (``sensor_config_and_sequence``: 640x480 at tile 15 and
    752x480 at tile 30, 8 levels), one lens-warped frame (B = 1) and the
    two kernels of the one-eye front end.  FAST+NMS-L bit-equal,
    descriptors identical with angle error 0, stereo costs equal.  Returns
    the max abs difference of each kernel checked."""
    import torch
    from jetson_slam_tpu_torch.config import load_config
    from jetson_slam_tpu_torch.io.synthetic import make_stereo_sequence
    if name == "kitti":
        cfg = load_config(os.path.join(REPO, "examples", "configs", GEOMETRIES[name]))
        cam = cfg.camera
        seq = make_stereo_sequence(seed=11, n_frames=1, h=cam.height, w=cam.width,
                                   fx=cam.fx, baseline=cam.bf / cam.fx, trajectory="arc",
                                   n_points=900)
        imgs = [seq.lefts[0], seq.rights[0]]
    else:
        cfg, _, greys, _ = sensor_config_and_sequence(name, seed=11, n_frames=1)
        imgs = greys
    cam, o = cfg.camera, cfg.orb
    fe = frontend_of(cfg)
    res, pyr = fe.extract_batch(torch.as_tensor(np.stack(imgs), device="cuda"))
    B, L, H0, W0 = pyr.shape
    print(f"phase geometry_{name}: the kernels at {GEOMETRIES[name]}, "
          f"{cam.width}x{cam.height}, {o.n_levels} levels, tile {o.tile_h}, "
          f"FAST {o.fast_n_min}..{o.fast_n_max} at threshold {o.th_fast_max}, "
          f"{B} image(s) of {fe.slot_level.shape[0]} slots")
    rpyr = torch.as_tensor(rng.integers(0, 256, tuple(pyr.shape), dtype=np.uint8),
                           device="cuda")
    err = {"fast_nms": max(fast_equal(fe, p.reshape(B * L, H0, W0), fe.lut, None,
                                      f"{name} {kind}")
                           for kind, p in (("real", pyr), ("random", rpyr)))}
    t = lambda a: torch.as_tensor(a, device="cuda")  # noqa: E731
    rk = tuple(map(t, random_keypoints(fe, rng, B)))
    err["orb_descriptor"] = max(
        desc_equal(fe, pyr, res.lx, res.ly, res.response, f"{name} real"),
        desc_equal(fe, rpyr, *rk, f"{name} random"))
    if name != "kitti":
        return err
    check(pyr[1:2].data_ptr() % 16 == 8 and rpyr[1:2].data_ptr() % 16 == 8,
          "the right eye's stack starts at 8 mod 16")
    args = stereo_args(fe, cfg, res, pyr)
    lvl = args[2]
    half = t(rng.random(tuple(lvl.shape)) < 0.5)
    inside = tuple(map(t, random_windows(fe, lvl, rng)))
    err["stereo_costs"] = max(
        costs_equal(args, "kitti real"),
        costs_equal((rpyr[0:1], rpyr[1:2], lvl) + inside + (half,), "kitti random"))
    return err


# ------------------------------------------------------------------- slice
def phase_slice(cfg, seq, fused: bool = True):
    """The mapping-off session over the arc (``fused=False``: phase
    slice_classic, the staged path on every frame, no fused frame and no
    speculated candidates required).  Returns (launches, median ms per
    frame)."""
    import torch
    from jetson_slam_tpu_torch.core.frame import Frame
    from jetson_slam_tpu_torch.core.tracking import TrackingState
    from jetson_slam_tpu_torch.io.evaluation import ate_rmse
    from jetson_slam_tpu_torch.models.slam import SlamSystem
    from jetson_slam_tpu_torch.ops.cuda_descriptor import orb_descriptor
    from jetson_slam_tpu_torch.ops.cuda_frontend import fast_nms
    from jetson_slam_tpu_torch.ops.cuda_stereo import stereo_costs
    name = "slice" if fused else "slice_classic"
    print(f"phase {name}: SlamSystem(EuRoC_stereo.yaml, stereo, mapping off"
          + ("" if fused else ", tracker.fused=False") + ")")
    Frame._next_id = 0
    slam = SlamSystem(cfg, sensor="stereo", enable_mapping=False)
    slam.tracker.fused = fused
    kernels = (fast_nms, orb_descriptor, stereo_costs)
    for k in kernels:
        k.launches = 0
    states, times, n_kp, n_st = [], [], [], []
    for i in range(len(seq.lefts)):
        t0 = time.perf_counter()
        state, frame = slam.track_stereo(seq.lefts[i], seq.rights[i], seq.timestamps[i])
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        states.append(state)
        n_kp.append(int(frame.valid.sum()))
        n_st.append(int((frame.depth > 0).sum()))
    launches = {k.__name__: k.launches for k in kernels}
    n = len(seq.lefts)
    est_ts, est_poses = slam.camera_trajectory()
    ate = ate_rmse(np.asarray(est_ts), np.asarray(est_poses), seq.timestamps,
                   seq.poses_twc)
    steady = times[5:]
    want_fused = fused
    fused = slam.tracker.fused_frames
    print(f"  frames={n} ok={sum(s == TrackingState.OK for s in states)} "
          f"fused={fused} ate_m={ate:.6f}")
    print(f"  ms_per_frame median={statistics.median(steady):.3f} "
          f"p90={float(np.percentile(steady, 90)):.3f} "
          f"(n={len(steady)} frames after 5 warm frames)")
    print(f"  keypoints_per_frame median={statistics.median(n_kp)} "
          f"stereo_matches_per_frame median={statistics.median(n_st)}")
    print(f"  launches={launches}")
    print(graph_line(slam.tracker))
    check(all(s == TrackingState.OK for s in states), "every frame OK")
    check_fused(slam.tracker, want_fused, n)
    check(ate < 0.05, f"ATE < 0.05 m ({ate:.6f})")
    for k, c in launches.items():
        check(c >= n, f"{k} launched at least once per frame ({c} >= {n})")
    return launches, statistics.median(steady)


def graph_line(tracker) -> str:
    """The session's fused-step graphs: buckets captured, each capture's ms,
    replays."""
    st = tracker.fused_step
    return (f"  graphs captured={st.graphs_captured} capture_ms="
            f"{ {c: round(ms, 3) for c, ms in st.capture_ms.items()} } replays={st.replays}")


def warmups(slam) -> int:
    """Eager runs of the fused step beside the frames fed: on the card the
    capture of each bucket first runs the step once on a side stream,
    which launches each of its kernels once."""
    st = slam.tracker.fused_step
    return st.graphs_captured if st.device.type == "cuda" else 0


def check_fused(tracker, fused: bool, n_frames: int):
    """All but 5 of the frames through the fused step, or (the staged
    path) none and no speculated local-map candidates."""
    n = tracker.fused_frames
    if fused:
        check(n >= n_frames - 5, f">= {n_frames - 5} fused frames ({n})")
    else:
        check(n == 0 and tracker._spec is None,
              f"no fused frame and no speculated candidates ({n} fused)")


def first_frames(seq, n: int):
    """The sequence's first n frames (the same render: the arc's motion
    per frame depends on the frames rendered)."""
    return dataclasses.replace(
        seq, lefts=seq.lefts[:n], rights=seq.rights[:n],
        depths=None if seq.depths is None else seq.depths[:n],
        timestamps=seq.timestamps[:n], poses_twc=seq.poses_twc[:n])


# ------------------------------------------------------- slice, mapping on
MAPPING_STAGES = {
    "cull_map_points": "mapping.cull_points",
    "create_new_map_points": "mapping.triangulate",
    "search_in_neighbors": "mapping.fuse",
    "_lba_prepare": "mapping.lba_prepare",
    "_lba_solve": "mapping.lba_solve",
    "_lba_commit": "mapping.lba_commit",
    "cull_keyframes": "mapping.cull_keyframes",
}


class MapperProbe:
    """For the duration of a with block, wraps LocalMapper's stages to count
    the keyframes it processes (``keyframes``), the local BAs it solves and
    the free cameras of each (``free_cams``), and to sum each stage's host
    ms (``ms``; every stage ends in a blocking pull, so host time holds its
    device time).  Works for the synchronous stage and the async worker."""

    def __enter__(self):
        import collections
        from jetson_slam_tpu_torch.core.local_mapping import LocalMapper
        self.cls = LocalMapper
        self.saved = {}
        self.ms = collections.Counter()
        self.keyframes = 0
        self.free_cams = []

        def timed(name, fn):
            def run(mapper, *args):
                t0 = time.perf_counter()
                try:
                    return fn(mapper, *args)
                finally:
                    self.ms[MAPPING_STAGES[name]] += (time.perf_counter() - t0) * 1e3
            return run

        def counted(fn):
            def run(mapper, kid):
                self.keyframes += 1
                return fn(mapper, kid)
            return run

        def solve(fn):
            def run(mapper, prep):
                self.free_cams.append(int((~prep["fixed"][:len(prep["cams"])]).sum()))
                return fn(mapper, prep)
            return run

        for name in list(MAPPING_STAGES) + ["_register_new_points"]:
            self.saved[name] = getattr(LocalMapper, name)
        for name in MAPPING_STAGES:
            setattr(LocalMapper, name, timed(name, self.saved[name]))
        LocalMapper._register_new_points = counted(self.saved["_register_new_points"])
        LocalMapper._lba_solve = solve(LocalMapper._lba_solve)
        return self

    def __exit__(self, *exc):
        for name, fn in self.saved.items():
            setattr(self.cls, name, fn)
        return False


def check_map(m):
    """Every observation of a live keyframe points at a live point, and the
    index _pt_obs agrees with kf_obs both ways."""
    kfs = m.keyframe_ids()
    obs = m.kf_obs[kfs]
    pids = obs[obs >= 0]
    check(bool(m.pt_alive[pids].all()),
          f"all {len(pids)} observations of {len(kfs)} keyframes point at live points")
    n_idx = 0
    for pid in np.flatnonzero(m.pt_alive):
        for kf, slot in m._pt_obs.get(int(pid), {}).items():
            n_idx += 1
            if m.kf_obs[kf, slot] != pid:
                raise AssertionError(f"_pt_obs[{pid}] holds ({kf}, {slot}); kf_obs has "
                                     f"{m.kf_obs[kf, slot]}")
    for k, slot in zip(*np.nonzero(m.kf_obs[kfs] >= 0)):
        kf = int(kfs[k])
        if m._pt_obs.get(int(m.kf_obs[kf, slot]), {}).get(kf) != slot:
            raise AssertionError(f"kf_obs[{kf}, {slot}] is missing from _pt_obs")
    check(n_idx >= len(pids), f"_pt_obs agrees with kf_obs ({n_idx} entries)")


def phase_mapping(cfg, seq, name: str, fused: bool = True, **kw):
    """One mapping-on session over the arc: the launch counters set to 0
    just before and read just after; checks and prints as the module's
    docstring says (``fused=False``: the staged path, as phase_slice).
    Returns (launches, {"median": ms per call, "window": steady window ms
    per frame})."""
    import torch
    from jetson_slam_tpu_torch.core.frame import Frame
    from jetson_slam_tpu_torch.io.evaluation import ate_rmse
    from jetson_slam_tpu_torch.core.tracking import TrackingState
    from jetson_slam_tpu_torch.models.slam import SlamSystem
    from jetson_slam_tpu_torch.ops.cuda_descriptor import orb_descriptor
    from jetson_slam_tpu_torch.ops.cuda_frontend import fast_nms
    from jetson_slam_tpu_torch.ops.cuda_stereo import stereo_costs
    print(f"phase {name}: SlamSystem(EuRoC_stereo.yaml, stereo, mapping on"
          + "".join(f", {k}={v}" for k, v in kw.items())
          + ("" if fused else ", tracker.fused=False") + ")")
    Frame._next_id = 0
    slam = SlamSystem(cfg, sensor="stereo", **kw)
    slam.tracker.fused = fused
    kernels = (fast_nms, orb_descriptor, stereo_costs)
    for k in kernels:
        k.launches = 0
    # no device-wide sync per call: it would also wait for the worker's
    # stream and the frames in flight, serialising what pipelining and the
    # side stream overlap; the window runs from the first call to the end
    # of shutdown(), which finishes every frame and drains the worker
    states, times = [], []
    n, warm = len(seq.lefts), 5
    with MapperProbe() as probe:
        t_start = time.perf_counter()
        for i in range(n):
            t0 = time.perf_counter()
            if i == warm:
                t_steady = t0
            state, _ = slam.track_stereo(seq.lefts[i], seq.rights[i], seq.timestamps[i])
            times.append((time.perf_counter() - t0) * 1e3)
            states.append(state)
        slam.shutdown()
        torch.cuda.synchronize()
        t_end = time.perf_counter()
    launches = {k.__name__: k.launches for k in kernels}
    m = slam.map
    est_ts, est_poses = slam.camera_trajectory()
    ate = ate_rmse(np.asarray(est_ts), np.asarray(est_poses), seq.timestamps,
                   seq.poses_twc)
    traj = slam.tracker.trajectory
    steady = times[warm:]
    n_fused = slam.tracker.fused_frames
    created = int(m.kf_gen.sum())
    n_kf = m.n_keyframes()
    kf_ms = sum(probe.ms.values()) / max(probe.keyframes, 1)
    print(f"  frames={n} ok={sum(s == TrackingState.OK for s in states)} "
          f"finished={len(traj)} lost={sum(e[3] for e in traj)} fused={n_fused} "
          f"ate_m={ate:.6f}")
    window = (t_end - t_steady) * 1e3 / (n - warm)
    print(f"  window_ms_per_frame all={(t_end - t_start) * 1e3 / n:.3f} "
          f"steady={window:.3f} (first call, or call "
          f"{warm}, to the end of shutdown())")
    print(f"  ms_per_call median={statistics.median(steady):.3f} "
          f"p90={float(np.percentile(steady, 90)):.3f} max={max(steady):.3f} "
          f"(n={len(steady)} calls after {warm} warm calls, no device sync)")
    print(f"  keyframes created={created} culled={created - n_kf} alive={n_kf} "
          f"map_points_alive={m.n_points()} keyframes_mapped={probe.keyframes} "
          f"local_bas={len(probe.free_cams)} free_cameras={probe.free_cams}")
    print(f"  mapping_ms_per_keyframe={kf_ms:.3f} by stage: " + "; ".join(
        f"{stage} {probe.ms[stage] / max(probe.keyframes, 1):.3f}"
        for stage in MAPPING_STAGES.values()))
    print(f"  launches={launches}")
    print(graph_line(slam.tracker))
    check(all(s == TrackingState.OK for s in states), "every frame OK")
    check(len(traj) == n and not any(e[3] for e in traj),
          f"all {n} frames finished, none lost")
    check_fused(slam.tracker, fused, n)
    check(ate < 0.05, f"ATE < 0.05 m ({ate:.6f})")
    check(n_kf >= 3, f">= 3 keyframes alive ({n_kf})")
    check(len(probe.free_cams) >= 1 and min(probe.free_cams) >= 1,
          f"local BA ran with a free camera ({len(probe.free_cams)} runs)")
    check_map(m)
    for k, c in launches.items():
        check(c >= n, f"{k} launched at least once per frame ({c} >= {n})")
    return launches, {"median": statistics.median(steady), "window": window,
                      "ate": ate}


# ------------------------------------------- relocalization, loop closing
RELOC_FRAMES, RELOC_VIEW = 20, 15


class RelocProbe:
    """For a with block, wraps ``Tracker._relocalization`` (host ms of each
    call, blocking: it ends in a pull) and ``tracking._batched_reloc`` (its
    outputs: the real candidates and each one's n_match / n_final)."""

    def __enter__(self):
        from jetson_slam_tpu_torch.core import tracking
        self.mod = tracking
        self.saved = (tracking.Tracker._relocalization, tracking._batched_reloc)
        self.calls = []
        reloc, batched = self.saved

        def timed(tracker, frame):
            t0 = time.perf_counter()
            ok = reloc(tracker, frame)
            self.calls.append({"ms": (time.perf_counter() - t0) * 1e3, "ok": ok,
                               **self.last})
            return ok

        def kept(*args):
            out = batched(*args)
            c_has = args[8]
            self.last = {"candidates": c_has.any(1), "n_match": out[0],
                         "n_final": out[1]}
            return out

        self.last = {}
        tracking.Tracker._relocalization = timed
        tracking._batched_reloc = kept
        return self

    def __exit__(self, *exc):
        self.mod.Tracker._relocalization, self.mod._batched_reloc = self.saved
        return False

    def lines(self):
        for k, c in enumerate(self.calls):
            real = c["candidates"].cpu().numpy() if "candidates" in c else np.zeros(0, bool)
            nm = c["n_match"].cpu().numpy()[real] if real.any() else []
            nf = c["n_final"].cpu().numpy()[real] if real.any() else []
            yield (f"  relocalization {k}: ok={c['ok']} ms={c['ms']:.3f} "
                   f"candidates={int(real.sum())} n_match={list(map(int, nm))} "
                   f"n_final={list(map(int, nf))}")


def phase_reloc(cfg, seq, name: str, vocab):
    """Track RELOC_FRAMES frames of the arc (mapping on, sync), blind the
    camera for 3 frames (LOST), then re-feed frame RELOC_VIEW until OK (at
    most 3 attempts); the launch counters are set to 0 just before and read
    just after.  Returns (session, launches) for the counting phase."""
    import torch
    from jetson_slam_tpu_torch.core.frame import Frame
    from jetson_slam_tpu_torch.core.tracking import TrackingState
    from jetson_slam_tpu_torch.models.slam import SlamSystem
    from jetson_slam_tpu_torch.ops.cuda_descriptor import orb_descriptor
    from jetson_slam_tpu_torch.ops.cuda_frontend import fast_nms
    from jetson_slam_tpu_torch.ops.cuda_stereo import stereo_costs
    print(f"phase {name}: SlamSystem(EuRoC_stereo.yaml, stereo, mapping on, "
          f"vocabulary={'none' if vocab is None else f'{vocab.n_words} words'}), "
          f"{RELOC_FRAMES} frames, 3 black frames, frame {RELOC_VIEW} again")
    Frame._next_id = 0
    t0 = time.perf_counter()
    slam = SlamSystem(cfg, sensor="stereo", vocabulary=vocab)
    print(f"  SlamSystem built in {(time.perf_counter() - t0) * 1e3:.3f} ms")
    kernels = (fast_nms, orb_descriptor, stereo_costs)
    for k in kernels:
        k.launches = 0
    est, states = {}, []
    for i in range(RELOC_FRAMES):
        state, frame = slam.track_stereo(seq.lefts[i], seq.rights[i], seq.timestamps[i])
        states.append(state)
        est[i] = frame.Tcw.copy()
    black = np.zeros((H, W), np.uint8)
    lost = []
    for j in range(3):
        state, _ = slam.track_stereo(black, black, 100.0 + j)
        lost.append(state)
    with RelocProbe() as probe:
        for attempt in range(3):
            t0 = time.perf_counter()
            state, frame = slam.track_stereo(seq.lefts[RELOC_VIEW], seq.rights[RELOC_VIEW],
                                             200.0 + attempt)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            print(f"  attempt {attempt}: state={state.name} frame_ms={ms:.3f}")
            if state == TrackingState.OK:
                break
    launches = {k.__name__: k.launches for k in kernels}
    for line in probe.lines():
        print(line)
    dt = float(np.linalg.norm(frame.Tcw[:3, 3] - est[RELOC_VIEW][:3, 3]))
    n = RELOC_FRAMES + 3 + attempt + 1
    print(f"  keyframes={slam.map.n_keyframes()} attempts={attempt + 1} "
          f"pose_gap_m={dt:.6f} launches={launches}")
    slam.shutdown()
    check(all(s == TrackingState.OK for s in states), f"all {RELOC_FRAMES} frames OK")
    check(lost[-1] == TrackingState.LOST, "3 black frames give LOST")
    check(state == TrackingState.OK, f"relocalized on attempt {attempt + 1} of at most 3")
    check(dt < 0.05, f"relocalized within 0.05 m of the tracked pose ({dt:.6f})")
    check(len(probe.calls) >= 1, "the relocalization ran")
    for k, c in launches.items():
        check(c >= n, f"{k} launched at least once per frame ({c} >= {n})")
    return slam, launches


def phase_reloc_counts(slam, seq, name: str):
    """Kernel launches (torch.profiler) and synchronising calls (by source
    line) of one relocalization of frame RELOC_VIEW in a session of
    phase_reloc."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from jetson_slam_tpu_torch.core.frame import Frame
    tr = slam.tracker
    frame = Frame(tr.frontend, tr.cam, 300.0, seq.lefts[RELOC_VIEW], seq.rights[RELOC_VIEW])
    tr._relocalization(frame)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        ok = tr._relocalization(frame)
        torch.cuda.synchronize()
    avgs = prof.key_averages()
    launch = sum(a.count for a in avgs if a.key in LAUNCH_CALLS)
    syncs = sum(a.count for a in avgs if "Synchronize" in a.key)
    sites = sync_sites(lambda: tr._relocalization(frame))
    print(f"phase {name}_counts: one relocalization (ok={ok}): kernel_launches={launch} "
          f"synchronize_calls={syncs}; synchronising calls by line: "
          f"{sum(sites.values())} " + json.dumps(sites))


class LoopProbe:
    """For a with block, wraps LoopCloser's stages: host ms of each
    compute_sim3 / correct_loop (which holds the essential graph and, when
    synchronous, the GBA) / global_bundle_adjustment / _gba_solve (the
    asynchronous GBA's solve on its thread) / _gba_commit, and the
    (keyframe, loop keyframe) of each correction.  Inside compute_sim3 it
    also times each step (``SIM3_STEPS``; within sim3_optimization its
    float64 ``torch.func.jacfwd`` calls and its ``torch.linalg.solve_ex``
    calls) between two syncs of the calling thread's stream, so each
    step's ms holds its device work; ``sim3_calls`` keeps, per compute_sim3, whether it accepted, its
    ms, the ms of each step, and the modules imported during the call
    (their count, and whether ``torch._dynamo`` was among them)."""
    STAGES = ("compute_sim3", "correct_loop", "global_bundle_adjustment",
              "_gba_solve", "_gba_commit")
    SIM3_STEPS = ("match_brute_force", "sim3_ransac", "_search_by_sim3",
                  "sim3_optimization", "jacfwd", "solve_ex", "_guided_loop_matches")

    def __enter__(self):
        import collections
        import threading
        import torch
        from jetson_slam_tpu_torch.core import loop_closing, matcher
        from jetson_slam_tpu_torch.core.loop_closing import LoopCloser
        self.cls = LoopCloser
        self.saved = {n: getattr(LoopCloser, n) for n in self.STAGES}
        self.saved_steps = [(LoopCloser, "_search_by_sim3"),
                            (LoopCloser, "_guided_loop_matches"),
                            (matcher, "match_brute_force"),
                            (loop_closing, "sim3_ransac"),
                            (loop_closing, "sim3_optimization"),
                            (torch.linalg, "solve_ex"), (torch.func, "jacfwd")]
        self.saved_steps = [(o, n, getattr(o, n)) for o, n in self.saved_steps]
        self.ms = collections.defaultdict(list)
        self.events = []
        self.sim3_calls = []
        here = threading.local()

        def timed(name, fn):
            def run(closer, *args, **kw):
                if name == "correct_loop":
                    self.events.append((int(args[0]), int(args[1])))
                if name == "compute_sim3":
                    here.steps = collections.defaultdict(float)
                    modules = set(sys.modules)
                t0 = time.perf_counter()
                out = None
                try:
                    out = fn(closer, *args, **kw)
                    return out
                finally:
                    ms = (time.perf_counter() - t0) * 1e3
                    self.ms[name].append(ms)
                    if name == "compute_sim3":
                        new = set(sys.modules) - modules
                        self.sim3_calls.append(dict(
                            accepted=bool(out and out[0]), ms=round(ms, 3),
                            **{k: round(v, 3) for k, v in here.steps.items()},
                            modules_imported=len(new),
                            imported_dynamo="torch._dynamo" in new))
                        here.steps = None
            return run

        def step(name, fn):
            def run(*args, **kw):
                steps = getattr(here, "steps", None)
                if steps is None or (name in ("jacfwd", "solve_ex")
                                     and not getattr(here, "in_opt", False)):
                    return fn(*args, **kw)
                # this thread's stream only: a device-wide sync on the
                # mapping worker would break the tracker's graph capture
                torch.cuda.current_stream().synchronize()
                t0 = time.perf_counter()
                here.in_opt = (getattr(here, "in_opt", False)
                               or name == "sim3_optimization")
                try:
                    out = fn(*args, **kw)
                    torch.cuda.current_stream().synchronize()
                    return out
                finally:
                    steps[name] += (time.perf_counter() - t0) * 1e3
                    if name == "sim3_optimization":
                        here.in_opt = False
            return run

        def jacfwd(fn, *a, **kw):
            return step("jacfwd", self.saved_steps[-1][2](fn, *a, **kw))

        for n, fn in self.saved.items():
            setattr(LoopCloser, n, timed(n, fn))
        for o, n, fn in self.saved_steps:
            setattr(o, n, jacfwd if n == "jacfwd" else step(n, fn))
        return self

    def __exit__(self, *exc):
        for n, fn in self.saved.items():
            setattr(self.cls, n, fn)
        for o, n, fn in self.saved_steps:
            setattr(o, n, fn)
        return False


def loop_sequence():
    """The 1.3-lap circle of tests/test_loop_fuzz.py at EuRoC geometry."""
    from jetson_slam_tpu_torch.config import load_config
    from jetson_slam_tpu_torch.io.synthetic import make_stereo_sequence
    cfg = load_config(os.path.join(REPO, "examples", "configs", "EuRoC_stereo.yaml"))
    seq = make_stereo_sequence(seed=3, n_frames=84, h=H, w=W, fx=435.2047,
                               baseline=0.110076, trajectory="circle",
                               n_points=1200, laps=1.3)
    cfg.camera.cx, cfg.camera.cy = seq.cx, seq.cy
    return cfg, seq


def phase_loop(cfg, seq, name: str, vocab, **kw):
    """One mapping-on session with a vocabulary over the 1.3-lap circle;
    the launch counters set to 0 just before and read just after.  Prints
    the loops closed, ATE, window ms per frame and the ms of each loop
    stage; returns what ``check_loop`` holds."""
    import torch
    from jetson_slam_tpu_torch.core.frame import Frame
    from jetson_slam_tpu_torch.core.tracking import TrackingState
    from jetson_slam_tpu_torch.io.evaluation import ate_rmse
    from jetson_slam_tpu_torch.models.slam import SlamSystem
    from jetson_slam_tpu_torch.ops.cuda_descriptor import orb_descriptor
    from jetson_slam_tpu_torch.ops.cuda_frontend import fast_nms
    from jetson_slam_tpu_torch.ops.cuda_stereo import stereo_costs
    print(f"phase {name}: SlamSystem(EuRoC_stereo.yaml, stereo, mapping on, "
          f"vocabulary={vocab.n_words} words (k={vocab.k}, L={vocab.L})"
          + "".join(f", {k}={v}" for k, v in kw.items())
          + f") on the {len(seq.lefts)}-frame 1.3-lap circle")
    Frame._next_id = 0
    t0 = time.perf_counter()
    slam = SlamSystem(cfg, sensor="stereo", vocabulary=vocab, **kw)
    print(f"  SlamSystem built in {(time.perf_counter() - t0) * 1e3:.3f} ms")
    kernels = (fast_nms, orb_descriptor, stereo_costs)
    for k in kernels:
        k.launches = 0
    states, n = [], len(seq.lefts)
    with LoopProbe() as probe:
        t_start = time.perf_counter()
        for i in range(n):
            state, _ = slam.track_stereo(seq.lefts[i], seq.rights[i], seq.timestamps[i])
            states.append(state)
        slam.shutdown()
        torch.cuda.synchronize()
        t_end = time.perf_counter()
    launches = {k.__name__: k.launches for k in kernels}
    lc = slam.loop_closer
    est_ts, est_poses = slam.camera_trajectory()
    ate = ate_rmse(np.asarray(est_ts), np.asarray(est_poses), seq.timestamps,
                   seq.poses_twc)
    traj = slam.tracker.trajectory
    n_ok = sum(s == TrackingState.OK for s in states)
    print(f"  frames={n} ok={n_ok} finished={len(traj)} lost={sum(e[3] for e in traj)} "
          f"ate_m={ate:.6f} keyframes created={int(slam.map.kf_gen.sum())} "
          f"alive={slam.map.n_keyframes()}")
    print(f"  loops_closed={lc.n_loops_closed} corrections(keyframe, loop keyframe)="
          f"{probe.events} gba_threads={lc.gba_launched} gba_dropped={lc.gba_dropped}")
    print(f"  window_ms_per_frame={(t_end - t_start) * 1e3 / n:.3f} (first call to the "
          f"end of shutdown())")
    print("  stage ms: " + "; ".join(
        f"{st} {[round(x, 3) for x in probe.ms[st]]}" for st in LoopProbe.STAGES))
    # the compute_sim3 calls that reached the Sim(3) LM, by step, in order
    deep = [dict(call=i, **c) for i, c in enumerate(probe.sim3_calls)
            if "sim3_optimization" in c]
    print(f"  compute_sim3 steps (ms between stream syncs; {len(probe.sim3_calls)} calls, "
          f"{len(deep)} reached sim3_optimization): " + json.dumps(deep))
    print(f"  launches={launches}")
    return dict(slam=slam, closed=lc.n_loops_closed, ate=ate, n=n,
                all_ok=n_ok == n and len(traj) == n and not any(e[3] for e in traj),
                gba_solves=len(probe.ms["_gba_solve"]), launches=launches,
                async_mapping=bool(kw.get("async_mapping")))


def phase_sensor(sensor: str, cell=None):
    """One mapping-on session (synchronous) of the RGB-D or mono cell
    (``sensor_config_and_sequence``), through ``track_rgbd`` or
    ``track_monocular``; the launch counters set to 0 just before and read
    just after.  RGB-D requires every frame OK, all but 5 frames fused,
    SE(3)-aligned ATE < 0.05 m and >= 3 keyframes alive; mono requires the
    initialization within the first 10 frames, every frame OK from there,
    Sim(3)-aligned ATE < 0.15 m and a fused frame.  Both require a
    consistent map, a launch of fast_nms and orb_descriptor per frame fed
    and no launch of stereo_costs.  Prints the window ms per frame, the ms
    per call, keyframes created and alive and, for mono, the initialization
    frame and each initializer call's ms.  ``cell``: the cell already
    rendered, else it is rendered here.  Returns the launches."""
    import torch
    from jetson_slam_tpu_torch.core.frame import Frame
    from jetson_slam_tpu_torch.core.initializer import MonoInitializer
    from jetson_slam_tpu_torch.core.tracking import TrackingState
    from jetson_slam_tpu_torch.io.evaluation import ate_rmse
    from jetson_slam_tpu_torch.models.slam import SlamSystem
    from jetson_slam_tpu_torch.ops.cuda_descriptor import orb_descriptor
    from jetson_slam_tpu_torch.ops.cuda_frontend import fast_nms
    from jetson_slam_tpu_torch.ops.cuda_stereo import stereo_costs
    cfg, seq, greys, depths = cell or sensor_config_and_sequence(sensor)
    c = cfg.camera
    name = f"slice_{sensor}"
    print(f"phase {name}: SlamSystem({SENSOR_CONFIGS[sensor]}, {sensor}, mapping on), "
          f"{c.width}x{c.height}, {cfg.orb.n_levels} levels, tile {cfg.orb.tile_h}, "
          f"lens k1={c.k1} k2={c.k2} p1={c.p1} p2={c.p2} k3={c.k3}")
    Frame._next_id = 0
    slam = SlamSystem(cfg, sensor=sensor)
    kernels = (fast_nms, orb_descriptor, stereo_costs)
    init_ms, init_calls = [], []
    orig_init = MonoInitializer.initialize

    def timed_init(self, *args):
        # keep the matches, the minimal samples drawn and the result
        draw, call = self._sample, dict(args=args)

        def sample(n_valid):
            call["sample"] = draw(n_valid)
            return call["sample"]

        self._sample = sample
        t0 = time.perf_counter()
        try:
            call["out"] = orig_init(self, *args)   # ends in a pull: blocking
            return call["out"]
        finally:
            init_ms.append((time.perf_counter() - t0) * 1e3)
            init_calls.append(call)

    for k in kernels:
        k.launches = 0
    states, times = [], []
    n, warm = SENSOR_FRAMES[sensor], 5
    MonoInitializer.initialize = timed_init
    try:
        with MapperProbe() as probe:
            t_start = time.perf_counter()
            for i in range(n):
                t0 = time.perf_counter()
                if i == warm:
                    t_steady = t0
                if sensor == "rgbd":
                    state, _ = slam.track_rgbd(greys[i], depths[i], seq.timestamps[i])
                else:
                    state, _ = slam.track_monocular(greys[i], seq.timestamps[i])
                times.append((time.perf_counter() - t0) * 1e3)
                states.append(state)
            slam.shutdown()
            torch.cuda.synchronize()
            t_end = time.perf_counter()
    finally:
        MonoInitializer.initialize = orig_init
    launches = {k.__name__: k.launches for k in kernels}
    m = slam.map
    est_ts, est_poses = slam.camera_trajectory()
    ate = ate_rmse(np.asarray(est_ts), np.asarray(est_poses), seq.timestamps,
                   seq.poses_twc, with_scale=sensor == "mono")
    ok = [s == TrackingState.OK for s in states]
    first = ok.index(True) if any(ok) else n
    fused = slam.tracker.fused_frames
    created, n_kf = int(m.kf_gen.sum()), m.n_keyframes()
    steady = times[warm:]
    print(f"  frames={n} ok={sum(ok)} first_ok_frame={first} fused={fused} "
          f"ate_m={ate:.6f} ({'Sim(3)' if sensor == 'mono' else 'SE(3)'}-aligned, "
          f"{len(est_ts)} poses)")
    print(f"  window_ms_per_frame all={(t_end - t_start) * 1e3 / n:.3f} "
          f"steady={(t_end - t_steady) * 1e3 / (n - warm):.3f} (first call, or call "
          f"{warm}, to the end of shutdown())")
    print(f"  ms_per_call median={statistics.median(steady):.3f} "
          f"p90={float(np.percentile(steady, 90)):.3f} max={max(steady):.3f} "
          f"(n={len(steady)} calls after {warm} warm calls, no device sync)")
    print(f"  keyframes created={created} culled={created - n_kf} alive={n_kf} "
          f"map_points_alive={m.n_points()} keyframes_mapped={probe.keyframes} "
          f"local_bas={len(probe.free_cams)}")
    if sensor == "mono":
        print(f"  initializer calls={len(init_ms)} ms={[round(x, 3) for x in init_ms]}")
    print(f"  launches={launches}")
    print(graph_line(slam.tracker))
    if sensor == "rgbd":
        check(all(ok), "every frame OK")
        check(fused >= n - 5, f">= {n - 5} fused frames ({fused})")
        check(ate < 0.05, f"SE(3)-aligned ATE < 0.05 m ({ate:.6f})")
        check(n_kf >= 3, f">= 3 keyframes alive ({n_kf})")
    else:
        check(first < 10, f"initialized within the first 10 frames (frame {first})")
        check(all(ok[first:]), "every frame OK from the initialization on")
        check(ate < 0.15, f"Sim(3)-aligned ATE < 0.15 m ({ate:.6f})")
        check(fused >= 1, f"a fused frame ({fused})")
        check_initializer(c, [r for r in init_calls if r["out"][0]][-1])
    check_map(m)
    for k in ("fast_nms", "orb_descriptor"):
        check(launches[k] >= n, f"{k} launched at least once per frame ({launches[k]} >= {n})")
    check(launches["stereo_costs"] == 0,
          f"stereo_costs not launched without a right eye ({launches['stereo_costs']})")
    return launches


def check_initializer(cam, call):
    """The mono session's accepted initializer call, repeated on the CPU
    with the same matches and the same minimal samples: the same best SH
    and SF within rtol 1e-4 and the same model, identical good-point masks, R and t within 1e-4 and the points within
    1e-3 relative (the bounds of tests/test_torch_initializer.py against
    the JAX package)."""
    import torch
    from jetson_slam_tpu_torch.core.initializer import MonoInitializer
    kp1, kp2, valid = call["args"]
    got = {}
    for dev in ("cuda", "cpu"):
        init = MonoInitializer(cam.fx, cam.fy, cam.cx, cam.cy, dev)
        sample = call["sample"].to(dev)
        init._sample = lambda n_valid, s=sample: s
        t = lambda a, dt: torch.as_tensor(np.asarray(a, dt), device=dev)  # noqa: E731
        sh, _, sf, _ = init.hypotheses(t(kp1, np.float32), t(kp2, np.float32),
                                       t(valid, bool), sample)
        SH, SF = float(sh.max()), float(sf.max())
        got[dev] = (SH, SF, SH / (SH + SF) > 0.40) + tuple(init.initialize(kp1, kp2, valid))
    (SH, SF, use_h, ok, R, tr, X, good), cpu = got["cuda"], got["cpu"]
    print(f"  initializer on the card / on the CPU: {int(valid.sum())} matches, "
          f"SH {SH:.4f} / {cpu[0]:.4f}, SF {SF:.4f} / {cpu[1]:.4f}, "
          f"{'H' if use_h else 'F'} / {'H' if cpu[2] else 'F'}, good {int(good.sum())} / "
          f"{int(cpu[7].sum())}, R err {np.abs(R - cpu[4]).max():.3g}, "
          f"t err {np.abs(tr - cpu[5]).max():.3g}")
    check(ok and cpu[3] and all(np.array_equal(a, b, equal_nan=True) for a, b in
                                zip((R, tr, X, good), call["out"][1:])),
          "the card's repeat of the accepted initializer call gives the session's result")
    check(abs(SH - cpu[0]) <= 1e-4 * abs(cpu[0]) and abs(SF - cpu[1]) <= 1e-4 * abs(cpu[1])
          and use_h == cpu[2], "best SH and SF within rtol 1e-4 of the CPU's, the same model")
    check(np.array_equal(good, cpu[7]), f"identical good points ({int(good.sum())})")
    check(np.abs(R - cpu[4]).max() <= 1e-4 and np.abs(tr - cpu[5]).max() <= 1e-4,
          "R and t within 1e-4 of the CPU's")
    err = np.linalg.norm(X[good] - cpu[6][good], axis=1) / np.linalg.norm(cpu[6][good], axis=1)
    check(err.max() <= 1e-3, f"the good points within 1e-3 relative of the CPU's "
          f"({err.max():.3g})")


# ------------------------------------------ adversarial sequences, fuzz
ADVERSARIAL = ("exposure", "low_texture", "static", "motion_jump")
CRUSHED, TAIL = range(15, 21), 24   # tests/test_adversarial.py's frames
FLIP_P = 3.4 / 256.0                # tests/test_descriptor_fuzz.py's rate


def crush(img):
    """Contrast crushed to 20 % about the image mean."""
    f = img.astype(np.float32)
    return np.clip(f.mean() + 0.2 * (f - f.mean()), 0, 255).astype(np.uint8)


def adversarial_frames(seq, name: str, order=None):
    """tests/test_adversarial.py's perturbation ``name`` applied to the arc:
    the illumination ramped 0.55x -> 1.45x over the frames fed (its 40);
    frames 15..20 of the first 36 crushed; frame 0 fed 15 times; frames
    0..9 then 16..25 (6 frames skipped).  ``order``, the indices of the
    frames fed, replaces those.  Returns (lefts, rights, timestamps, and
    the ground truth's timestamps and poses of the frames fed)."""
    n = len(seq.lefts)
    if order is None:
        order = {"exposure": list(range(n)), "low_texture": list(range(36)),
                 "static": [0] * 15,
                 "motion_jump": list(range(10)) + list(range(16, 26))}.get(name, list(range(n)))
    lefts = [seq.lefts[i] for i in order]
    rights = [seq.rights[i] for i in order]
    if name == "exposure":
        gains = np.linspace(0.55, 1.45, len(order))
        lefts = [np.clip(im.astype(np.float32) * g, 0, 255).astype(np.uint8)
                 for im, g in zip(lefts, gains)]
        rights = [np.clip(im.astype(np.float32) * g, 0, 255).astype(np.uint8)
                  for im, g in zip(rights, gains)]
    if name == "low_texture":
        for i in CRUSHED:
            lefts[i], rights[i] = crush(lefts[i]), crush(rights[i])
    if name in ("static", "motion_jump"):
        ts = [j / 20.0 for j in range(len(order))]
    else:
        ts = [float(seq.timestamps[i]) for i in order]
    return lefts, rights, ts, np.asarray(ts), [seq.poses_twc[i] for i in order]


def fuzz_frontend(fe, seed: int = 1234):
    """Make fe flip each descriptor bit with probability FLIP_P after every
    extraction; ``fe.fuzz`` counts the bits flipped on valid slots and the
    valid slots' bits (device tensors).  On the card the bits come from
    the default CUDA generator, seeded with seed here, which a captured
    fused step advances at every replay; on the CPU from a torch.Generator
    seeded with seed + the extraction's count."""
    import torch
    from jetson_slam_tpu_torch.ops.frontend import OrbFrontend

    class FuzzFrontend(OrbFrontend):
        def extract_batch(self, imgs_u8):
            res, pyr = super().extract_batch(imgs_u8)
            self.fuzz_calls += 1
            gen = None
            if res.desc.device.type != "cuda":
                gen = torch.Generator(device=res.desc.device)
                gen.manual_seed(seed + self.fuzz_calls)
            bits = torch.rand(res.desc.shape + (8,), generator=gen,
                              device=res.desc.device) < FLIP_P
            shifts = torch.arange(8, device=bits.device, dtype=torch.int32)
            mask = (bits.to(torch.int32) << shifts).sum(-1).to(torch.uint8)
            valid = res.valid[..., None, None]
            self.fuzz[0] += (bits & valid).sum()
            self.fuzz[1] += valid.sum() * 256
            return dataclasses.replace(res, desc=res.desc ^ mask), pyr

    fe.__class__ = FuzzFrontend
    if fe.device.type == "cuda":
        torch.cuda.manual_seed(seed)
    fe.fuzz_calls = 0
    fe.fuzz = torch.zeros(2, dtype=torch.int64, device=fe.device)
    return fe


def phase_adversarial(cfg, seq, name: str, vocab=None, clean_ate=None):
    """One mapping-on session (synchronous) over the arc with one of
    tests/test_adversarial.py's perturbations (``adversarial_<name>``), or
    over the whole arc with its descriptor bits flipped at FLIP_P
    (``descriptor_fuzz``, against ``clean_ate``: slice_mapping's ATE in
    the same call); the launch counters set to 0 just before and read just
    after.  Gates, as the JAX tests': exposure > 80 % of the frames OK and
    ATE < 0.08 m; low_texture the last frame and frames 24.. OK; static the
    last frame OK and a drift < 0.01 m; motion_jump the last 6 frames OK;
    the fuzz every frame OK, ATE < 0.05 m and within 0.01 m of clean_ate.
    Every kernel launched at least once per frame fed.  Prints the states,
    the ATE (the drift for static), the fused frames, keyframes, the window
    ms per frame and the phase's seconds."""
    import torch
    from jetson_slam_tpu_torch.core.frame import Frame
    from jetson_slam_tpu_torch.io.evaluation import ate_rmse
    from jetson_slam_tpu_torch.models.slam import SlamSystem
    from jetson_slam_tpu_torch.ops.cuda_descriptor import orb_descriptor
    from jetson_slam_tpu_torch.ops.cuda_frontend import fast_nms
    from jetson_slam_tpu_torch.ops.cuda_stereo import stereo_costs
    fuzz = name == "descriptor_fuzz"
    phase = name if fuzz else f"adversarial_{name}"
    t_phase = time.perf_counter()
    lefts, rights, ts, gt_ts, gt_poses = adversarial_frames(seq, name)
    print(f"phase {phase}: SlamSystem(EuRoC_stereo.yaml, stereo, mapping on, vocabulary="
          f"{'none' if vocab is None else f'{vocab.n_words} words'}), {len(lefts)} frames")
    Frame._next_id = 0
    slam = SlamSystem(cfg, sensor="stereo", vocabulary=vocab)
    if fuzz:
        fuzz_frontend(slam.frontend)
    kernels = (fast_nms, orb_descriptor, stereo_costs)
    for k in kernels:
        k.launches = 0
    t_start = time.perf_counter()
    states = [slam.track_stereo(lefts[i], rights[i], ts[i])[0].name
              for i in range(len(lefts))]
    slam.shutdown()
    torch.cuda.synchronize()
    window = (time.perf_counter() - t_start) * 1e3 / len(lefts)
    launches = {k.__name__: k.launches for k in kernels}
    est_ts, est_p = slam.camera_trajectory()
    est_p = np.asarray(est_p)
    if name == "static":
        err = float(np.linalg.norm(est_p[:, :3, 3] - est_p[0, :3, 3], axis=1).max())
    else:
        err = float(ate_rmse(np.asarray(est_ts), est_p, gt_ts, gt_poses))
    n, n_ok = len(states), sum(s == "OK" for s in states)
    print(f"  states={''.join(s[0] for s in states)} ok={n_ok}/{n} "
          f"{'drift' if name == 'static' else 'ate'}_m={err:.6f} "
          f"fused={slam.tracker.fused_frames} keyframes created={int(slam.map.kf_gen.sum())} "
          f"alive={slam.map.n_keyframes()} window_ms_per_frame={window:.3f}")
    print(f"  launches={launches}")
    if fuzz:
        flipped, total = (int(x) for x in slam.frontend.fuzz)
        print(f"  bits flipped on valid slots {flipped} of {total} "
              f"({256 * flipped / max(total, 1):.3f} per 256)")
        check(all(s == "OK" for s in states), "every frame OK")
        check(err < 0.05, f"ATE < 0.05 m ({err:.6f})")
        check(abs(err - clean_ate) <= 0.01,
              f"within 0.01 m of the unflipped run ({err:.6f} against {clean_ate:.6f})")
    elif name == "exposure":
        check(n_ok > 0.8 * n, f"> 80 % of the frames OK ({n_ok}/{n})")
        check(err < 0.08, f"ATE < 0.08 m ({err:.6f})")
    elif name == "low_texture":
        check(all(s == "OK" for s in states[TAIL:]),
              f"OK again after the low-texture frames (frames {TAIL}..{n - 1})")
    elif name == "static":
        check(states[-1] == "OK", "OK at the end")
        check(err < 0.01, f"drift < 0.01 m ({err:.6f})")
    else:
        check(all(s == "OK" for s in states[-6:]), "the last 6 frames OK")
    check_map(slam.map)
    for k, c in launches.items():
        check(c >= n, f"{k} launched at least once per frame ({c} >= {n})")
    print(f"  phase {phase} took {time.perf_counter() - t_phase:.1f} s")
    return launches


# ------------------------------------------------- the fused step's graphs
GRAPH_BUCKETS = (128, 256, 512, 1024, 2048)
GRAPH_FRAMES = 10   # frames of each mode's recording session


def record_fused_inputs(mode: str, cfg, frames):
    """A mapping-off session of one cell over its first frames, keeping the
    arguments of its last fused dispatch.  frames: (imgs, timestamp) per
    frame.  Returns (the session's FusedStep, args, kwargs)."""
    from jetson_slam_tpu_torch.core.frame import Frame
    from jetson_slam_tpu_torch.models.slam import SlamSystem
    Frame._next_id = 0
    slam = SlamSystem(cfg, sensor=mode, enable_mapping=False)
    step = slam.tracker.fused_step
    calls = []
    orig = step.dispatch

    def dispatch(*args, **kw):
        calls.append((args, kw))
        return orig(*args, **kw)

    step.dispatch = dispatch
    track = {"stereo": slam.track_stereo, "rgbd": slam.track_rgbd,
             "mono": slam.track_monocular}[mode]
    for imgs, ts in frames:
        track(*imgs, ts)
    slam.shutdown()
    del step.dispatch
    check(len(calls) >= 1, f"{mode}: the recording session took a fused step "
          f"({len(calls)} in {len(frames)} frames)")
    return step, calls[-1][0], calls[-1][1]


def bucket_args(args, C: int):
    """The dispatch arguments with the candidates cut or padded to C."""
    cand = {}
    for k, v in args[3].items():
        v = np.asarray(v)[:C]
        pad = np.full((C - len(v),) + v.shape[1:], -1 if k == "pid" else 0, v.dtype)
        cand[k] = np.concatenate([v, pad])
    return args[:3] + (cand,) + args[4:]


def pulled_fields(res) -> dict:
    """{name: host array} of a fused_track_pull result."""
    pulled, _, fz = res
    names = ("valid", "xs", "ys", "octave", "angle", "desc", "u_right", "depth",
             "response")
    out = dict(zip(names, pulled))
    out.update({k: np.asarray(getattr(fz, k)) for k in (
        "m", "n_match", "R1", "t1", "inl1", "n_map1", "ok", "sel", "R2", "t2",
        "inl2", "n_map2")})
    return out


def compare_results(a: dict, b: dict, what: str, rel: float = 1e-6) -> float:
    """Integers and booleans equal, floats equal or within rel of the
    larger magnitude; returns the largest float difference."""
    worst = 0.0
    for k, x in a.items():
        y = b[k]
        if x.dtype.kind in "biu":
            if not np.array_equal(x, y):
                check(False, f"{what}: {k} equal")
            continue
        d = float(np.max(np.abs(x.astype(np.float64) - y))) if x.size else 0.0
        scale = float(np.max(np.abs(x))) if x.size else 0.0
        if d > rel * max(scale, 1.0):
            check(False, f"{what}: {k} within {rel} relative ({d} of {scale})")
        worst = max(worst, d)
    return worst


def phase_fused_graph(cells):
    """The fused step captured as one CUDA graph per candidate bucket,
    against the same step run eagerly: for each cell (mode, cfg, frames), a
    mapping-off session's last fused dispatch is recorded; a new FusedStep
    captures every bucket of GRAPH_BUCKETS (``prewarm_fused``), and on the
    recorded inputs cut or padded to each bucket the replay must equal the
    eager step (integers and booleans exact, floats within 1e-6 relative)
    and launch each kernel of its mode once.  Prints each bucket's capture
    ms, the growth of the step's one graph pool and host ms per frame of
    the eager step and of the replay (dispatch to pull, host clock,
    median); then replays the buckets in the reverse order, each equal to
    its eager result again (the shared pool).  The recorded bucket is
    also run on the CPU with the kernels' plain versions: keypoints,
    descriptors, angles and responses equal to the replay's."""
    import copy
    import torch
    from jetson_slam_tpu_torch.core.fused_track import (FusedStep, fused_track_pull,
                                                        prewarm_fused)
    t_phase = time.perf_counter()
    print(f"phase fused_graph: each mode's fused step captured per bucket "
          f"{list(GRAPH_BUCKETS)}, replay against eager on recorded inputs")
    for mode, cfg, frames in cells:
        step0, args, kw = record_fused_inputs(mode, cfg, frames)
        step = FusedStep(step0.fe, step0.cam, mode, step0._sf, step0._inv_s2)
        prewarm_fused(step, GRAPH_BUCKETS)
        n_cand = int(np.asarray(args[3]["alive"]).sum())
        print(f"  {mode}: {cfg.camera.width}x{cfg.camera.height}, recorded bucket "
              f"{len(args[3]['alive'])} with {n_cand} live candidates, undistort="
              f"{step._undistort}")
        wants = {}
        for C in GRAPH_BUCKETS:
            a = bucket_args(args, C)

            def eager():
                return fused_track_pull(*step.dispatch(*a, **kw, eager=True))

            def replay():
                return fused_track_pull(*step.dispatch(*a, **kw))

            want, got = pulled_fields(eager()), pulled_fields(replay())
            wants[C] = want
            worst = compare_results(want, got, f"{mode} C={C} replay against eager")
            per = step.launches_per_replay[C]
            kernels = ("fast_nms", "orb_descriptor") + (("stereo_costs",) if mode == "stereo"
                                                         else ())
            for k in kernels:
                check(per.get(k) == 1, f"{mode} C={C}: {k} launched once per replay "
                      f"({per.get(k)})")
            check(mode == "stereo" or "stereo_costs" not in per,
                  f"{mode} C={C}: no stereo_costs in the graph")
            torch.cuda.synchronize()
            e_ms = host_ms(eager, 3, warm=1)
            r_ms = host_ms(replay, 7, warm=1)
            print(f"  {mode} C={C}: capture_ms={step.capture_ms[C]:.3f} "
                  f"pool_bytes={step.pool_bytes[C]} launches_per_replay={per} "
                  f"host_ms_per_frame eager={e_ms:.3f} replay={r_ms:.3f} "
                  f"(x{e_ms / r_ms:.2f}) n_match={int(got['n_match'])} "
                  f"selected={int((got['sel'] >= 0).sum())} "
                  f"float_max_abs_diff={worst:.3g}")
        # the buckets share one pool: replayed in the reverse of their
        # capture order, each must still equal its eager result
        for C in reversed(GRAPH_BUCKETS):
            got = pulled_fields(fused_track_pull(*step.dispatch(*bucket_args(args, C), **kw)))
            compare_results(wants[C], got, f"{mode} C={C} replayed in reverse order")
        check(True, f"{mode}: every bucket equal to eager when replayed in reverse "
              f"order (one shared pool, {sum(step.pool_bytes.values())} bytes)")
        # the kernels' plain versions on the CPU, on the recorded bucket
        fe_cpu = copy.deepcopy(step0.fe).to("cpu")
        cpu = FusedStep(fe_cpu, step0.cam, mode, step0._sf.cpu(), step0._inv_s2.cpu())
        on_cpu = lambda v: v.cpu() if isinstance(v, torch.Tensor) else v  # noqa: E731
        a = (args[0], args[1], {k: on_cpu(v) for k, v in args[2].items()}) + args[3:]
        t0 = time.perf_counter()
        plain = pulled_fields(fused_track_pull(*cpu.dispatch(*a, **kw)))
        cpu_s = time.perf_counter() - t0
        card = pulled_fields(fused_track_pull(*step.dispatch(*args, **kw)))
        for k in ("valid", "octave", "response", "desc", "xs", "ys"):
            check(np.array_equal(plain[k], card[k]),
                  f"{mode}: replay's {k} equal to the plain versions' on the CPU")
        # atan2 of the host's libm and of the card round apart by an ulp
        d_ang = float(np.max(np.abs(plain["angle"] - card["angle"])))
        check(d_ang <= 1e-3, f"{mode}: replay's angles within 1e-3 degrees of the "
              f"plain versions' on the CPU ({d_ang:.3g})")
        print(f"  {mode}: the CPU step took {cpu_s:.1f} s; graphs captured "
              f"{step.graphs_captured}, replays {step.replays}")
    print(f"  phase fused_graph took {time.perf_counter() - t_phase:.1f} s")


# ----------------------------------------------------------- dataset runs
DATASET_BAND = (356, 396)   # the 40-px band of columns that mask.left blanks


class FrameProbe:
    """For a with block, wraps ``SlamSystem.track_stereo`` and
    ``track_rgbd`` to keep each returned Frame's valid raw keypoints, their
    depths and the frame's Tcw."""

    def __enter__(self):
        from jetson_slam_tpu_torch.models.slam import SlamSystem
        self.cls = SlamSystem
        self.saved = (SlamSystem.track_stereo, SlamSystem.track_rgbd)
        self.kp, self.depth, self.Tcw = [], [], []

        def wrap(fn):
            def call(slam, *args):
                state, frame = fn(slam, *args)
                self.kp.append(frame.kp_xy_raw[frame.valid])
                self.depth.append(frame.depth[frame.valid])
                self.Tcw.append(frame.Tcw.copy())
                return state, frame
            return call

        SlamSystem.track_stereo, SlamSystem.track_rgbd = (wrap(f) for f in self.saved)
        return self

    def __exit__(self, *exc):
        self.cls.track_stereo, self.cls.track_rgbd = self.saved
        return False


def centre(Tcw):
    return -Tcw[:3, :3].T @ Tcw[:3, 3]


def ms_stats(xs) -> str:
    return (f"median={statistics.median(xs):.3f} p90={float(np.percentile(xs, 90)):.3f} "
            f"(n={len(xs)})")


def trajectory_ate(path, gt_ts, gt_poses) -> float:
    """SE(3)-aligned ATE of a TUM trajectory file against the ground truth."""
    from jetson_slam_tpu_torch.io.evaluation import ate_rmse
    from jetson_slam_tpu_torch.io.trajectory import load_trajectory_tum
    ts, poses = load_trajectory_tum(path)
    return float(ate_rmse(np.asarray(ts), np.asarray(poses), np.asarray(gt_ts), gt_poses))


def euroc_dataset(cfg, seq, root):
    """The arc of ``make_config_and_sequence`` as a EuRoC tree at 752x480
    under root: each eye warped by EuRoC_stereo.yaml's lens (LEFT.D,
    RIGHT.D), a settings file with the render intrinsics as the camera and
    LEFT.*/RIGHT.* blocks K = P = the render intrinsics, those D and R = I,
    so rectification undoes the warp; and a mask.left PNG that blanks
    DATASET_BAND.  Returns (settings path, sequence dir)."""
    import copy
    from jetson_slam_tpu_torch.config import CameraConfig, save_config
    from jetson_slam_tpu_torch.io import png
    from jetson_slam_tpu_torch.io.synthetic import warp_lens, write_euroc_stereo
    d = copy.deepcopy(cfg)
    c = d.camera
    c.fx, c.fy, c.cx, c.cy, c.bf = seq.fx, seq.fy, seq.cx, seq.cy, seq.bf
    K = np.array([[seq.fx, 0, seq.cx], [0, seq.fy, seq.cy], [0, 0, 1.0]])
    eyes = []
    for attr, imgs in (("left_rect", seq.lefts), ("right_rect", seq.rights)):
        D = np.asarray(getattr(cfg, attr)["D"], np.float64).ravel()
        lens = CameraConfig(fx=seq.fx, fy=seq.fy, cx=seq.cx, cy=seq.cy, k1=D[0], k2=D[1],
                            p1=D[2], p2=D[3], k3=D[4] if len(D) > 4 else 0.0)
        setattr(d, attr, {"K": K, "D": D, "R": np.eye(3),
                          "P": np.hstack([K, np.zeros((3, 1))]), "height": H, "width": W})
        eyes.append([warp_lens(im, lens, order=1) for im in imgs])
    seq_dir = os.path.join(root, "euroc")
    write_euroc_stereo(seq_dir, eyes[0], eyes[1], seq.timestamps)
    mask = np.full((H, W), 255, np.uint8)
    mask[:, DATASET_BAND[0]:DATASET_BAND[1]] = 0
    d.orb.mask_left = os.path.join(root, "mask_left.png")
    png.write(d.orb.mask_left, mask)
    settings = os.path.join(root, "euroc.yaml")
    save_config(d, settings)
    return settings, seq_dir


def phase_dataset_euroc(cfg, seq, vocab, root):
    """The main path from files on disk: ``cli.run_slam`` stereo-euroc on
    ``euroc_dataset``'s tree with the bundled 10k vocabulary and
    ``--save-map``, the launch counters set to 0 just before and read just
    after; then a fresh session loads the saved map and relocalizes on
    frame RELOC_VIEW.  Returns the launches."""
    import torch
    from jetson_slam_tpu_torch.cli import run_slam
    from jetson_slam_tpu_torch.config import load_config
    from jetson_slam_tpu_torch.core.frame import Frame
    from jetson_slam_tpu_torch.core.tracking import TrackingState
    from jetson_slam_tpu_torch.io import datasets
    from jetson_slam_tpu_torch.io.rectify import StereoRectifier
    from jetson_slam_tpu_torch.io.synthetic import EUROC_T0_NS
    from jetson_slam_tpu_torch.models.slam import SlamSystem
    from jetson_slam_tpu_torch.ops.cuda_descriptor import orb_descriptor
    from jetson_slam_tpu_torch.ops.cuda_frontend import fast_nms
    from jetson_slam_tpu_torch.ops.cuda_stereo import stereo_costs
    t0 = time.perf_counter()
    settings, seq_dir = euroc_dataset(cfg, seq, root)
    n = len(seq.lefts)
    print(f"phase dataset_euroc: cli.run_slam stereo-euroc, {n} lens-warped PNG pairs at "
          f"{W}x{H}, LEFT/RIGHT rectification, mask.left band x={DATASET_BAND}, vocabulary "
          f"10k, --save-map (tree written in {time.perf_counter() - t0:.1f} s)")
    map_path, traj = os.path.join(root, "euroc_map.npz"), os.path.join(root, "euroc_traj.txt")
    kernels = (fast_nms, orb_descriptor, stereo_costs)
    Frame._next_id = 0
    for k in kernels:
        k.launches = 0
    with FrameProbe() as probe:
        out = run_slam.main(["stereo-euroc", settings, seq_dir, "--vocab", "10k",
                             "--save-map", map_path, "--out", traj])
    launches = {k.__name__: k.launches for k in kernels}
    slam = out["slam"]
    ok = sum(s == TrackingState.OK for s in out["states"])
    gt_ts = [(int(t * 1e9) + EUROC_T0_NS) * 1e-9 for t in seq.timestamps]
    ate = trajectory_ate(traj, gt_ts, seq.poses_twc)
    x0, x1 = DATASET_BAND
    depth_in = max(float(np.minimum(kp[:, 0] - x0, x1 - kp[:, 0]).max(initial=-1e9))
                   for kp in probe.kp)
    src_l, src_r = out["sources"]
    print(f"  frames={n} ok={ok} fused={slam.tracker.fused_frames} ate_m={ate:.6f} "
          f"(SE(3)-aligned, the written trajectory) keyframes={slam.map.n_keyframes()} "
          f"points={slam.map.n_points()} loops={slam.loop_closer.n_loops_closed}")
    print(f"  decode_ms_per_frame (host, png.read on a thread pool of 2): left "
          f"{ms_stats(src_l.decode_ms)} right {ms_stats(src_r.decode_ms)}; wait_ms left "
          f"{ms_stats(src_l.wait_ms)}")
    print(f"  rectify_ms_per_frame (host numpy remap, both eyes) {ms_stats(out['rectify_ms'])}")
    print(f"  track_ms_per_call {ms_stats(out['track_ms'][5:])} after 5 warm calls, "
          f"no device sync; window_ms_per_frame={out['window_ms_per_frame']:.3f} (first "
          f"frame to the end of shutdown, decode and rectify included)")
    print(f"  mask band: deepest valid keypoint {depth_in:.3f} px inside; launches={launches}")
    # resume: a fresh session loads the saved map and relocalizes
    free_saved = sorted(slam.map._kf_free)
    slam2 = SlamSystem(load_config(settings), sensor="stereo", vocabulary=vocab)
    t0 = time.perf_counter()
    slam2.load_map(map_path)
    load_ms = (time.perf_counter() - t0) * 1e3
    free_loaded = sorted(slam2.map._kf_free)
    state0 = slam2.get_tracking_state()
    left, right = datasets.load_euroc_stereo(seq_dir)[RELOC_VIEW][1:]
    pair = StereoRectifier(slam2.config).rectify(datasets.imread_gray(left),
                                                 datasets.imread_gray(right))
    with RelocProbe() as rp:
        for attempt in range(3):
            t0 = time.perf_counter()
            state, frame = slam2.track_stereo(*pair, 300.0 + attempt)
            torch.cuda.synchronize()
            print(f"  resume attempt {attempt}: state={state.name} "
                  f"frame_ms={(time.perf_counter() - t0) * 1e3:.3f}")
            if state == TrackingState.OK:
                break
    for line in rp.lines():
        print(line)
    gap = float(np.linalg.norm(centre(frame.Tcw) - centre(probe.Tcw[RELOC_VIEW])))
    print(f"  save_ms={out['save_ms']:.3f} load_ms={load_ms:.3f} "
          f"map_bytes={os.path.getsize(map_path)} keyframes={slam2.map.n_keyframes()} "
          f"free_rows={free_loaded} pose_gap_m={gap:.6f}")
    slam2.shutdown()
    check(ok == n, f"{n}/{n} frames OK ({ok})")
    check(ate < 0.05, f"ATE < 0.05 m on the written trajectory ({ate:.6f})")
    check(depth_in <= 2.0, f"no valid keypoint more than 2 px inside the masked band "
                           f"({depth_in:.3f})")
    w = warmups(slam)
    for k, c in launches.items():
        check(c == n + w, f"{k} launched once per frame and once per graph warm-up "
                          f"({c} == {n} + {w})")
    check(state0 == TrackingState.LOST, f"the loaded session starts LOST ({state0.name})")
    check(free_loaded == free_saved, f"the free keyframe rows restored ({free_loaded} == "
                                     f"{free_saved})")
    check(state == TrackingState.OK, f"relocalized on attempt {attempt + 1} of at most 3")
    check(gap < 0.05, f"relocalized within 0.05 m of the tracked pose ({gap:.6f})")
    return launches


def phase_dataset_tum_rgbd(cell, root):
    """``cli.run_slam`` rgbd-tum on slice_rgbd's frames (``cell``, from
    ``sensor_config_and_sequence("rgbd")``) written as a TUM tree: 8-bit
    RGB PNGs (the grey in all three channels), 16-bit depth PNGs at the
    config's DepthMapFactor and an association file; the launch counters
    set to 0 just before and read just after.  Returns the launches."""
    from jetson_slam_tpu_torch.cli import run_slam
    from jetson_slam_tpu_torch.config import save_config
    from jetson_slam_tpu_torch.core.frame import Frame
    from jetson_slam_tpu_torch.core.tracking import TrackingState
    from jetson_slam_tpu_torch.io.synthetic import write_tum_rgbd
    from jetson_slam_tpu_torch.ops.cuda_descriptor import orb_descriptor
    from jetson_slam_tpu_torch.ops.cuda_frontend import fast_nms
    from jetson_slam_tpu_torch.ops.cuda_stereo import stereo_costs
    cfg, seq, greys, depths = cell
    c = cfg.camera
    t0 = time.perf_counter()
    seq_dir = os.path.join(root, "tum")
    assoc = write_tum_rgbd(seq_dir, greys, depths, seq.timestamps, c.depth_map_factor)
    settings = os.path.join(root, "tum.yaml")
    save_config(cfg, settings)
    n = len(greys)
    print(f"phase dataset_tum_rgbd: cli.run_slam rgbd-tum, {n} RGB + 16-bit depth PNGs at "
          f"{c.width}x{c.height}, DepthMapFactor {c.depth_map_factor}, lens k1={c.k1} "
          f"(tree written in {time.perf_counter() - t0:.1f} s)")
    traj = os.path.join(root, "tum_traj.txt")
    kernels = (fast_nms, orb_descriptor, stereo_costs)
    Frame._next_id = 0
    for k in kernels:
        k.launches = 0
    with FrameProbe() as probe:
        out = run_slam.main(["rgbd-tum", settings, seq_dir, assoc, "--out", traj])
    launches = {k.__name__: k.launches for k in kernels}
    slam = out["slam"]
    ok = sum(s == TrackingState.OK for s in out["states"])
    ate = trajectory_ate(traj, seq.timestamps, seq.poses_twc)
    dep = np.concatenate(probe.depth)
    med_depth = float(np.median(dep[dep > 0]))
    src_rgb, src_d = out["sources"]
    print(f"  frames={n} ok={ok} fused={slam.tracker.fused_frames} ate_m={ate:.6f} "
          f"(SE(3)-aligned, the written trajectory) keyframes={slam.map.n_keyframes()} "
          f"points={slam.map.n_points()} median_keypoint_depth_m={med_depth:.4f}")
    print(f"  decode_ms_per_frame (host, png.read on a thread pool of 2): rgb "
          f"{ms_stats(src_rgb.decode_ms)} depth {ms_stats(src_d.decode_ms)}")
    print(f"  track_ms_per_call {ms_stats(out['track_ms'][5:])} after 5 warm calls, "
          f"no device sync; window_ms_per_frame={out['window_ms_per_frame']:.3f}")
    print(f"  launches={launches}")
    check(ok == n, f"{n}/{n} frames OK ({ok})")
    check(ate < 0.05, f"ATE < 0.05 m on the written trajectory ({ate:.6f})")
    check(med_depth > 0.5, f"median keypoint depth > 0.5 m ({med_depth:.4f})")
    w = warmups(slam)
    for k in ("fast_nms", "orb_descriptor"):
        check(launches[k] == n + w, f"{k} launched once per frame and once per graph "
                                    f"warm-up ({launches[k]} == {n} + {w})")
    check(launches["stereo_costs"] == 0,
          f"stereo_costs not launched without a right eye ({launches['stereo_costs']})")
    return launches


def check_loop(r):
    check(r["closed"] >= 1, f"a loop closed ({r['closed']})")
    check(r["all_ok"], f"all {r['n']} frames OK")
    check(r["ate"] < 0.05, f"ATE < 0.05 m ({r['ate']:.6f})")
    check_map(r["slam"].map)
    if r["async_mapping"]:
        check(r["slam"].loop_closer.gba_launched >= 1 and r["gba_solves"] >= 1,
              "the global BA ran on its own thread")
    for k, c in r["launches"].items():
        check(c >= r["n"], f"{k} launched at least once per frame ({c} >= {r['n']})")


def sync_sites(fn) -> dict:
    """Call fn with CUDA's sync debug mode on; returns the count of
    synchronising calls by the innermost line of the port that made them."""
    import collections
    import traceback
    import warnings
    import torch
    pkg = os.path.join(REPO, "jetson_slam_tpu_torch")
    sites = collections.Counter()

    def hook(message, category, filename, lineno, file=None, line=None):
        if "synchroniz" not in str(message):
            return
        stack = traceback.extract_stack()[:-1]
        own = [f for f in stack if f.filename.startswith(pkg)]
        where = (own or [f for f in stack if not f.filename.endswith("warnings.py")])[-1]
        sites[f"{os.path.relpath(where.filename, REPO)}:{where.lineno}"] += 1

    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = hook
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return dict(sites.most_common())


def phase_profile(cfg, seq, median_ms, out_path=None, n_warm=8, n_prof=4):
    """Where a steady-state frame's time goes: a fresh session tracks
    n_warm frames, then n_prof frames under torch.profiler.  Prints CUDA
    kernel launches, copies and synchronisations per frame, the device busy
    time per frame against the unprofiled median frame time (median_ms),
    the host and device time of each ``slice.*`` stage and the busiest
    operators, then where one more frame synchronises the host with the
    card; the full tables go to out_path when one is given."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from jetson_slam_tpu_torch.models.slam import SlamSystem
    print(f"phase profile: frames {n_warm}..{n_warm + n_prof - 1} of a fresh session, "
          f"its buckets captured first (Tracker.prewarm in the foreground)")
    slam = SlamSystem(cfg, sensor="stereo", enable_mapping=False)
    slam.tracker.prewarm(background=False)
    for i in range(n_warm):
        slam.track_stereo(seq.lefts[i], seq.rights[i], seq.timestamps[i])
    fused0 = slam.tracker.fused_frames
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(n_warm, n_warm + n_prof):
            slam.track_stereo(seq.lefts[i], seq.rights[i], seq.timestamps[i])
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / n_prof
    avgs = prof.key_averages()
    from torch.autograd import DeviceType
    dev_us = lambda a: getattr(a, "self_device_time_total",  # noqa: E731
                               getattr(a, "self_cuda_time_total", 0))
    tot_us = lambda a: getattr(a, "device_time_total",  # noqa: E731
                               getattr(a, "cuda_time_total", 0))
    launch = sum(a.count for a in avgs if a.key in (
        "cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel", "cuLaunchKernelEx"))
    graphs = sum(a.count for a in avgs if a.key in ("cudaGraphLaunch", "cuGraphLaunch"))
    copies = sum(a.count for a in avgs if a.key.startswith("cudaMemcpy"))
    syncs = sum(a.count for a in avgs if "Synchronize" in a.key)
    # device-side rows are kernels and copies, plus the GPU ranges of the
    # slice.* annotations, which span idle time and are left out
    busy = sum(dev_us(a) for a in avgs if a.device_type == DeviceType.CUDA
               and not a.key.startswith("slice.")) / 1e3 / n_prof
    print(f"  frames_fused={slam.tracker.fused_frames - fused0}/{n_prof} "
          f"profiled_wall_ms_per_frame={wall:.3f} device_busy_ms_per_frame={busy:.3f} "
          f"device_idle_share_vs_unprofiled_median={1 - busy / median_ms:.4f}")
    n_fused = slam.tracker.fused_frames - fused0
    print(f"  per_frame: kernel_launches={launch / n_prof:.1f} "
          f"graph_launches={graphs / n_prof:.1f} (per fused frame "
          f"{graphs / max(n_fused, 1):.1f}) "
          f"memcpy_calls={copies / n_prof:.1f} synchronize_calls={syncs / n_prof:.1f}")
    check(graphs == n_fused, f"one graph launch per fused frame ({graphs} for {n_fused})")
    stages = [a for a in avgs
              if a.key.startswith("slice.") and a.device_type == DeviceType.CPU]
    print("  stages per frame (host ms / device ms): " + "; ".join(
        f"{a.key} {a.cpu_time_total / 1e3 / n_prof:.3f} / {tot_us(a) / 1e3 / n_prof:.3f}"
        for a in sorted(stages, key=lambda a: a.key)))
    ops = [a for a in avgs if a.device_type == DeviceType.CPU and dev_us(a) > 0]
    print("  top operators by device time per frame: " + "; ".join(
        f"{a.key[:40]} {dev_us(a) / 1e3 / n_prof:.3f} ms x{a.count // n_prof}"
        for a in sorted(ops, key=dev_us, reverse=True)[:8]))
    fused1 = slam.tracker.fused_frames
    i = n_warm + n_prof
    step = slam.tracker.fused_step
    calls = []
    orig = step.dispatch

    def dispatch(*args, **kw):
        calls.append((args, kw))
        return orig(*args, **kw)

    step.dispatch = dispatch
    sites = sync_sites(lambda: slam.track_stereo(seq.lefts[i], seq.rights[i],
                                                 seq.timestamps[i]))
    del step.dispatch
    print(f"  synchronising calls in frame {n_warm + n_prof} "
          f"(fused={slam.tracker.fused_frames > fused1}): {sum(sites.values())} "
          + json.dumps(sites))
    # the replay is one range: the stages' device times come from the same
    # step run eagerly on that frame's inputs
    check(len(calls) == 1, "the frame after the profile took the fused step")
    from jetson_slam_tpu_torch.core.fused_track import fused_track_pull
    args, kw = calls[0]
    fused_track_pull(*step.dispatch(*args, **kw, eager=True))
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as eprof:
        for _ in range(n_prof):
            fused_track_pull(*step.dispatch(*args, **kw, eager=True))
        torch.cuda.synchronize()
    eavgs = eprof.key_averages()
    estages = [a for a in eavgs
               if a.key.startswith("slice.") and a.device_type == DeviceType.CPU]
    ebusy = sum(dev_us(a) for a in eavgs if a.device_type == DeviceType.CUDA
                and not a.key.startswith("slice.")) / 1e3 / n_prof
    elaunch = sum(a.count for a in eavgs if a.key in LAUNCH_CALLS) / n_prof
    print(f"  the step eagerly on frame {i}'s inputs, per call: device_busy_ms={ebusy:.3f} "
          f"kernel_launches={elaunch:.1f}; stages (host ms / device ms): " + "; ".join(
              f"{a.key} {a.cpu_time_total / 1e3 / n_prof:.3f} / "
              f"{tot_us(a) / 1e3 / n_prof:.3f}" for a in sorted(estages, key=lambda a: a.key)))
    if out_path is None:
        return
    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
    with open(out_path, "w") as f:
        f.write(f"gpu: {gpu_line()}\nframes profiled: {n_prof}\n\n")
        f.write(avgs.table(sort_by="self_cpu_time_total", row_limit=40))
        f.write("\n\n")
        dev_key = ("self_device_time_total" if hasattr(avgs[0], "self_device_time_total")
                   else "self_cuda_time_total")
        f.write(avgs.table(sort_by=dev_key, row_limit=40))


LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel", "cuLaunchKernelEx")


def phase_profile_mapping(cfg, seq, out_path=None, n_warm=6, max_prof=14):
    """Where a keyframe's mapping time goes: a fresh mapping-on session
    tracks n_warm frames, then frames under torch.profiler until two
    keyframes were mapped (at most max_prof frames).  Prints, per mapped
    keyframe, the host and device ms of each ``mapping.*`` span and the
    kernel launches, synchronising calls and copies made inside them; then
    tracks on, running the mapper apart from the tracker, to the next
    keyframe with a local BA, and counts where its mapping synchronises."""
    import collections
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from jetson_slam_tpu_torch.core.frame import Frame
    from jetson_slam_tpu_torch.models.slam import SlamSystem
    Frame._next_id = 0
    slam = SlamSystem(cfg, sensor="stereo")
    for i in range(n_warm):
        slam.track_stereo(seq.lefts[i], seq.rights[i], seq.timestamps[i])
    torch.cuda.synchronize()
    i = n_warm
    with MapperProbe() as probe, \
            profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        while probe.keyframes < 2 and i < n_warm + max_prof:
            slam.track_stereo(seq.lefts[i], seq.rights[i], seq.timestamps[i])
            i += 1
        torch.cuda.synchronize()
    n_kf = probe.keyframes
    print(f"phase profile_mapping: frames {n_warm}..{i - 1} of a fresh mapping-on "
          f"session, {n_kf} keyframes mapped, local BAs {len(probe.free_cams)}")
    check(n_kf >= 1, "the profiled window mapped a keyframe")
    avgs = prof.key_averages()
    tot_us = lambda a: getattr(a, "device_time_total",  # noqa: E731
                               getattr(a, "cuda_time_total", 0))
    spans = {a.key: a for a in avgs
             if a.key.startswith("mapping.") and a.device_type == DeviceType.CPU}
    print("  mapping spans per keyframe (host ms / device ms): " + "; ".join(
        f"{k} {spans[k].cpu_time_total / 1e3 / n_kf:.3f} / {tot_us(spans[k]) / 1e3 / n_kf:.3f}"
        for k in MAPPING_STAGES.values() if k in spans))

    def in_mapping(e):
        p = e.cpu_parent
        while p is not None:
            if p.name.startswith("mapping."):
                return True
            p = p.cpu_parent
        return False

    calls = collections.Counter()
    for e in prof.events():
        kind = ("launches" if e.name in LAUNCH_CALLS else
                "synchronize_calls" if "Synchronize" in e.name else
                "memcpy_calls" if e.name.startswith("cudaMemcpy") else None)
        if kind and in_mapping(e):
            calls[kind] += 1
    print("  inside mapping.* spans, per keyframe: " + " ".join(
        f"{k}={calls[k] / n_kf:.1f}" for k in ("launches", "synchronize_calls",
                                                "memcpy_calls")))
    mapper = slam.local_mapper
    mapper.process_pending()
    while i < len(seq.lefts):
        slam.tracker.track_stereo(seq.lefts[i], seq.rights[i], seq.timestamps[i])
        i += 1
        if mapper.queue and slam.map.n_keyframes() > 2:
            kid = mapper.queue[0]
            with MapperProbe() as one:
                sites = sync_sites(mapper.process_pending)
            print(f"  synchronising calls in the mapping of keyframe {kid} (frame {i - 1}, "
                  f"local BAs {len(one.free_cams)}): {sum(sites.values())} "
                  + json.dumps(sites))
            break
        mapper.process_pending()
    if out_path is not None:
        with open(out_path, "a") as f:
            f.write(f"\n\nmapping-on session, frames {n_warm}..{i - 1}, {n_kf} keyframes "
                    f"mapped\n\n")
            f.write(avgs.table(sort_by="self_cpu_time_total", row_limit=40))


# ------------------------------------------- batched front end, distribution
BATCH = 4
DIST_FRAMES = 20


def phase_frontend_batch(fe, cfg, seq, dev="cuda"):
    """``OrbFrontend.frame_step_batch`` on frames 0..BATCH-1 of the arc:
    equal to BATCH ``frame_step`` calls (integers and floats exact), one
    launch of each kernel per batch, and each kernel equal to its plain
    version at the batch shapes (2 BATCH x L canvases, 2 BATCH descriptor
    images, BATCH stereo frames).  Prints the ms per batch and per frame
    against BATCH single calls (host clock around a device sync, median of
    20).  Returns (the max abs difference of each kernel, the batch inputs
    for ``phase_frontend_batch_kernels``)."""
    import torch
    from jetson_slam_tpu_torch.ops.cuda_descriptor import orb_descriptor
    from jetson_slam_tpu_torch.ops.cuda_frontend import fast_nms
    from jetson_slam_tpu_torch.ops.cuda_stereo import stereo_costs
    from jetson_slam_tpu_torch.ops.frontend import FrontendResult
    cam = cfg.camera
    lefts = torch.as_tensor(np.stack(seq.lefts[:BATCH]), device=dev)
    rights = torch.as_tensor(np.stack(seq.rights[:BATCH]), device=dev)
    L = fe.geom.n_levels
    print(f"phase frontend_batch: frame_step_batch of frames 0..{BATCH - 1} at {W}x{H}, "
          f"{L} levels, tile {cfg.orb.tile_h}")
    kernels = (fast_nms, orb_descriptor, stereo_costs)
    for k in kernels:
        k.launches = 0
    out = fe.frame_step_batch(lefts, rights, cam.bf, cam.bf / cam.fx)
    launches = {k.__name__: k.launches for k in kernels}
    fields = [f.name for f in dataclasses.fields(FrontendResult)]
    for i in range(BATCH):
        one = fe.frame_step(lefts[i], rights[i], cam.bf, cam.bf / cam.fx)
        same = all(torch.equal(getattr(out[e], f)[i], getattr(one[e], f))
                   for e in (0, 1) for f in fields)
        same &= all(torch.equal(out[e][i], one[e]) for e in (2, 3, 4))
        check(same, f"frame {i}: the batch equals frame_step on every field, u_right, "
                    f"depth and best_dist ({int((one[3] > 0).sum())} stereo depths)")
    print(f"  launches in one batch: {launches}")
    for k, c in launches.items():
        check(c == 1, f"{k} launched once per batch ({c})")

    def batch():
        fe.frame_step_batch(lefts, rights, cam.bf, cam.bf / cam.fx)
        sync(dev)

    def singles():
        for i in range(BATCH):
            fe.frame_step(lefts[i], rights[i], cam.bf, cam.bf / cam.fx)
        sync(dev)

    ms_batch, ms_single = host_ms(batch, 20), host_ms(singles, 20)
    print(f"  ms per batch of {BATCH}: {ms_batch:.3f} ({ms_batch / BATCH:.3f} per frame); "
          f"{BATCH} frame_step calls {ms_single:.3f} ({ms_single / BATCH:.3f} per frame); "
          f"host clock around a device sync, median of 20")
    # the kernels at the batch shapes, against their plain versions
    res, pyr = fe.extract_batch(torch.cat([lefts, rights]))
    B2, _, H0, W0 = pyr.shape
    s_args = stereo_args(fe, cfg, res, pyr, BATCH)
    err = {"fast_nms": fast_equal(fe, pyr.reshape(B2 * L, H0, W0), fe.lut, None,
                                  f"batch, {B2 * L} canvases"),
           "orb_descriptor": desc_equal(fe, pyr, res.lx, res.ly, res.response,
                                        f"batch, B = {B2}"),
           "stereo_costs": costs_equal(s_args, f"batch, B = {BATCH}")}
    return err, (pyr, res, s_args)


def phase_frontend_batch_kernels(fe, inputs, floor):
    """Each kernel's device time at the batch shapes of phase_frontend_batch
    (``kernel_ms``, so after the slices: it runs torch.profiler)."""
    from jetson_slam_tpu_torch.ops.cuda_descriptor import orb_descriptor
    from jetson_slam_tpu_torch.ops.cuda_frontend import fast_nms
    from jetson_slam_tpu_torch.ops.cuda_stereo import stereo_costs
    pyr, res, s_args = inputs
    B2, L, H0, W0 = pyr.shape
    canv = pyr.reshape(B2 * L, H0, W0)
    kx, ky, ks = res.lx.contiguous(), res.ly.contiguous(), res.response.contiguous()
    tabs = (fe.slot_level, fe.level_hw, fe.pattern, fe.gauss, fe.ic_masks)
    print("phase frontend_batch_kernels: device time at the batch shapes")
    for name, fn, what in (
            ("fast_nms", lambda: fast_nms(canv, fe.roi, fe.lut, fe.threshold),
             f"{B2 * L} canvases"),
            ("orb_descriptor", lambda: orb_descriptor(pyr, kx, ky, ks, *tabs),
             f"B = {B2}, {int((ks > 0).sum())} valid slots"),
            ("stereo_costs", lambda: stereo_costs(*s_args),
             f"B = {s_args[0].shape[0]}, {int(s_args[-1].sum())} matched slots")):
        t = kernel_ms(fn, f"{name}_kernel")
        print(f"  {name} ms={t['ms']:.5f} (profiler median of {t['n_prof']}) "
              f"mean_ms={t['mean_ms']:.5f} b2b_ms={t['b2b_ms']:.5f} floor_ms={floor['ms']:.5f} "
              f"({what})")


def sync(dev):
    import torch
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize()


def host_ms(fn, n: int, warm: int = 2) -> float:
    """Median host ms of fn over n calls (fn ends in a device sync)."""
    for _ in range(warm):
        fn()
    ts = []
    for _ in range(n):
        t0 = time.perf_counter()
        fn()
        ts.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(ts)


# ---- ranks in child processes: ``python3 chip_smoke.py --child NAME ...``
def start_procs(tag: str, cmds, root: str) -> list:
    """Start every command at once from the repository's root, each writing
    its output to a log under root (a file, so no pipe can fill and stall
    a rank).  Returns [(Popen, log path)]."""
    procs = []
    for i, cmd in enumerate(cmds):
        log = os.path.join(root, f"{tag}_{i}.log")
        with open(log, "w") as f:
            procs.append((subprocess.Popen(cmd, cwd=REPO, stdout=f, stderr=subprocess.STDOUT),
                          log))
    return procs


def wait_procs(procs, timeout=600) -> list:
    """Wait for every process, killing any still running at the timeout;
    a non-zero exit fails the phase.  Returns each one's output."""
    deadline = time.monotonic() + timeout
    try:
        for p, _ in procs:
            p.wait(timeout=max(1.0, deadline - time.monotonic()))
    finally:
        stop_procs(procs)
    outs = []
    for i, (p, log) in enumerate(procs):
        with open(log) as f:
            outs.append(f.read())
        if p.returncode != 0:
            print(outs[-1][-6000:])
            raise AssertionError(f"{log} exited {p.returncode}")
    return outs


def stop_procs(procs):
    for p, _ in procs:
        if p.poll() is None:
            p.kill()
            p.wait()


def start_children(name: str, world: int, root: str, backend: str, after: str, *args):
    """Start ``world`` ranks of child NAME (this script with ``--child``) on
    a FileStore under root.  A rank waits for the file ``after`` (unless it
    is "-") before its work, so it can start while another phase runs."""
    store = os.path.join(root, f"store_{name}_{backend}_{world}")
    cmd = [sys.executable, os.path.abspath(__file__), "--child", name, str(world), store,
           backend, after]
    return start_procs(f"{name}_{backend}_{world}",
                       [cmd + [str(r)] + [str(a) for a in args] for r in range(world)], root)


def child_results(procs, timeout=600) -> list:
    """Wait for a child phase's ranks; returns each rank's result (the JSON
    of its ``CHILD_RESULT`` line)."""
    return [json.loads([s for s in out.splitlines() if s.startswith("CHILD_RESULT ")][-1]
                       .split(" ", 1)[1]) for out in wait_procs(procs, timeout)]


def child_main(argv) -> int:
    """One rank of a child phase: NAME WORLD STORE BACKEND AFTER RANK
    [ARGS...].  Exits if the parent goes away while it waits for AFTER."""
    import torch
    import torch.distributed as dist
    from jetson_slam_tpu_torch.parallel import multihost as mh
    name, world, store, backend, after = argv[0], int(argv[1]), argv[2], argv[3], argv[4]
    rank = int(argv[5])
    parent = os.getppid()
    torch.backends.cuda.matmul.allow_tf32 = False
    mh.initialize("file://" + store, world, rank, backend=backend)
    try:
        while after != "-" and not os.path.exists(after):
            if os.getppid() != parent:
                return 1
            time.sleep(0.05)
        out = CHILDREN[name](rank, *argv[6:])
    finally:
        dist.destroy_process_group()
    print("CHILD_RESULT " + json.dumps(out), flush=True)
    return 0


GBA_KEYS = ("Rs", "ts", "fixed", "pt_pos", "e_cam", "e_pt", "obs_arr", "is_stereo",
            "inv_s2", "e_valid")


def child_dist_ba(rank, problem, out_path, dev="cuda"):
    """DistBA over the default group on the saved GBA problem: a first
    solve, then a timed one (host clock around a device sync); rank 0
    saves the solution."""
    import torch
    from jetson_slam_tpu_torch.parallel import multihost as mh
    from jetson_slam_tpu_torch.parallel.dist_ba import DistBA
    with np.load(problem) as d:
        prep = {k: d[k] for k in d.files}
    solver = DistBA(mh.global_group(), device=dev)
    cam = [float(x) for x in prep["cam"]]
    ms = []
    for _ in range(2):
        sync(dev)
        t0 = time.perf_counter()
        sol = solver.solve(*(prep[k] for k in GBA_KEYS), *cam, its1=5, its2=int(prep["its"]))
        sync(dev)
        ms.append((time.perf_counter() - t0) * 1e3)
    if rank == 0:
        np.savez(out_path, R=sol[0], t=sol[1], p=sol[2], outlier=sol[3])
    return dict(ms=ms, device=str(torch.device(dev)), **solver.stats)


def child_dist_mapper(rank, frames, out_path, dev="cuda"):
    """SlamSystem(mesh=the default group) on the frames saved in FRAMES (the
    first DIST_FRAMES of the arc), mapping on, sync; counts the local BAs
    and the DistBA solves, and saves the trajectory to
    OUT_PATH_rankR.npz."""
    from jetson_slam_tpu_torch.config import load_config
    from jetson_slam_tpu_torch.core.frame import Frame
    from jetson_slam_tpu_torch.core.tracking import TrackingState
    from jetson_slam_tpu_torch.io.evaluation import ate_rmse
    from jetson_slam_tpu_torch.models.slam import SlamSystem
    from jetson_slam_tpu_torch.parallel import multihost as mh
    cfg = load_config(os.path.join(REPO, "examples", "configs", "EuRoC_stereo.yaml"))
    with np.load(frames) as d:
        seq = {k: d[k] for k in d.files}
    cfg.camera.cx, cfg.camera.cy = float(seq["cx"]), float(seq["cy"])
    Frame._next_id = 0
    slam = SlamSystem(cfg, sensor="stereo", mesh=mh.global_group(), device=dev)
    mapper = slam.local_mapper
    counts = {"lba": 0, "dist": 0}
    lba_solve, dist_solve = mapper._lba_solve, mapper._dist_ba.solve

    def counted_lba(prep):
        counts["lba"] += 1
        return lba_solve(prep)

    def counted_dist(*a, **kw):
        counts["dist"] += 1
        return dist_solve(*a, **kw)

    mapper._lba_solve, mapper._dist_ba.solve = counted_lba, counted_dist
    t0 = time.perf_counter()
    states = [slam.track_stereo(seq["lefts"][i], seq["rights"][i], seq["timestamps"][i])[0]
              for i in range(DIST_FRAMES)]
    slam.shutdown()
    sync(dev)
    window = (time.perf_counter() - t0) * 1e3 / DIST_FRAMES
    ts, poses = slam.camera_trajectory()
    ate = ate_rmse(np.asarray(ts), np.asarray(poses), seq["timestamps"], seq["poses_twc"])
    np.savez(f"{out_path}_rank{rank}.npz", poses=np.asarray(poses), kf_pose=slam.map.kf_pose)
    return dict(ok=sum(s == TrackingState.OK for s in states), ate=float(ate),
                window_ms_per_frame=window, keyframes=int(slam.map.n_keyframes()),
                **counts)


CHILDREN = {"dist_ba": child_dist_ba, "dist_mapper": child_dist_mapper}


def camera_centres(R, t):
    return -np.einsum("cji,cj->ci", R, t)


def median_chi2(prep, R, t, p) -> float:
    """Median squared reprojection error of the problem's valid edges."""
    v = prep["e_valid"]
    e_cam, e_pt = prep["e_cam"][v], prep["e_pt"][v]
    obs, stereo = prep["obs_arr"][v], prep["is_stereo"][v]
    fx, fy, cx, cy, bf = prep["cam"]
    pc = np.einsum("eij,ej->ei", R[e_cam], p[e_pt]) + t[e_cam]
    z = np.maximum(pc[:, 2], 1e-6)
    u = fx * pc[:, 0] / z + cx
    r = np.stack([obs[:, 0] - u, obs[:, 1] - (fy * pc[:, 1] / z + cy),
                  np.where(stereo, obs[:, 2] - (u - bf / z), 0.0)], 1)
    return float(np.median((r ** 2).sum(1)))


def phase_dist_ba(loop_slam, root, dev="cuda"):
    """The global BA problem of the slice_loop session's final map, saved
    under root, solved three ways: in process by ``local_ba``, by DistBA
    on 2 gloo ranks sharing the card (CUDA tensors), and by DistBA on NCCL
    at world size 1.  Each DistBA against the in-process solve: camera
    centres within 5e-3 m, >= 98 % of the edges classified alike, the
    gauge camera unmoved, the median reprojection chi2 no more than 0.1 %
    above the in-process solve's.  Prints the ms per solve (host clock
    around a device sync) and the collectives per LM iteration."""
    import torch
    from jetson_slam_tpu_torch.core.local_ba import local_ba
    lc = loop_slam.loop_closer
    prep = lc._gba_prepare()
    check(prep is not None, "the slice_loop map gives a global BA problem")
    cam = lc.cam
    prep["cam"] = np.array([cam.fx, cam.fy, cam.cx, cam.cy, cam.bf], np.float64)
    C = len(prep["kids"])
    E = int(prep["e_valid"].sum())
    problem = os.path.join(root, "gba_problem.npz")
    np.savez(problem, **{k: prep[k] for k in GBA_KEYS + ("pt_edges", "cam", "its")})
    print(f"phase dist_ba: the slice_loop map's global BA, {C} keyframes, {prep['P']} points, "
          f"{E} edges (padded C {prep['Rs'].shape[0]}, P {prep['pt_pos'].shape[0]}, "
          f"E {len(prep['e_valid'])})")

    def local():
        out = local_ba(*(torch.as_tensor(np.ascontiguousarray(prep[k]), device=dev)
                         for k in GBA_KEYS + ("pt_edges",)),
                       *prep["cam"].tolist(), its1=5, its2=int(prep["its"]))
        return [o.cpu().numpy() for o in out]

    ms_local = []
    for _ in range(3):
        sync(dev)
        t0 = time.perf_counter()
        ref = local()
        ms_local.append((time.perf_counter() - t0) * 1e3)
    chi0 = median_chi2(prep, prep["Rs"], prep["ts"], prep["pt_pos"])
    chi_ref = median_chi2(prep, *ref[:3])
    print(f"  in process: local_ba ms={[round(x, 3) for x in ms_local]} median chi2 "
          f"{chi0:.5f} -> {chi_ref:.5f}")
    c_ref = camera_centres(ref[0][:C], ref[1][:C])
    v = prep["e_valid"]
    # the NCCL rank starts beside the gloo pair and solves after it, so the
    # solves never share the card
    gloo_done = os.path.join(root, "gloo_done")
    started = {label: start_children("dist_ba", world, root, backend, after, problem,
                                     os.path.join(root, f"gba_{label}.npz"), dev)
               for label, world, backend, after in (("gloo_2_ranks", 2, "gloo", "-"),
                                                    ("nccl_1_rank", 1, "nccl", gloo_done))}
    try:
        results = {"gloo_2_ranks": child_results(started["gloo_2_ranks"])}
        open(gloo_done, "w").close()
        results["nccl_1_rank"] = child_results(started["nccl_1_rank"])
    finally:
        for procs in started.values():
            stop_procs(procs)
    for label, res in results.items():
        with np.load(os.path.join(root, f"gba_{label}.npz")) as d:
            R, t, p, outlier = d["R"], d["t"], d["p"], d["outlier"]
        gap = float(np.linalg.norm(camera_centres(R[:C], t[:C]) - c_ref, axis=1).max())
        agree = float((outlier[v] == ref[3][v]).mean())
        chi = median_chi2(prep, R, t, p)
        r0 = res[0]
        print(f"  DistBA {label}: ms per solve {[round(x, 3) for x in r0['ms']]} (first, "
              f"second; every rank {[round(r['ms'][1], 3) for r in res]}) on {r0['device']}; "
              f"LM iterations {r0['lm_iterations']}, collectives {r0['lm_collectives']} "
              f"({r0['lm_collectives'] / max(r0['lm_iterations'], 1):.1f} per LM iteration) "
              f"+ {r0['other_collectives']} (header check, depth flag, gather); centre gap {gap:.3g} m, "
              f"outliers agree {agree:.5f}, median chi2 {chi:.5f}")
        check(gap < 5e-3, f"{label}: camera centres within 5e-3 m of the in-process solve")
        check(agree >= 0.98, f"{label}: >= 98 % of the edges classified alike ({agree:.5f})")
        check(np.array_equal(R[0], prep["Rs"][0]) and np.array_equal(t[0], prep["ts"][0]),
              f"{label}: the gauge camera unmoved")
        check(chi <= chi_ref * 1.001, f"{label}: median chi2 {chi:.5f} not above the "
                                      f"in-process {chi_ref:.5f} by more than 0.1 %")
    noisy_ba(dev)


NOISY_BA = os.path.join(REPO, "tests", "data", "noisy_ba_problem.npz")


def noisy_ba(dev="cuda"):
    """tests/test_dist_ba.py's noisy problem (5 cameras, 64 points, 10 %
    outliers; tests/data/noisy_ba_problem.npz, written with the JAX
    package's solutions by tests/jax_ba_reference.py), where an unguarded
    float32 landmark inverse meets a determinant that cancels to 0: solved
    by ``local_ba`` on the card in float32 and float64; requires the
    float32 camera translations within 1e-4 m of the float64 ones and of
    JAX's float64 ones, and the outlier flags equal to JAX's."""
    import torch
    from jetson_slam_tpu_torch.core.local_ba import local_ba
    with np.load(NOISY_BA) as d:
        prob = {k: d[k] for k in d.files}
    keys = ("Rs", "ts", "fixed", "pts", "e_cam", "e_pt", "obs", "stereo", "inv_sigma2",
            "e_valid", "pt_edges")
    sols = {}
    for dtype in (np.float32, np.float64):
        args = [prob[k].astype(dtype) if prob[k].dtype == np.float32 else prob[k]
                for k in keys]
        out = local_ba(*(torch.as_tensor(a, device=dev) for a in args),
                       *prob["cam"].tolist())
        sols[dtype] = [o.cpu().numpy() for o in out]
    t32, out32 = sols[np.float32][1], sols[np.float32][3]
    gap64 = float(np.abs(t32 - sols[np.float64][1]).max())
    gap_jax = float(np.abs(t32 - prob["t64"]).max())
    diff = int((out32 != prob["out32"]).sum())
    print(f"  noisy problem ({len(prob['e_cam'])} edges) on {dev}: float32 t within "
          f"{gap64:.3g} m of float64, {gap_jax:.3g} m of JAX's float64; outlier flags "
          f"differing from JAX's float32 {diff}, from JAX's float64 "
          f"{int((out32 != prob['out64']).sum())}; {int(out32.sum())} outliers")
    check(gap64 < 1e-4 and gap_jax < 1e-4, "float32 within 1e-4 m of float64")
    check(diff == 0 and np.array_equal(out32, prob["out64"]), "JAX's outlier classes")


def phase_cross_host(root, dev="cuda"):
    """``cli/cross_host_worker.py`` as 2 gloo ranks on the card at EuRoC
    geometry (16 frames, local BA off on the tracker): both print
    CROSS_HOST_OK, the problem digests agree, and on rank 1 the applied
    map's observation index agrees with kf_obs for every live point.
    Prints the delta's bytes and the ms to serialize, send, receive and
    apply it."""
    store = os.path.join(root, "store_cross_host")
    settings = os.path.join(REPO, "examples", "configs", "EuRoC_stereo.yaml")
    print(f"phase cross_host: cli.cross_host_worker, 2 gloo ranks on {dev}, EuRoC_stereo.yaml")
    cmd = [sys.executable, "-m", "jetson_slam_tpu_torch.cli.cross_host_worker",
           f"file://{store}", "2"]
    outs = wait_procs(start_procs("cross_host", [
        cmd + [str(r), "--device", dev, "--backend", "gloo", "--settings", settings,
               "--frames", "16"] for r in range(2)], root))
    stats = []
    for r, out in enumerate(outs):
        check(f"CROSS_HOST_OK {r}" in out, f"rank {r} printed CROSS_HOST_OK and exited 0")
        stats.append(json.loads([s for s in out.splitlines()
                                 if s.startswith("CROSS_HOST_STATS ")][-1].split(" ", 1)[1]))
    s0, s1 = stats
    print(f"  delta_bytes={s0['delta_bytes']} serialize_ms={s0['serialize_ms']:.3f} "
          f"put_ms={s0['put_ms']:.3f} get_ms={s1['get_ms']:.3f} (rank 1's wait, tracking "
          f"included) apply_ms={s1['apply_ms']:.3f}; solve_ms {s0['solve_ms']:.3f} / "
          f"{s1['solve_ms']:.3f}, LM collectives {s0['lm_collectives']} over "
          f"{s0['lm_iterations']} iterations; median chi2 {s0['chi2_before']:.5f} -> "
          f"{s0['chi2_after']:.5f}")
    check(s0["digest"] == s1["digest"], f"the problem digests agree ({s0['digest']})")
    check(s1["obs_index_ok"] is True,
          "rank 1: the applied map's observation index agrees with kf_obs")


def phase_mapping_device(cfg, seq, dev="cuda", mapping_device="cpu"):
    """The slice_mapping session on the first DIST_FRAMES frames, tracker
    on the card, ``mapping_device="cpu"`` (the only second device of a
    one-card machine), sync: every frame OK, ATE < 0.05 m, every local BA
    solved on the CPU (a probe records the device of each solve's
    tensors), and one launch of each kernel per frame and per graph
    warm-up.  Prints the mapping
    ms per keyframe."""
    import torch
    from jetson_slam_tpu_torch.core import local_mapping
    from jetson_slam_tpu_torch.core.frame import Frame
    from jetson_slam_tpu_torch.core.tracking import TrackingState
    from jetson_slam_tpu_torch.io.evaluation import ate_rmse
    from jetson_slam_tpu_torch.models.slam import SlamSystem
    from jetson_slam_tpu_torch.ops.cuda_descriptor import orb_descriptor
    from jetson_slam_tpu_torch.ops.cuda_frontend import fast_nms
    from jetson_slam_tpu_torch.ops.cuda_stereo import stereo_costs
    print(f"phase mapping_device: SlamSystem(EuRoC_stereo.yaml, stereo, mapping on, "
          f"device={dev!r}, mapping_device={mapping_device!r}), frames 0..{DIST_FRAMES - 1}")
    Frame._next_id = 0
    slam = SlamSystem(cfg, sensor="stereo", device=dev, mapping_device=mapping_device)
    solve_devices = []
    lba = local_mapping.local_ba

    def probe(*args, **kw):
        solve_devices.append(str(args[0].device))
        return lba(*args, **kw)

    kernels = (fast_nms, orb_descriptor, stereo_costs)
    local_mapping.local_ba = probe
    try:
        with MapperProbe() as mp:
            for k in kernels:
                k.launches = 0
            t0 = time.perf_counter()
            states = [slam.track_stereo(seq.lefts[i], seq.rights[i], seq.timestamps[i])[0]
                      for i in range(DIST_FRAMES)]
            slam.shutdown()
            sync(dev)
            window = (time.perf_counter() - t0) * 1e3 / DIST_FRAMES
            launches = {k.__name__: k.launches for k in kernels}
    finally:
        local_mapping.local_ba = lba
    ts, poses = slam.camera_trajectory()
    ate = ate_rmse(np.asarray(ts), np.asarray(poses), seq.timestamps, seq.poses_twc)
    n_ok = sum(s == TrackingState.OK for s in states)
    kf_ms = sum(mp.ms.values()) / max(mp.keyframes, 1)
    print(f"  frames={DIST_FRAMES} ok={n_ok} ate_m={ate:.6f} keyframes_mapped={mp.keyframes} "
          f"local_bas={len(solve_devices)} on {sorted(set(solve_devices))} "
          f"mapper device {slam.local_mapper.device}, tracker {slam.frontend.device}")
    print(f"  window_ms_per_frame={window:.3f} mapping_ms_per_keyframe={kf_ms:.3f} by stage: "
          + "; ".join(f"{st} {mp.ms[st] / max(mp.keyframes, 1):.3f}"
                      for st in MAPPING_STAGES.values()) + f"; launches={launches}")
    check(n_ok == DIST_FRAMES, f"every frame OK ({n_ok})")
    check(ate < 0.05, f"ATE < 0.05 m ({ate:.6f})")
    check(len(solve_devices) >= 1 and set(solve_devices) == {str(torch.device(mapping_device))},
          f"every local BA solved on {mapping_device} ({len(solve_devices)})")
    w = warmups(slam)
    for k, c in launches.items():
        check(c == DIST_FRAMES + w, f"{k} launched once per frame and once per graph warm-up "
                                    f"on {dev} ({c} == {DIST_FRAMES} + {w})")


def start_dist_mapper(seq, root, dev="cuda"):
    """Start phase_dist_mapper's 2 gloo ranks on the first DIST_FRAMES
    frames of the arc (saved under root), waiting for the file
    ``root/dist_mapper_go``, so their start overlaps the phases before."""
    n = DIST_FRAMES
    frames = os.path.join(root, "dist_mapper_frames.npz")
    np.savez(frames, lefts=np.stack(seq.lefts[:n]), rights=np.stack(seq.rights[:n]),
             timestamps=seq.timestamps[:n], poses_twc=seq.poses_twc[:n], cx=seq.cx, cy=seq.cy)
    return start_children("dist_mapper", 2, root, "gloo",
                          os.path.join(root, "dist_mapper_go"), frames,
                          os.path.join(root, "dist_mapper"), dev)


def phase_dist_mapper(procs, root, dev="cuda"):
    """2 gloo ranks on the card (``start_dist_mapper``), each a
    ``SlamSystem(mesh=group)`` on the first DIST_FRAMES frames, mapping on,
    sync: every local BA through DistBA, both ranks' trajectories equal,
    every frame OK, ATE < 0.05 m.  Every rank must solve the same problem:
    the maps stay identical only while each rank's tracking and mapping
    are deterministic, and DistBA's header check raises on the first
    difference."""
    print(f"phase dist_mapper: 2 gloo ranks on {dev}, SlamSystem(EuRoC_stereo.yaml, "
          f"mesh=group), frames 0..{DIST_FRAMES - 1}, mapping on, sync")
    open(os.path.join(root, "dist_mapper_go"), "w").close()
    res = child_results(procs)
    runs = []
    for r in range(2):
        with np.load(os.path.join(root, f"dist_mapper_rank{r}.npz")) as d:
            runs.append((d["poses"], d["kf_pose"]))
    gap = float(np.abs(runs[0][0] - runs[1][0]).max())
    for r, x in enumerate(res):
        print(f"  rank {r}: ok={x['ok']} ate_m={x['ate']:.6f} keyframes={x['keyframes']} "
              f"local_bas={x['lba']} through DistBA={x['dist']} "
              f"window_ms_per_frame={x['window_ms_per_frame']:.3f}")
    print(f"  the ranks' camera poses differ by at most {gap:.3g}")
    for r, x in enumerate(res):
        check(x["ok"] == DIST_FRAMES, f"rank {r}: every frame OK ({x['ok']})")
        check(x["ate"] < 0.05, f"rank {r}: ATE < 0.05 m ({x['ate']:.6f})")
        check(x["lba"] >= 1 and x["dist"] == x["lba"],
              f"rank {r}: every local BA through DistBA ({x['dist']} of {x['lba']})")
    check(np.array_equal(runs[0][0], runs[1][0]) and np.array_equal(runs[0][1], runs[1][1]),
          "both ranks' trajectories and keyframe poses are equal")


def build_host_sources():
    """Build the PNG unfilter and the native prefetch loader from their
    sources in the checkout, and hold the native FAST LUT against the
    package's."""
    from jetson_slam_tpu_torch.io import native_loader, png
    from jetson_slam_tpu_torch.ops.tables import fast_lut
    t0 = time.perf_counter()
    png._unfilter()
    native_loader.load_lib()
    print(f"build: png_unfilter.c and native/loader.cpp in {time.perf_counter() - t0:.1f} s")
    for n_min, n_max in ((9, 16), (9, 14)):
        check(np.array_equal(native_loader.fast_lut_native(n_min, n_max), fast_lut(n_min, n_max)),
              f"native FAST LUT {n_min}..{n_max} equals ops.tables.fast_lut")


def main(argv) -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    from jetson_slam_tpu_torch.ops import cuda_build
    t_main = time.perf_counter()

    def mark(done: str):
        print(f"elapsed: {time.perf_counter() - t_main:.1f} s after {done}", flush=True)

    print(f"gpu: {gpu_line()}")
    print(f"torch: {torch.__version__} cuda: {torch.version.cuda}")
    t0 = time.perf_counter()
    for name in cuda_build.SOURCES:
        cuda_build.load(name)
    print(f"build: {len(cuda_build.SOURCES)} kernels in {time.perf_counter() - t0:.1f} s")
    for name in cuda_build.SOURCES:
        for line in cuda_build.LOGS.get(name, "").splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                print(f"  {name}: {line.strip()}")
    build_host_sources()
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(0)
    cfg, seq = make_config_and_sequence()
    fe = frontend_of(cfg)
    pyr_np = phase_pyramid(fe, seq)
    # the slice runs before any torch.profiler session: once the profiler
    # has run in a process, every later launch costs the host more
    _, median_ms = phase_slice(cfg, seq)
    _, classic_ms = phase_slice(cfg, seq, fused=False)
    mark("slice, slice_classic")
    launches, mapping = phase_mapping(cfg, seq, "slice_mapping")
    _, classic_mapping = phase_mapping(cfg, seq, "slice_classic_mapping", fused=False)
    print(f"slice_classic against slice: mapping off {classic_ms:.3f} against "
          f"{median_ms:.3f} ms per frame (median, synchronised); mapping on window "
          f"{classic_mapping['window']:.3f} against {mapping['window']:.3f} ms per frame, "
          f"ms per call {classic_mapping['median']:.3f} against {mapping['median']:.3f}")
    mark("slice_mapping, slice_classic_mapping")
    # the production shape, prewarmed as cli.run_slam does for --pipeline > 0
    phase_mapping(cfg, first_frames(seq, ASYNC_FRAMES), "slice_async", async_mapping=True,
                  pipeline_depth=2, prewarm=True)
    mark("slice_async")
    if "--mapping-modes" in argv:
        phase_mapping(cfg, seq, "mode_async_depth0", async_mapping=True)
        phase_mapping(cfg, seq, "mode_sync_depth2", pipeline_depth=2)
        phase_mapping(cfg, seq, "mode_sync_again")
    from jetson_slam_tpu_torch.bow.vocabulary import bundled_vocabulary
    voc10k = bundled_vocabulary("10k")
    reloc = [phase_reloc(cfg, seq, "slice_reloc", None),
             phase_reloc(cfg, seq, "slice_reloc_vocab10k", voc10k)]
    mark("slice_reloc, slice_reloc_vocab10k")
    cfg_loop, seq_loop = loop_sequence()
    loop = phase_loop(cfg_loop, seq_loop, "slice_loop", voc10k)
    check_loop(loop)
    check_loop(phase_loop(cfg_loop, seq_loop, "slice_loop_async", voc10k,
                          async_mapping=True, pipeline_depth=2))
    mark("slice_loop, slice_loop_async")
    rgbd_cell = sensor_config_and_sequence("rgbd")
    mono_cell = sensor_config_and_sequence("mono")
    phase_sensor("rgbd", rgbd_cell)
    phase_sensor("mono", mono_cell)
    mark("slice_rgbd, slice_mono")
    n = GRAPH_FRAMES
    phase_fused_graph([
        ("stereo", cfg, [((seq.lefts[i], seq.rights[i]), seq.timestamps[i]) for i in range(n)]),
        ("rgbd", rgbd_cell[0], [((rgbd_cell[2][i], rgbd_cell[3][i]), rgbd_cell[1].timestamps[i])
                                for i in range(n)]),
        ("mono", mono_cell[0], [((mono_cell[2][i],), mono_cell[1].timestamps[i])
                                for i in range(n)])])
    mark("fused_graph")
    for name in ADVERSARIAL:
        phase_adversarial(cfg, seq, name, voc10k if name == "low_texture" else None)
    phase_adversarial(cfg, seq, "descriptor_fuzz", clean_ate=mapping["ate"])
    mark("adversarial_*, descriptor_fuzz")
    os.makedirs(os.path.join(REPO, "build"), exist_ok=True)
    with tempfile.TemporaryDirectory(dir=os.path.join(REPO, "build")) as root:
        phase_dataset_euroc(cfg, first_frames(seq, DATASET_FRAMES), voc10k, root)
        c_cfg, c_seq, c_greys, c_depths = rgbd_cell
        n = DATASET_FRAMES
        phase_dataset_tum_rgbd((c_cfg, first_frames(c_seq, n), c_greys[:n], c_depths[:n]),
                               root)
    mark("dataset_euroc, dataset_tum_rgbd")
    # the batched front end and distribution, before any torch.profiler session
    with tempfile.TemporaryDirectory(dir=os.path.join(REPO, "build")) as root:
        t0 = time.perf_counter()
        batch_err, batch_inputs = phase_frontend_batch(fe, cfg, seq)
        print(f"  phase frontend_batch took {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        phase_dist_ba(loop["slam"], root)
        print(f"  phase dist_ba took {time.perf_counter() - t0:.1f} s")
        # dist_mapper's ranks start now and wait until mapping_device is done
        mapper_ranks = start_dist_mapper(seq, root)
        try:
            for name, run in (("cross_host", lambda: phase_cross_host(root)),
                              ("mapping_device", lambda: phase_mapping_device(cfg, seq)),
                              ("dist_mapper", lambda: phase_dist_mapper(mapper_ranks, root))):
                t0 = time.perf_counter()
                run()
                print(f"  phase {name} took {time.perf_counter() - t0:.1f} s")
        finally:
            stop_procs(mapper_ranks)
    mark("frontend_batch to dist_mapper")
    floor = launch_floor()
    print(f"launch floor: ms={floor['ms']:.5f} (profiler median of {floor['n_prof']}) "
          f"b2b_ms={floor['b2b_ms']:.5f} (a one-element fill kernel)")
    rows = [phase_fast(fe, pyr_np, rng, floor)]
    row, res, pyr = phase_descriptor(fe, seq, rng, floor)
    rows.append(row)
    rows.append(phase_stereo(fe, cfg, res, pyr, rng, floor))
    phase_frontend_batch_kernels(fe, batch_inputs, floor)
    geometry_err = [phase_geometry(name, rng) for name in GEOMETRIES] + [batch_err]
    mark("kernels against their plain versions, geometries")
    out = argv[argv.index("--profile-out") + 1] if "--profile-out" in argv else None
    phase_profile(cfg, seq, median_ms, out)
    phase_profile_mapping(cfg, seq, out)
    phase_reloc_counts(reloc[0][0], seq, "slice_reloc")
    phase_reloc_counts(reloc[1][0], seq, "slice_reloc_vocab10k")
    mark("profiles and counts")
    for r in rows:
        r["launches"] = launches[r["name"]]
        r["max_abs_err"] = max([r["max_abs_err"]] + [float(e[r["name"]])
                                                     for e in geometry_err if r["name"] in e])
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [{k: r[k] for k in keys} for r in rows]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--child"]:
        sys.exit(child_main(sys.argv[2:]))
    sys.exit(main(sys.argv[1:]))
