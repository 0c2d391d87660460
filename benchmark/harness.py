"""One run of one cell: set-up, the measured window, the output check and
the result line.

Everything that belongs to one configuration, traffic mix, metric or
kernel sits in a file of its own, found by the name in ``BENCHMARK.json``:
``configs/<config>.json``, ``traffic/<traffic>.json``,
``metrics/<metric>.py`` (``read(run)`` returns the number, or None where
the run has nothing to read), ``roofline/<kernel>.py`` (the work a
kernel's stage needs at the run's shapes) and ``limits/<cell>.json`` (the
limit of each number the output check compares).

A traffic mix is data: the parameters that the one generator
(``generator.py``) and the one feeding loop (``drive``) read, so a cell
added with data files alone can carry a claim.

The window is a closed loop, as the reference's dataset mains run when
tracking is slower than the camera: each frame is fed when the facade call
before it returns, and nothing sleeps to the timestamps.  ``feed`` picks
the facade call by the configuration's ``sensor``.

A mono session's frames fed before its two-view initializer succeeds get
no pose: ORB-SLAM2 records none, and the tracker appends none to its
trajectory while the frame's pose is unset.  They count in ``attempted``
and in ``failed`` and add nothing to ``pose_ms_p95``.  Every seed feeds the
same lap, so the parent and a change meet the same frames there.
"""
from __future__ import annotations

import gc
import importlib.util
import json
import os
import subprocess
import sys
import threading
import time
from collections import defaultdict
from pathlib import Path

import numpy as np

BENCH = Path(__file__).resolve().parent
REPO = BENCH.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "jetson_slam_tpu")
ANNOTATIONS = ("slice.", "mapping.", "bench.")   # the program's and the benchmark's ranges
LAST_RUN = None     # the Run behind the last result (the tests and the control read it)


def load_json(path: Path):
    with open(path) as f:
        return json.load(f)


def load_module(kind: str, name: str):
    """benchmark/<kind>/<name>.py as a module (names may hold dots)."""
    path = BENCH / kind / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"benchmark_{kind}_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def forbidden_modules() -> list:
    """Loaded modules whose top-level name (before the first dot) is one
    of FORBIDDEN, compared whole."""
    return sorted(m for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN)


def process_age_s() -> float:
    """Seconds since this process started (the kernel's start time)."""
    with open("/proc/self/stat") as f:
        start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
    with open("/proc/uptime") as f:
        up = float(f.read().split()[0])
    return up - start_ticks / os.sysconf("SC_CLK_TCK")


def cell_of(workload: str, bench: dict | None = None):
    bench = bench or load_json(REPO / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}; known: {sorted(cells)}")
    cell = cells[workload]
    config = load_json(BENCH / "configs" / f"{cell['config']}.json")
    traffic = load_json(BENCH / "traffic" / f"{cell['traffic']}.json")
    metrics = {"end_to_end": [m for m in bench["end_to_end"]
                              if workload in m.get("workloads", [workload])],
               "per_layer": [m for m in bench["per_layer"]
                             if workload in m.get("workloads", [workload])]}
    return cell, config, traffic, metrics


def card_line() -> str:
    """The card's name and power limit as nvidia-smi reports them."""
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "nvidia-smi not available"


class Run:
    """What one run measured: the frames fed and when their poses came
    back, host spans and counters of the layers, the traced sub-window and
    the records the output check reads."""

    def __init__(self, cell, config, traffic, seed, seconds, trace):
        self.cell, self.config, self.traffic = cell, config, traffic
        self.seed, self.trace = seed, trace
        self.fed = []           # one dict per frame fed in the window
        self.by_ts = {}
        self.spans = defaultdict(float)   # summed host ms per layer
        self.counts = defaultdict(int)
        self.sessions = []      # (ts, est Twc, truth Twc) of the first ate_frames
        self.traced = []        # frames fed after the window under the profiler
        self.after = []         # frames fed after it until ate_frames are back
        self.recs = {}          # fused frames kept for the output check, by slot
        self.n_fused = 0        # fused frames dispatched (the sample's stream)
        self.keep_rng = np.random.default_rng([seed % (2 ** 63), 1])
        self.kfs = []           # keyframes' new points kept for it
        self.inits = []         # mono: the initializer's accepted calls kept for it
        self.device_trace = None
        self.frames = None
        self.window_s = float(seconds)
        self.replays0 = 0
        self.gc_ms = []         # the window's garbage collections, ms each
        self.clock_setup = None     # seconds of set-up, read as the window opens

    def reserve(self):
        """The slot of the output check's sample that the next fused frame
        takes, or None: a uniform sample of ``check.frames`` fused frames
        drawn from the seed as they come (reservoir sampling)."""
        n, k = self.n_fused, self.traffic["check"]["frames"]
        self.n_fused += 1
        if n < k:
            return n
        j = int(self.keep_rng.integers(0, n + 1))
        return j if j < k else None

    # ---------------------------------------------------- end-to-end views
    def back_in_window(self):
        return [r for r in self.fed if r.get("t_back") is not None
                and r["t_back"] <= self.t_end]

    def latencies_ms(self):
        return [(r["t_back"] - r["t_fed"]) * 1e3 for r in self.fed
                if r.get("t_back") is not None]


# ------------------------------------------------------------- the probes
class Probes:
    """Class-level wrappers installed from the benchmark for the length of
    the window: the output check's records always, the host clocks of the
    layers with ``--trace 1``.  They change nothing the program computes."""

    def __init__(self, run: Run, timing: bool):
        self.run, self.timing = run, timing
        self.saved = []

    def wrap(self, cls, name, make):
        fn = getattr(cls, name)
        self.saved.append((cls, name, fn))
        setattr(cls, name, make(fn))

    def timed(self, key):
        run = self.run

        def make(fn):
            def call(*a, **kw):
                t0 = time.perf_counter()
                try:
                    return fn(*a, **kw)
                finally:
                    run.spans[key] += (time.perf_counter() - t0) * 1e3
                    run.counts[key] += 1
            return call
        return make

    def __enter__(self):
        from jetson_slam_tpu_torch.core.fused_track import FusedStep
        from jetson_slam_tpu_torch.core.local_mapping import LocalMapper
        from jetson_slam_tpu_torch.core.loop_closing import LoopCloser
        from jetson_slam_tpu_torch.core.tracking import Tracker
        run = self.run

        def begin(fn):
            def call(tracker, imgs, timestamp):
                step = tracker.fused_step
                step._bench = None
                pending = fn(tracker, imgs, timestamp)
                if pending is not None and step._bench is not None:
                    pending["bench"] = step._bench
                return pending
            return call

        def dispatch(fn):
            def call(step, imgs, pred, last_state, cand, th_mm, th_lm, cam_params,
                     forward, backward, **kw):
                slot = run.reserve()
                if slot is not None:
                    rec = {f"last_{k}": _snap(v) for k, v in last_state.items()}
                    rec.update({f"cand_{k}": _snap(v) for k, v in cand.items()})
                    rec.update(pred=np.array(pred, np.float64), th_mm=float(th_mm),
                               th_lm=float(th_lm), log_scale=float(cam_params[10]),
                               lims=tuple(float(v) for v in cam_params[6:10]),
                               forward=bool(forward), backward=bool(backward))
                    step._bench = (slot, rec)
                return fn(step, imgs, pred, last_state, cand, th_mm, th_lm, cam_params,
                          forward, backward, **kw)
            return call

        def finish(fn):
            def call(tracker, pending):
                frame, fz = fn(tracker, pending)
                bench = pending.get("bench")
                img = run.by_ts.get(round(frame.timestamp, 6), {}).get("img")
                if bench is not None and img is not None:
                    slot, rec = bench
                    rec.update(
                        _frontend_record(frame, img), m=fz.m.copy(), sel=fz.sel.copy(),
                        R1=fz.R1.copy(), t1=fz.t1.copy(), R2=fz.R2.copy(), t2=fz.t2.copy())
                    run.recs[slot] = rec
                return frame, fz
            return call

        def triangulate(fn):
            def call(mapper, kid):
                m = mapper.map
                before = m.kf_obs[kid].copy()
                poses = m.kf_pose.copy()
                out = fn(mapper, kid)
                new = np.flatnonzero((before < 0) & (m.kf_obs[kid] >= 0))
                by_kf = defaultdict(lambda: ([], [], []))
                for sl1 in new:
                    pid = int(m.kf_obs[kid, sl1])
                    if m.pt_first_kf[pid] != kid:
                        continue
                    for kid2, sl2 in m._pt_obs.get(pid, {}).items():
                        if kid2 != kid:
                            e = by_kf[int(kid2)]
                            e[0].append(int(sl1))
                            e[1].append(int(sl2))
                            e[2].append(m.pt_pos[pid].astype(np.float64).copy())
                ts1 = run.by_ts.get(round(float(m.kf_timestamp[kid]), 6), {}).get("img")
                for kid2, (s1, s2, pts) in by_kf.items():
                    ts2 = run.by_ts.get(round(float(m.kf_timestamp[kid2]), 6), {}).get("img")
                    if ts1 is not None and ts2 is not None:
                        run.kfs.append(dict(kid=kid, img1=ts1, img2=ts2, s1=s1, s2=s2,
                                            points=pts, pose1=poses[kid].astype(np.float64),
                                            pose2=poses[kid2].astype(np.float64)))
                return out
            return call

        self.wrap(Tracker, "_begin_fused", begin)
        self.wrap(FusedStep, "dispatch", dispatch)
        self.wrap(Tracker, "_finish_fused", finish)
        self.wrap(LocalMapper, "create_new_map_points", triangulate)
        if run.config["sensor"] == "mono":
            self.initializer()
        if self.timing:
            for name in ("track_stereo", "track_rgbd", "track_monocular"):
                self.wrap(Tracker, name, self.timed("tracker"))
            self.wrap(FusedStep, "dispatch", self.timed("fused.dispatch"))
            self.wrap(Tracker, "_finish_fused", self.timed("fused.finish"))
            self.wrap(LocalMapper, "process_keyframe", self.timed("mapping"))
            self.wrap(LoopCloser, "process_keyframe", self.timed("loop_closing"))
        return self

    def initializer(self):
        """Mono: keep the initializer's accepted call for the output check.
        Each attempt of ``Tracker._monocular_initialization`` gathers, on
        its own thread, the brute-force matches to the reference frame, the
        minimal samples drawn, every score and inlier mask of the two
        models, and the result; where the attempt builds the first map, the
        record adds both frames' slots, the second keyframe's pose and the
        first points as the tracker put them into the map (scaled to a unit
        median depth)."""
        from jetson_slam_tpu_torch.core import initializer, matcher
        from jetson_slam_tpu_torch.core.initializer import MonoInitializer
        from jetson_slam_tpu_torch.core.tracking import Tracker
        run = self.run
        attempt = {}

        def keep(fn, store):
            def call(*a, **kw):
                out = fn(*a, **kw)
                if attempt.get("thread") == threading.get_ident():
                    store(a, out)
                return out
            return call

        def copies(values):
            return tuple(None if v is None else np.array(v, copy=True) for v in values)

        def attempt_init(fn):
            def call(tracker, frame):
                ref = tracker._mono_init_ref
                attempt.clear()
                attempt["thread"] = threading.get_ident()
                try:
                    return fn(tracker, frame)
                finally:
                    got = dict(attempt)
                    attempt.clear()
                    rec = (_init_record(run, tracker, ref, frame, got)
                           if got.get("out", (False,))[0] and frame.pose_set else None)
                    if rec is not None:
                        run.inits.append(rec)
            return call

        self.wrap(Tracker, "_monocular_initialization", attempt_init)
        self.wrap(MonoInitializer, "initialize", lambda fn: keep(fn, lambda a, out: attempt.update(
            args=copies(a[1:4]), out=copies(out))))
        self.wrap(MonoInitializer, "_sample", lambda fn: keep(fn, lambda a, out: attempt.update(
            sample=_snap(out))))
        self.wrap(matcher, "match_brute_force", lambda fn: keep(fn, lambda a, out: attempt.update(
            match=_snap(out[0]))))
        for kind in ("h", "f"):
            self.wrap(initializer, f"_score_{kind}", lambda fn, kind=kind: keep(
                fn, lambda a, out: attempt.setdefault("scores", []).append(
                    (kind, _snap(out[0]), _snap(out[1])))))

    def __exit__(self, *exc):
        for cls, name, fn in reversed(self.saved):
            setattr(cls, name, fn)
        return False


# ------------------------------------------------------------- the window
def _snap(x):
    """A copy of one input of the fused step, taken as it is dispatched: a
    tensor stays on its device (no wait), an array is copied."""
    import torch
    if isinstance(x, torch.Tensor):
        return x.detach().clone()
    return np.array(x, copy=True)


def _frontend_record(frame, img: int) -> dict:
    """A frame's slots as the output check reads them."""
    return dict(img=img, valid=frame.valid.copy(), xs=frame.kp_xy_raw[:, 0].copy(),
                ys=frame.kp_xy_raw[:, 1].copy(), octave=frame.octave.copy(),
                desc=frame.desc.copy(), depth=np.asarray(frame.depth).copy())


def _init_record(run, tracker, ref, frame, got: dict):
    """The initializer's accepted call (``got``) with the map it built, read
    under the tracker's map lock before the mapper moves anything: the
    reference frame's and the current frame's slots, the second keyframe's
    pose, and the current frame's slots that hold a map point with the
    point."""
    img1 = run.by_ts.get(round(ref.timestamp, 6), {}).get("img")
    img2 = run.by_ts.get(round(frame.timestamp, 6), {}).get("img")
    if img1 is None or img2 is None:
        return None
    m = tracker.map
    pids = frame.map_points
    pt_slots = np.flatnonzero(pids >= 0)
    return dict(got, fe1=_frontend_record(ref, img1), fe2=_frontend_record(frame, img2),
                pose2=np.asarray(m.kf_pose[tracker.ref_kf], np.float64).copy(),
                pt_slots=pt_slots, pt_pos=np.asarray(m.pt_pos[pids[pt_slots]], np.float64))


def _collect(run, slam, seen, t_now):
    """Mark the frames whose pose the tracker handed back since ``seen``."""
    traj = slam.tracker.trajectory
    for entry in traj[seen:]:
        r = run.by_ts.get(round(entry[0], 6))
        if r is not None and r.get("t_back") is None:
            r["t_back"] = t_now
            r["lost"] = bool(entry[3])
    return len(traj)


def _trajectory_head(slam, n: int):
    """The first ``n`` poses the tracker handed back, as
    ``SlamSystem.camera_trajectory`` rebuilds them (Tcr x Trw with the
    reference keyframe's current pose), read without finishing the frames
    in flight: (timestamps, Twc) of the frames not lost."""
    m = slam.map
    ts_out, poses = [], []
    for ts, Tcw, ref_kf, lost, rel, ref_gen in slam.tracker.trajectory[:n]:
        if lost:
            continue
        T = np.asarray(Tcw, np.float64)
        if rel is not None and ref_kf is not None and ref_kf >= 0 and \
                m.kf_alive[ref_kf] and int(m.kf_gen[ref_kf]) == ref_gen:
            T = np.asarray(rel, np.float64) @ np.asarray(m.kf_pose[ref_kf], np.float64)
        ts_out.append(round(ts, 6))
        poses.append(np.linalg.inv(T))
    return ts_out, poses


def feed(slam, sensor: str, frames, i: int, ts: float):
    """Frame ``i`` of the lap at time ``ts`` through the facade call of
    the configuration's sensor."""
    if sensor == "stereo":
        slam.track_stereo(frames.lefts[i], frames.rights[i], ts)
    elif sensor == "rgbd":
        slam.track_rgbd(frames.lefts[i], frames.depths[i], ts)
    elif sensor == "mono":
        slam.track_monocular(frames.lefts[i], ts)
    else:
        raise ValueError(f"unknown sensor {sensor!r}")


def drive(run: Run, slam, frames, traffic: dict, seconds: float, dtrace=None):
    """Feed the lap's frames back to back, cycling with rising timestamps,
    for ``seconds``; returns the window's end.  The trajectory that
    ``ate_m`` reads is taken once the first ``ate_frames`` poses are back,
    so it is the same work in every run however far the window gets (the
    frames after the close are fed until then).  With ``dtrace`` the traced
    frames follow the window's close, in the same traffic, so the
    profiler's cost stays out of the window."""
    from torch.profiler import record_function
    n, ate_n = traffic["frames"], traffic["ate_frames"]
    sensor = run.config["sensor"]
    truth_of = {}
    st = {"seen": 0, "feed": 0}

    def feed_one(into):
        i = st["feed"] % n
        ts = round(st["feed"] * frames.period, 6)
        truth_of[ts] = frames.poses_twc[i]
        rec = {"img": i, "ts": ts, "t_fed": time.perf_counter()}
        into.append(rec)
        run.by_ts[ts] = rec
        with record_function("bench.track"):
            feed(slam, sensor, frames, i, ts)
        st["seen"] = _collect(run, slam, st["seen"], time.perf_counter())
        st["feed"] += 1
        if not run.sessions and st["seen"] >= ate_n:
            ts_h, est = _trajectory_head(slam, ate_n)
            run.sessions.append((np.asarray(ts_h), np.asarray(est),
                                 np.asarray([truth_of[t] for t in ts_h])))

    started = [0.0]

    def gc_clock(phase, info):
        if phase == "start":
            started[0] = time.perf_counter()
        else:
            run.gc_ms.append((time.perf_counter() - started[0]) * 1e3)

    if run.clock_setup is not None:
        run.setup_s = run.clock_setup()
    gc.callbacks.append(gc_clock)
    t0 = time.perf_counter()
    deadline = t0 + seconds
    run.t0, run.t_end = t0, deadline
    try:
        while time.perf_counter() < deadline:
            feed_one(run.fed)
    finally:
        gc.callbacks.remove(gc_clock)
    # the window's spans and counters end here; the traced frames and the
    # flush of the frames in flight count apart
    run.window_spans, run.window_counts = run.spans, run.counts
    run.spans, run.counts = defaultdict(float), defaultdict(int)
    run.window_counts["replays"] = slam.tracker.fused_step.replays - run.replays0
    run.window_keyframes = int(slam.map.n_keyframes())
    if dtrace is not None:
        dtrace.start()
        for _ in range(dtrace.n_frames):
            feed_one(run.traced)
        dtrace.stop()
    while not run.sessions:
        feed_one(run.after)
    slam.tracker.flush_pipeline()
    st["seen"] = _collect(run, slam, st["seen"], time.perf_counter())
    return deadline


# --------------------------------------------------------------- tracing
class DeviceTrace:
    """torch.profiler over ``n_frames`` frames fed right after the window:
    the device's busy time, the device operations that took most time, the
    longest idle gaps by what the host was doing, and each kernel's
    launches."""

    def __init__(self, n_frames: int):
        self.n_frames = n_frames
        self.prof = None

    def start(self):
        from torch.profiler import ProfilerActivity, profile
        self.prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        self.prof.__enter__()
        self.t0 = time.perf_counter()

    def stop(self):
        import torch
        torch.cuda.synchronize()
        self.t1 = time.perf_counter()
        self.prof.__exit__(None, None, None)

    def summarise(self) -> dict | None:
        if self.prof is None:
            return None
        from torch.autograd import DeviceType
        dev, cpu = [], []
        for e in self.prof.profiler.kineto_results.events():
            iv = (e.start_ns(), e.start_ns() + e.duration_ns(), e.name())
            if e.device_type() == DeviceType.CUDA:
                if not e.is_user_annotation() and not iv[2].startswith(ANNOTATIONS):
                    dev.append(iv)     # kernels, copies and sets; not the ranges
            elif e.device_type() == DeviceType.CPU:
                cpu.append(iv)
        window_s = self.t1 - self.t0
        dev.sort()
        busy, gaps = 0, []
        cur_s = cur_e = None
        for s, e, _ in dev:
            if cur_e is None or s > cur_e:
                if cur_e is not None:
                    busy += cur_e - cur_s
                    gaps.append((s - cur_e, cur_e))
                cur_s, cur_e = s, e
            else:
                cur_e = max(cur_e, e)
        if cur_e is not None:
            busy += cur_e - cur_s
        by_name = defaultdict(int)
        kernels = defaultdict(list)
        for s, e, name in dev:
            by_name[name] += e - s
            kernels[name].append((e - s) * 1e-9)
        gaps.sort(reverse=True)

        def host_at(t):
            best = None
            for s, e, name in cpu:
                if s <= t <= e and (best is None or e - s < best[1] - best[0]):
                    if name.startswith(ANNOTATIONS):
                        best = (s, e, name)
            return best[2] if best else "host"

        result = {
            "busy_s": busy * 1e-9, "window_s": window_s, "frames": self.n_frames,
            "device_ops": [[n, t * 1e-9] for n, t in
                           sorted(by_name.items(), key=lambda kv: -kv[1])[:10]],
            "idle_gaps": [[host_at(t), g * 1e-9] for g, t in gaps[:10]],
            "kernels": dict(kernels),
        }
        self.prof = None
        return result


# ------------------------------------------------------------------ a run
def _setup_line(name, t0, extra=""):
    """Print one step of the set-up; returns the clock for the next."""
    print(f"setup {name}: {time.perf_counter() - t0:.3f} s{extra}", flush=True)
    return time.perf_counter()


def build_system(config: dict, traffic: dict, device: str, vocabulary):
    from jetson_slam_tpu_torch.config import config_from_dict
    from jetson_slam_tpu_torch.models.slam import SlamSystem
    cfg = config_from_dict(config["settings"])
    cfg.max_map_points = config["max_map_points"]
    cfg.max_keyframes = config["max_keyframes"]
    sysd = traffic["system"]
    return SlamSystem(cfg, sensor=config["sensor"], vocabulary=vocabulary,
                      async_mapping=sysd["async_mapping"],
                      pipeline_depth=sysd["pipeline_depth"], device=device)


def run_cell(workload: str, seed: int, seconds: float, trace: bool,
             device: str = "cuda", overrides: dict | None = None,
             render_workers: int | None = None, control: bool = False) -> dict:
    """One run; returns the result dict (the last line's object).
    ``overrides``: {"config": {...}, "traffic": {...}} merged over the
    files (the tests' small sizes)."""
    t_start = time.perf_counter()
    cell, config, traffic, metrics = cell_of(workload)
    for key, part in (overrides or {}).items():
        target = config if key == "config" else traffic
        for k, v in part.items():
            if isinstance(v, dict) and isinstance(target.get(k), dict):
                target[k] = {**target[k], **v}
            else:
                target[k] = v
    run = Run(cell, config, traffic, seed, seconds, trace)
    from . import generator
    # the lap renders in a pool of processes beside the steps below, which
    # wait mostly on the card and CUDA; the warm session needs it
    rendered = {}

    def render():
        try:
            rendered["frames"] = generator.make_frames(config, traffic, render_workers)
        except BaseException as exc:    # raised again where the frames are needed
            rendered["error"] = exc
        rendered["s"] = time.perf_counter() - t_render
    t_render = t = time.perf_counter()
    renderer = threading.Thread(target=render, daemon=True)
    renderer.start()
    import torch
    torch.set_num_threads(4)
    if device == "cuda":
        torch.cuda.init()
        torch.zeros(1, device="cuda")
    t = _setup_line("import_and_cuda", t)
    if device == "cuda":
        from jetson_slam_tpu_torch.ops import cuda_build
        for name in cuda_build.SOURCES:
            cuda_build.load(name)
        built = sorted(cuda_build.LOGS)
        t = _setup_line("nvcc", t, f" (built {built or 'none: cached'})")
    vocab = None
    if traffic["system"].get("vocabulary"):
        from jetson_slam_tpu_torch.bow.vocabulary import bundled_vocabulary
        vocab = bundled_vocabulary(config["vocabulary"])
        t = _setup_line("vocabulary", t)
    from jetson_slam_tpu_torch.core.frame import Frame
    Frame._next_id = 0
    slam = build_system(config, traffic, device, vocab)
    t = _setup_line("system", t)
    slam.tracker.prewarm(background=False, caps=tuple(traffic["buckets"]))
    step = slam.tracker.fused_step
    caps = {c: round(ms, 3) for c, ms in step.capture_ms.items()}
    t = _setup_line("prewarm", t, f" (buckets {caps} ms)")
    renderer.join()
    if "error" in rendered:
        raise rendered["error"]
    frames = run.frames = rendered["frames"]
    t = _setup_line("render_wait", t, f" (the lap's {traffic['frames']} frames rendered in "
                    f"{rendered['s']:.3f} s beside the steps above)")
    # the warm session: the traffic's first frames until the mapper has
    # mapped a keyframe, then reset (the captured graphs are kept)
    warm = traffic["warm_frames"]
    for i in range(warm):
        feed(slam, config["sensor"], frames, i, -1000.0 + i * frames.period)
    slam.tracker.flush_pipeline()
    if slam.pipeline is not None:
        slam.pipeline.drain()
    n_kf_warm = int(slam.map.n_keyframes())
    slam.reset()
    if device == "cuda":
        torch.cuda.synchronize()
    t = _setup_line("warm_session", t, f" ({warm} frames, {n_kf_warm} keyframes)")
    captured0 = step.graphs_captured
    if device == "cuda":
        torch.cuda.reset_peak_memory_stats()
    run.clock_setup = (process_age_s if device == "cuda"
                       else lambda: time.perf_counter() - t_start)

    dtrace = None
    if trace and device == "cuda":
        dtrace = DeviceTrace(traffic["trace"]["frames"])
    run.replays0 = step.replays
    # what set-up left is not the window's to collect
    gc.collect()
    gc.freeze()
    with Probes(run, timing=trace):
        drive(run, slam, frames, traffic, seconds, dtrace)
        if slam.pipeline is not None:
            slam.shutdown()
    gc.unfreeze()
    print(f"setup total: {run.setup_s:.3f} s (process start to the window)", flush=True)
    back = len(run.back_in_window())
    print(f"window: {len(run.fed)} frames fed ({len(run.fed) / traffic['frames']:.2f} laps), "
          f"{back} back inside it, {run.window_keyframes} keyframes in the map at the "
          f"close, {len(run.gc_ms)} garbage collections {sum(run.gc_ms):.3f} ms "
          f"(longest {max(run.gc_ms, default=0.0):.3f} ms)", flush=True)
    run.window_counts["captured_in_window"] = step.graphs_captured - captured0
    run.memory_peak = int(torch.cuda.max_memory_allocated()) if device == "cuda" else 0
    if run.window_counts["captured_in_window"]:
        print(f"warning: {run.window_counts['captured_in_window']} buckets captured in "
              f"the window (first use)", file=sys.stderr, flush=True)
    if dtrace is not None:
        run.device_trace = dtrace.summarise()
        run.device_trace_feeds = [r["img"] for r in run.traced]
    del slam, step
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
    return finish(run, metrics, device, control)


def _sample(run, items, n, salt):
    if len(items) <= n:
        return list(items)
    rng = np.random.default_rng([run.seed % (2 ** 63), salt])
    return [items[i] for i in sorted(rng.choice(len(items), size=n, replace=False))]


def _host(rec: dict) -> dict:
    """A kept record with its tensors as numpy arrays."""
    return {k: (v.cpu().numpy() if hasattr(v, "cpu") else v) for k, v in rec.items()}


def _host_init(rec: dict) -> dict:
    """A kept initializer call with its tensors as numpy arrays."""
    out = _host(rec)
    out["scores"] = [(kind, s.cpu().numpy(), ok.cpu().numpy()) for kind, s, ok in rec["scores"]]
    return out


def within(numbers: dict, limits: dict, sensor: str) -> bool:
    """Every number within its limit, and something of each kind checked."""
    from .check import numbers_of
    names, counts = numbers_of(sensor)
    return (all(numbers[k] <= limits[k] for k in names)
            and all(numbers[k] > 0 for k in counts))


def finish(run: Run, metrics: dict, device: str, control: bool) -> dict:
    from .check import Judge, numbers_of
    sensor = run.config["sensor"]
    chk = run.traffic["check"]
    recs = [_host(run.recs[k]) for k in sorted(run.recs)]
    kfs = _sample(run, run.kfs, chk["keyframes"], 2)
    inits = [_host_init(r) for r in run.inits]
    t = time.perf_counter()
    judge = Judge(run.config, device)
    numbers = judge.judge(run.frames, recs, kfs, inits)
    run.judge, run.numbers = judge, numbers
    extra = f"{numbers['inits_checked']} initializer calls, " if sensor == "mono" else ""
    print(f"check: {len(recs)} of {run.n_fused} fused frames, {len(kfs)} of "
          f"{len(run.kfs)} keyframe pairs, {numbers['matches_checked']} associations, "
          f"{numbers['stages_checked']} pose stages, {numbers['points_checked']} points, "
          f"{extra}{time.perf_counter() - t:.3f} s", flush=True)
    limits = load_json(BENCH / "limits" / f"{run.cell['name']}.json")
    checked = {k: {"value": numbers[k], "limit": limits[k]} for k in numbers_of(sensor)[0]}
    correct = within(numbers, limits, sensor)
    if control:
        run.control = judge.judge(run.frames, recs, kfs, inits, control=True)
        run.control_correct = within(run.control, limits, sensor)
    import torch
    run.device_kind = torch.cuda.get_device_name(0) if device == "cuda" else "cpu"
    kind = "per_layer" if run.trace else "end_to_end"
    out_metrics = {}
    for m in metrics[kind]:
        value = load_module("metrics", m["name"]).read(run)
        if value is not None:
            out_metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    attempted = len(run.fed)
    failed = sum(1 for r in run.fed if r.get("t_back") is None or r.get("lost"))
    dev = {"platform": "gpu" if device == "cuda" else "cpu", "kind": run.device_kind,
           "count": 1, "memory_peak_bytes": run.memory_peak}
    result = {"correct": bool(correct), "attempted": attempted, "failed": failed,
              "metrics": out_metrics, "device": dev}
    if run.trace and run.device_trace is not None:
        dev["busy_s"] = run.device_trace["busy_s"]
        dev["window_s"] = run.device_trace["window_s"]
        result["breakdown"] = {"device_ops": run.device_trace["device_ops"],
                               "idle_gaps": run.device_trace["idle_gaps"]}
    result["checked"] = checked
    run.result = result
    global LAST_RUN
    LAST_RUN = run
    return result


def main(argv) -> int:
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = ap.parse_args(argv)
    cell, config, traffic, _ = cell_of(a.workload)
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"error: {a.workload} needs {cell['chips']} CUDA device(s); "
              f"available: {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    print(f"card: {card_line()}", flush=True)
    result = run_cell(a.workload, a.seed, a.seconds, bool(a.trace))
    bad = forbidden_modules()
    if bad:
        print(f"error: modules of JAX or the JAX package loaded: {bad}", file=sys.stderr)
        return 3
    print(f"memory peak: {result['device']['memory_peak_bytes']} bytes", flush=True)
    for k, v in result["checked"].items():
        print(f"checked {k}: {v['value']!r} limit {v['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
