"""Small sizes for the benchmark's CPU tests: every cell at 320x240, four
levels, a 64-frame lap, with the port's plain kernel versions.  A lap is
rendered once per process and shared by the tests."""
import json
import re
import shutil

import torch

from benchmark import generator, harness

SETTINGS = {"Camera.width": 320, "Camera.height": 240, "Camera.fx": 300.0,
            "Camera.fy": 300.0, "Camera.cx": 160.0, "Camera.cy": 120.0,
            "ORBextractor.nLevels": 4, "ORBextractor.tile_h": 16,
            "ORBextractor.tile_w": 16}
_LAPS = {}
_make_frames = generator.make_frames


def _lap(config, traffic, workers=None):
    key = json.dumps([config, traffic], sort_keys=True)
    if key not in _LAPS:
        _LAPS[key] = _make_frames(config, traffic, workers)
    return _LAPS[key]


def small(workload: str) -> dict:
    cell, config, _, _ = harness.cell_of(workload)
    settings = dict(SETTINGS)
    if config["sensor"] == "stereo":
        settings["Camera.bf"] = 120.0
    else:   # a milder lens at this size, the same model
        settings.update({"Camera.k1": 0.05, "Camera.k2": -0.02, "Camera.k3": 0.0,
                         "Camera.p1": 0.0, "Camera.p2": 0.0})
    return {"config": {"settings": settings},
            "traffic": {"frames": 64, "scene_points": 700, "ate_frames": 8,
                        "buckets": [128, 256, 512, 1024, 2048],
                        "warm_frames": 4,
                        "check": {"frames": 3, "keyframes": 3}}}


def run_small(workload: str, seed: int = 2, seconds: float = 20.0, control=False):
    """One run at the small size on the CPU.  The window is long enough for
    the stereo lap's first keyframe pair with new points (about 12 frames
    in) on a CPU shared with other test workers."""
    torch.manual_seed(0)
    generator.make_frames = _lap
    try:
        return harness.run_cell(workload, seed, seconds, False, device="cpu",
                                overrides=small(workload), render_workers=1,
                                control=control)
    finally:
        generator.make_frames = _make_frames


MONO = "euroc_mono.lap"


def mono_config() -> dict:
    """``examples/configs/EuRoC_mono.yaml`` as a configuration file of the
    benchmark, every key of the YAML as it stands."""
    settings = {}
    for line in (harness.REPO / "examples" / "configs" / "EuRoC_mono.yaml").read_text().splitlines():
        m = re.fullmatch(r"([A-Za-z][A-Za-z0-9_.]*):\s*(\S+)\s*", line)
        if m:
            v = m.group(2)
            settings[m.group(1)] = int(v) if re.fullmatch(r"-?\d+", v) else float(v)
    stereo = json.loads((harness.BENCH / "configs" / "euroc_stereo.json").read_text())
    return dict(stereo, name="euroc_mono", sensor="mono", settings=settings,
                source="EuRoC MAV cam0 as set in ORB-SLAM2 Examples/Monocular/EuRoC.yaml; "
                       "this repo's examples/configs/EuRoC_mono.yaml",
                deployment="the EuRoC MAV's left camera alone (752x480 at 20 Hz, raw with "
                           "its lens), tracking and mapping on one H100")


def install_mono(tmp_path, monkeypatch, init_limit: float) -> str:
    """A copy of the benchmark with a mono configuration, ``mapping``'s
    lap (20 Hz, each keyframe mapped before the next frame) and the cell's
    limits added as files, ``BENCHMARK.json`` with the cell, and the
    harness pointed at both.  Returns the cell's name."""
    copy = tmp_path / "benchmark"
    shutil.copytree(harness.BENCH, copy, ignore=shutil.ignore_patterns("__pycache__"))
    (copy / "configs" / "euroc_mono.json").write_text(json.dumps(mono_config()))
    shutil.copy(copy / "traffic" / "mapping.json", copy / "traffic" / "lap.json")
    limits = json.loads((copy / "limits" / "euroc_stereo.mapping.json").read_text())
    (copy / "limits" / f"{MONO}.json").write_text(json.dumps(dict(limits, init_gap=init_limit)))
    bench = json.loads((harness.REPO / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": MONO, "config": "euroc_mono", "traffic": "lap",
                               "chips": 1, "why": "a test cell"})
    for m in bench["end_to_end"]:
        if m["name"] == "ate_m":
            m["workloads"].append(MONO)
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    monkeypatch.setattr(harness, "BENCH", copy)
    monkeypatch.setattr(harness, "REPO", tmp_path)
    return MONO
