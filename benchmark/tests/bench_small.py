"""Small sizes for the benchmark's CPU tests: every cell at 320x240, four
levels, a 64-frame lap, with the port's plain kernel versions.  A lap is
rendered once per process and shared by the tests."""
import json

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


def run_small(workload: str, seed: int = 2, seconds: float = 12.0, control=False):
    torch.manual_seed(0)
    generator.make_frames = _lap
    try:
        return harness.run_cell(workload, seed, seconds, False, device="cpu",
                                overrides=small(workload), render_workers=1,
                                control=control)
    finally:
        generator.make_frames = _make_frames
