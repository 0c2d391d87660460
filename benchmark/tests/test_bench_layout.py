"""A configuration, a traffic mix, a metric and a kernel's roofline are
found by name; adding one edits no file that is there."""
import hashlib
import json
import shutil

from benchmark import harness
from benchmark.check import MONO_NAMES, numbers_of
from benchmark.tests.bench_small import mono_config


def _digest(root):
    h = {}
    for p in sorted(root.rglob("*")):
        if p.is_file() and "__pycache__" not in p.parts:
            h[str(p.relative_to(root))] = hashlib.sha256(p.read_bytes()).hexdigest()
    return h


def test_new_files_are_found_by_name(tmp_path, monkeypatch):
    copy = tmp_path / "benchmark"
    shutil.copytree(harness.BENCH, copy, ignore=shutil.ignore_patterns("__pycache__"))
    before = _digest(copy)
    bench = json.loads((harness.REPO / "BENCHMARK.json").read_text())
    (copy / "traffic" / "hover.json").write_text(json.dumps(
        dict(json.loads((copy / "traffic" / "mapping.json").read_text()), frames=8)))
    (copy / "configs" / "euroc_mono.json").write_text(json.dumps(mono_config()))
    (copy / "metrics" / "tracker.frames_fed.py").write_text(
        "def read(run):\n    return float(len(run.fed))\n")
    (copy / "roofline" / "stereo_costs.py").write_text(
        "KERNEL = 'stereo_costs_kernel'\n\n\ndef work(geom, n_images, valid_slots):\n"
        "    return 0.0, 0.0\n")
    bench["workloads"].append({"name": "euroc_mono.hover", "config": "euroc_mono",
                               "traffic": "hover", "chips": 1, "why": "a test cell"})
    bench["per_layer"].append({"name": "tracker.frames_fed", "unit": "frames",
                               "better": "higher", "source": "host_clock",
                               "layer": "tracker host", "moves": "frames_per_s",
                               "workloads": ["euroc_mono.hover"]})
    monkeypatch.setattr(harness, "BENCH", copy)
    cell, config, traffic, metrics = harness.cell_of("euroc_mono.hover", bench)
    assert traffic["frames"] == 8 and config["sensor"] == "mono"
    assert config["settings"]["Camera.k1"] == -0.28340811
    assert numbers_of(config["sensor"])[0] == MONO_NAMES
    assert "tracker.frames_fed" in [m["name"] for m in metrics["per_layer"]]
    run = harness.Run(cell, config, traffic, 0, 1.0, True)
    run.fed = [{}] * 3
    assert harness.load_module("metrics", "tracker.frames_fed").read(run) == 3.0
    assert harness.load_module("roofline", "stereo_costs").KERNEL == "stereo_costs_kernel"
    after = _digest(copy)
    assert {k: v for k, v in after.items() if k in before} == before
