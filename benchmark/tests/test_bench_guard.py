"""The import guard: a module of JAX or of the JAX package, compared by its
whole top-level name, fails the run and no result is printed."""
import sys
import types

import torch

from benchmark import harness


def test_guard_compares_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "jetson_slam_tpu_torch_fake", types.ModuleType("x"))
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jetson_slam_tpu.ops", types.ModuleType("x"))
    monkeypatch.setitem(sys.modules, "jax", types.ModuleType("x"))
    assert harness.forbidden_modules() == ["jax", "jetson_slam_tpu.ops"]


def test_guard_fires_at_the_end_of_a_run(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(harness, "card_line", lambda: "fake")

    def fake_run(*a, **kw):
        sys.modules["jetson_slam_tpu"] = types.ModuleType("jetson_slam_tpu")
        return {"correct": True}
    monkeypatch.setattr(harness, "run_cell", fake_run)
    try:
        rc = harness.main(["--workload", "euroc_stereo.mapping", "--seed", "1",
                           "--seconds", "1"])
    finally:
        sys.modules.pop("jetson_slam_tpu", None)
    out, err = capsys.readouterr()
    assert rc == 3
    assert "jetson_slam_tpu" in err and "{" not in out


def test_no_card_no_result(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = harness.main(["--workload", "euroc_stereo.mapping", "--seed", "1", "--seconds", "1"])
    out, _ = capsys.readouterr()
    assert rc != 0 and out == ""


def test_reference_imports_nothing_of_the_program():
    """The plain reference (the initializer's among it) imports neither
    package nor JAX: its top-level import names, compared whole."""
    import ast
    names = set()
    for path in (harness.BENCH / "reference").glob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names |= {a.name.split(".")[0] for a in node.names}
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names.add(node.module.split(".")[0])
    assert "numpy" in names
    assert not names & {"jax", "jaxlib", "flax", "jetson_slam_tpu", "jetson_slam_tpu_torch"}
