"""The port stands alone: it imports torch, never JAX or the JAX package
(its I/O, viewers, profiling, command-line tools and distribution
included), runs on the card unless asked for the CPU, and an option of the
wrong type raises TypeError naming it."""
import ast
import os
import subprocess
import sys

import numpy as np
import pytest

pytest.importorskip("jax")
import torch  # noqa: E402

import jetson_slam_tpu_torch  # noqa: E402
from jetson_slam_tpu_torch.config import SLAMConfig  # noqa: E402
from jetson_slam_tpu_torch.models.slam import SlamSystem  # noqa: E402

torch.set_num_threads(2)

PKG = os.path.dirname(jetson_slam_tpu_torch.__file__)
REPO = os.path.dirname(PKG)
SLICE_MODULES = [
    "jetson_slam_tpu_torch", "jetson_slam_tpu_torch.config",
    "jetson_slam_tpu_torch.convert", "jetson_slam_tpu_torch.device",
    "jetson_slam_tpu_torch.ops.tables", "jetson_slam_tpu_torch.ops.frontend",
    "jetson_slam_tpu_torch.ops.stereo", "jetson_slam_tpu_torch.ops.hamming",
    "jetson_slam_tpu_torch.ops.cuda_build", "jetson_slam_tpu_torch.ops.cuda_frontend",
    "jetson_slam_tpu_torch.ops.cuda_descriptor", "jetson_slam_tpu_torch.ops.cuda_stereo",
    "jetson_slam_tpu_torch.utils.lie", "jetson_slam_tpu_torch.core.map",
    "jetson_slam_tpu_torch.core.frame", "jetson_slam_tpu_torch.core.optimizer",
    "jetson_slam_tpu_torch.core.matcher", "jetson_slam_tpu_torch.core.fused_track",
    "jetson_slam_tpu_torch.core.tracking", "jetson_slam_tpu_torch.core.triangulation",
    "jetson_slam_tpu_torch.core.local_ba", "jetson_slam_tpu_torch.core.local_mapping",
    "jetson_slam_tpu_torch.core.pipeline", "jetson_slam_tpu_torch.models.slam",
    "jetson_slam_tpu_torch.io.synthetic", "jetson_slam_tpu_torch.io.evaluation",
    "jetson_slam_tpu_torch.io.trajectory", "jetson_slam_tpu_torch.bow.vocabulary",
    "jetson_slam_tpu_torch.bow.database", "jetson_slam_tpu_torch.core.pnp_solver",
    "jetson_slam_tpu_torch.core.sim3_solver", "jetson_slam_tpu_torch.core.pose_graph",
    "jetson_slam_tpu_torch.core.loop_closing", "jetson_slam_tpu_torch.core.initializer",
    "jetson_slam_tpu_torch.io.png", "jetson_slam_tpu_torch.io.native_build",
    "jetson_slam_tpu_torch.io.native_loader", "jetson_slam_tpu_torch.io.datasets",
    "jetson_slam_tpu_torch.io.rectify", "jetson_slam_tpu_torch.io.checkpoint",
    "jetson_slam_tpu_torch.utils.profiling", "jetson_slam_tpu_torch.viz",
    "jetson_slam_tpu_torch.viz.frame_drawer", "jetson_slam_tpu_torch.viz.map_drawer",
    "jetson_slam_tpu_torch.viz.viewer", "jetson_slam_tpu_torch.viz.live_server",
    "jetson_slam_tpu_torch.cli.run_slam", "jetson_slam_tpu_torch.cli.euroc_gate",
    "jetson_slam_tpu_torch.parallel", "jetson_slam_tpu_torch.parallel.dist_ba",
    "jetson_slam_tpu_torch.parallel.multihost", "jetson_slam_tpu_torch.cli.cross_host_worker",
    "jetson_slam_tpu_torch.cli.train_vocabulary",
]


def _forbidden(name: str) -> bool:
    return (name == "jax" or name.startswith("jax.")
            or name == "jetson_slam_tpu" or name.startswith("jetson_slam_tpu."))


def test_import_loads_no_jax_and_no_jax_package():
    code = ("import importlib, json, sys\n"
            f"for m in {SLICE_MODULES!r}: importlib.import_module(m)\n"
            "print(json.dumps(sorted(sys.modules)))\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120, check=True)
    loaded = __import__("json").loads(out.stdout.strip().splitlines()[-1])
    assert "jetson_slam_tpu_torch.models.slam" in loaded
    bad = [m for m in loaded if _forbidden(m)]
    assert not bad, bad


def test_sources_import_no_jax_and_no_jax_package():
    files = []
    for root, _dirs, names in os.walk(PKG):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    files.append(os.path.join(REPO, "chip_smoke.py"))
    assert len(files) > 20
    for path in files:
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            assert not any(_forbidden(n) for n in names), (path, names)


def _cfg():
    cfg = SLAMConfig()
    cfg.camera.width, cfg.camera.height = 160, 120
    cfg.orb.n_levels, cfg.orb.tile_h, cfg.orb.tile_w = 2, 16, 16
    cfg.max_map_points, cfg.max_keyframes = 1024, 8
    return cfg


def test_cuda_is_the_default_and_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device works")
    with pytest.raises(RuntimeError, match="cuda"):
        SlamSystem(_cfg(), sensor="stereo", enable_mapping=False)
    from jetson_slam_tpu_torch.ops.frontend import OrbFrontend
    with pytest.raises(RuntimeError, match="cuda"):
        OrbFrontend(120, 160, n_levels=2, tile_h=16, tile_w=16)


@pytest.mark.parametrize("kw", [
    dict(mapping_device=object()), dict(vocabulary=object(), mesh=object()),
    dict(mesh=object()),
], ids=lambda kw: next(iter(kw)) + "=" + repr(next(iter(kw.values())))[:12])
def test_out_of_slice_options_raise(kw):
    """The distribution options are legal now (mapping_device a
    torch.device or its name, mesh a torch.distributed ProcessGroup, with
    or without a vocabulary); a value of another type is not accepted
    silently: TypeError naming the option."""
    name = "mesh" if "mesh" in kw else "mapping_device"
    with pytest.raises(TypeError, match=name):
        SlamSystem(_cfg(), **{"sensor": "stereo", "device": "cpu", **kw})


@pytest.mark.parametrize("sensor", ["mono", "rgbd"])
def test_mono_and_rgbd_build_on_the_cpu_and_default_to_the_card(sensor):
    """The mono and RGB-D sessions build with device="cpu" and track a
    frame there; without device they ask for the card, which raises here."""
    from jetson_slam_tpu_torch.core.tracking import TrackingState
    slam = SlamSystem(_cfg(), sensor=sensor, device="cpu")
    assert slam.tracker.sensor == slam.local_mapper.sensor == sensor
    img = np.zeros((120, 160), np.uint8)
    if sensor == "mono":
        state, _ = slam.track_monocular(img, 0.0)
    else:
        state, _ = slam.track_rgbd(img, np.zeros((120, 160), np.float32), 0.0)
    assert state == TrackingState.NOT_INITIALIZED
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            SlamSystem(_cfg(), sensor=sensor)


def test_relocalization_raises():
    """A LOST frame used to raise NotImplementedError; relocalization is
    ported now, so on an empty map it finds no candidate and the frame stays
    LOST, with and without a vocabulary.  The LoopCloser's mesh is legal
    now; one that is not a ProcessGroup raises TypeError naming it."""
    from jetson_slam_tpu_torch.bow.vocabulary import small_vocabulary
    from jetson_slam_tpu_torch.core.loop_closing import LoopCloser
    from jetson_slam_tpu_torch.core.tracking import TrackingState
    img = np.zeros((120, 160), np.uint8)
    for vocab in (None, small_vocabulary()):
        slam = SlamSystem(_cfg(), sensor="stereo", device="cpu", vocabulary=vocab)
        slam.tracker.state = TrackingState.LOST
        state, _ = slam.track_stereo(img, img, 0.0)
        assert state == TrackingState.LOST
    with pytest.raises(TypeError, match="mesh"):
        LoopCloser(slam.map, slam.database, slam.config.camera, slam.frontend.geom,
                   "cpu", mesh=object())


def _fast_nms_call():
    from jetson_slam_tpu_torch.ops.cuda_frontend import fast_nms
    from jetson_slam_tpu_torch.ops.tables import fast_lut
    return fast_nms, (torch.zeros((1, 64, 64), dtype=torch.uint8),
                      torch.tensor([[20, 44, 20, 44]], dtype=torch.int32),
                      torch.as_tensor(fast_lut(9, 16).astype(np.uint8)), 20)


def _orb_descriptor_call():
    from jetson_slam_tpu_torch.ops.cuda_descriptor import orb_descriptor
    from jetson_slam_tpu_torch.ops.frontend import OrbFrontend
    fe = OrbFrontend(64, 64, n_levels=1, tile_h=32, tile_w=32, device="cpu")
    K = fe.n_slots_padded
    kp = torch.full((1, K), 32, dtype=torch.int32)
    return orb_descriptor, (torch.zeros((1, 1, 64, 64), dtype=torch.uint8), kp, kp,
                            torch.ones((1, K), dtype=torch.int32), fe.slot_level,
                            fe.level_hw, fe.pattern, fe.gauss, fe.ic_masks)


def _stereo_costs_call():
    from jetson_slam_tpu_torch.ops.cuda_stereo import stereo_costs
    pyr = torch.zeros((1, 1, 64, 64), dtype=torch.uint8)
    at = torch.full((1, 4), 32, dtype=torch.int32)
    return stereo_costs, (pyr, pyr, torch.zeros_like(at), at, at, at,
                          torch.ones((1, 4), dtype=torch.bool))


@pytest.mark.parametrize("call", [_fast_nms_call, _orb_descriptor_call, _stereo_costs_call],
                         ids=["fast_nms", "orb_descriptor", "stereo_costs"])
def test_kernel_wrappers_take_the_plain_version_only_on_the_cpu(call):
    wrapper, args = call()
    meta = tuple(a.to("meta") if isinstance(a, torch.Tensor) else a for a in args)
    with pytest.raises(ValueError, match="device"):
        wrapper(*meta)
    before = wrapper.launches
    wrapper(*args)
    assert wrapper.launches == before   # the plain version launches nothing
