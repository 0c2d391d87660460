"""The port's session extras against the JAX package on the CPU
(tests/test_torch_relocalization.py's scene: seed 2, 320x240, 4 levels,
tile 16, mapping on, synchronous):

- save_map / load_map: each package tracks 8 frames with the bundled small
  vocabulary, saves its map, loads it into the same session (which
  restarts LOST), relocalizes on frame 5 and tracks frame 8: the same
  states in both, the relocalized pose within 0.05 m of the one tracked
  at frame 5, and the map loaded equal to the map saved.  The port loads
  the JAX session's map file into the same tables and observation index
  as the JAX package does, its keyframes entered into the BoW database;
- change_calibration mid-sequence, mapping off: frames 0..5 rendered at fx
  300, frames 6..11 at fx 330 (bf with it), the calibration changed before
  frame 6: the same states in both and tracked camera centres within 1e-3
  m of each other (measured 3e-5).  With mapping on, whole runs of the two
  packages drift apart by rounding up to 2.2e-3 m on this scene even
  without a change, so the bound is held with mapping off; the port's
  mapper then reads the new camera matrix, where the JAX package's keeps
  the one it was built with (ROADMAP queue 3);
- a mask image (``mask.left``): both facades read it into the same
  per-level masks, and, given the JAX package's pyramid, the same keypoint
  slots.  A missing, unreadable, 16-bit or wrongly sized mask raises;
- ``utils/profiling.py``: TicToc's statistics and ``scope(sync=...)``,
  and ``trace`` writing a Chrome trace on the CPU.

The JAX sessions run in two child processes (``InChild``) started at the
file's first test, beside the port's, which run here.
"""
import json
import os

import numpy as np
import pytest

pytest.importorskip("jax")
import torch  # noqa: E402

from jetson_slam_tpu.bow.vocabulary import bundled_vocabulary as jax_vocab  # noqa: E402
from jetson_slam_tpu.config import SLAMConfig as JaxConfig  # noqa: E402
from jetson_slam_tpu.core.frame import Frame as JaxFrame  # noqa: E402
from jetson_slam_tpu.io import checkpoint as jckpt  # noqa: E402
from jetson_slam_tpu.models.slam import SlamSystem as JaxSlam  # noqa: E402
from jetson_slam_tpu_torch.bow.vocabulary import bundled_vocabulary  # noqa: E402
from jetson_slam_tpu_torch.config import SLAMConfig  # noqa: E402
from jetson_slam_tpu_torch.core.frame import Frame  # noqa: E402
from jetson_slam_tpu_torch.io import checkpoint, png  # noqa: E402
from jetson_slam_tpu_torch.io.synthetic import make_stereo_sequence  # noqa: E402
from jetson_slam_tpu_torch.models.slam import SlamSystem  # noqa: E402
from jetson_slam_tpu_torch.utils.profiling import TicToc, trace  # noqa: E402
from tests.test_torch_solvers import InChild  # noqa: E402

torch.set_num_threads(2)

N, SAVE_AT, VIEW, CHANGE_AT = 12, 8, 5, 6   # N: frames of the calibration run
FX0, FX1 = 300.0, 330.0
BASELINE = 0.4     # make_stereo_sequence's default


def _config(cfg, seq):
    c = cfg.camera
    c.fx, c.fy, c.cx, c.cy, c.bf = seq.fx, seq.fy, seq.cx, seq.cy, seq.bf
    c.width, c.height = 320, 240
    c.k1 = c.k2 = c.p1 = c.p2 = 0.0
    cfg.orb.n_levels, cfg.orb.tile_h, cfg.orb.tile_w = 4, 16, 16
    return cfg


def _sequences():
    return (make_stereo_sequence(seed=2, n_frames=N, h=240, w=320, fx=FX0),
            make_stereo_sequence(seed=2, n_frames=N, h=240, w=320, fx=FX1))


def _save_load_run(slam, seq, path):
    """SAVE_AT frames, save, load, frame VIEW again, then frame SAVE_AT:
    (state names, Tcw tracked at VIEW, relocalized Tcw)."""
    states = []
    for i in range(SAVE_AT):
        state, fr = slam.track_stereo(seq.lefts[i], seq.rights[i], seq.timestamps[i])
        states.append(state.name)
        if i == VIEW:
            est = fr.Tcw.copy()
    slam.save_map(path)
    slam.load_map(path)
    states.append(slam.get_tracking_state().name)
    state, fr = slam.track_stereo(seq.lefts[VIEW], seq.rights[VIEW], 100.0)
    states.append(state.name)
    reloc = fr.Tcw.copy()
    state, _ = slam.track_stereo(seq.lefts[SAVE_AT], seq.rights[SAVE_AT], 101.0)
    states.append(state.name)
    slam.shutdown()
    return states, est, reloc


def _calibration_run(slam, seqs):
    """Frames 0..CHANGE_AT-1 of seqs[0], the calibration of seqs[1], then
    its frames: (state names, camera centres)."""
    states, centres = [], []
    for i in range(N):
        seq = seqs[i >= CHANGE_AT]
        if i == CHANGE_AT:
            slam.change_calibration(seq.fx, seq.fy, seq.cx, seq.cy, bf=seq.bf)
        state, fr = slam.track_stereo(seq.lefts[i], seq.rights[i], seq.timestamps[i])
        states.append(state.name)
        centres.append(fr.camera_center.copy())
    slam.shutdown()
    return states, np.array(centres)


def _mask_image(h=240, w=320):
    mask = np.full((h, w), 255, np.uint8)
    mask[:, 140:180] = 0
    mask[:30] = 0
    return mask


def _jax_save_load(seq, map_path):
    """The JAX save / load session (run in a child process), and the map
    as the JAX package loads it back."""
    JaxFrame._next_id = 0
    slam = JaxSlam(_config(JaxConfig(), seq), sensor="stereo", vocabulary=jax_vocab("small"))
    run = _save_load_run(slam, seq, map_path)
    loaded = jckpt.load_map(map_path)
    return run, {k: getattr(loaded, k) for k in checkpoint._ARRAYS + ("_pt_obs",)}


def _jax_calibration_and_mask(seqs, mask_path):
    """The JAX calibration run and masked extraction (run in a child
    process): (states, centres), and (per-level masks, pyramid levels and
    extraction outputs of frame 0)."""
    import jax.numpy as jnp
    seq = seqs[0]
    JaxFrame._next_id = 0
    slam = JaxSlam(_config(JaxConfig(), seq), sensor="stereo", enable_mapping=False)
    calibration = _calibration_run(slam, seqs)
    cfg = _config(JaxConfig(), seq)
    cfg.orb.mask_left = mask_path
    jf = JaxSlam(cfg, sensor="stereo", enable_mapping=False).frontend
    levels = jf._pyramid_batch(jf._tables, jnp.asarray(seq.lefts[:1]))
    r = jf.extract(seq.lefts[0])
    return calibration, ([np.asarray(m) for m in jf.masks],
                         [np.asarray(lv)[0] for lv in levels],
                         {f: np.asarray(getattr(r, f))
                          for f in ("valid", "octave", "lx", "ly", "xs", "ys")})


@pytest.fixture(scope="module")
def seqs():
    return _sequences()


@pytest.fixture(scope="module")
def jax_runs(tmp_path_factory, seqs):
    """The JAX sessions, started in two child processes at the first test
    of this file, so that they run beside each other and the port's."""
    d = tmp_path_factory.mktemp("jax")
    mask_path, map_path = str(d / "mask.png"), str(d / "jax_map.npz")
    png.write(mask_path, _mask_image())
    children = {"save_load": InChild(_jax_save_load).start(seqs[0], map_path),
                "calibration_mask": InChild(_jax_calibration_and_mask).start(seqs, mask_path)}
    results = {}

    def get(name):
        if name not in results:
            results[name] = children[name].result()
        return results[name]

    yield {"get": get, "map_path": map_path, "mask_path": mask_path}
    for child in children.values():
        child.close()


def test_save_load_relocalizes_as_jax(jax_runs, seqs, tmp_path):
    seq = seqs[0]
    Frame._next_id = 0
    slam = SlamSystem(_config(SLAMConfig(), seq), sensor="stereo",
                      vocabulary=bundled_vocabulary("small"), device="cpu")
    path = str(tmp_path / "port_map.npz")
    saved = {}
    orig = checkpoint.save_map

    def keep(m, p):
        orig(m, p)
        saved["map"] = checkpoint.load_map(p)
        saved["tables"] = {k: getattr(m, k).copy() for k in checkpoint._ARRAYS}
        saved["n"] = (m.n_keyframes(), m.n_points())

    checkpoint.save_map = keep
    try:
        states, est, reloc = _save_load_run(slam, seq, path)
    finally:
        checkpoint.save_map = orig
    for k, v in saved["tables"].items():
        np.testing.assert_array_equal(getattr(saved["map"], k), v, err_msg=k)
    (j_states, j_est, j_reloc), j_map = jax_runs["get"]("save_load")
    print("port", states, "\njax ", j_states)
    assert states[SAVE_AT] == "LOST" and states[SAVE_AT + 1] == "OK"
    assert states == j_states
    for tcw_est, tcw in ((est, reloc), (j_est, j_reloc)):
        gap = np.linalg.norm(-tcw[:3, :3].T @ tcw[:3, 3] + tcw_est[:3, :3].T @ tcw_est[:3, 3])
        assert gap < 0.05, gap
    # the JAX session's map file, loaded by the port as by the JAX package
    slam.load_map(jax_runs["map_path"])
    for k, v in j_map.items():
        got = getattr(slam.map, k)
        assert got == v if k == "_pt_obs" else np.array_equal(got, v), k
    assert slam.get_tracking_state().name == "LOST"
    assert int(slam.database.has.sum()) == slam.map.n_keyframes() > 1


def test_change_calibration_matches_jax(jax_runs, seqs):
    Frame._next_id = 0
    slam = SlamSystem(_config(SLAMConfig(), seqs[0]), sensor="stereo", enable_mapping=False,
                      device="cpu")
    states, centres = _calibration_run(slam, seqs)
    c = slam.config.camera
    assert (c.fx, c.bf) == (FX1, FX1 * BASELINE)
    assert slam.tracker.th_depth == pytest.approx(c.th_depth * BASELINE)
    j_states, j_centres = jax_runs["get"]("calibration_mask")[0]
    print("port", states, "\njax ", j_states)
    print("centre gap", np.abs(centres - j_centres).max())
    assert states == j_states and all(s == "OK" for s in states)
    np.testing.assert_allclose(centres, j_centres, atol=1e-3, rtol=0)


def test_change_calibration_reaches_the_mapper(seqs):
    """The port's mapper builds its camera matrix from the current
    intrinsics at each use."""
    seq = seqs[0]
    slam = SlamSystem(_config(SLAMConfig(), seq), sensor="stereo", device="cpu")
    np.testing.assert_allclose(slam.local_mapper.K, [[FX0, 0, 160], [0, FX0, 120], [0, 0, 1]])
    slam.change_calibration(FX1, FX1 + 1, 161.0, 119.0, k1=0.01, bf=FX1 * BASELINE)
    np.testing.assert_allclose(slam.local_mapper.K, [[FX1, 0, 161], [0, FX1 + 1, 119], [0, 0, 1]])
    assert slam.local_mapper.cam is slam.tracker.cam is slam.config.camera
    assert slam.config.camera.k1 == 0.01


def test_mask_image_gives_jax_keypoint_slots(jax_runs, seqs):
    seq = seqs[0]
    cfg = _config(SLAMConfig(), seq)
    cfg.orb.mask_left = jax_runs["mask_path"]
    tf = SlamSystem(cfg, sensor="stereo", enable_mapping=False, device="cpu").frontend
    masks, levels, want = jax_runs["get"]("calibration_mask")[1]
    g = tf.geom
    for i, m in enumerate(masks):
        np.testing.assert_array_equal(tf.mask_stack[i, :g.heights[i], :g.widths[i]].numpy(), m)

    def pyramid(imgs_u8):
        out = torch.zeros((1, len(levels)) + tuple(imgs_u8.shape[1:]), dtype=torch.uint8)
        for i, lv in enumerate(levels):
            out[0, i, :lv.shape[0], :lv.shape[1]] = torch.as_tensor(lv)
        return out

    tf.pyramid = pyramid
    r = tf.extract(seq.lefts[0])
    v = want["valid"]
    assert v.sum() > 100
    for f in ("valid", "octave", "lx", "ly"):
        np.testing.assert_array_equal(getattr(r, f).numpy(), want[f], err_msg=f)
    for f in ("xs", "ys"):
        np.testing.assert_allclose(getattr(r, f).numpy(), want[f], atol=1e-5, rtol=0)
    xs = r.xs.numpy()[v]
    assert not ((xs > 142) & (xs < 178)).any()


def test_bad_mask_images_raise(seqs, tmp_path):
    seq = seqs[0]
    cfg = _config(SLAMConfig(), seq)
    cfg.orb.mask_left = str(tmp_path / "missing.png")
    with pytest.raises(FileNotFoundError):
        SlamSystem(cfg, sensor="stereo", device="cpu")
    (tmp_path / "bad.png").write_bytes(b"not a png")
    cfg.orb.mask_left = str(tmp_path / "bad.png")
    with pytest.raises(ValueError, match="not a PNG"):
        SlamSystem(cfg, sensor="stereo", device="cpu")
    png.write(tmp_path / "deep.png", np.zeros((240, 320), np.uint16))
    cfg.orb.mask_left = str(tmp_path / "deep.png")
    with pytest.raises(ValueError, match="not 8-bit grey"):
        SlamSystem(cfg, sensor="stereo", device="cpu")
    png.write(tmp_path / "small.png", np.zeros((120, 160), np.uint8))
    cfg.orb.mask_left = str(tmp_path / "small.png")
    with pytest.raises(ValueError, match="160x120, the camera 320x240"):
        SlamSystem(cfg, sensor="stereo", device="cpu")


def test_tictoc_and_trace_on_the_cpu(tmp_path):
    tt = TicToc()
    for _ in range(3):
        tt.tic("a")
        tt.toc("a")
    x = torch.ones(64)
    with tt.scope("b", sync=x):
        x = x * 2
    with tt.scope("c", sync=[x, x + 1]):
        pass
    sa, sb = tt.stats("a"), tt.stats("b")
    assert sa["count"] == 3 and sb["count"] == 1 and tt.stats("c")["count"] == 1
    assert sa["total_ms"] >= sa["max_ms"] >= sa["median_ms"] >= sa["min_ms"] >= 0
    assert "a" in tt.report() and "b" in tt.report()
    tt.reset()
    assert tt.stats("a") == {"count": 0}
    with trace(str(tmp_path / "prof")) as prof:
        torch.ones((32, 32)) @ torch.ones((32, 32))
    assert any("matmul" in e.key or "mm" in e.key for e in prof.key_averages())
    with open(tmp_path / "prof" / "trace.json") as f:
        assert json.load(f)["traceEvents"]
    assert os.path.getsize(tmp_path / "prof" / "trace.json") > 100
