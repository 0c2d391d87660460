"""The port's viewers and command-line tools on the CPU:

- ``viz.FrameDrawer`` on real port Frames of a lens-warped RGB-D session
  (the first one built by ``Frame``, the next by the fused step's
  ``Frame.from_arrays``): each keeps its raw keypoints ``kp_xy_raw``, and
  the drawing equals the JAX package's FrameDrawer on the same frame;
- ``viz.MapDrawer`` and ``viz.Viewer`` on a port session's map (PNG files
  through ``io/png.py``);
- ``viz.live_server.LiveViewer``: the page, the PNGs, the stats and the
  controls; a reset or a localization-mode request POSTed to the page
  leaves the session untouched until the next ``update`` on the tracking
  thread;
- ``cli.run_slam`` stereo-euroc on a lens-warped EuRoC tree with LEFT/RIGHT
  rectification blocks, saving its map, then resuming from it
  (``--load-map``: the first frame relocalizes); rgbd-tum on 16-bit depth
  PNGs; stereo-kitti and mono-euroc on their layouts; stereo-live raises;
  the card is the default device;
- ``cli.euroc_gate`` on its synthetic EuRoC layout.
"""
import json
import os
import urllib.request

import numpy as np
import pytest

pytest.importorskip("jax")
import torch  # noqa: E402

from jetson_slam_tpu.viz.frame_drawer import FrameDrawer as JaxFrameDrawer  # noqa: E402
from jetson_slam_tpu_torch.cli import euroc_gate, run_slam  # noqa: E402
from jetson_slam_tpu_torch.config import CameraConfig, SLAMConfig, load_config, save_config  # noqa: E402
from jetson_slam_tpu_torch.core.frame import Frame  # noqa: E402
from jetson_slam_tpu_torch.core.tracking import TrackingState  # noqa: E402
from jetson_slam_tpu_torch.io import png  # noqa: E402
from jetson_slam_tpu_torch.io.evaluation import ate_rmse  # noqa: E402
from jetson_slam_tpu_torch.io.synthetic import (EUROC_T0_NS, make_stereo_sequence,  # noqa: E402
                                                warp_lens, write_euroc_stereo,
                                                write_tum_rgbd)
from jetson_slam_tpu_torch.io.trajectory import load_trajectory_tum  # noqa: E402
from jetson_slam_tpu_torch.models.slam import SlamSystem  # noqa: E402
from jetson_slam_tpu_torch.viz import FrameDrawer, MapDrawer, Viewer  # noqa: E402
from jetson_slam_tpu_torch.viz.live_server import LiveViewer  # noqa: E402

torch.set_num_threads(2)

LENS = dict(k1=0.04, k2=-0.01, p1=0.001, p2=-0.0005, k3=0.0)
EUROC_D = np.array([-0.28340811, 0.07395907, 0.00019359, 1.76187114e-05, 0.0])


def _config(seq, **lens):
    cfg = SLAMConfig()
    c = cfg.camera
    c.fx, c.fy, c.cx, c.cy, c.bf = seq.fx, seq.fy, seq.cx, seq.cy, seq.bf
    c.width, c.height = 320, 240
    c.k1 = c.k2 = c.p1 = c.p2 = c.k3 = 0.0
    for k, v in lens.items():
        setattr(c, k, v)
    cfg.orb.n_levels, cfg.orb.tile_h, cfg.orb.tile_w = 4, 16, 16
    return cfg


@pytest.fixture(scope="module")
def stereo_session():
    """A port session (mapping on) after 6 frames of the arc (seed 2)."""
    seq = make_stereo_sequence(seed=2, n_frames=8, h=240, w=320)
    Frame._next_id = 0
    slam = SlamSystem(_config(seq), sensor="stereo", device="cpu")
    for i in range(6):
        state, frame = slam.track_stereo(seq.lefts[i], seq.rights[i], seq.timestamps[i])
    assert state == TrackingState.OK
    return slam, seq, frame


def test_frame_drawer_draws_raw_keypoints_as_jax(tmp_path):
    seq = make_stereo_sequence(seed=4, n_frames=8, h=240, w=320, with_depth=True)
    cfg = _config(seq, **LENS)
    Frame._next_id = 0
    slam = SlamSystem(cfg, sensor="rgbd", device="cpu")
    frames = []
    for i in range(5):
        _, frame = slam.track_rgbd(warp_lens(seq.lefts[i], cfg.camera),
                                   warp_lens(seq.depths[i], cfg.camera, order=0),
                                   seq.timestamps[i])
        frames.append(frame)
    assert slam.tracker.fused_frames >= 1          # a frame from Frame.from_arrays
    for i, frame in enumerate(frames):
        v = frame.valid
        assert frame.kp_xy_raw.shape == frame.kp_xy.shape
        assert np.abs(frame.kp_xy_raw[v] - frame.kp_xy[v]).max() > 0.5   # the lens
        grey = warp_lens(seq.lefts[i], cfg.camera)
        kw = dict(state_name="OK", n_kfs=slam.map.n_keyframes(), n_pts=slam.map.n_points())
        got = FrameDrawer(16, 16).draw(grey, frame, **kw)
        assert got.shape == (260, 320, 3) and got.dtype == np.uint8
        np.testing.assert_array_equal(got, JaxFrameDrawer(16, 16).draw(grey, frame, **kw))


def test_map_drawer_and_viewer(stereo_session, tmp_path):
    slam, seq, frame = stereo_session
    for top_down in (False, True):
        img = MapDrawer(top_down=top_down).draw(slam.map, current_Tcw=frame.Tcw,
                                                trajectory=np.tile(np.eye(4), (3, 1, 1)))
        assert img.ndim == 3 and img.shape[2] == 3 and img.any()
    seen = []
    viewer = Viewer(out_dir=str(tmp_path / "v"), every=2, tile_h=16, tile_w=16,
                    callback=lambda i, f, m: seen.append((i, f.shape, m.shape)))
    for _ in range(3):
        viewer.update(slam, seq.lefts[5], frame)
    assert [s[0] for s in seen] == [0, 2]
    names = sorted(os.listdir(tmp_path / "v"))
    assert names == ["frame_000000.png", "frame_000002.png", "map_000000.png",
                     "map_000002.png"]
    assert png.read(tmp_path / "v" / "frame_000000.png").shape == (260, 320)


def _get(port, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=10) as r:
        return r.read()


def _post(port, path):
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", method="POST", data=b"")
    with urllib.request.urlopen(req, timeout=10) as r:
        return r.read()


def test_live_viewer_applies_controls_on_the_tracking_thread(stereo_session):
    slam, seq, frame = stereo_session
    viewer = LiveViewer(slam, port=0, tile_h=16, tile_w=16, min_period=0.0)
    try:
        viewer.update(slam, seq.lefts[5], frame)
        port = viewer.port
        page = _get(port, "/")
        assert b"localization mode" in page and b"follow camera" in page
        for name in ("/frame.png", "/map.png"):
            body = _get(port, name)
            assert body[:8] == png.SIGNATURE and len(body) > 1000
        assert png.decode(_get(port, "/frame.png")).shape == (260, 320)
        stats = json.loads(_get(port, "/stats.json"))
        assert stats["state"] == "OK" and stats["frame"] == 1
        assert stats["keyframes"] >= 1 and stats["points"] > 100
        # follow and top-down change only the renders: at once
        _post(port, "/control?follow=0&topdown=1")
        assert not viewer.follow and viewer.map_drawer.top_down
        # localization mode and reset wait for the next update
        old_map, n_kf = slam.map, slam.map.n_keyframes()
        _post(port, "/control?localization=1")
        _post(port, "/control?reset=1")
        assert not slam.localization_only and not slam.tracker.only_tracking
        assert slam.map is old_map and slam.map.n_keyframes() == n_kf
        viewer.update(slam, seq.lefts[5], frame)
        assert slam.localization_only and slam.tracker.only_tracking
        assert slam.map is not old_map and slam.map.n_keyframes() == 0
        _post(port, "/control?localization=0")
        viewer.update(slam, seq.lefts[5], None)
        assert not slam.localization_only
        assert json.loads(_get(port, "/stats.json"))["frame"] == 3
    finally:
        viewer.close()


def _euroc_tree(root, seq):
    """The sequence as a EuRoC tree, each eye warped by a EuRoC lens, and
    settings whose LEFT/RIGHT blocks undo the warp."""
    cfg = _config(seq)
    K = np.array([[seq.fx, 0, seq.cx], [0, seq.fy, seq.cy], [0, 0, 1.0]])
    lens = CameraConfig(fx=seq.fx, fy=seq.fy, cx=seq.cx, cy=seq.cy, k1=EUROC_D[0],
                        k2=EUROC_D[1], p1=EUROC_D[2], p2=EUROC_D[3])
    rect = {"K": K, "D": EUROC_D, "R": np.eye(3), "P": np.hstack([K, np.zeros((3, 1))]),
            "height": 240, "width": 320}
    cfg.left_rect, cfg.right_rect = rect, dict(rect)
    write_euroc_stereo(str(root / "seq"), [warp_lens(i, lens) for i in seq.lefts],
                       [warp_lens(i, lens) for i in seq.rights], seq.timestamps)
    save_config(cfg, str(root / "settings.yaml"))
    return str(root / "settings.yaml"), str(root / "seq")


def test_cli_stereo_euroc_saves_and_resumes(tmp_path, capsys):
    seq = make_stereo_sequence(seed=2, n_frames=10, h=240, w=320)
    settings, seq_dir = _euroc_tree(tmp_path, seq)
    assert load_config(settings).left_rect is not None
    traj, map_path = str(tmp_path / "traj.txt"), str(tmp_path / "map.npz")
    Frame._next_id = 0
    out = run_slam.main(["stereo-euroc", settings, seq_dir, "--out", traj, "--device", "cpu",
                         "--save-map", map_path])
    assert [s.name for s in out["states"]] == ["OK"] * 10
    assert len(out["rectify_ms"]) == 10 and out["save_ms"] > 0
    assert len(out["sources"][0].decode_ms) == 10
    ts, poses = load_trajectory_tum(traj)
    gt_ts = [(int(t * 1e9) + EUROC_T0_NS) * 1e-9 for t in seq.timestamps]
    ate = ate_rmse(np.asarray(ts), np.asarray(poses), np.asarray(gt_ts), seq.poses_twc)
    assert len(ts) == 10 and ate < 0.05, ate
    printed = capsys.readouterr().out
    assert "median tracking time" in printed and "map saved to" in printed
    # resume: the first frame relocalizes against the saved map
    out2 = run_slam.main(["stereo-euroc", settings, seq_dir, "--out", "", "--device", "cpu",
                          "--load-map", map_path, "--max-frames", "2", "--no-ba"])
    assert out2["slam"].map.n_keyframes() >= out["slam"].map.n_keyframes()
    assert [s.name for s in out2["states"]] == ["OK", "OK"]
    assert "map loaded from" in capsys.readouterr().out


def test_cli_rgbd_tum_reads_16_bit_depth(tmp_path):
    seq = make_stereo_sequence(seed=4, n_frames=8, h=240, w=320, with_depth=True)
    cfg = _config(seq, **LENS)
    cfg.camera.depth_map_factor = 5000.0
    greys = [warp_lens(g, cfg.camera) for g in seq.lefts]
    depths = [warp_lens(d, cfg.camera, order=0) for d in seq.depths]
    assoc = write_tum_rgbd(str(tmp_path / "tum"), greys, depths, seq.timestamps, 5000.0)
    assert png.read(tmp_path / "tum" / "depth" / f"{seq.timestamps[0]:.6f}.png").dtype == np.uint16
    save_config(cfg, str(tmp_path / "tum.yaml"))
    traj = str(tmp_path / "traj.txt")
    Frame._next_id = 0
    out = run_slam.main(["rgbd-tum", str(tmp_path / "tum.yaml"), str(tmp_path / "tum"), assoc,
                         "--out", traj, "--device", "cpu"])
    assert [s.name for s in out["states"]] == ["OK"] * 8
    ts, poses = load_trajectory_tum(traj)
    assert ate_rmse(np.asarray(ts), np.asarray(poses), seq.timestamps, seq.poses_twc) < 0.05
    m = out["slam"].map
    kf = m.keyframe_ids()
    depth = m.kf_kp_depth[kf][m.kf_kp_valid[kf] & (m.kf_kp_depth[kf] > 0)]
    # depth in metres as rendered (the scene lies 3 to 12 m away), not the
    # <= 0.051 m of an 8-bit read
    assert np.median(depth) > 3.0, np.median(depth)


@pytest.mark.parametrize("mode", ["stereo-kitti", "mono-euroc"])
def test_cli_kitti_and_mono_layouts(mode, tmp_path):
    """stereo-kitti reads image_0 / image_1 and times.txt (no rectification
    blocks: the images pass through); mono-euroc reads cam0 alone and
    initializes from two views."""
    seq = make_stereo_sequence(seed=2, n_frames=8, h=240, w=320)
    root = tmp_path / "seq"
    if mode == "stereo-kitti":
        for sub, imgs in (("image_0", seq.lefts), ("image_1", seq.rights)):
            (root / sub).mkdir(parents=True)
            for i, img in enumerate(imgs[:6]):
                png.write(root / sub / f"{i:06d}.png", img)
        (root / "times.txt").write_text("".join(f"{t:.6e}\n" for t in seq.timestamps[:6]))
    else:
        write_euroc_stereo(str(root), seq.lefts[:6], seq.rights[:6], seq.timestamps[:6])
    save_config(_config(seq), str(tmp_path / "s.yaml"))
    Frame._next_id = 0
    out = run_slam.main([mode, str(tmp_path / "s.yaml"), str(root), "--out",
                         str(tmp_path / "traj.txt"), "--device", "cpu"])
    states = [s.name for s in out["states"]]
    assert len(states) == 6
    if mode == "stereo-kitti":
        assert states == ["OK"] * 6
        assert "rectify_ms" in out and len(out["sources"]) == 2
    else:
        assert out["slam"].sensor == "mono" and "OK" in states, states
        assert states[states.index("OK"):] == ["OK"] * (6 - states.index("OK"))


def test_cli_refuses_stereo_live_and_defaults_to_the_card():
    with pytest.raises(SystemExit, match="stereo-live"):
        run_slam.main(["stereo-live", "settings.yaml", "0", "1"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            run_slam.main(["synthetic", "--frames", "2"])


def test_euroc_gate_on_its_synthetic_layout(tmp_path):
    seq_dir = str(tmp_path / "fake_mh01")
    euroc_gate.main(["make-synthetic", seq_dir, "--frames", "12"])
    assert len(os.listdir(os.path.join(seq_dir, "mav0", "cam1", "data"))) == 12
    out = str(tmp_path / "verdict.json")
    Frame._next_id = 0
    v = euroc_gate.main(["run", os.path.join(seq_dir, "settings.yaml"), seq_dir, "--golden",
                         os.path.join(seq_dir, "groundtruth_tum.txt"), "--out", out,
                         "--device", "cpu"])
    assert v["pass"] and v["tracked_frac"] == 1.0 and v["device"] == "cpu", v
    with open(out) as f:
        assert json.load(f)["ate_rmse_m"] == v["ate_rmse_m"]
