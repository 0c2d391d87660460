"""The traffic generator: the cycled lap has no seam, every seed feeds the
same frames, and RGB-D frames render in one pass."""
import numpy as np

from benchmark import generator, harness
from benchmark.reference import synthetic


def _centre_step(a, b):
    return float(np.linalg.norm(a[:3, 3] - b[:3, 3]))


def _yaw(T):
    return float(np.arctan2(T[0, 2], T[0, 0]))


def test_cycled_lap_is_continuous_at_the_wrap():
    K = 64
    poses = synthetic.trajectory("circle", K)
    steps = [_centre_step(poses[k], poses[k + 1]) for k in range(K - 1)]
    wrap = _centre_step(poses[K - 1], poses[0])
    np.testing.assert_allclose(wrap, np.mean(steps), rtol=1e-9)
    dyaw = (_yaw(poses[0]) - _yaw(poses[K - 1])) % (2 * np.pi)
    np.testing.assert_allclose(dyaw, 2 * np.pi / K, rtol=1e-9)
    # no duplicate frame at the wrap
    assert wrap > 0.5 * np.mean(steps)


def _tiny(config_name, traffic_name):
    config = harness.load_json(harness.BENCH / "configs" / f"{config_name}.json")
    traffic = harness.load_json(harness.BENCH / "traffic" / f"{traffic_name}.json")
    config["settings"].update({"Camera.width": 96, "Camera.height": 64, "Camera.cx": 48.0,
                               "Camera.cy": 32.0, "Camera.fx": 90.0, "Camera.fy": 90.0})
    traffic.update(frames=5, scene_points=50)
    return config, traffic


def test_the_lap_renders_the_same_frames_every_time():
    config, traffic = _tiny("euroc_stereo", "mapping")
    a = generator.make_frames(config, traffic, workers=1)
    b = generator.make_frames(config, traffic, workers=1)
    for k in range(5):
        np.testing.assert_array_equal(b.lefts[k], a.lefts[k])
        np.testing.assert_array_equal(b.rights[k], a.rights[k])
    np.testing.assert_array_equal(a.poses_twc, synthetic.trajectory("circle", 5))


def test_rgbd_frames_render_grey_and_depth_in_one_pass():
    config, traffic = _tiny("tum_rgbd", "room")
    f = generator.make_frames(config, traffic, workers=1)
    assert f.rights is None and len(f.depths) == 5
    s = config["settings"]
    T_cw = np.linalg.inv(f.poses_twc[0])
    grey = synthetic.render(f.scene, T_cw, s["Camera.fx"], s["Camera.fy"], s["Camera.cx"],
                            s["Camera.cy"], 64, 96)
    lens = generator.lens_of(s)
    np.testing.assert_array_equal(f.lefts[0], synthetic.warp_lens(grey, lens, 1))
    assert (f.depths[0] > 0).any()
