"""A mono configuration added as files alone: the harness feeds it through
``SlamSystem.track_monocular``, the output check holds its initializer and
its stages, and the frames before the initialization count as failed; and
``ate_m`` aligns with Sim(3) for mono alone."""
import numpy as np
import pytest

from benchmark import harness
from benchmark.check import MONO_COUNTS
from benchmark.reference.ate import umeyama_alignment
from benchmark.tests.bench_small import install_mono, run_small


def test_mono_cell_added_as_files_runs_correct(tmp_path, monkeypatch):
    from jetson_slam_tpu_torch.models.slam import SlamSystem
    cell = install_mono(tmp_path, monkeypatch, 1e-3)
    calls = {"track_stereo": 0, "track_rgbd": 0, "track_monocular": 0}
    for name in calls:
        orig = getattr(SlamSystem, name)

        def counted(*a, name=name, orig=orig, **kw):
            calls[name] += 1
            return orig(*a, **kw)
        monkeypatch.setattr(SlamSystem, name, counted)
    r = run_small(cell)
    run = harness.LAST_RUN
    assert run.config["sensor"] == "mono"
    assert r["correct"], run.numbers
    assert all(run.numbers[k] > 0 for k in MONO_COUNTS), run.numbers
    assert run.numbers["inits_checked"] == 1
    # every frame of the window, the warm session and after the close, through
    # the one-eye facade call
    assert calls["track_stereo"] == calls["track_rgbd"] == 0
    fed = len(run.fed) + len(run.traced) + len(run.after)
    assert calls["track_monocular"] == fed + run.traffic["warm_frames"], calls
    # the frames before the initialization have no pose, and count as failed
    init_img = run.inits[0]["fe2"]["img"]
    before = [k for k, rec in enumerate(run.fed) if rec["img"] == init_img][0]
    assert before >= 1
    assert all(rec.get("t_back") is None for rec in run.fed[:before])
    assert r["failed"] == before, [(rec["img"], rec.get("t_back"), rec.get("lost"))
                                   for rec in run.fed]
    assert "ate_m" in r["metrics"]


def _sessions(est, gt):
    n = len(gt)
    return [(np.arange(n) * 0.05, est, gt)]


def _truth(n=40, seed=0):
    rng = np.random.default_rng(seed)
    gt = np.tile(np.eye(4), (n, 1, 1))
    a = np.linspace(0, 2.0, n)
    gt[:, :3, 3] = np.stack([0.6 * np.cos(a), 0.1 * np.sin(3 * a), 0.6 * np.sin(a)], 1)
    gt[:, :3, 3] += rng.normal(0, 0.01, (n, 3))
    return gt


def _run(sensor, est, gt):
    run = harness.Run({"name": "fake"}, {"sensor": sensor}, {}, 0, 1.0, False)
    run.sessions = _sessions(est, gt)
    return run


def test_ate_m_reads_se3_as_before_for_stereo_and_rgbd():
    gt = _truth()
    est = gt.copy()
    c, s = np.cos(0.2), np.sin(0.2)
    R0 = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]])
    est[:, :3, 3] = gt[:, :3, 3] @ R0.T + [0.3, -0.1, 0.05]
    est[:, :3, 3] += np.random.default_rng(1).normal(0, 0.02, (len(gt), 3))
    # the arithmetic of ate_m before the mono branch
    p_est, p_gt = est[:, :3, 3], gt[:, :3, 3]
    sc, R, t = umeyama_alignment(p_est, p_gt)
    err = (sc * (R @ p_est.T)).T + t - p_gt
    before = float(np.sqrt(np.mean((err ** 2).sum(1))))
    ate = harness.load_module("metrics", "ate_m")
    for sensor in ("stereo", "rgbd"):
        assert ate.read(_run(sensor, est, gt)) == before
    assert before > 0.01


@pytest.mark.parametrize("scale", [0.37, 4.2])
def test_ate_m_recovers_the_scale_of_a_mono_trajectory(scale):
    gt = _truth()
    est = gt.copy()
    c, s = np.cos(-0.7), np.sin(-0.7)
    R0 = np.array([[1, 0, 0], [0, c, -s], [0, s, c]])
    est[:, :3, 3] = scale * gt[:, :3, 3] @ R0.T + [1.0, 2.0, -0.5]
    ate = harness.load_module("metrics", "ate_m")
    assert ate.read(_run("mono", est, gt)) < 1e-9
    assert ate.read(_run("stereo", est, gt)) > 0.05
