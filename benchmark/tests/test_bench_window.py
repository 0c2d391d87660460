"""The window's arithmetic on a fake session: a stall moves frames_per_s
and pose_ms_p95, pipelined frames are matched to the call that handed
back their pose by timestamp, the lap cycles with rising timestamps, and
ate_m reads the same first frames however far the window gets."""
import time
import types

import numpy as np

from benchmark import generator, harness


class FakeTracker:
    def __init__(self, depth, stall_at=None, stall_s=0.0, step_s=0.005):
        self.trajectory = []
        self.inflight = []
        self.depth, self.stall_at, self.stall_s, self.step_s = depth, stall_at, stall_s, step_s
        self.calls = 0
        self.fused_step = types.SimpleNamespace(replays=0)

    def _finish(self):
        ts = self.inflight.pop(0)
        self.trajectory.append((ts, np.eye(4), -1, False, None, 0))

    def track(self, ts):
        self.calls += 1
        time.sleep(self.step_s + (self.stall_s if self.calls == self.stall_at else 0.0))
        self.inflight.append(ts)
        while len(self.inflight) > self.depth:
            self._finish()

    def flush_pipeline(self):
        while self.inflight:
            self._finish()


class FakeSlam:
    def __init__(self, tracker):
        self.tracker = tracker
        self.map = types.SimpleNamespace(n_keyframes=lambda: 0)

    def track_stereo(self, left, right, ts):
        self.tracker.track(ts)


def _frames(n=8):
    img = np.zeros((4, 4), np.uint8)
    return generator.Frames([img] * n, [img] * n, None,
                            np.stack([np.eye(4)] * n), None, 0.05)


def _window(tracker, seconds=1.0, ate_frames=4):
    run = harness.Run({"name": "fake"}, {"sensor": "stereo"}, {}, 0, seconds, False)
    harness.drive(run, FakeSlam(tracker), _frames(), {"frames": 8, "ate_frames": ate_frames},
                  seconds)
    fps = harness.load_module("metrics", "frames_per_s").read(run)
    p95 = harness.load_module("metrics", "pose_ms_p95").read(run)
    return run, fps, p95


def test_a_stall_moves_rate_and_tail():
    _, fps0, p95_0 = _window(FakeTracker(0))
    _, fps1, p95_1 = _window(FakeTracker(0, stall_at=20, stall_s=0.4))
    assert fps1 < 0.8 * fps0
    # one stalled frame in ~120: the tail of a single frame moves p95 only
    # when it is wide enough; a stall of every 10th frame does
    run, fps2, p95_2 = _window(FakeTracker(0, stall_at=None))
    t = FakeTracker(0)
    orig = t.track

    def slow(ts):
        orig(ts)
        if t.calls % 10 == 0:
            time.sleep(0.05)
    t.track = slow
    _, fps3, p95_3 = _window(t)
    assert p95_3 > 5 * p95_0
    assert fps3 < fps0


def test_pipelined_frames_match_their_return_by_timestamp():
    run, _, _ = _window(FakeTracker(2), seconds=0.5)
    fed = run.fed
    assert all(r.get("t_back") is not None for r in fed)
    # frame k comes back in the call that fed frame k + 2
    for k in range(len(fed) - 2):
        assert fed[k]["t_back"] >= fed[k + 2]["t_fed"]
        assert fed[k]["t_back"] < fed[k + 2]["t_fed"] + 0.004 + 0.005 + 0.05
    lat = run.latencies_ms()
    # three calls of 5 ms each from feeding to the return, but for the
    # two frames still in flight at the close, which the flush hands back
    assert min(lat[:-2]) > 3 * 5.0 * 0.9
    assert max(lat[-2:]) < 3 * 5.0


def test_the_lap_cycles_with_rising_timestamps():
    run, _, _ = _window(FakeTracker(2), seconds=0.3)
    imgs = [r["img"] for r in run.fed]
    assert len(imgs) > 16
    assert imgs == [k % 8 for k in range(len(imgs))]
    ts = [r["ts"] for r in run.fed]
    assert all(b > a for a, b in zip(ts, ts[1:]))
    np.testing.assert_allclose(np.diff(ts), 0.05, atol=1e-6)


def test_ate_reads_the_same_first_frames_however_far_the_window_gets():
    fast, _, _ = _window(FakeTracker(2, step_s=0.002), seconds=0.3, ate_frames=12)
    slow, _, _ = _window(FakeTracker(2, step_s=0.05), seconds=0.3, ate_frames=12)
    assert len(fast.sessions) == len(slow.sessions) == 1
    np.testing.assert_array_equal(fast.sessions[0][0], slow.sessions[0][0])
    assert len(fast.sessions[0][0]) == 12
    # the slow run ended its window before 12 poses were back: the frames
    # after the close were fed until they were, outside the window
    assert len(slow.fed) < 12 and slow.after and not fast.after
