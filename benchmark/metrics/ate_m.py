"""ATE RMSE against the generator's truth over the first ``ate_frames``
frames of the run's session (the traffic file's), read when the tracker
has handed their poses back: the same work in every run, however far the
window gets.  Aligned with SE(3), and with Sim(3) where the configuration's
sensor is mono: a mono map's scale is free (its unit is the initializer's
median scene depth), and every mono evaluation, ORB-SLAM2's included,
aligns the scale too."""
import numpy as np

from benchmark.reference.ate import umeyama_alignment


def read(run):
    with_scale = run.config["sensor"] == "mono"
    sq = []
    for ts, est, gt in run.sessions:
        if len(ts) < 3:
            continue
        p_est, p_gt = est[:, :3, 3], gt[:, :3, 3]
        s, R, t = umeyama_alignment(p_est, p_gt, with_scale)
        err = (s * (R @ p_est.T)).T + t - p_gt
        sq.extend((err ** 2).sum(1).tolist())
    return float(np.sqrt(np.mean(sq))) if sq else None
