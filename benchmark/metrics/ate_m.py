"""SE(3)-aligned ATE RMSE against the generator's truth over the first
``ate_frames`` frames of the run's session (the traffic file's), read when
the tracker has handed their poses back: the same work in every run,
however far the window gets."""
import numpy as np

from benchmark.reference.ate import umeyama_alignment


def read(run):
    sq = []
    for ts, est, gt in run.sessions:
        if len(ts) < 3:
            continue
        p_est, p_gt = est[:, :3, 3], gt[:, :3, 3]
        s, R, t = umeyama_alignment(p_est, p_gt)
        err = (s * (R @ p_est.T)).T + t - p_gt
        sq.extend((err ** 2).sum(1).tolist())
    return float(np.sqrt(np.mean(sq))) if sq else None
