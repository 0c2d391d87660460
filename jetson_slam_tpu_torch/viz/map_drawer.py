"""MapDrawer: 3D map + trajectory rendering.

Port of ``jetson_slam_tpu/viz/map_drawer.py``.  Headless replacement for
the reference's Pangolin MapDrawer (src/MapDrawer.cpp:1-270: DrawMapPoints,
DrawKeyFrames, DrawCurrentCamera, covisibility-graph lines).  Renders map
points, keyframe frusta, the covisibility graph, and the current camera
into a matplotlib 3D (or top-down) figure and returns an RGB array; no GUI
event loop.  matplotlib is imported at the first draw.
"""
from __future__ import annotations

import numpy as np


def _frustum_lines(Twc, scale=0.1):
    """Camera frustum wireframe segments in world coords (MapDrawer's
    DrawCurrentCamera geometry)."""
    w, h, z = 1.0 * scale, 0.75 * scale, 0.6 * scale
    pts_c = np.array([
        [0, 0, 0], [w, h, z], [w, -h, z], [-w, -h, z], [-w, h, z]],
        np.float32)
    R, t = Twc[:3, :3], Twc[:3, 3]
    pts = (R @ pts_c.T).T + t
    segs = [(0, 1), (0, 2), (0, 3), (0, 4), (1, 2), (2, 3), (3, 4), (4, 1)]
    return [(pts[a], pts[b]) for a, b in segs]


class MapDrawer:
    def __init__(self, point_size=1.0, camera_size=0.08, top_down=False):
        self.point_size = point_size
        self.camera_size = camera_size
        self.top_down = top_down

    def draw(self, map_store, current_Tcw=None, trajectory=None,
             figsize=(8, 6), show_covisibility=True) -> np.ndarray:
        """map_store: core.map.MapStore; current_Tcw: (4,4) or None;
        trajectory: optional (N, 4, 4) Twc list.  Returns RGB uint8 array."""
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        fig = plt.figure(figsize=figsize, dpi=100)
        if self.top_down:
            ax = fig.add_subplot(111)
        else:
            ax = fig.add_subplot(111, projection="3d")

        def plot_pts(P, **kw):
            if self.top_down:
                ax.scatter(P[:, 0], P[:, 2], **kw)
            else:
                ax.scatter(P[:, 0], P[:, 2], -P[:, 1], **kw)

        def plot_seg(a, b, **kw):
            if self.top_down:
                ax.plot([a[0], b[0]], [a[2], b[2]], **kw)
            else:
                ax.plot([a[0], b[0]], [a[2], b[2]], [-a[1], -b[1]], **kw)

        pts = map_store.pt_pos[map_store.pt_alive]
        if len(pts):
            plot_pts(pts, s=self.point_size, c="k", alpha=0.4, linewidths=0)

        kf_ids = map_store.keyframe_ids()
        centers = {}
        for k in kf_ids:
            Twc = np.eye(4, dtype=np.float32)
            R = map_store.kf_pose[k, :3, :3]
            t = map_store.kf_pose[k, :3, 3]
            Twc[:3, :3] = R.T
            Twc[:3, 3] = -R.T @ t
            centers[k] = Twc[:3, 3]
            for a, b in _frustum_lines(Twc, self.camera_size):
                plot_seg(a, b, c="b", lw=0.6)

        if show_covisibility and len(kf_ids) > 1:
            # covisibility graph lines (MapDrawer::DrawKeyFrames graph pass)
            for k in kf_ids:
                ids, w = map_store.covisible_keyframes(k, min_weight=100)
                for j in ids:
                    if j > k:
                        plot_seg(centers[k], centers[j], c="g", lw=0.5,
                                 alpha=0.6)

        if trajectory is not None and len(trajectory) > 1:
            T = np.asarray(trajectory)
            c = T[:, :3, 3]
            if self.top_down:
                ax.plot(c[:, 0], c[:, 2], c="r", lw=1.0)
            else:
                ax.plot(c[:, 0], c[:, 2], -c[:, 1], c="r", lw=1.0)

        if current_Tcw is not None:
            Tcw = np.asarray(current_Tcw)
            Twc = np.eye(4, dtype=np.float32)
            Twc[:3, :3] = Tcw[:3, :3].T
            Twc[:3, 3] = -Tcw[:3, :3].T @ Tcw[:3, 3]
            for a, b in _frustum_lines(Twc, self.camera_size * 1.6):
                plot_seg(a, b, c="r", lw=1.2)

        ax.set_xlabel("x")
        ax.set_ylabel("z")
        if self.top_down:
            ax.set_aspect("equal")
        fig.tight_layout()
        fig.canvas.draw()
        buf = np.asarray(fig.canvas.buffer_rgba())[:, :, :3].copy()
        plt.close(fig)
        return buf
