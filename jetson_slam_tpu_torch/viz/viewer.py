"""Viewer: per-frame visualization orchestrator.

Port of ``jetson_slam_tpu/viz/viewer.py``.  Headless replacement for the
reference's Pangolin Viewer thread (src/Viewer.cpp:1-242: Run loop polling
FrameDrawer/MapDrawer at mT ms): the viewer renders the annotated frame
and the 3D map every ``every`` frames and writes PNGs into an output
directory (``io/png.py``) or hands them to a user callback.  Menu toggles
(follow camera, show points/KFs/graph, Viewer.cpp:120-135) map to
constructor flags.
"""
from __future__ import annotations

import os

import numpy as np

from ..io import png
from .frame_drawer import FrameDrawer
from .map_drawer import MapDrawer


class Viewer:
    def __init__(self, out_dir: str | None = None, every: int = 10,
                 tile_h: int = 30, tile_w: int = 30, top_down=False,
                 show_points=True, show_graph=True, callback=None):
        self.out_dir = out_dir
        if out_dir:
            os.makedirs(out_dir, exist_ok=True)
        self.every = max(1, int(every))
        self.frame_drawer = FrameDrawer(tile_h, tile_w)
        self.map_drawer = MapDrawer(top_down=top_down)
        self.show_points = show_points
        self.show_graph = show_graph
        self.callback = callback
        self._count = 0

    def update(self, slam, gray_img, frame) -> None:
        """Call once per tracked frame (SlamSystem, raw grey image, Frame)."""
        i = self._count
        self._count += 1
        if i % self.every:
            return
        state = slam.get_tracking_state()
        frame_img = self.frame_drawer.draw(
            gray_img, frame, state_name=getattr(state, "name", str(state)),
            n_kfs=slam.map.n_keyframes(), n_pts=slam.map.n_points())
        _, poses = slam.camera_trajectory()
        traj = np.asarray(poses) if len(poses) > 1 else None
        map_img = self.map_drawer.draw(
            slam.map, current_Tcw=frame.Tcw if frame is not None else None,
            trajectory=traj, show_covisibility=self.show_graph)
        if self.callback is not None:
            self.callback(i, frame_img, map_img)
        if self.out_dir:
            png.write(os.path.join(self.out_dir, f"frame_{i:06d}.png"), frame_img)
            png.write(os.path.join(self.out_dir, f"map_{i:06d}.png"), map_img)
