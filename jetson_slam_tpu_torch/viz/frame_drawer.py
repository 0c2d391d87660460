"""FrameDrawer: annotated camera-frame rendering.

Port of ``jetson_slam_tpu/viz/frame_drawer.py``.  Headless replacement for
the reference's Pangolin-backed FrameDrawer (src/FrameDrawer.cpp:1-254):
draws keypoints (green squares = map-point matches, blue = visual-odometry
only, reference DrawFrame color scheme) at their raw positions
(``Frame.kp_xy_raw``, so the boxes sit on the corners of the raw,
distorted image), the NMS-G tile grid (the reference overlays
tile_h_/tile_w_, FrameDrawer.h:53-55 set from Tracking.cpp:219-220), and a
status line with tracking state / keyframe / map sizes.  Output is an RGB
uint8 array, drawn with Pillow (imported at the first draw; no GUI), for
viz.Viewer's PNG dumps, the live viewer or notebook display.
"""
from __future__ import annotations

import numpy as np

GREEN = (40, 220, 60)
BLUE = (70, 120, 255)
RED = (230, 60, 40)
GRID = (70, 70, 70)
TEXT = (255, 255, 40)


class FrameDrawer:
    def __init__(self, tile_h: int = 30, tile_w: int = 30, draw_grid=True):
        self.tile_h = tile_h
        self.tile_w = tile_w
        self.draw_grid = draw_grid

    def draw(self, gray_img, frame=None, state_name: str = "",
             n_map: int = 0, n_kfs: int = 0, n_pts: int = 0) -> np.ndarray:
        """gray_img: (H, W) uint8; frame: core.frame.Frame or None.
        Returns (H+20, W, 3) uint8 RGB with an info bar at the bottom."""
        from PIL import Image, ImageDraw

        g = np.asarray(gray_img, np.uint8)
        H, W = g.shape
        rgb = np.repeat(g[:, :, None], 3, axis=2)
        im = Image.fromarray(rgb).convert("RGB")
        dr = ImageDraw.Draw(im)

        if self.draw_grid:
            for y in range(0, H, self.tile_h):
                dr.line([(0, y), (W - 1, y)], fill=GRID, width=1)
            for x in range(0, W, self.tile_w):
                dr.line([(x, 0), (x, H - 1)], fill=GRID, width=1)

        n_tracked = n_vo = 0
        if frame is not None:
            valid = np.asarray(frame.valid)
            xy = np.asarray(frame.kp_xy_raw)
            mp = np.asarray(frame.map_points)
            out = np.asarray(frame.outlier)
            for s in np.flatnonzero(valid):
                x, y = float(xy[s, 0]), float(xy[s, 1])
                r = 3
                if mp[s] >= 0 and not out[s]:
                    color = GREEN
                    n_tracked += 1
                elif mp[s] >= 0:
                    color = RED
                else:
                    color = BLUE
                    n_vo += 1
                dr.rectangle([x - r, y - r, x + r, y + r], outline=color)

        # bottom info bar (reference DrawTextInfo)
        bar = Image.new("RGB", (W, 20), (20, 20, 20))
        bd = ImageDraw.Draw(bar)
        txt = (f"{state_name}  KFs: {n_kfs}  MPs: {n_pts}  "
               f"matches: {n_tracked}  kps: {n_vo + n_tracked}")
        bd.text((4, 4), txt, fill=TEXT)
        canvas = Image.new("RGB", (W, H + 20))
        canvas.paste(im, (0, 0))
        canvas.paste(bar, (0, H))
        return np.asarray(canvas)
