"""Live interactive viewer: a browser UI over a running SLAM session.

Port of ``jetson_slam_tpu/viz/live_server.py``.  The reference runs a
Pangolin GUI on its own thread with follow-camera and a localization-mode
menu (src/Viewer.cpp:58-180, include/Viewer.h:43-57).  A server with a
card has no display stack, so the interactive surface here is a tiny
stdlib HTTP server on a daemon thread:

- `/`            one-page UI: live annotated frame + 3D map side by side,
                 auto-refreshing at the configured rate, with the
                 reference's menu as buttons (localization mode on/off,
                 follow camera, top-down/free view, reset);
- `/frame.png` `/map.png`  latest renders (PNG, ``io/png.py``; rendered on
                 the tracking thread at most every `min_period` seconds);
- `/stats.json`  state, frame counter, keyframe/point counts, fps;
- `POST /control?localization=1|0&follow=1|0&topdown=1|0&reset=1`.

The HTTP thread never touches the session: ``control`` records a reset or
a localization-mode request, and the next ``update`` applies it on the
tracking thread, between two frames (the reference's Viewer sets flags
that Tracking reads).  Follow and top-down only change the renders.

Usage:
    viewer = LiveViewer(slam, port=8765)      # starts serving immediately
    ... per frame: viewer.update(slam, gray_img, frame)
    viewer.close()

``python -m jetson_slam_tpu_torch.cli.run_slam ... --live-viewer PORT``
wires it into every dataset mode.
"""
from __future__ import annotations

import json
import threading
import time

import numpy as np

from ..io import png
from .frame_drawer import FrameDrawer
from .map_drawer import MapDrawer

_PAGE = """<!doctype html>
<html><head><title>jetson_slam_tpu_torch live</title>
<style>
 body { background:#14151a; color:#e8e8e8; font-family:system-ui,sans-serif;
        margin:16px; }
 img { image-rendering:pixelated; border:1px solid #333; max-width:48vw; }
 button { margin:2px 6px 2px 0; padding:6px 10px; background:#26272e;
          color:#e8e8e8; border:1px solid #444; border-radius:4px;
          cursor:pointer; }
 button.on { background:#2d5ba9; }
 #stats { color:#9aa0a6; margin:8px 0; font-size:14px; }
</style></head><body>
<h3>jetson_slam_tpu_torch &mdash; live session</h3>
<div id="stats">connecting&hellip;</div>
<div>
 <button id="loc" onclick="toggle('localization')">localization mode</button>
 <button id="follow" class="on" onclick="toggle('follow')">follow camera</button>
 <button id="topdown" onclick="toggle('topdown')">top-down</button>
 <button onclick="fetch('/control?reset=1',{method:'POST'})">reset</button>
</div>
<p><img id="frame" src="/frame.png"> <img id="map" src="/map.png"></p>
<script>
 const S = {localization:false, follow:true, topdown:false};
 function toggle(k){ S[k]=!S[k];
   document.getElementById(k=='localization'?'loc':k).classList.toggle('on',S[k]);
   fetch('/control?'+k+'='+(S[k]?1:0), {method:'POST'}); }
 setInterval(()=>{
   document.getElementById('frame').src='/frame.png?t='+Date.now();
   document.getElementById('map').src='/map.png?t='+Date.now();
   fetch('/stats.json').then(r=>r.json()).then(s=>{
     document.getElementById('stats').textContent =
       `state ${s.state}  frame ${s.frame}  ${s.fps.toFixed(1)} fps  ` +
       `${s.keyframes} KFs  ${s.points} pts  loops ${s.loops}`;
   });
 }, %REFRESH%);
</script></body></html>"""


class LiveViewer:
    """Serve a live, interactive view of a running SlamSystem."""

    def __init__(self, slam, port: int = 8765, host: str = "127.0.0.1",
                 tile_h: int = 30, tile_w: int = 30,
                 refresh_ms: int = 500, min_period: float = 0.2):
        self.slam = slam
        self.frame_drawer = FrameDrawer(tile_h, tile_w)
        self.map_drawer = MapDrawer()
        self.follow = True
        self.min_period = float(min_period)
        self._lock = threading.Lock()
        self._latest = None          # (gray_img, frame) from the tracker
        self._requests = {}          # control requests for the next update
        self._frame_png = _blank_png()
        self._map_png = _blank_png()
        self._count = 0
        self._last_render = 0.0
        self._t_frames = []
        self._server = _make_server(self, host, port, refresh_ms)
        self.port = self._server.server_address[1]
        self._thread = threading.Thread(
            target=self._server.serve_forever, daemon=True,
            name="live-viewer")
        self._thread.start()

    # ------------------------------------------------------------ tracker
    def update(self, slam, gray_img, frame) -> None:
        """Per tracked frame, on the tracking thread: applies the control
        requests that came since the last call, then records the frame;
        O(1) unless a render is due (rate-limited)."""
        self._apply_requests()
        now = time.perf_counter()
        with self._lock:
            self._latest = (np.asarray(gray_img), frame)
            self._count += 1
            self._t_frames.append(now)
            if len(self._t_frames) > 60:
                self._t_frames = self._t_frames[-60:]
        if now - self._last_render >= self.min_period:
            self._render()

    def _render(self):
        with self._lock:
            latest = self._latest
        if latest is None:
            return
        gray, frame = latest
        slam = self.slam
        state = slam.get_tracking_state()
        fimg = self.frame_drawer.draw(
            gray, frame, state_name=getattr(state, "name", str(state)),
            n_kfs=slam.map.n_keyframes(), n_pts=slam.map.n_points())
        # trajectory WITHOUT flushing the tracking pipeline: render the
        # tracker's raw pose chain (loop corrections land on refresh)
        traj = None
        tr = [e[1] for e in slam.tracker.trajectory[-2000:] if not e[3]]
        if len(tr) > 1:
            traj = np.array([np.linalg.inv(T) for T in tr])
        cur = frame.Tcw if frame is not None and frame.pose_set else None
        mimg = self.map_drawer.draw(slam.map, current_Tcw=cur if self.follow
                                    else None, trajectory=traj)
        with self._lock:
            self._frame_png = _to_png(fimg)
            self._map_png = _to_png(mimg)
            self._last_render = time.perf_counter()

    # ------------------------------------------------------------- server
    def stats(self) -> dict:
        with self._lock:
            ts = list(self._t_frames)
            count = self._count
        fps = 0.0
        if len(ts) > 1:
            span = ts[-1] - ts[0]
            fps = (len(ts) - 1) / span if span > 0 else 0.0
        slam = self.slam
        state = slam.get_tracking_state()
        lc = slam.loop_closer
        return {
            "state": getattr(state, "name", str(state)),
            "frame": count,
            "fps": fps,
            "keyframes": int(slam.map.n_keyframes()),
            "points": int(slam.map.n_points()),
            "loops": int(lc.n_loops_closed) if lc is not None else 0,
        }

    def control(self, q: dict):
        """A control request from the page (the HTTP thread).  Follow and
        top-down change the renders at once; a reset and the localization
        mode are recorded for the next ``update``."""
        if "follow" in q:
            self.follow = q["follow"] == "1"
        if "topdown" in q:
            self.map_drawer.top_down = q["topdown"] == "1"
        with self._lock:
            if "localization" in q:
                self._requests["localization"] = q["localization"] == "1"
            if q.get("reset") == "1":
                self._requests["reset"] = True

    def _apply_requests(self):
        with self._lock:
            req, self._requests = self._requests, {}
        if req.get("reset"):
            self.slam.reset()
        if "localization" in req:
            if req["localization"]:
                self.slam.activate_localization_mode()
            else:
                self.slam.deactivate_localization_mode()

    def close(self):
        self._server.shutdown()
        self._server.server_close()


def _blank_png():
    return _to_png(np.zeros((24, 32, 3), np.uint8))


def _to_png(rgb: np.ndarray) -> bytes:
    return png.encode(rgb, level=1)


def _make_server(viewer: LiveViewer, host: str, port: int, refresh_ms: int):
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
    from urllib.parse import parse_qsl, urlparse

    page = _PAGE.replace("%REFRESH%", str(int(refresh_ms))).encode()

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):  # silent
            pass

        def _send(self, body, ctype):
            self.send_response(200)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.send_header("Cache-Control", "no-store")
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            path = urlparse(self.path).path
            if path == "/":
                self._send(page, "text/html")
            elif path == "/frame.png":
                with viewer._lock:
                    body = viewer._frame_png
                self._send(body, "image/png")
            elif path == "/map.png":
                with viewer._lock:
                    body = viewer._map_png
                self._send(body, "image/png")
            elif path == "/stats.json":
                self._send(json.dumps(viewer.stats()).encode(),
                           "application/json")
            else:
                self.send_error(404)

        def do_POST(self):
            u = urlparse(self.path)
            if u.path == "/control":
                viewer.control(dict(parse_qsl(u.query)))
                self._send(b"{}", "application/json")
            else:
                self.send_error(404)

    return ThreadingHTTPServer((host, port), Handler)
