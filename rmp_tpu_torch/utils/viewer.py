"""Interactive live viewer: the reference's PyBullet GUI, headless.

The port's `rmp_tpu/utils/viewer.py`. The reference opens PyBullet's debug
window with an orbitable camera (simulation.py:325-330); a host without a
display serves the same surface over a small standard-library HTTP server:

  * a background thread steps the env's control step on its device (a
    batch of one) in soft real time, a lock around the state,
  * GET  /          -- control page (live stream, orbit/zoom/pause),
  * GET  /stream    -- multipart/x-mixed-replace PNG stream,
  * GET  /frame.png -- one rendered frame,
  * GET  /state     -- q, q̇, goal and tick as JSON,
  * POST /camera    -- {"dyaw": deg, "dpitch": deg, "zoom": factor},
  * POST /pause, /resume, /reset -- control of the run.

Frames come from utils/render.render_frame (the native ray tracer where a
C++ compiler is there, else matplotlib); PNG encoding is zlib alone.
"""
from __future__ import annotations

import json
import struct
import threading
import time
import zlib
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import torch

from rmp_tpu_torch.utils.profiling import block


def encode_png(rgb: np.ndarray) -> bytes:
    """Encode an (H, W, 3) uint8 array as PNG (stdlib zlib, no deps)."""
    h, w, _ = rgb.shape
    raw = b"".join(b"\x00" + rgb[y].tobytes() for y in range(h))

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data)))

    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr)
            + chunk(b"IDAT", zlib.compress(raw, 6)) + chunk(b"IEND", b""))


_PAGE = """<!doctype html><html><head><title>rmp_tpu_torch viewer — {name}</title>
<style>body{{font-family:sans-serif;background:#111;color:#eee;text-align:center}}
img{{border:1px solid #444;margin:8px}}button{{margin:2px;padding:6px 10px}}</style>
</head><body><h3>{name}</h3><img src="/stream" width="{w}" height="{h}"><br>
<button onclick="cam(-15,0,1)">&#8634; yaw</button>
<button onclick="cam(15,0,1)">yaw &#8635;</button>
<button onclick="cam(0,-10,1)">pitch &#8593;</button>
<button onclick="cam(0,10,1)">pitch &#8595;</button>
<button onclick="cam(0,0,0.8)">zoom in</button>
<button onclick="cam(0,0,1.25)">zoom out</button>
<button onclick="fetch('/pause',{{method:'POST'}})">pause</button>
<button onclick="fetch('/resume',{{method:'POST'}})">resume</button>
<button onclick="fetch('/reset',{{method:'POST'}})">reset</button>
<pre id="st"></pre>
<script>
function cam(dy,dp,z){{fetch('/camera',{{method:'POST',
  body:JSON.stringify({{dyaw:dy,dpitch:dp,zoom:z}})}})}}
setInterval(async()=>{{let r=await fetch('/state');
  document.getElementById('st').textContent=JSON.stringify(await r.json());}},500);
</script></body></html>"""


class SimViewer:
    """Live viewer around an Env: sim thread + HTTP server (see module doc).

    viewer = SimViewer(envs.make("franka/06_cluttered_environment"))
    viewer.serve()            # blocking; or .start() / .stop() for embedding
    """

    def __init__(self, env, host: str = "127.0.0.1", port: int = 8777,
                 width: int = 480, height: int = 360,
                 realtime: bool = True, geometry: str = "capsule"):
        from rmp_tpu_torch import envs as envs_mod
        from rmp_tpu_torch.envs.cameras import camera_for

        self.env = env
        self.width, self.height = width, height
        self.realtime = realtime
        self.geometry = geometry      # render geometry: capsule/hull/visual
        self.camera = camera_for(env.name)
        self._step = envs_mod.make_control_step(env)
        self._params = env.gather_params()
        self._state = env.reset(1, 0)
        self.renderer: str | None = None
        self._lock = threading.Lock()
        self._paused = False
        self._running = False
        self._frame: bytes | None = None
        self._tick = 0
        self._server = ThreadingHTTPServer((host, port), self._handler())
        self._threads: list[threading.Thread] = []

    # -- sim + render loop ---------------------------------------------------

    def _render(self) -> bytes:
        from rmp_tpu_torch.envs.cameras import eye_target
        from rmp_tpu_torch.utils.render import render_frame

        with self._lock:
            state, cam = self._state, dict(self.camera)
        rgb, self.renderer = render_frame(
            self.env.model, state.sim, camera=eye_target(cam),
            geometry=self.geometry, width=self.width, height=self.height)
        return encode_png(np.asarray(rgb, np.uint8))

    def _loop(self):
        tick_dt = self.env.dt * self.env.control_every
        while self._running:
            t0 = time.perf_counter()
            if not self._paused:
                with self._lock:
                    state = self._state
                with torch.no_grad():
                    state, _ = self._step(state, self._params)
                block(state.sim.q)
                with self._lock:
                    self._state = state
                    self._tick += 1
            self._frame = self._render()
            if self.realtime:
                time.sleep(max(0.0, tick_dt - (time.perf_counter() - t0)))

    # -- HTTP ------------------------------------------------------------------

    def _handler(self):
        viewer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # quiet
                pass

            def _send(self, code, ctype, body: bytes):
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                if self.path == "/":
                    page = _PAGE.format(name=viewer.env.name,
                                        w=viewer.width, h=viewer.height)
                    self._send(200, "text/html", page.encode())
                elif self.path == "/frame.png":
                    frame = viewer._frame or viewer._render()
                    self._send(200, "image/png", frame)
                elif self.path == "/state":
                    with viewer._lock:
                        s = viewer._state
                        body = json.dumps(dict(
                            env=viewer.env.name, tick=viewer._tick,
                            paused=viewer._paused,
                            device=str(s.sim.q.device),
                            q=s.sim.q[0].cpu().numpy().tolist(),
                            qd=s.sim.qd[0].cpu().numpy().round(4).tolist(),
                            goal=(s.sim.goal[0].cpu().numpy().tolist()
                                  if s.sim.goal is not None else None),
                            goals_reached=int(s.solved_count[0]),
                            camera=viewer.camera)).encode()
                    self._send(200, "application/json", body)
                elif self.path == "/stream":
                    self.send_response(200)
                    self.send_header(
                        "Content-Type",
                        "multipart/x-mixed-replace; boundary=frame")
                    self.end_headers()
                    try:
                        while viewer._running:
                            frame = viewer._frame or viewer._render()
                            self.wfile.write(
                                b"--frame\r\nContent-Type: image/png\r\n"
                                + f"Content-Length: {len(frame)}\r\n\r\n"
                                .encode() + frame + b"\r\n")
                            time.sleep(0.05)
                    except (BrokenPipeError, ConnectionResetError):
                        pass
                else:
                    self._send(404, "text/plain", b"not found")

            def do_POST(self):
                n = int(self.headers.get("Content-Length") or 0)
                body = self.rfile.read(n) if n else b"{}"
                if self.path == "/camera":
                    try:
                        d = json.loads(body or b"{}")
                    except json.JSONDecodeError:
                        self._send(400, "text/plain", b"bad json")
                        return
                    with viewer._lock:
                        cam = viewer.camera
                        cam["yaw"] = float(cam["yaw"] + d.get("dyaw", 0.0))
                        cam["pitch"] = float(
                            np.clip(cam["pitch"] + d.get("dpitch", 0.0),
                                    -89.0, 89.0))
                        cam["distance"] = float(
                            np.clip(cam["distance"] * d.get("zoom", 1.0),
                                    0.2, 20.0))
                    self._send(200, "application/json", b'{"ok": true}')
                elif self.path == "/pause":
                    viewer._paused = True
                    self._send(200, "application/json", b'{"ok": true}')
                elif self.path == "/resume":
                    viewer._paused = False
                    self._send(200, "application/json", b'{"ok": true}')
                elif self.path == "/reset":
                    with viewer._lock:
                        viewer._state = viewer.env.reset(1, 0)
                        viewer._tick = 0
                    self._send(200, "application/json", b'{"ok": true}')
                else:
                    self._send(404, "text/plain", b"not found")

        return Handler

    # -- lifecycle ---------------------------------------------------------------

    @property
    def address(self) -> tuple[str, int]:
        return self._server.server_address[:2]

    def start(self):
        self._running = True
        for fn in (self._loop, self._server.serve_forever):
            t = threading.Thread(target=fn, daemon=True)
            t.start()
            self._threads.append(t)
        return self

    def stop(self):
        self._running = False
        self._server.shutdown()
        self._server.server_close()

    def serve(self):
        host, port = self.address
        print(f"rmp_tpu_torch viewer: http://{host}:{port}/  (ctrl-c to "
              f"stop)")
        self.start()
        try:
            while True:
                time.sleep(1.0)
        except KeyboardInterrupt:
            self.stop()
