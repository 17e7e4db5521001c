"""Interactive web viewer — port of cednerf_tpu/viewer/server.py.

Serves the same single-page app (orbit camera, time scrubber, max-samples
slider, depth toggle, view snapping): the browser posts
{c2w, time, depth, max_samples, width} to /render and the server renders
through make_eval_render_fn (the segment eval renderer for uniform-step
configs, the lattice marcher for cone-angle ones such as the HyperNeRF and
DyNeRF presets) at eval_chunk_for's chunk, and replies with a PNG encoded
by the standard library (utils/image.py).

Usage:
    server = ViewerServer(field, occ_state, cfg, train_poses=..., K=...,
                          wh=(w, h))
    server.serve(port=8890)   # blocking; or .start() for a daemon thread
"""

import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional, Tuple

import numpy as np

from ..datasets.rays import pinhole_rays
from ..engine.renderer import eval_chunk_for, make_eval_render_fn, render_image
from ..utils.image import encode_png
from ..utils.metrics import depth_to_img

_PAGE = """<!DOCTYPE html>
<html><head><title>cednerf_torch viewer</title><style>
body { margin:0; background:#111; color:#ddd; font-family:monospace; }
#bar { padding:6px; } #bar * { margin-right: 10px; }
canvas { display:block; margin:auto; image-rendering:pixelated; }
input[type=range] { vertical-align: middle; }
</style></head><body>
<div id="bar">
  <span id="stats">-</span>
  <label>t <input type="range" id="time" min="0" max="1" step="0.01" value="0"></label>
  <button id="play">play</button>
  <label>samples <input type="range" id="msamp" min="32" max="512" step="32" value="128"></label>
  <label><input type="checkbox" id="depth"> depth</label>
  <button id="snap">snap view</button>
  <span>drag = orbit, shift-drag = pan, wheel = zoom</span>
</div>
<canvas id="cv" width="400" height="400"></canvas>
<script>
let radius = 4.0, theta = 0.0, phi = 0.6, center = [0,0,0];
let playing = false, busy = false, pending = false;
const cv = document.getElementById('cv'), ctx2d = cv.getContext('2d');
function c2w() {
  const cx = center, r = radius;
  const pos = [cx[0] + r*Math.cos(phi)*Math.cos(theta),
               cx[1] + r*Math.cos(phi)*Math.sin(theta),
               cx[2] + r*Math.sin(phi)];
  let z = [pos[0]-cx[0], pos[1]-cx[1], pos[2]-cx[2]];
  const zn = Math.hypot(...z); z = z.map(v=>v/zn);
  const up = [0,0,1];
  let x = [up[1]*z[2]-up[2]*z[1], up[2]*z[0]-up[0]*z[2], up[0]*z[1]-up[1]*z[0]];
  const xn = Math.hypot(...x); x = x.map(v=>v/xn);
  const y = [z[1]*x[2]-z[2]*x[1], z[2]*x[0]-z[0]*x[2], z[0]*x[1]-z[1]*x[0]];
  return [x[0],y[0],z[0],pos[0], x[1],y[1],z[1],pos[1], x[2],y[2],z[2],pos[2]];
}
async function render(preview) {
  if (busy) { pending = preview ? 'p' : 'f'; return; }
  busy = true;
  const w = preview ? Math.max(cv.width >> 1, 64) : cv.width;
  const body = JSON.stringify({
    c2w: c2w(), time: parseFloat(document.getElementById('time').value),
    depth: document.getElementById('depth').checked,
    max_samples: parseInt(document.getElementById('msamp').value),
    width: w });
  const t0 = performance.now();
  const resp = await fetch('/render', {method:'POST', body});
  const blob = await resp.blob();
  const img = await createImageBitmap(blob);
  ctx2d.drawImage(img, 0, 0, cv.width, cv.height);
  document.getElementById('stats').textContent =
      (performance.now()-t0).toFixed(0) + ' ms/frame' +
      (preview ? ' (preview)' : '');
  busy = false;
  if (pending) { const p = pending === 'p'; pending = false; render(p); }
}
let refineTimer = null;
function interact() {
  render(true);
  clearTimeout(refineTimer);
  refineTimer = setTimeout(() => render(false), 300);
}
let drag = null;
cv.onmousedown = e => drag = [e.clientX, e.clientY, e.shiftKey];
window.onmouseup = () => drag = null;
window.onmousemove = e => {
  if (!drag) return;
  const dx = e.clientX - drag[0], dy = e.clientY - drag[1];
  if (drag[2]) { center[0] -= dx*0.003*radius; center[2] += dy*0.003*radius; }
  else { theta -= dx*0.01; phi = Math.min(1.5, Math.max(-1.5, phi + dy*0.01)); }
  drag = [e.clientX, e.clientY, drag[2]];
  interact();
};
cv.onwheel = e => { e.preventDefault(); radius *= Math.exp(e.deltaY*0.001); interact(); };
document.getElementById('time').oninput = interact;
document.getElementById('msamp').oninput = interact;
document.getElementById('depth').oninput = interact;
document.getElementById('play').onclick = () => {
  playing = !playing;
  document.getElementById('play').textContent = playing ? 'pause' : 'play';
};
document.getElementById('snap').onclick = async () => {
  const r = await fetch('/snap'); const p = await r.json();
  radius = p.radius; theta = p.theta; phi = p.phi; center = p.center;
  render(false);
};
setInterval(() => {
  if (!playing) return;
  const t = document.getElementById('time');
  t.value = (parseFloat(t.value) + 0.02) % 1.0;
  interact();
}, 100);
render(false);
</script></body></html>"""


class ViewerServer:
    """Serves the viewer page and renders frames of `field` (on whatever
    device the field lives) with the occupancy grid `occ_state`.

    Frames render one at a time (a lock serializes concurrent requests: the
    card renders one frame at a full chunk budget anyway). `last_frame`
    holds the latest frame's stats: ms, passes per chunk, finite flag.
    render_bkgd defaults to black for every family, as in the JAX
    ViewerServer (the HyperNeRF and DyNeRF families' own background)."""

    def __init__(self, field, occ_state, cfg, *,
                 train_poses: Optional[np.ndarray] = None,
                 K: Optional[np.ndarray] = None,
                 wh: Tuple[int, int] = (400, 400), render_bkgd=None):
        self.field = field
        self.occ = occ_state
        self.cfg = cfg
        self.train_poses = train_poses
        self.base_wh = wh
        self._snap_idx = 0
        self._render_fns = {}
        self._lock = threading.Lock()
        self.last_frame = None
        self.render_bkgd = (np.zeros(3, np.float32) if render_bkgd is None
                            else np.asarray(render_bkgd, np.float32))
        if K is None:  # fallback intrinsics: 50deg fov
            f = wh[0] * 1.1
            K = np.array([[f, 0, wh[0] / 2], [0, f, wh[1] / 2], [0, 0, 1]])
        self.K = np.asarray(K, np.float32)

    def _render_fn(self, s_max: int):
        if s_max not in self._render_fns:
            self._render_fns[s_max] = make_eval_render_fn(self.field, self.cfg,
                                                          s_max=s_max)
        return self._render_fns[s_max]

    def render_frame(self, c2w: np.ndarray, t: float, width: int,
                     max_samples: int, depth_view: bool) -> np.ndarray:
        """Render one viewer frame -> uint8 [H, W, 3] (gui.py render_frame)."""
        w = h = int(width)
        scale = w / self.base_wh[0]
        K = self.K.copy()
        K[:2] *= scale
        x, yy = np.meshgrid(np.arange(w, dtype=np.float32),
                            np.arange(h, dtype=np.float32), indexing="xy")
        origins, viewdirs, _ = pinhole_rays(
            x.reshape(-1), yy.reshape(-1), K,
            np.broadcast_to(c2w.astype(np.float32), (w * h, 3, 4)), True)
        with self._lock:
            fn = self._render_fn(max_samples)
            n_log = len(fn.pass_log)
            t0 = time.perf_counter()
            rgb, opac, dep = render_image(
                self.field, self.occ, fn, origins.reshape(h, w, 3),
                viewdirs.reshape(h, w, 3), float(t), self.render_bkgd,
                chunk=eval_chunk_for(self.cfg))
            self.last_frame = {
                "ms": (time.perf_counter() - t0) * 1e3,
                "width": w, "max_samples": int(max_samples),
                "passes_per_chunk": fn.pass_log[n_log:],
                "finite": bool(np.isfinite(rgb).all()
                               and np.isfinite(dep).all()),
            }
        if depth_view:
            return depth_to_img(dep[..., 0])
        return (np.clip(rgb, 0, 1) * 255).astype(np.uint8)

    def _snap(self) -> dict:
        """Orbit parameters matching the next train pose (view snap)."""
        if self.train_poses is None:
            return {"radius": 4.0, "theta": 0.0, "phi": 0.6,
                    "center": [0, 0, 0]}
        pose = np.asarray(self.train_poses)[
            self._snap_idx % len(self.train_poses)]
        self._snap_idx += 1
        pos = pose[:3, 3]
        radius = float(np.linalg.norm(pos))
        theta = float(np.arctan2(pos[1], pos[0]))
        phi = float(np.arcsin(np.clip(pos[2] / max(radius, 1e-6), -1, 1)))
        return {"radius": radius, "theta": theta, "phi": phi,
                "center": [0, 0, 0]}

    def _handler(self):
        server = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *args):
                pass

            def _reply(self, body: bytes, ctype: str):
                self.send_response(200)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                if self.path == "/snap":
                    self._reply(json.dumps(server._snap()).encode(),
                                "application/json")
                else:
                    self._reply(_PAGE.encode(), "text/html")

            def do_POST(self):
                n = int(self.headers.get("Content-Length", 0))
                req = json.loads(self.rfile.read(n))
                c2w = np.asarray(req["c2w"], np.float32).reshape(3, 4)
                img = server.render_frame(
                    c2w, float(req.get("time", 0.0)),
                    int(req.get("width", 400)),
                    int(req.get("max_samples", 128)),
                    bool(req.get("depth", False)))
                self._reply(encode_png(img), "image/png")

        return Handler

    def start(self, port: int = 8890,
              host: str = "0.0.0.0") -> ThreadingHTTPServer:
        """Serve from a daemon thread; call .shutdown() on the result."""
        httpd = ThreadingHTTPServer((host, port), self._handler())
        threading.Thread(target=httpd.serve_forever, daemon=True).start()
        return httpd

    def serve(self, port: int = 8890, host: str = "0.0.0.0"):
        print(f"viewer: http://localhost:{port}/")
        ThreadingHTTPServer((host, port), self._handler()).serve_forever()
