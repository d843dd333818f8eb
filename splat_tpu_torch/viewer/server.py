"""Interactive viewer: a local HTTP server that renders a frame per pose
request (port of ``splat_tpu.viewer.server``).

The counterpart of the reference's window and arrow-key loop
(src/main.rs:41-80) for a headless host: the page sends pose updates (arrow
keys = +-10 degrees of yaw/pitch like the reference, R = reset, drag to
orbit, wheel to dolly, M = colour/depth, T = raw/PNG transport, -/+ = the
0.5/1.0/2.0 resolution ladder) and draws the frames it gets back.  Frames
are rendered one at a time behind a lock, on the scene's device, inside
``torch.inference_mode()``.

:func:`make_server` builds the server; :func:`serve` runs it until Ctrl-C.
Standard library only on the host side.
"""

from __future__ import annotations

import dataclasses
import math
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

import numpy as np
import torch

_PAGE = """<!doctype html>
<html><head><title>splat_tpu viewer</title><style>
 body { margin:0; background:#111; color:#ccc; font:13px monospace; }
 #hud { position:fixed; top:8px; left:8px; background:#000a; padding:6px 10px;
        border-radius:4px; white-space:pre; }
 canvas { display:block; margin:0 auto; image-rendering:pixelated; }
</style></head>
<body>
<div id="hud">loading…</div>
<canvas id="view" width="__W__" height="__H__"></canvas>
<script>
let yaw = 0, pitch = 0, dist = 1.0, busy = false, dirty = true, t0 = 0;
let mode = '__MODE__', transport = '__TRANSPORT__';
const SCALES = [0.5, 1.0, 2.0];   // live resolution ladder ('-'/'+')
let scaleIdx = 1;
const hud = document.getElementById('hud');
const cv = document.getElementById('view');
const ctx = cv.getContext('2d');
function fit(w, h) {
  if (cv.width !== w || cv.height !== h) { cv.width = w; cv.height = h; }
}
async function tick() {
  if (dirty && !busy) {
    busy = true; dirty = false; t0 = performance.now();
    const q = `yaw=${yaw}&pitch=${pitch}&dist=${dist}&mode=${mode}` +
              `&scale=${SCALES[scaleIdx]}&t=${Date.now()}`;
    let overflow = 0;
    try {
      if (transport === 'raw') {
        // raw RGBA straight into the canvas: no PNG encode server-side
        // and no decode here
        const r = await fetch('/frame.raw?' + q);
        overflow = parseInt(r.headers.get('X-Splat-Overflow') || '0');
        const w = parseInt(r.headers.get('X-Splat-W'));
        const h = parseInt(r.headers.get('X-Splat-H'));
        const buf = new Uint8ClampedArray(await r.arrayBuffer());
        fit(w, h);
        ctx.putImageData(new ImageData(buf, w, h), 0, 0);
      } else {
        const r = await fetch('/frame.png?' + q);
        overflow = parseInt(r.headers.get('X-Splat-Overflow') || '0');
        const bmp = await createImageBitmap(await r.blob());
        fit(bmp.width, bmp.height);
        ctx.drawImage(bmp, 0, 0);
      }
    } catch (e) {}
    const ms = (performance.now() - t0).toFixed(0);
    hud.textContent =
      `yaw ${(yaw*180/Math.PI).toFixed(1)}°  pitch ${(pitch*180/Math.PI).toFixed(1)}°` +
      `  dist x${dist.toFixed(2)}  ${cv.width}x${cv.height}  mode ${mode}  ${transport}  pose→pixels ${ms} ms\\n` +
      `arrows: orbit (±10°)   drag: orbit   wheel: dolly   R: reset   M: color/depth   T: transport   -/+: resolution` +
      (overflow > 0 ? `\\nWARNING: ${overflow} pairs dropped — ` +
                      `frame truncated; restart with a larger --dup-factor`
                    : '');
    busy = false;
  }
  requestAnimationFrame(tick);
}
const STEP = 10 * Math.PI / 180;           // reference: ±10° per keypress
addEventListener('keydown', e => {
  if (e.key === 'ArrowLeft')  { yaw -= STEP; dirty = true; }
  if (e.key === 'ArrowRight') { yaw += STEP; dirty = true; }
  if (e.key === 'ArrowUp')    { pitch += STEP; dirty = true; }
  if (e.key === 'ArrowDown')  { pitch -= STEP; dirty = true; }
  if (e.key === 'r' || e.key === 'R') { yaw = 0; pitch = 0; dist = 1; dirty = true; }
  if (e.key === 'm' || e.key === 'M') {
    mode = (mode === 'depth') ? 'color' : 'depth'; dirty = true;
  }
  if (e.key === 't' || e.key === 'T') {
    transport = (transport === 'raw') ? 'png' : 'raw'; dirty = true;
  }
  if (e.key === '-' || e.key === '_') {
    scaleIdx = Math.max(0, scaleIdx - 1); dirty = true;
  }
  if (e.key === '+' || e.key === '=') {
    scaleIdx = Math.min(SCALES.length - 1, scaleIdx + 1); dirty = true;
  }
});
let dragging = false, lx = 0, ly = 0;
cv.addEventListener('mousedown', e => { dragging = true; lx = e.clientX; ly = e.clientY; });
addEventListener('mouseup', () => dragging = false);
addEventListener('mousemove', e => {
  if (!dragging) return;
  yaw   += (e.clientX - lx) * 0.01;
  pitch -= (e.clientY - ly) * 0.01;
  lx = e.clientX; ly = e.clientY; dirty = true;
});
addEventListener('wheel', e => {
  dist = Math.min(10, Math.max(0.1, dist * (e.deltaY > 0 ? 1.1 : 0.9)));
  dirty = true;
});
tick();
</script></body></html>
"""

# the live resolution ladder ('-'/'+' in the browser)
SCALES = (0.5, 1.0, 2.0)


def make_server(scene, camera, config=None, *, host: str = "127.0.0.1",
                port: int = 8000, method: str = "auto", png_level: int = 0,
                transport: str = "raw") -> ThreadingHTTPServer:
    """The viewer's HTTP server, bound to ``host:port`` (0 = any free
    port) and not yet serving.  ``scene`` is a ``GaussianScene``, packed
    here once, or a ``DeviceScene``.

    GET ``/`` is the page; GET ``/frame.raw`` (RGBA bytes) and
    ``/frame.png`` (PNG at ``png_level``) render the pose in the query
    (yaw, pitch, dist, mode, scale) and answer with the headers
    ``X-Splat-Overflow``, ``X-Splat-W`` and ``X-Splat-H``.  transport is
    the page's initial choice.  The tiled path renders with its stats, so
    duplication-buffer overflow reaches the page's HUD; at scale > 1 the
    pair capacity grows by scale^2.
    """
    if transport not in ("raw", "png"):
        raise ValueError(f"transport must be 'raw' or 'png', "
                         f"got {transport!r}")
    from splat_tpu_torch.config import RenderConfig
    from splat_tpu_torch.render.api import render_fn, resolve_method
    from splat_tpu_torch.render.tiled import render_tiled
    from splat_tpu_torch.scene import GaussianScene
    from splat_tpu_torch.utils.image import encode_png

    config = config or RenderConfig()
    m = resolve_method(method, scene)

    def config_for(mode: str, scale: float) -> RenderConfig:
        cfg = dataclasses.replace(config, render_mode=mode)
        if m == "tiled" and scale > 1.0:
            # pairs grow at most scale^2 with the pixels while the capacity
            # was sized at 1.0x; quarter steps, as splat_tpu rounds it
            dup = math.ceil(config.max_dup_factor * scale * scale * 4) / 4
            cfg = dataclasses.replace(cfg, max_dup_factor=dup)
        return cfg

    if isinstance(scene, GaussianScene):
        scene = scene.pack_device()   # the feature-major layout, once
    lock = threading.Lock()
    camera = camera.to(scene.device)
    base_pos = camera.position.cpu().numpy()
    target = camera.target.cpu().numpy()

    def render_pose(yaw: float, pitch: float, dist: float, mode: str,
                    scale: float) -> tuple[np.ndarray, int]:
        """(H, W, C) uint8 frame and its overflow."""
        scale = min(SCALES, key=lambda s: abs(s - scale))
        cam = camera.with_pose(yaw=yaw, pitch=pitch,
                               position=target + (base_pos - target) * dist)
        if scale != 1.0:
            cam = dataclasses.replace(
                cam, h=max(8, int(camera.h * scale) & ~1),
                w=max(8, int(camera.w * scale) & ~1))
        cfg = config_for(mode, scale)
        # inference mode is per thread: requests arrive on handler threads
        with lock, torch.inference_mode():
            if m == "tiled":
                img, stats = render_tiled(scene, cam, cfg, return_stats=True)
                overflow = int(stats["overflow"])
            else:
                img, overflow = render_fn(m, cfg)(scene, cam), 0
            img = (torch.clamp(img, 0.0, 1.0) * 255.0 + 0.5).to(torch.uint8)
            return img.cpu().numpy(), overflow

    def to_rgba(img: np.ndarray) -> bytes:
        """(H, W, 3|4) uint8 -> raw RGBA bytes for canvas putImageData."""
        h, w, c = img.shape
        out = np.full((h, w, 4), 255, np.uint8)
        out[..., :c] = img
        return out.tobytes()

    page = (_PAGE.replace("__W__", str(camera.w))
            .replace("__H__", str(camera.h))
            .replace("__MODE__", config.render_mode)
            .replace("__TRANSPORT__", transport))

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):  # quiet
            pass

        def do_GET(self):
            u = urlparse(self.path)
            if u.path == "/":
                body = page.encode()
                self.send_response(200)
                self.send_header("Content-Type", "text/html")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
            elif u.path in ("/frame.png", "/frame.raw"):
                q = parse_qs(u.query)
                mode = q.get("mode", [config.render_mode])[0]
                if mode not in ("color", "depth"):
                    mode = config.render_mode
                try:
                    def get(k, d):
                        return float(q.get(k, [d])[0])
                    img, overflow = render_pose(
                        get("yaw", 0.0), get("pitch", 0.0),
                        get("dist", 1.0), mode, get("scale", 1.0))
                    if u.path == "/frame.raw":
                        body = to_rgba(img)
                        ctype = "application/octet-stream"
                    else:
                        body = encode_png(img, level=png_level)
                        ctype = "image/png"
                except Exception as e:  # the boundary: report to the client
                    msg = f"render error: {e}".encode()
                    self.send_response(500)
                    self.send_header("Content-Length", str(len(msg)))
                    self.end_headers()
                    self.wfile.write(msg)
                    return
                self.send_response(200)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.send_header("X-Splat-Overflow", str(overflow))
                self.send_header("X-Splat-W", str(img.shape[1]))
                self.send_header("X-Splat-H", str(img.shape[0]))
                self.send_header("Cache-Control", "no-store")
                self.end_headers()
                self.wfile.write(body)
            else:
                self.send_response(404)
                self.end_headers()

    return ThreadingHTTPServer((host, port), Handler)


def serve(scene, camera, config=None, *, host: str = "127.0.0.1",
          port: int = 8000, method: str = "auto", png_level: int = 0,
          transport: str = "raw") -> None:
    """Serve the viewer until Ctrl-C (see :func:`make_server`)."""
    srv = make_server(scene, camera, config, host=host, port=port,
                      method=method, png_level=png_level, transport=transport)
    print(f"splat_tpu viewer on http://{host}:{srv.server_address[1]}/ "
          f"(N={scene.num_gaussians}, {camera.w}x{camera.h})")
    try:
        srv.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        srv.server_close()
