"""Browser-based progressive viewer — the GL-interop display replacement.

The reference shows a live GLUT window fed by CUDA-GL interop
(``CudaUtils.h:27-188``) with keyboard camera control
(``CudaTracer.cu:748-786``). The GPU typically sits across a network, so the
"window" here is a zero-dependency local HTTP server: a page that polls the
progressive framebuffer as PNG and forwards the same WASD/QE/TFGH key
bindings (plus ``0`` = screenshot) back to the renderer. Accumulation resets
on camera moves exactly as the reference's ``resetTicksThisFrame`` path.

Run:  python -m cuda_path_tracer_ss.cli view --scene showcase
then open http://localhost:8642/.
"""
from __future__ import annotations

import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from .utils.image import encode_png

_PAGE = """<!DOCTYPE html>
<html><head><title>cuda-path-tracer-ss</title><style>
body { background:#111; color:#ccc; font-family:monospace; text-align:center }
img { image-rendering:pixelated; margin-top:12px; }
</style></head><body>
<h3>cuda-path-tracer-ss — progressive view</h3>
<div id="stats">connecting…</div>
<img id="frame" width="{width}" height="{height}"/>
<p>keys: w/a/s/d/q/e move · t/f/g/h rotate · p ray/path mode · 0 screenshot</p>
<script>
async function tick() {
  const img = document.getElementById('frame');
  img.src = '/frame.png?' + Date.now();
  try {
    const s = await (await fetch('/stats')).json();
    document.getElementById('stats').textContent =
      `spp ${s.spp}  ·  ${(s.rays_per_s/1e6).toFixed(1)} M rays/s`;
  } catch (e) {}
}
setInterval(tick, 1000); tick();
document.addEventListener('keydown', e => {
  if ('wasdqetfgh0p'.includes(e.key)) fetch('/key?k=' + e.key);
});
</script></body></html>"""


class ViewerState:
    def __init__(self, renderer):
        self.renderer = renderer
        self.lock = threading.Lock()
        self.png = b""
        self.spp = 0
        self.rays_per_s = 0.0
        self.pending_keys: list = []
        self.stop = False

    def render_loop(self):
        while not self.stop:
            with self.lock:
                keys, self.pending_keys = self.pending_keys, []
            for k in keys:
                if k == "p":
                    mode = self.renderer.toggle_ray_trace_mode()
                    print("\nray-trace mode" if mode else "\npath-trace mode")
                elif k == "0":
                    path = time.strftime("render%Y-%m-%d-%H%M%S.png")
                    self.renderer.save(path)
                    print(f"\nwrote {path}")
                elif self.renderer.move_camera(k):
                    print(f"\ncamera moved ({k}); accumulation reset")
            m = self.renderer.step()
            png = encode_png(self.renderer.image_u8())
            with self.lock:
                self.png = png
                self.spp = m["samples_per_pixel"]
                self.rays_per_s = m["primary_rays_per_s"]


def serve(renderer, host: str = "127.0.0.1", port: int = 8642,
          state_out: dict = None):
    """Serve the viewer until interrupted. ``state_out``, if given, receives
    the ViewerState under key "state" before the render loop starts —
    embedders/tests set ``state.stop = True`` for a clean shutdown."""
    state = ViewerState(renderer)
    if state_out is not None:
        state_out["state"] = state

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):
            pass

        def do_GET(self):
            if self.path.startswith("/frame.png"):
                with state.lock:
                    body = state.png
                self._reply(200, "image/png", body)
            elif self.path.startswith("/stats"):
                import json
                with state.lock:
                    body = json.dumps({"spp": state.spp,
                                       "rays_per_s": state.rays_per_s}).encode()
                self._reply(200, "application/json", body)
            elif self.path.startswith("/key"):
                k = self.path.split("k=")[-1][:1]
                with state.lock:
                    state.pending_keys.append(k)
                self._reply(200, "text/plain", b"ok")
            else:
                cfg = state.renderer.config
                page = (_PAGE.replace("{width}", str(cfg.width))
                             .replace("{height}", str(cfg.height)))
                self._reply(200, "text/html", page.encode())

        def _reply(self, code, ctype, body):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.send_header("Cache-Control", "no-store")
            self.end_headers()
            self.wfile.write(body)

    server = ThreadingHTTPServer((host, port), Handler)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    print(f"viewer at http://{host}:{port}/ (ctrl-c to stop)")
    try:
        state.render_loop()
    except KeyboardInterrupt:
        pass
    finally:
        state.stop = True
        server.shutdown()
    return state
