"""Interactive browser viewer — the stand-in for the GLUT app.

The reference is an interactive OpenGL/GLUT application: mouse drag rotates /
translates / zooms the camera (volumeRender.cpp:389-432) and keyboard keys
adjust render parameters and the query method (volumeRender.cpp:302-384),
re-rendering every frame through the CUDA-GL PBO (volumeRender.cpp:194-295).
The accelerator has no display attached, so the equivalent here is a tiny stdlib HTTP
server: the browser page captures the SAME mouse/keyboard interactions, keeps
the camera/render state client-side, and fetches freshly rendered frames as
raw RGBA bytes painted into a canvas (the PBO analogue). All render
parameters are traced jit arguments, so interaction never recompiles; the FPS
readout in the page title mirrors computeFPS (volumeRender.cpp:174-191).

Key map (volumeRender.cpp:302-384):
    f           toggle linear/point filtering      '=' / '+' / '-'  density
    ']' / '['   brightness                         ';' / '\\''       TF offset
    '.' / ','   TF scale                           0-9              query method
Mouse: left drag = rotate, middle drag = translate x/y, right drag = zoom
(volumeRender.cpp:389-432).

Usage:  python -m vrdd_tpu.cli view --volume synthetic --port 8412
"""

from __future__ import annotations

import json
import threading
import time
from collections import deque
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional
from urllib.parse import parse_qs, urlparse

import numpy as np

from vrdd_tpu.core.geometry import inv_view_from_rotation_translation
from vrdd_tpu.models.pipeline import RenderPipeline
from vrdd_tpu.utils.config import (
    CameraConfig,
    QueryMethod,
    RenderConfig,
    TransferFunctionConfig,
)

_PAGE = """<!doctype html>
<html><head><title>vrdd_tpu viewer</title><style>
body { background: #111; color: #ccc; font: 13px monospace; margin: 16px; }
canvas { border: 1px solid #444; image-rendering: pixelated; cursor: grab; }
#hud { margin-top: 8px; white-space: pre; }
</style></head><body>
<canvas id="c" width="__W__" height="__H__"></canvas>
<div id="hud"></div>
<script>
// client-side render state == the reference's keyboard-updated globals
// (volumeRender.cpp:121-134); the server is stateless.
let S = { rx: 0, ry: 0, tx: 0, ty: 0, tz: -4, density: 0.05, brightness: 1.0,
          toff: 0.0, tscale: 1.0, query: __QUERY__, filter: 1 };
const W = __W__, H = __H__;
const cv = document.getElementById('c'), ctx = cv.getContext('2d');
const hud = document.getElementById('hud');
let busy = false, dirty = true, fps = 0;

async function frame() {
  if (busy || !dirty) { requestAnimationFrame(frame); return; }
  busy = true; dirty = false;
  const q = new URLSearchParams(S).toString() + '&fmt=rgb&pipe=1';
  try {
    const r = await fetch('/frame?' + q);
    // RGB over the wire (25% fewer bytes from the device); expand to RGBA
    const rgb = new Uint8Array(await r.arrayBuffer());
    const buf = new Uint8ClampedArray(W * H * 4);
    for (let i = 0, j = 0; i < rgb.length; i += 3, j += 4) {
      buf[j] = rgb[i]; buf[j+1] = rgb[i+1]; buf[j+2] = rgb[i+2];
      buf[j+3] = 255;
    }
    ctx.putImageData(new ImageData(buf, W, H), 0, 0);
    // pipelined server: the frame just painted lags the params by one
    // dispatch; when interaction stops, fetch once more to flush the
    // in-flight frame (the repeat request returns it without dispatching)
    if (!dirty && r.headers.get('X-Frame-Lag') === '1') dirty = true;
    // render throughput from the server's own timing, not wall time since
    // the previous frame (which would count idle gaps between interactions)
    const rsec = parseFloat(r.headers.get('X-Render-Seconds') || '0');
    fps = rsec > 0 ? 1 / rsec : 0;
    document.title = `vrdd_tpu viewer: ${fps.toFixed(1)} fps`;
    hud.textContent =
      `query=${S.query} density=${(+S.density).toFixed(3)} ` +
      `brightness=${(+S.brightness).toFixed(2)} tf_off=${(+S.toff).toFixed(3)} ` +
      `tf_scale=${(+S.tscale).toFixed(3)} filter=${S.filter ? 'linear' : 'point'}\\n` +
      `rot=(${S.rx.toFixed(1)}, ${S.ry.toFixed(1)}) z=${S.tz.toFixed(2)} ` +
      `${fps.toFixed(1)} fps (reference target: 60 fps)\\n` +
      `keys: f filter  +/- density  ]/[ brightness  ;/' tf-offset  ./ , ` +
      `tf-scale  0-9 query | drag: left rotate, middle pan, right zoom`;
  } catch (e) { hud.textContent = 'render error: ' + e; }
  busy = false;
  requestAnimationFrame(frame);
}
requestAnimationFrame(frame);

// keyboard map of volumeRender.cpp:302-384
document.addEventListener('keydown', (e) => {
  const k = e.key;
  if (k === 'f') S.filter = S.filter ? 0 : 1;
  else if (k === '+' || k === '=') S.density += 0.01;
  else if (k === '-') S.density = Math.max(0, S.density - 0.01);
  else if (k === ']') S.brightness += 0.1;
  else if (k === '[') S.brightness -= 0.1;
  else if (k === ';') S.toff += 0.01;
  else if (k === "'") S.toff -= 0.01;
  else if (k === '.') S.tscale += 0.01;
  else if (k === ',') S.tscale -= 0.01;
  else if (k >= '0' && k <= '9') S.query = +k;
  else return;
  dirty = true;
});

// mouse map of volumeRender.cpp:389-432 (1=rotate, 2=pan, 3=zoom)
let drag = null;
cv.addEventListener('mousedown', (e) => {
  drag = { b: e.buttons, x: e.clientX, y: e.clientY }; e.preventDefault();
});
window.addEventListener('mouseup', () => { drag = null; });
cv.addEventListener('contextmenu', (e) => e.preventDefault());
window.addEventListener('mousemove', (e) => {
  if (!drag) return;
  const dx = e.clientX - drag.x, dy = e.clientY - drag.y;
  drag.x = e.clientX; drag.y = e.clientY;
  if (drag.b === 4) {             // middle: pan (viewTranslation.xy += d/100)
    S.tx += dx / 100.0; S.ty -= dy / 100.0;
  } else if (drag.b === 2) {      // right: zoom (viewTranslation.z += dy/100)
    S.tz += dy / 100.0;
  } else {                        // left: rotate (viewRotation += d/5)
    S.rx += dy / 5.0; S.ry += dx / 5.0;
  }
  dirty = true;
});
</script></body></html>
"""


class ViewerServer:
    """Serves the interactive page + frames from a RenderPipeline."""

    def __init__(
        self,
        pipeline: RenderPipeline,
        width: int = 512,
        height: int = 512,
        renderer: str = "auto",
        query: int = 1,
        host: str = "127.0.0.1",
        port: int = 8412,
        pipelined: bool = True,
    ):
        self.pipeline = pipeline
        self.width = width
        self.height = height
        # 'scan' keeps the view matrix a traced argument — dragging the mouse
        # re-renders without recompiling (shear-warp would recompile per view)
        self.renderer = renderer
        self.query = query
        # pipelined=True: render_frame DISPATCHES the requested frame,
        # starts its device->host copy immediately (copy_to_host_async,
        # so the transfer does not wait for the blocking np.asarray), and
        # returns the OLDEST in-flight frame — the device renders frames
        # N+1, N+2 while frame N's bytes cross to the host (the reference
        # overlaps render and display the same way through its GL PBO,
        # volumeRender.cpp:194-295). The displayed frame lags interaction
        # by up to `depth` dispatches; the client flushes the queue when
        # the drag stops (X-Frame-Lag header, see _PAGE). A REPEATED
        # request (identical params) drains one in-flight frame instead of
        # dispatching, so a static scene costs nothing and the flush
        # terminates.
        self.pipelined = pipelined
        # The queue only lags DURING a continuous drag (up to 4
        # dispatches behind the mouse); the client's X-Frame-Lag flush
        # drains it the moment interaction stops, so a static view is
        # always exact. Depth vs fps on a GPU: not measured.
        self.pipeline_depth = 4
        self._pending = deque()  # in-flight (device array, params key)
        self.last_frame_lagged = False
        self._render_lock = threading.Lock()
        outer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # quiet
                pass

            def do_GET(self):
                url = urlparse(self.path)
                if url.path == "/":
                    page = (
                        _PAGE.replace("__W__", str(outer.width))
                        .replace("__H__", str(outer.height))
                        .replace("__QUERY__", str(outer.query))
                    )
                    body = page.encode()
                    self.send_response(200)
                    self.send_header("Content-Type", "text/html")
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)
                elif url.path == "/frame":
                    q = {k: v[0] for k, v in parse_qs(url.query).items()}
                    try:
                        t0 = time.perf_counter()
                        rgba, lagged = outer.render_frame_ex(q)
                        dt = time.perf_counter() - t0
                        self.send_response(200)
                        self.send_header(
                            "Content-Type", "application/octet-stream"
                        )
                        self.send_header("Content-Length", str(len(rgba)))
                        self.send_header(
                            "X-Render-Seconds", f"{dt:.4f}"
                        )
                        self.send_header(
                            "X-Frame-Lag", "1" if lagged else "0"
                        )
                        self.end_headers()
                        self.wfile.write(rgba)
                    except Exception as e:  # surface errors to the page
                        msg = json.dumps({"error": str(e)}).encode()
                        self.send_response(500)
                        self.send_header("Content-Type", "application/json")
                        self.send_header("Content-Length", str(len(msg)))
                        self.end_headers()
                        self.wfile.write(msg)
                else:
                    self.send_response(404)
                    self.end_headers()

        self.httpd = ThreadingHTTPServer((host, port), Handler)

    @property
    def address(self) -> str:
        h, p = self.httpd.server_address[:2]
        return f"http://{h}:{p}/"

    def _dispatch(self, q: dict):
        """Enqueue ONE jitted render for the given params (async): as_uint8
        fuses the uint8 pack into the render's single jitted call — the
        whole frame is one device dispatch; ``fmt=rgb`` drops alpha inside
        the jit too (25% fewer readback bytes)."""
        config = RenderConfig(
            camera=CameraConfig(width=self.width, height=self.height),
            tf=TransferFunctionConfig(
                offset=float(q.get("toff", 0.0)),
                scale=float(q.get("tscale", 1.0)),
            ),
            density=float(q.get("density", 0.05)),
            brightness=float(q.get("brightness", 1.0)),
            query_method=QueryMethod(int(q.get("query", self.query))),
            filter_linear=bool(int(q.get("filter", 1))),
        )
        inv_view = inv_view_from_rotation_translation(
            float(q.get("rx", 0.0)),
            float(q.get("ry", 0.0)),
            (
                float(q.get("tx", 0.0)),
                float(q.get("ty", 0.0)),
                float(q.get("tz", -4.0)),
            ),
        )
        return self.pipeline.render(
            inv_view, config, self.renderer, as_uint8=True,
            channels=3 if q.get("fmt") == "rgb" else 4,
        )

    def render_frame_ex(self, q: dict):
        """One frame from query-string params -> (bytes, lagged).

        Pipelining engages ONLY when the request opts in with ``pipe=1``
        (the bundled page does; a plain GET /frame — curl, screenshot
        tools — keeps the strict contract that the response matches the
        requested params). A pipelined response returns the OLDEST
        in-flight frame after enqueueing this one (device compute overlaps
        the link transfers), flagged ``lagged`` so the client can flush; a
        repeat request with identical params drains one in-flight frame
        instead of dispatching — see __init__."""
        with self._render_lock:  # one device render at a time
            if not (self.pipelined and q.get("pipe") == "1"):
                img = self._dispatch(q)
                img.copy_to_host_async()
                return (
                    np.ascontiguousarray(np.asarray(img)).tobytes(), False
                )
            key = tuple(sorted(q.items()))
            if self._pending and self._pending[-1][1] == key:
                img = self._pending.popleft()[0]  # flush/static: drain one
            else:
                img_new = self._dispatch(q)  # async: device starts now
                # start the device->host copy NOW (see __init__: without
                # this the transfer only begins at the blocking read and
                # nothing overlaps)
                img_new.copy_to_host_async()
                self._pending.append((img_new, key))
                if len(self._pending) > self.pipeline_depth:
                    img = self._pending.popleft()[0]
                else:
                    # pipeline filling after an idle gap: re-serve the
                    # oldest in-flight frame (completed or nearly so)
                    # without draining, so the queue reaches full depth
                    img = self._pending[0][0]
            lagged = len(self._pending) > 0
            self.last_frame_lagged = lagged
            # np.asarray collects the (already streaming) host copy while
            # the device renders the frames behind it
            return np.ascontiguousarray(np.asarray(img)).tobytes(), lagged

    def render_frame(self, q: dict) -> bytes:
        """Compatibility form of :meth:`render_frame_ex` (bytes only)."""
        return self.render_frame_ex(q)[0]

    def serve_forever(self):
        print(f"vrdd_tpu viewer at {self.address}  (Ctrl-C to stop)")
        try:
            self.httpd.serve_forever()
        except KeyboardInterrupt:
            pass
        finally:
            self.httpd.server_close()

    def start_background(self) -> threading.Thread:
        t = threading.Thread(target=self.httpd.serve_forever, daemon=True)
        t.start()
        return t

    def shutdown(self):
        self.httpd.shutdown()
        self.httpd.server_close()
