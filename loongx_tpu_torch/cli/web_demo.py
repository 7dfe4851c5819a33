"""Zero-dependency web demo server on the stdlib's http.server
(counterpart of ``loongx_tpu/cli/web_demo.py``).

It serves the editing core of `cli.gradio_app` (``process_image_and_text``:
centre crop, subject condition, few-step generate) with a single-page UI,
so the demo runs with no optional dependency; `cli.gradio_app` hands over
to it when gradio is missing.

    python -m loongx_tpu_torch.cli.web_demo --checkpoint <dir> [--port 7860]

Protocol (also the demo's programmatic API):
  GET  /        -> HTML page (file picker + instruction box, fetch()-based)
  GET  /health  -> {"status": "ok"}
  POST /edit    -> request  {"image_b64": <base64 PNG/JPEG>, "text": str}
                   response {"image_b64": <base64 PNG>, "elapsed_s": float}

The pipeline serves on the GPU unless ``--device cpu``, through the
kernels wherever its tensors are on the card (the JAX package's
``attn_backend`` choice has no counterpart: the port routes by the
tensors' device).  The serving knobs are `cli.infer.serving_knobs`'s
environment variables (LOONGX_W8A8=1, ...), read once in `main`.
``--tiny-random`` serves a random tiny pipeline (float32, head_dim 32) on
zero text embeds: its widths are below what the kernels take, so it runs
with ``--device cpu``.
"""

from __future__ import annotations

import argparse
import base64
import io
import json
import threading
import time
import traceback
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

_PAGE = """<!doctype html>
<html><head><meta charset="utf-8"><title>LoongX demo</title>
<style>
 body{font-family:sans-serif;max-width:720px;margin:2rem auto;padding:0 1rem}
 textarea{width:100%%;box-sizing:border-box}
 img{max-width:100%%;border:1px solid #ccc;margin-top:1rem}
 #status{color:#666}
</style></head>
<body>
<h2>LoongX &mdash; subject-driven generation</h2>
<p>Upload a subject image and describe the edit; the server runs the
conditioned FLUX pipeline (%(steps)d steps).</p>
<input type="file" id="img" accept="image/*"><br><br>
<textarea id="text" rows="2" placeholder="instruction"></textarea><br><br>
<button id="go">Generate</button> <span id="status"></span>
<div><img id="out" style="display:none"></div>
<script>
document.getElementById('go').onclick = async () => {
  const f = document.getElementById('img').files[0];
  const status = document.getElementById('status');
  if (!f) { status.textContent = 'pick an image first'; return; }
  const b64 = await new Promise((res) => {
    const r = new FileReader();
    r.onload = () => res(r.result.split(',')[1]);
    r.readAsDataURL(f);
  });
  status.textContent = 'generating…';
  const resp = await fetch('/edit', {
    method: 'POST', headers: {'Content-Type': 'application/json'},
    body: JSON.stringify({image_b64: b64,
                          text: document.getElementById('text').value}),
  });
  const data = await resp.json();
  if (!resp.ok) { status.textContent = 'error: ' + data.error; return; }
  const img = document.getElementById('out');
  img.src = 'data:image/png;base64,' + data.image_b64;
  img.style.display = 'block';
  status.textContent = data.elapsed_s.toFixed(2) + ' s';
};
</script>
</body></html>
"""


def build_server(editor, port: int = 0, num_steps: int = 8):
    """HTTP server around ``editor(image: PIL.Image, text: str) -> PIL.Image``.

    ``editor`` is injected so the HTTP surface runs without model weights;
    `main` wires the pipeline through ``gradio_app.process_image_and_text``.
    Returns a ThreadingHTTPServer (``.server_address[1]`` is the bound port
    when ``port=0``).
    """
    import binascii

    from PIL import Image, UnidentifiedImageError

    # one edit at a time: concurrent denoise loops on one card would
    # double-allocate activations (out of memory at the 12B point) and race
    # adapter switching in generate(); gradio queues the same way
    edit_lock = threading.Lock()

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):  # quiet by default
            pass

        def _json(self, code: int, obj) -> None:
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/health":
                self._json(200, {"status": "ok"})
                return
            body = (_PAGE % {"steps": num_steps}).encode()
            self.send_response(200)
            self.send_header("Content-Type", "text/html; charset=utf-8")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_POST(self):
            if self.path != "/edit":
                self._json(404, {"error": "unknown endpoint"})
                return
            try:  # request parsing: malformed input is the client's fault
                n = int(self.headers.get("Content-Length", "0"))
                req = json.loads(self.rfile.read(n))
                img = Image.open(
                    io.BytesIO(base64.b64decode(req["image_b64"]))
                ).convert("RGB")
                text = str(req.get("text", ""))
            except (KeyError, ValueError, TypeError, binascii.Error,
                    UnidentifiedImageError) as e:
                self._json(400, {"error": f"{type(e).__name__}: {e}"})
                return
            try:  # model execution: failures here are server faults
                t0 = time.perf_counter()
                with edit_lock:
                    out = editor(img, text)
                elapsed = time.perf_counter() - t0
                buf = io.BytesIO()
                out.save(buf, format="PNG")
                self._json(200, {
                    "image_b64": base64.b64encode(buf.getvalue()).decode(),
                    "elapsed_s": elapsed,
                })
            except Exception as e:
                traceback.print_exc()
                self._json(500, {"error": f"{type(e).__name__}: {e}"})

    return ThreadingHTTPServer(("127.0.0.1", port), Handler)


def serve_forever_in_thread(server) -> threading.Thread:
    t = threading.Thread(target=server.serve_forever, daemon=True)
    t.start()
    return t


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--checkpoint", type=str, default=None,
                        help="pipeline directory written by "
                        "loongx_tpu_torch.cli.convert")
    parser.add_argument("--tiny-random", action="store_true",
                        help="serve a random tiny pipeline (no weights; "
                        "smoke/demo mode, outputs are noise; --device cpu)")
    parser.add_argument("--steps", type=int, default=8)
    parser.add_argument("--size", type=int, default=512)
    parser.add_argument("--port", type=int, default=7860)
    parser.add_argument("--device", type=str, default="cuda",
                        help="'cuda' (default) or 'cpu'")
    args = parser.parse_args(argv)
    from loongx_tpu_torch.precision import set_precision

    set_precision()

    import torch

    from loongx_tpu_torch.cli.gradio_app import process_image_and_text
    from loongx_tpu_torch.cli.infer import require_device, serving_knobs
    from loongx_tpu_torch.models.pipeline import LoongXPipeline

    require_device(parser, args.device)
    knobs = serving_knobs()
    if args.tiny_random:
        pipeline = LoongXPipeline.tiny(
            torch.Generator(args.device).manual_seed(0), device=args.device)
        size = 32
        # the random tiny pipeline has no tokenizers: drive it on zero embeds
        knobs.update(
            prompt_embeds=torch.zeros((1, 8, pipeline.flux_cfg.joint_dim),
                                      device=args.device),
            pooled_prompt_embeds=torch.zeros(
                (1, pipeline.flux_cfg.pooled_dim), device=args.device))
    elif args.checkpoint:
        pipeline = LoongXPipeline.from_pretrained(args.checkpoint,
                                                  device=args.device)
        size = args.size
    else:
        parser.error("--checkpoint or --tiny-random required")

    def editor(image, text):
        return process_image_and_text(
            pipeline, image, "" if args.tiny_random else text or "",
            num_steps=args.steps, size=size, **knobs)

    server = build_server(editor, port=args.port, num_steps=args.steps)
    print(f"serving on http://127.0.0.1:{server.server_address[1]}")
    server.serve_forever()


if __name__ == "__main__":
    main()
