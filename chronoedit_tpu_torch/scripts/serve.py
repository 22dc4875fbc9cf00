"""ChronoEdit batching inference server on PyTorch (the JAX package's
``scripts/serve.py``, same HTTP protocol).

A dependency-free (stdlib http.server) endpoint around
:class:`chronoedit_tpu_torch.pipeline.server.EditServer`: concurrent POSTs
are grouped into padded batch buckets and run through the pipeline once
per batch.

Examples:
  # smoke server on tiny random weights, on the CPU
  python -m chronoedit_tpu_torch.scripts.serve --smoke --device cpu --port 8080 \\
      --warmup 32x32

  # the distilled model from a checkpoint directory on the card, with the
  # block cache
  python -m chronoedit_tpu_torch.scripts.serve \\
      --checkpoint-dir ./checkpoints/ChronoEdit-14B --lora distill.safetensors \\
      --cache-blocks 8:32 --warmup 720x1280

Protocol:
  GET  /healthz
      -> JSON {pending, device, requests, batches, ...}
  POST /edit?seed=0&prompt=<urlencoded>&steps=8&frame_only=1
      body: .npz with arrays
        image       (3,H,W) or (1,3,H,W) float32 in [-1,1]   required
        prompt_emb  (L,D)   or (1,L,D)   float32              required
        image_emb / neg_prompt_emb                            optional
      -> .npz with array "edit" (3,H,W) in [-1,1]
         (or the full clip (3,T,H,W) with frame_only=0)
      errors: 400 malformed, 403 guardrail-blocked, 413 oversized body,
              503 queue full
"""

from __future__ import annotations

import argparse
import io
import json
import urllib.parse
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

from chronoedit_tpu_torch.scripts import run_inference as ri


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ri.add_pipeline_args(p)
    p.add_argument("--host", type=str, default="127.0.0.1")
    p.add_argument("--port", type=int, default=8080)
    p.add_argument("--max-batch", type=int, default=4)
    p.add_argument("--max-wait-ms", type=float, default=50.0)
    p.add_argument("--max-queue", type=int, default=64)
    p.add_argument("--warmup", type=str, default=None,
                   help="HxW: run every batch bucket once at this geometry before "
                        "accepting traffic")
    p.add_argument("--warmup-bare", action="store_true",
                   help="also warm up the no-image_emb variant of each bucket")
    p.add_argument("--max-body-mb", type=int, default=64,
                   help="reject request bodies larger than this (413)")
    return p.parse_args(argv)


def make_handler(server, max_body_mb: int = 64):
    """Request handler bound to an EditServer (separable for tests)."""
    from chronoedit_tpu_torch.aux.guardrails import GuardrailBlocked

    server_max_body = max_body_mb * 1024 * 1024

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *a):  # quiet by default
            pass

        def _send(self, code: int, body: bytes, ctype: str):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _json(self, code: int, obj: dict):
            self._send(code, json.dumps(obj).encode(), "application/json")

        def do_GET(self):
            if urllib.parse.urlparse(self.path).path == "/healthz":
                self._json(200, server.health())
            else:
                self._json(404, {"error": "unknown path"})

        def do_POST(self):
            url = urllib.parse.urlparse(self.path)
            if url.path != "/edit":
                self._json(404, {"error": "unknown path"})
                return
            q = urllib.parse.parse_qs(url.query)

            def qget(name, cast, default):
                return cast(q[name][0]) if name in q else default

            n = int(self.headers.get("Content-Length", 0) or 0)
            if n > server_max_body:
                # drain in bounded chunks without buffering (the cap guards
                # memory): answering before the client finishes writing
                # races into a broken pipe instead of a clean 413
                left = n
                while left > 0:
                    left -= len(self.rfile.read(min(left, 1 << 20)) or b"x")
                self._json(413, {"error": f"body {n} B exceeds {server_max_body} B cap"})
                return
            try:
                # query casts and submit()'s own validation are client
                # errors too: everything up to the Future is a 400
                with np.load(io.BytesIO(self.rfile.read(n))) as z:
                    arrays = {k: z[k] for k in z.files}
                image = arrays.pop("image")
                prompt_emb = arrays.pop("prompt_emb")
                fut = server.submit(
                    image, prompt_emb,
                    neg_prompt_emb=arrays.get("neg_prompt_emb"),
                    image_emb=arrays.get("image_emb"),
                    seed=qget("seed", int, 0),
                    prompt=qget("prompt", str, ""),
                    num_steps=qget("steps", int, None),
                    guidance_scale=qget("guidance", float, None),
                    flow_shift=qget("shift", float, None),
                    enable_temporal_reasoning=bool(qget("reasoning", int, 0)),
                    num_temporal_reasoning_steps=qget("reasoning_steps", int, 0),
                    frame_only=bool(qget("frame_only", int, 1)))
            except Exception as e:  # noqa: BLE001 - malformed client input
                self._json(400, {"error": f"bad request: {e}"})
                return
            try:
                edit = fut.result()
            except GuardrailBlocked as e:
                self._json(403, {"error": str(e)})
                return
            except Exception as e:  # noqa: BLE001 - surface as an HTTP status
                msg = str(e)
                self._json(503 if "queue full" in msg else 500, {"error": msg})
                return
            buf = io.BytesIO()
            np.savez(buf, edit=edit.numpy())
            self._send(200, buf.getvalue(), "application/octet-stream")

    return Handler


def main(argv=None) -> None:
    args = parse_args(argv)
    from chronoedit_tpu_torch.pipeline.server import EditServer, ServerConfig

    pipe = ri.build_pipeline(args)
    server = EditServer(pipe, ServerConfig(max_batch=args.max_batch,
                                           max_wait_ms=args.max_wait_ms,
                                           max_queue=args.max_queue)).start()
    if args.warmup:
        h, w = (int(x) for x in args.warmup.lower().split("x"))
        print(f"[serve] warming up batch buckets {server.cfg.resolved_buckets()} at "
              f"{h}x{w} ...", flush=True)
        server.warmup(h, w)
        if args.warmup_bare:
            server.warmup(h, w, with_image_emb=False)

    httpd = ThreadingHTTPServer((args.host, args.port), make_handler(server, args.max_body_mb))
    print(f"[serve] listening on {args.host}:{httpd.server_address[1]} "
          f"({server.health()['device']})", flush=True)
    try:
        httpd.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        httpd.server_close()
        server.stop()


if __name__ == "__main__":
    main()
