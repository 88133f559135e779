"""Minimal HTTP stylization server, standard library only
(cyclegan_tpu/apps/server.py): POST an image, get the stylized PNG back.

    python -m cyclegan_tpu_torch.apps.server --model_dir \\
        model_instances/converged256 --port 8000 --size 256 \\
        --dtype bfloat16 [--device cpu]

    curl -X POST --data-binary @cat.png \\
        "http://localhost:8000/stylize?direction=a2b" -o tortie.png

Endpoints, as the JAX server's:
    GET  /healthz                      -> 200 "ok"
    POST /stylize?direction=a2b|b2a    -> stylized PNG (image/png)

A request that cannot be served (an unknown direction, a body of no or
too large a length, an image that does not decode) gets 400 with the
reason; any other path 404. The port decodes PNG everywhere and JPEG only
where cv2 or PIL imports (``data/codec.py``). Each reply carries a
``Server-Timing`` header with the milliseconds of its decode, resize,
stylize and encode. Requests are served on threads
(``ThreadingHTTPServer``); the session's layout scope is per thread.
"""

from __future__ import annotations

import argparse
import logging
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from pathlib import Path
from urllib.parse import parse_qs, urlparse

import numpy as np

logger = logging.getLogger(__name__)

MAX_BODY = 64 * 1024 * 1024
TIMED_STAGES = ("decode", "resize", "stylize", "encode")


def make_handler(session, size: int):
    """The request handler class serving ``session`` at size x size."""
    from cyclegan_tpu_torch.data.codec import (
        decode_image_rgb,
        encode_png_bgr,
        resize_rgb,
    )

    def respond(data: bytes, direction: str):
        """(PNG, {stage: ms}) of one request's image."""
        marks = [time.perf_counter()]
        rgb = decode_image_rgb(data)
        marks.append(time.perf_counter())
        rgb = resize_rgb(rgb, (size, size))
        marks.append(time.perf_counter())
        stylized = session.stylize(rgb[np.newaxis], direction)[0]
        marks.append(time.perf_counter())
        png = encode_png_bgr(np.ascontiguousarray(stylized[..., ::-1]))
        marks.append(time.perf_counter())
        return png, {stage: (b - a) * 1e3 for stage, a, b in
                     zip(TIMED_STAGES, marks, marks[1:])}

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):  # route through logging
            logger.info("%s " + fmt, self.address_string(), *args)

        def _reply(self, code: int, body: bytes, content_type: str,
                   timings=None):
            self.send_response(code)
            self.send_header("Content-Type", content_type)
            self.send_header("Content-Length", str(len(body)))
            if timings:
                self.send_header("Server-Timing", ", ".join(
                    f"{k};dur={v:.3f}" for k, v in timings.items()))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if urlparse(self.path).path == "/healthz":
                self._reply(200, b"ok", "text/plain")
            else:
                self._reply(404, b"not found", "text/plain")

        def do_POST(self):
            parsed = urlparse(self.path)
            if parsed.path != "/stylize":
                self._reply(404, b"not found", "text/plain")
                return
            direction = parse_qs(parsed.query).get("direction", ["a2b"])[0]
            if direction not in ("a2b", "b2a"):
                self._reply(400, b"direction must be a2b or b2a",
                            "text/plain")
                return
            try:
                length = int(self.headers.get("Content-Length", 0))
            except ValueError:
                length = 0
            if not 0 < length <= MAX_BODY:
                self._reply(400, b"bad content length", "text/plain")
                return
            data = self.rfile.read(length)
            try:
                png, timings = respond(data, direction)
            except Exception as exc:  # noqa: BLE001 - report to the client
                logger.exception("stylize failed")
                self._reply(400, f"error: {exc}".encode(), "text/plain")
                return
            self._reply(200, png, "image/png", timings)

    return Handler


def serve(model_dir: Path, host: str, port: int, size: int,
          dtype: str = "float32", spatial_devices: int = 0,
          device: str = "cuda"):
    """Load the session, run one forward per direction (so the first
    request builds no kernel), then serve until interrupted."""
    from cyclegan_tpu_torch.apps.inference import InferenceSession

    if int(spatial_devices) > 1:
        raise NotImplementedError(
            "serve(spatial_devices > 1): the HTTP server runs one process; "
            "spatial serving needs rank 0 to answer requests while the "
            "other ranks follow each one (ROADMAP.md queue 1, item 7b)")
    session = InferenceSession(model_dir, compute_dtype=dtype,
                               spatial_devices=spatial_devices,
                               device=device)
    for direction in ("a2b", "b2a"):
        session.stylize(np.zeros((1, size, size, 3), np.uint8), direction)
    server = ThreadingHTTPServer((host, port), make_handler(session, size))
    logger.info("serving on %s:%d (size %d, %s, %s)", host, port, size,
                dtype, device)
    try:
        server.serve_forever()
    finally:
        server.server_close()


def main(argv=None):
    logging.basicConfig(level=logging.INFO)
    parser = argparse.ArgumentParser("cyclegan_tpu_torch inference server")
    parser.add_argument("--model_dir", type=Path,
                        default=Path("model_instances", "model"))
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument("--port", type=int, default=8000)
    parser.add_argument("--size", type=int, default=256)
    parser.add_argument("--dtype", default="float32",
                        choices=["float32", "bfloat16"],
                        help="bfloat16 = the serving mode (on the card it "
                        "also takes the NHCW kernel path via tpu_layout "
                        "auto)")
    parser.add_argument("--spatial_devices", type=int, default=0,
                        help="shard each image's H axis over this many "
                        "devices (not ported yet: more than 1 raises)")
    parser.add_argument("--device", default="cuda",
                        help="torch device (cuda by default; cpu runs the "
                        "kernels' plain versions)")
    args = parser.parse_args(argv)
    serve(args.model_dir, args.host, args.port, args.size, dtype=args.dtype,
          spatial_devices=args.spatial_devices, device=args.device)


if __name__ == "__main__":
    main()
