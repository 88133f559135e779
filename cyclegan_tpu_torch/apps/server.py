"""Minimal HTTP stylization server, standard library only
(cyclegan_tpu/apps/server.py): POST an image, get the stylized PNG back.

    python -m cyclegan_tpu_torch.apps.server --model_dir \\
        model_instances/converged256 --port 8000 --size 256 \\
        --dtype bfloat16 [--device cpu]

    curl -X POST --data-binary @cat.png \\
        "http://localhost:8000/stylize?direction=a2b" -o tortie.png

Spatially, each image's H axis over N ranks (one process per device):

    torchrun --nproc_per_node N -m cyclegan_tpu_torch.apps.server \\
        --distributed --spatial_devices N --size 512 ...

or N processes with ``--coordinator host:port --num_processes N
--process_id r``.

Endpoints, as the JAX server's:
    GET  /healthz                      -> 200 "ok"
    POST /stylize?direction=a2b|b2a    -> stylized PNG (image/png)

A request that cannot be served (an unknown direction, a body of no or
too large a length, an image that does not decode) gets 400 with the
reason; any other path 404. The port decodes PNG everywhere and JPEG only
where cv2 or PIL imports (``data/codec.py``). Each reply carries a
``Server-Timing`` header with the milliseconds of its decode, resize,
stylize and encode: the spans of its ``tracing`` root ``request``.
Requests are served on threads (``ThreadingHTTPServer``); the session's
layout scope and the open spans are per thread.

With ``spatial_devices`` N > 1, ``serve`` runs in every rank of a group
of N. Rank 0 answers HTTP; for each request it has decoded and resized,
it broadcasts a small header (a command, the batch shape, the direction)
and then the uint8 pixels, and every rank calls the spatial session's
``stylize`` on them (``SpatialLeader``, ``follow``); rank 0 encodes the
reply. Every rank must issue the same collectives in the same order, so
rank 0 holds one lock from the broadcast to the end of ``stylize``:
requests on several threads take turns. A request rank 0 rejects is
rejected before anything is broadcast. The warm-up forwards and a final
stop command go through the same broadcast, so the followers return when
rank 0's server shuts down.
"""

from __future__ import annotations

import argparse
import logging
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from pathlib import Path
from urllib.parse import parse_qs, urlparse

import numpy as np

logger = logging.getLogger(__name__)

MAX_BODY = 64 * 1024 * 1024
TIMED_STAGES = ("decode", "resize", "stylize", "encode")
# the spatial ranks' header: command, N, H, W, C, direction index
STOP, STYLIZE = 0, 1
DIRECTIONS = ("a2b", "b2a")
_HEADER = 6


def _broadcast_header(device, command: int, shape=(0, 0, 0, 0),
                      direction: str = "a2b"):
    import torch
    import torch.distributed as dist

    header = torch.tensor([command, *shape, DIRECTIONS.index(direction)],
                          dtype=torch.int64, device=device)
    dist.broadcast(header, src=0)


class SpatialLeader:
    """Rank 0's side of a spatial session: ``stylize`` broadcasts the
    request to the followers (``follow``) and stylizes its strip with
    them, under one lock; ``stop`` sends them the stop command."""

    def __init__(self, session):
        self.session = session
        self.lock = threading.Lock()

    def stylize(self, images: np.ndarray, direction: str = "a2b"
                ) -> np.ndarray:
        import torch
        import torch.distributed as dist

        images = np.ascontiguousarray(images, np.uint8)
        device = self.session.device
        with self.lock:
            _broadcast_header(device, STYLIZE, images.shape, direction)
            dist.broadcast(torch.from_numpy(images).to(device), src=0)
            return self.session.stylize(images, direction)

    def stop(self) -> None:
        with self.lock:
            _broadcast_header(self.session.device, STOP)


def follow(session) -> int:
    """A follower rank: stylize each request rank 0 broadcasts until its
    stop command. Returns the number of requests followed."""
    import torch
    import torch.distributed as dist

    count = 0
    while True:
        header = torch.zeros(_HEADER, dtype=torch.int64,
                             device=session.device)
        dist.broadcast(header, src=0)
        command, *shape, direction = header.tolist()
        if command == STOP:
            return count
        pixels = torch.empty(shape, dtype=torch.uint8, device=session.device)
        dist.broadcast(pixels, src=0)
        session.stylize(pixels.cpu().numpy(), DIRECTIONS[direction])
        count += 1


def make_handler(session, size: int):
    """The request handler class serving ``session`` at size x size."""
    from cyclegan_tpu_torch import tracing
    from cyclegan_tpu_torch.data.codec import (
        decode_image_rgb,
        encode_png_bgr,
        resize_rgb,
    )

    def respond(data: bytes, direction: str):
        """(PNG, {stage: ms}) of one request's image: a ``tracing`` root
        ``request`` whose stages are its spans."""
        with tracing.span("request") as request:
            with tracing.span("decode"):
                rgb = decode_image_rgb(data)
            with tracing.span("resize"):
                rgb = resize_rgb(rgb, (size, size))
            with tracing.span("stylize"):
                stylized = session.stylize(rgb[np.newaxis], direction)[0]
            with tracing.span("encode"):
                png = encode_png_bgr(np.ascontiguousarray(stylized[..., ::-1]))
        return png, {stage: request["spans"][stage] / 1e6
                     for stage in TIMED_STAGES}

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
          device: str = "cuda", on_ready=None):
    """Load the session, run one forward per direction (so the first
    request builds no kernel), then serve until interrupted or shut down.
    With ``spatial_devices`` > 1 every rank of the group calls this: rank
    0 serves HTTP, the others follow it (the module docstring) and return
    when it stops. ``on_ready(server)``, where given, is called on the
    serving rank once the server is bound (``server.shutdown()`` from
    another thread ends it). Returns the number of requests a follower
    followed, else None."""
    from cyclegan_tpu_torch.apps.inference import InferenceSession

    session = InferenceSession(model_dir, compute_dtype=dtype,
                               spatial_devices=spatial_devices,
                               device=device)
    stylizer = session
    if session.spatial_mesh is not None:
        import torch.distributed as dist

        if dist.get_rank() != 0:
            return follow(session)
        stylizer = SpatialLeader(session)
    try:
        for direction in DIRECTIONS:
            stylizer.stylize(np.zeros((1, size, size, 3), np.uint8),
                             direction)
        server = ThreadingHTTPServer((host, port),
                                     make_handler(stylizer, size))
        logger.info("serving on %s:%d (size %d, %s, %s, %d spatial ranks)",
                    host, port, size, dtype, device,
                    max(int(spatial_devices), 1))
        try:
            if on_ready is not None:
                on_ready(server)
            server.serve_forever()
        finally:
            server.server_close()
    finally:
        if stylizer is not session:
            stylizer.stop()
    return None


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
                        "ranks, one process per device joined with "
                        "--distributed or --coordinator; rank 0 answers "
                        "HTTP")
    parser.add_argument("--device", default="cuda",
                        help="torch device (cuda by default; cpu runs the "
                        "kernels' plain versions)")
    parser.add_argument("--distributed", action="store_true",
                        help="Join the process group the launcher's "
                        "environment describes (env://, as torchrun sets).")
    parser.add_argument("--coordinator", default=None,
                        help="host:port of rank 0 (tcp://), with "
                        "--num_processes and --process_id")
    parser.add_argument("--num_processes", type=int, default=None)
    parser.add_argument("--process_id", type=int, default=None)
    args = parser.parse_args(argv)
    device = args.device
    if args.distributed or args.coordinator:
        import torch.distributed as dist

        from cyclegan_tpu_torch.parallel import init_distributed

        device = init_distributed(args.device, args.coordinator,
                                  args.num_processes, args.process_id)
        try:
            serve(args.model_dir, args.host, args.port, args.size,
                  dtype=args.dtype, spatial_devices=args.spatial_devices,
                  device=device)
        finally:
            dist.destroy_process_group()
        return
    serve(args.model_dir, args.host, args.port, args.size, dtype=args.dtype,
          spatial_devices=args.spatial_devices, device=device)


if __name__ == "__main__":
    main()
