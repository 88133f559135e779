"""The HTTP server with ``spatial_devices=2`` on two gloo ranks of the CPU.

Both ranks call ``apps.server.serve``; rank 0 answers HTTP and broadcasts
each request to rank 1, which follows it until rank 0's server shuts down.
``model_instances/demo`` at 64x64, f32, seeded uint8 images. Rank 0 posts
one request, two more at once from two threads, and one PNG that does not
decode, then shuts its server down. Checks: every reply's pixels equal,
bit for bit, the same ranks' spatial ``stylize`` of the image; they are
within one uint8 step of a one-rank session's (two f32 paths may round a
pixel on either side of a half); the rejected request broadcasts nothing
(rank 1 follows the two warm-up forwards and the three good requests
only); and rank 1's ``serve`` returns.
"""

import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from cyclegan_tpu_torch.apps import server
from cyclegan_tpu_torch.apps.inference import InferenceSession
from cyclegan_tpu_torch.data import png
from cyclegan_tpu_torch.parallel import run_ranks

MODEL_DIR = "model_instances/demo"
SIZE = 64
DIRECTIONS = ("a2b", "a2b", "b2a")  # the first alone, then two at once


def _post(url, body):
    request = urllib.request.Request(url, data=body, method="POST")
    try:
        with urllib.request.urlopen(request, timeout=120) as response:
            return response.status, response.read()
    except urllib.error.HTTPError as err:
        return err.code, err.read()


def _client(httpd, images, replies):
    """Rank 0's requests, then the server's shutdown."""
    url = f"http://127.0.0.1:{httpd.server_address[1]}/stylize?direction="
    try:
        replies[0] = _post(url + DIRECTIONS[0], png.encode_png(images[0]))

        def one(i):
            replies[i] = _post(url + DIRECTIONS[i],
                               png.encode_png(images[i]))

        threads = [threading.Thread(target=one, args=(i,)) for i in (1, 2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        replies["bad"] = _post(url + "a2b", b"\x89PNG not an image")
    finally:
        httpd.shutdown()


def _server_worker(rank, world, images):
    replies = {}
    clients = []

    def on_ready(httpd):
        clients.append(threading.Thread(target=_client,
                                        args=(httpd, images, replies)))
        clients[0].start()

    followed = server.serve(MODEL_DIR, "127.0.0.1", 0, SIZE,
                            dtype="float32", spatial_devices=world,
                            device="cpu", on_ready=on_ready)
    for t in clients:
        t.join()
    session = InferenceSession(MODEL_DIR, "float32", spatial_devices=world,
                               device="cpu")
    spatial = [session.stylize(images[i:i + 1], d)[0]
               for i, d in enumerate(DIRECTIONS)]
    return {"followed": followed, "replies": replies, "spatial": spatial}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def images():
    return np.random.default_rng(16).integers(0, 256, (3, SIZE, SIZE, 3),
                                              dtype=np.uint8)


@pytest.fixture(scope="module")
def ranks(images):
    return run_ranks(_server_worker, 2, (images,), timeout=300)


def _reply_pixels(ranks, i):
    code, body = ranks[0]["replies"][i]
    assert code == 200, body
    return png.decode_png(body)


@pytest.mark.parametrize("request_index", [0, 1, 2])
def test_reply_is_the_ranks_spatial_stylize(ranks, request_index):
    np.testing.assert_array_equal(_reply_pixels(ranks, request_index),
                                  ranks[0]["spatial"][request_index])
    np.testing.assert_array_equal(ranks[1]["spatial"][request_index],
                                  ranks[0]["spatial"][request_index])


def test_reply_is_within_a_step_of_one_rank(ranks, images):
    session = InferenceSession(MODEL_DIR, "float32", device="cpu")
    for i, direction in enumerate(DIRECTIONS):
        want = session.stylize(images[i:i + 1], direction)[0]
        diff = np.abs(_reply_pixels(ranks, i).astype(int) - want)
        assert diff.max() <= 1, (i, int(diff.max()))


def test_rejected_request_broadcasts_nothing_and_followers_exit(ranks):
    code, body = ranks[0]["replies"]["bad"]
    assert code == 400 and body.startswith(b"error:")
    assert ranks[0]["followed"] is None
    assert ranks[1]["followed"] == len(server.DIRECTIONS) + len(DIRECTIONS)
