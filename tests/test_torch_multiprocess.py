"""The port's entry points across processes on the CPU: the training CLI
as two processes joined by ``--coordinator`` (gloo), data-parallel and
spatial, and ``InferenceSession(spatial_devices=2)`` on two ranks.

The data-parallel run is the JAX package's ``tests/test_multiprocess.py``
for the port: the smoke training config (``configs/smoke_training.yaml``,
here at 32x32, one image per process and step) on that test's tiny U-Net
recipe must write through the lead alone (one checkpoint, one ``train/``
event file, nothing from rank 1) and end with the parameters of one
process trained at the global batch of 2, within rtol 2e-5 and atol 2e-6
(the JAX test's bounds). The smoke model (``configs/smoke.yaml``, PatchGAN
discriminators) is too ill-conditioned at its random init for such a
bound: one process run twice with 1 and 4 torch threads already ends 4e-4
apart (Adam's first steps turn rounding into signs). It runs the spatial
CLI case. Each process has its own deadline; a hang fails the test.
"""

import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist

from cyclegan_tpu_torch.config import namespace2yaml, yaml2namespace
from cyclegan_tpu_torch.data.codec import image2example
from cyclegan_tpu_torch.data.tfrecord import write_tfrecord_file
from cyclegan_tpu_torch.parallel import run_ranks
from cyclegan_tpu_torch.utils.checkpoint import load_pytree
from cyclegan_tpu_torch.weights import models_to_jax_params

REPO = Path(__file__).resolve().parent.parent
SIZE = 32
SERVE_DIR = REPO / "model_instances" / "converged256"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _configs(root, batch_size, tiny=False, **train):
    """The smoke recipe (with ``tiny``, the tiny U-Net model) in
    ``root/models`` at 32x32, and its yaml files."""
    model = yaml2namespace(REPO / "configs" / "smoke.yaml")
    if tiny:
        unet = dict(type="unet_generator", filters=[4, 4], kernels=[3, 3],
                    expansion="upsample", normalization="instancenorm",
                    dropout=False)
        model.generator = dict(unet, output_channels=3,
                               final_activation="tanh")
        model.discriminator = dict(unet, output_channels=1,
                                   final_activation="sigmoid")
    model.location = str(root / "models")
    training = yaml2namespace(REPO / "configs" / "smoke_training.yaml")
    training.image_size, training.batch_size = SIZE, batch_size
    for k, v in train.items():
        training[k] = v
    root.mkdir(parents=True, exist_ok=True)
    paths = root / "model.yaml", root / "train.yaml"
    namespace2yaml(paths[0], model)
    namespace2yaml(paths[1], training)
    return paths


def _records(root, n=5):
    rng = np.random.default_rng(7)
    for domain in ("tabby_records", "tortie_records"):
        (root / domain).mkdir(parents=True)
        images = rng.integers(0, 256, (n, SIZE, SIZE, 3), dtype=np.uint8)
        write_tfrecord_file(root / domain / "00000.tfrecords",
                            (image2example(im) for im in images))


def _run_cli(root, data, nproc, *flags, tiny=False, timeout=300):
    model_yaml, train_yaml = _configs(root, 1, tiny)
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=f"{REPO}:"
               + os.environ.get("PYTHONPATH", ""), OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, "-m", "cyclegan_tpu_torch.train", "--model_config",
         str(model_yaml), "--train_config", str(train_yaml), "--data_dir",
         str(data), "--device", "cpu", "--coordinator",
         f"127.0.0.1:{port}", "--num_processes", str(nproc),
         "--process_id", str(r), *flags],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for r in range(nproc)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-4000:]
    return outs


def _params(folder):
    from cyclegan_tpu_torch import steps

    cfg = yaml2namespace(folder / "model_config.yaml")
    template = {"params": models_to_jax_params(steps.build_models(cfg))}
    restored = load_pytree(folder / "checkpoint.npz", template)
    leaves = []

    def walk(t):
        if isinstance(t, dict):
            for k in sorted(t):
                walk(t[k])
        elif isinstance(t, (list, tuple)):
            for v in t:
                walk(v)
        else:
            leaves.append(np.asarray(t, np.float64).reshape(-1))

    walk(restored["params"])
    return np.concatenate(leaves)


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    root = tmp_path_factory.mktemp("records")
    _records(root)
    return root


def test_two_process_cli_matches_single_process(tmp_path, data):
    pod = tmp_path / "pod"
    outs = _run_cli(pod, data, 2, tiny=True)
    assert "gloo backend" in outs[0] and "rank 1 of 2" in outs[1]
    folder = pod / "models" / "smoke"
    assert (folder / "checkpoint.npz").exists()
    events = list((folder / "train").iterdir())
    assert len(events) == 1, events
    assert len(list((folder / "validation").iterdir())) == 1

    from cyclegan_tpu_torch.train import main

    solo = tmp_path / "solo"
    model_yaml, train_yaml = _configs(solo, 2, tiny=True)
    main(["--model_config", str(model_yaml), "--train_config",
          str(train_yaml), "--data_dir", str(data), "--device", "cpu"])
    np.testing.assert_allclose(_params(folder),
                               _params(solo / "models" / "smoke"),
                               rtol=2e-5, atol=2e-6)


def test_two_process_cli_spatial(tmp_path, data):
    """--spatial_devices 2 --dp_shard_map: each process trains its H strip
    of the same images; the lead writes the one checkpoint."""
    outs = _run_cli(tmp_path, data, 2, "--spatial_devices", "2",
                    "--dp_shard_map")
    assert "'spatial': 2" in outs[0]
    folder = tmp_path / "models" / "smoke"
    assert (folder / "checkpoint.npz").exists()
    assert len(list((folder / "train").iterdir())) == 1
    assert np.isfinite(_params(folder)).all()


def _serve_worker(rank, world, images, dtype, tpu_layout):
    from cyclegan_tpu_torch.apps.inference import InferenceSession

    session = InferenceSession(SERVE_DIR, dtype, tpu_layout=tpu_layout,
                               spatial_devices=world, device="cpu")
    assert session.spatial_mesh.shape == {"data": 1, "spatial": world}
    out = session.stylize(images, "a2b")
    # every rank got the whole output
    whole = torch.from_numpy(out.astype(np.int64))
    total = whole.clone()
    dist.all_reduce(total)
    assert torch.equal(total, whole * world)
    return out


@pytest.mark.parametrize("tpu_layout", [True, False])
def test_spatial_session_matches_whole_session(tpu_layout):
    from cyclegan_tpu_torch.apps.inference import InferenceSession

    images = np.random.default_rng(1).integers(0, 256, (2, 64, 64, 3),
                                               dtype=np.uint8)
    got = run_ranks(_serve_worker, 2, (images, "float32", tpu_layout),
                    timeout=240)[0]
    want = InferenceSession(SERVE_DIR, "float32", tpu_layout=tpu_layout,
                            device="cpu").stylize(images, "a2b")
    diff = np.abs(got.astype(int) - want.astype(int))
    # f32: the strips' sums differ from the whole image's in rounding only
    assert diff.max() <= 1 and (diff > 0).mean() < 1e-3
