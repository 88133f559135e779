"""The port's offline evaluation against the JAX package's, on the CPU:
``evaluate`` (the validate step's six metrics over a split) and
``evaluate_quality`` (stylized vs real FID-class statistics), on records
the test writes, ``model_instances/demo``'s weights at 16x16.

Tolerances: the metrics within 1e-5 (f32 forwards in another order); the
proxy FID/KID within 1e-3 relative (f32 features within 1e-4, and a
stylized pixel may round to the other uint8 step); SWD on the same uint8
images equal unless a stylized pixel differs by that step.
"""

import json
import shutil

import numpy as np
import pytest
import torch

from cyclegan_tpu.apps import evaluate as jax_evaluate
from cyclegan_tpu_torch.apps import evaluate
from cyclegan_tpu_torch.data import png
from cyclegan_tpu_torch.data.tfrecord import tfrecord_writer

METRICS = ("dA_loss", "dB_loss", "gAB_loss", "gBA_loss", "dA_acc", "dB_acc")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs in several worker processes."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """demo's model folder, trained at 16x16 per its train config, and 10
    seeded images a domain in two shards each."""
    root = tmp_path_factory.mktemp("eval")
    model = root / "model"
    model.mkdir()
    for name in ("checkpoint.npz", "model_config.yaml"):
        shutil.copy(f"model_instances/demo/{name}", model / name)
    (model / "train_config.yaml").write_text("image_size: 16\n")
    rng = np.random.default_rng(8)
    records = {}
    for domain in ("a", "b"):
        src = root / f"imgs_{domain}"
        src.mkdir()
        for i in range(10):
            img = rng.integers(0, 256, (16, 16, 3), dtype=np.uint8)
            (src / f"{i}.png").write_bytes(png.encode_png(img))
        records[domain] = [str(p) for p in tfrecord_writer(
            src, root / f"rec_{domain}", shard_size=6, seed=0)]
    return model, records


@pytest.mark.parametrize("split,batch", [("val", 1), ("train", 4)])
def test_evaluate_matches_jax(setup, split, batch):
    model, records = setup
    got = evaluate.evaluate(model, records["a"], records["b"], batch=batch,
                            split=split, device="cpu")
    want = jax_evaluate.evaluate(model, records["a"], records["b"],
                                 batch=batch, split=split)
    assert sorted(got) == sorted(want) == sorted(METRICS + ("batches",
                                                            "split"))
    assert got["batches"] == want["batches"] == (2 if split == "val" else 2)
    assert got["split"] == split
    for key in METRICS:
        assert abs(got[key] - want[key]) <= 1e-5, key


def test_evaluate_quality_matches_jax(setup):
    model, records = setup
    got = evaluate.evaluate_quality(model, records["a"], records["b"],
                                    batch=4, split="train", device="cpu")
    want = jax_evaluate.evaluate_quality(model, records["a"], records["b"],
                                         batch=4, split="train")
    assert sorted(got) == sorted(want)
    assert got["n_images"] == want["n_images"] == 8
    for tag in ("a2b", "b2a"):
        for key in ("fid_proxy", "kid_proxy"):
            g, w = got[f"{tag}_{key}"], want[f"{tag}_{key}"]
            assert abs(g - w) <= 1e-3 * abs(w) + 1e-5, (tag, key)
        assert abs(got[f"{tag}_swd"] - want[f"{tag}_swd"]) <= 1e-3


def test_main_prints_one_json_line(setup, capsys):
    model, records = setup
    evaluate.main(["--model_dir", str(model), "--records_a",
                   str(records["a"][0]).rsplit("/", 1)[0], "--records_b",
                   *records["b"], "--batch", "2", "--quality",
                   "--max_images", "4", "--device", "cpu"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    result = json.loads(lines[0])
    assert set(METRICS) < set(result)
    assert {"a2b_fid_proxy", "b2a_kid_proxy", "a2b_swd", "n_images"} < set(
        result)
    assert result["split"] == "val" and result["n_images"] == 2
