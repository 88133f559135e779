"""The port's train-step bench entry point runs on the CPU when asked and
refuses to run without a card otherwise."""

import json

import pytest
import torch

from cyclegan_tpu_torch import bench


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for these small CPU shapes: the suite runs in
    several worker processes at once, and torch's default of one thread
    per core in each of them oversubscribes the cores many times over."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_cpu_run_prints_one_json_line(capsys):
    result = bench.main(["--device", "cpu", "--batch", "1", "--image-size",
                         "32", "--steps", "1", "--warmup", "0"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    printed = json.loads(lines[0])
    assert printed == result
    assert printed["metric"] == "train_images_per_sec_32px_b1_bfloat16"
    assert printed["unit"] == "images/sec/chip"
    assert printed["device"] == "cpu"
    assert printed["value"] > 0 and printed["step_ms"] > 0


def test_default_device_is_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench.main(["--batch", "1", "--image-size", "32", "--steps", "1",
                    "--warmup", "0"])


@pytest.mark.parametrize("flags,layout", [
    (["--remat"], "nhcw"), (["--fuse-apps"], "nhcw"),
    (["--paired", "--pallas"], "nhwc")])
def test_step_option_flags_reach_the_step(flags, layout, monkeypatch):
    """``--remat``, ``--fuse-apps`` and ``--paired`` are the step's
    options; ``--paired`` runs NHWC whatever ``--layout`` says."""
    seen = {}
    make = bench.make_train_step

    def recording(*args, **kwargs):
        seen.update(kwargs)
        return make(*args, **kwargs)

    monkeypatch.setattr(bench, "make_train_step", recording)
    result = bench.main(["--device", "cpu", "--batch", "1", "--image-size",
                         "32", "--steps", "1", "--warmup", "0", *flags])
    assert result["layout"] == layout
    assert seen["tpu_layout"] == (layout == "nhcw")
    for flag, key in (("--remat", "remat"), ("--fuse-apps", "fuse_apps"),
                      ("--paired", "paired")):
        assert seen[key] == result[key] == (flag in flags), key
    assert result["value"] > 0
