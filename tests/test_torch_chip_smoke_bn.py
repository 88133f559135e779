"""chip_smoke.py's phases 24 (batch norm) and 25 (the data layer), on the
CPU.

The batch-norm plan is held against the launches a recorded train step
really makes; the f32 point is held kink-free; and both phases run end to
end at 32x32, batch 2, with the kernels' dispatchers counted as their
launches are on the card: every check holds.
"""

import collections

import numpy as np
import pytest
import torch

import chip_smoke
from cyclegan_tpu_torch import kernels
from cyclegan_tpu_torch.data.codec import image2example
from cyclegan_tpu_torch.data.tfrecord import write_tfrecord_file
from cyclegan_tpu_torch.ops import (cuda_concat, cuda_conv, cuda_norm,
                                    cuda_norm_act, cuda_resize, layout)
from tests.test_torch_chip_smoke import _record_train_step

# each NHCW dispatcher the Functions call and the kernel it launches
DISPATCHERS = [(cuda_conv, "_conv_same", "conv_same"),
               (cuda_conv, "conv_dw", "conv_dw"),
               (cuda_norm_act, "_instance_norm_act", "instance_norm_act"),
               (cuda_norm_act, "instance_norm_act_bwd",
                "instance_norm_act_bwd"),
               (cuda_resize, "sum2x2", "sum2x2"),
               (cuda_resize, "dup2x2", "dup2x2"),
               (cuda_concat, "_concat_up2", "concat_up2"),
               (cuda_concat, "split_pool2", "split_pool2"),
               (cuda_norm, "_instance_norm_nhwc", "instance_norm_nhwc")]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs in several worker processes."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_batchnorm_plan_matches_a_recorded_step(monkeypatch):
    cfg = chip_smoke.batchnorm_config()
    with layout.nhcw():
        seen = _record_train_step(monkeypatch, cfg, 2, 32)
    plan = chip_smoke.batchnorm_launches(chip_smoke.train_launches(cfg, 2,
                                                                   32))
    assert set(seen) == set(plan) == {
        "conv_same", "conv_dw", "sum2x2", "dup2x2", "concat_up2",
        "split_pool2"}
    for name, shapes in plan.items():
        assert collections.Counter(seen[name]) == \
            collections.Counter(shapes), name
    full = chip_smoke.batchnorm_launches(chip_smoke.train_launches(cfg, 8,
                                                                   256))
    assert {k: len(v) for k, v in full.items()} == {
        "conv_same": 304, "sum2x2": 30, "concat_up2": 30, "conv_dw": 134,
        "dup2x2": 30, "split_pool2": 30}


def test_bn_f32_point_is_kink_free():
    cfg = chip_smoke.batchnorm_config()
    x = chip_smoke.f32_point_inputs(chip_smoke.BN_F32_POINT)
    _, kink = chip_smoke.nearest_kink(lambda: chip_smoke._bn_step(
        cfg, "cpu", "float32", x, chip_smoke.BN_F32_POINT))
    assert kink > chip_smoke.KINK_MARGIN


def test_batchnorm_and_data_phases_on_the_cpu(tmp_path, monkeypatch):
    for name, value in (("DEVICE", "cpu"), ("SIZE", 32), ("BATCH", 2),
                        ("CLI_IMAGES", 10), ("TIMED_REPS", 1),
                        ("TRAIN_STEPS_TIMED", 1)):
        monkeypatch.setattr(chip_smoke, name, value)
    monkeypatch.setattr(chip_smoke, "failures", [])
    monkeypatch.setattr(chip_smoke, "smi_line", lambda: "cpu, 0 W")
    monkeypatch.setattr(chip_smoke, "device_trace", lambda *a, **k: None)
    for name in ("synchronize", "reset_peak_memory_stats"):
        monkeypatch.setattr(torch.cuda, name, lambda *a: None)
    monkeypatch.setattr(torch.cuda, "max_memory_allocated", lambda *a: 0)
    for module, name, key in DISPATCHERS:
        def counted(*args, _plain=getattr(module, name), _key=key,
                    **kwargs):
            kernels.launches[_key] += 1
            return _plain(*args, **kwargs)

        monkeypatch.setattr(module, name, counted)
    cfg = chip_smoke.batchnorm_config()
    plan = chip_smoke.batchnorm_launches(chip_smoke.train_launches(cfg, 2,
                                                                   32))
    serve = chip_smoke.batchnorm_launches(chip_smoke.serve_launches(
        cfg["generator"], 2, 32))
    launches, forwards, metrics = chip_smoke.batchnorm(cfg, plan, serve,
                                                       tmp_path, None)
    assert chip_smoke.failures == []
    assert launches["unet_bn_train"] == {k: len(v) for k, v in plan.items()}
    assert launches["unet_bn_serve"] == chip_smoke._times(serve, forwards)
    assert metrics["serving"]["nhwc"]["launches"] == {}
    assert metrics["reload_differences"] == []

    rng = np.random.default_rng(0)
    for domain in ("tabby_records", "tortie_records"):
        (tmp_path / "data" / domain).mkdir(parents=True)
        write_tfrecord_file(tmp_path / "data" / domain / "00000.tfrecords",
                            (image2example(im) for im in rng.integers(
                                0, 256, (10, 32, 32, 3), dtype=np.uint8)))
    launches, metrics = chip_smoke.data_layer(tmp_path)
    assert chip_smoke.failures == []
    assert metrics["streaming"]["batches_compared"] == 2 * (4 + 1)
    assert metrics["native_loader"]["built"]
    assert metrics["native_loader"]["max_steps_from_python"] == 0
    assert metrics["trainer_streaming"]["step"] == 4
    assert "instance_norm_nhwc" not in launches["trainer_cli_streaming"]
    assert set(metrics["png_unfilter"]) == {"average", "paeth"}
