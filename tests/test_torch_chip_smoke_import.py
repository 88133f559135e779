"""chip_smoke.py's phase 28 (the reference import) on the CPU.

``write_bundle``'s bundles read back through the port's reader (the
TensorFlow check is in ``tests/test_torch_import_reference.py``), and the
phase runs end to end at 32x32, batch 2: converged256 written in the
reference's layout, imported on the CPU, served and resumed, with the
kernels' dispatchers counted as their launches are on the card (an f32
K1 or K5 launch also counted under its CUDA-core design, as the card's f32
step counts it): every check holds.
"""

import numpy as np
import pytest
import torch

import chip_smoke
from cyclegan_tpu_torch import kernels
from cyclegan_tpu_torch.config import yaml2namespace
from cyclegan_tpu_torch.ops import (cuda_concat, cuda_conv, cuda_norm_act,
                                    cuda_resize)
from cyclegan_tpu_torch.utils.tensor_bundle import TensorBundle

DISPATCHERS = [(cuda_conv, "_conv_same", "conv_same", chip_smoke.SIMT_SAME),
               (cuda_conv, "conv_dw", "conv_dw", chip_smoke.SIMT),
               (cuda_norm_act, "_instance_norm_act", "instance_norm_act",
                None),
               (cuda_norm_act, "instance_norm_act_bwd",
                "instance_norm_act_bwd", None),
               (cuda_resize, "sum2x2", "sum2x2", None),
               (cuda_resize, "dup2x2", "dup2x2", None),
               (cuda_concat, "_concat_up2", "concat_up2", None),
               (cuda_concat, "split_pool2", "split_pool2", None)]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_write_bundle_reads_back(tmp_path):
    rng = np.random.default_rng(1)
    tensors = {f"layer_with_weights-{i}/kernel/.ATTRIBUTES/VARIABLE_VALUE":
               rng.normal(size=(2, i + 1)).astype(np.float32)
               for i in range(12)}
    prefix = tmp_path / "variables" / "variables"
    chip_smoke.write_bundle(prefix, tensors)
    bundle = TensorBundle(prefix)
    assert set(bundle.entries) == set(tensors)
    for key, value in tensors.items():
        np.testing.assert_array_equal(bundle.tensor(key), value)


def test_import_phase_on_the_cpu(tmp_path, monkeypatch):
    for name, value in (("DEVICE", "cpu"), ("SIZE", 32), ("BATCH", 2),
                        ("GRAD_BATCH", 1)):
        monkeypatch.setattr(chip_smoke, name, value)
    monkeypatch.setattr(chip_smoke, "failures", [])
    for module, name, key, simt in DISPATCHERS:
        def counted(x, *args, _plain=getattr(module, name), _key=key,
                    _simt=simt, **kwargs):
            kernels.launches[_key] += 1
            if _simt is not None and x.dtype == torch.float32:
                kernels.launches[_simt] += 1
            return _plain(x, *args, **kwargs)

        monkeypatch.setattr(module, name, counted)
    cfg = yaml2namespace(chip_smoke.MODEL_DIR / "model_config.yaml")
    serve_plan = chip_smoke.serve_launches(cfg.generator, 2, 32)
    train_plan = chip_smoke.train_launches(cfg, 1, 32)
    launches, metrics = chip_smoke.import_reference(cfg, serve_plan,
                                                    train_plan, tmp_path)
    assert chip_smoke.failures == []
    assert launches["import_serve"] == {k: len(v) for k, v in
                                        serve_plan.items()}
    assert metrics["serve_bit_equal"] and metrics["resume_bit_equal"]
    assert not metrics["tensorflow_imported"]
