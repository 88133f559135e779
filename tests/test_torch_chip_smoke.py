"""chip_smoke.py's launch plan is the generator's real one.

chip_smoke.py checks and times each kernel at the shape of every launch of
one generator forward, from a plan it derives from the config. Here the
plan is held against the launches a forward really makes, recorded on the
CPU through the plain versions the wrappers call there.
"""

import pytest
import torch

import chip_smoke
from cyclegan_tpu_torch.config import yaml2namespace
from cyclegan_tpu_torch.models import UNetGenerator
from cyclegan_tpu_torch.ops import (cuda_concat, cuda_conv, cuda_norm_act,
                                    cuda_resize)


@pytest.mark.parametrize("config", [
    "model_instances/converged256/model_config.yaml",
    "configs/smoke.yaml",
])
def test_launch_plan_matches_a_recorded_forward(config, monkeypatch):
    cfg = yaml2namespace(config).generator
    batch, size = 2, 32
    seen = {"conv_same": [], "instance_norm_act": [], "sum2x2": [],
            "concat_up2": []}

    def record(module, name, key, shape_of):
        plain = getattr(module, name)

        def wrapper(*args, **kwargs):
            seen[key].append(shape_of(*args))
            return plain(*args, **kwargs)

        monkeypatch.setattr(module, name, wrapper)

    record(cuda_conv, "conv_same_plain", "conv_same",
           lambda x, w, b=None: (x.shape[0], x.shape[1], x.shape[2],
                                 w.shape[3], w.shape[0], b is not None))
    record(cuda_norm_act, "instance_norm_act_plain", "instance_norm_act",
           lambda x, *a: (x.shape[0], x.shape[1], x.shape[2]))
    record(cuda_resize, "sum2x2_plain", "sum2x2",
           lambda x, *a: (x.shape[0], x.shape[1], x.shape[2]))
    record(cuda_concat, "concat_up2_plain", "concat_up2",
           lambda skip, x: (skip.shape[0], skip.shape[1], skip.shape[2],
                            x.shape[2]))
    model = UNetGenerator(cfg, torch.Generator().manual_seed(0))
    with torch.no_grad():
        model(torch.zeros(batch, size, 3, size))
    assert chip_smoke.generator_launches(cfg, batch, size) == seen


def test_default_generator_launch_counts():
    cfg = yaml2namespace("model_instances/converged256/model_config.yaml")
    plan = chip_smoke.generator_launches(cfg.generator, 8, 256)
    assert {k: len(v) for k, v in plan.items()} == {
        "conv_same": 15, "instance_norm_act": 14, "sum2x2": 3,
        "concat_up2": 3}
    assert (8, 128, 160, 64, 4, False) in plan["conv_same"]
    assert plan["conv_same"][-1] == (8, 256, 32, 3, 1, True)
