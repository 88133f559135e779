"""The port's whole U-Net generator against the JAX package, on the CPU.

The default recipe's generator (filters 16/32/64/128, all k4, upsample
expansion, affine instance norm, tanh) at 64x64, batch 2. Weights are drawn
with numpy from a seed, in the JAX parameter tree, and carried across by
``jax_params_to_torch``; the port runs its plain kernel versions.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cyclegan_tpu.models import create_model as jax_create_model
from cyclegan_tpu_torch.models import UNetGenerator, create_model
from cyclegan_tpu_torch.ops import layout
from cyclegan_tpu_torch.weights import jax_params_to_torch


@pytest.fixture(autouse=True, scope="module")
def _nhcw_layout():
    """These tests feed the ops and networks NHCW activations, the layout
    of the port's kernels; the default layout scope is NHWC."""
    with layout.nhcw():
        yield


CONFIG = {
    "type": "unet_generator",
    "filters": [16, 32, 64, 128],
    "kernels": [4, 4, 4, 4],
    "output_channels": 3,
    "expansion": "upsample",
    "normalization": "instancenorm",
    "dropout": False,
    "final_activation": "tanh",
}


def _numpy_params(seed):
    """The JAX init's tree, every leaf redrawn with numpy: convs N(0, 0.1),
    gamma 1 + N(0, 0.1), beta and biases N(0, 0.1)."""
    params, state = jax_create_model(CONFIG).init(jax.random.PRNGKey(0))
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        name = str(path[-1].key)
        noise = 0.1 * rng.normal(size=leaf.shape)
        return (noise + 1.0 if name == "gamma" else noise).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, params), state


@pytest.fixture(scope="module")
def weights_and_input():
    params, state = _numpy_params(seed=0)
    x = np.random.default_rng(1).uniform(-1, 1, (2, 64, 64, 3))
    return params, state, x.astype(np.float32)


def _port(params, x, dtype):
    model = UNetGenerator(CONFIG)
    model.load_state_dict(jax_params_to_torch(params), strict=True)
    model.to(dtype)
    with torch.no_grad():
        y = model(layout.to_nhcw(torch.from_numpy(x).to(dtype)))
    return layout.from_nhcw(y).float().numpy()


def _jax(params, state, x, dtype):
    model = jax_create_model(CONFIG)
    p = jax.tree_util.tree_map(lambda v: jnp.asarray(v, dtype), params)
    y, _ = jax.jit(lambda p, x: model.apply(p, state, x, train=False))(
        p, jnp.asarray(x, dtype))
    return np.asarray(y, np.float32)


def test_generator_f32_matches_jax(weights_and_input):
    params, state, x = weights_and_input
    got = _port(params, x, torch.float32)
    ref = _jax(params, state, x, jnp.float32)
    assert got.shape == ref.shape == (2, 64, 64, 3)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-4)


def test_generator_bf16_matches_jax_bf16(weights_and_input):
    """Both round every activation to bf16; tanh output on [-1, 1].

    Fifteen layers of bf16 rounding, re-amplified by every instance norm,
    leave a tail: at this size the JAX bf16 output itself differs from the
    JAX f32 output by up to ~0.09 (mean ~0.01), and the port's bf16 by as
    much, in other pixels. So the port is held to the mean difference from
    JAX bf16 (3e-2), and to a worst case no more than 1.5x the JAX bf16
    path's own distance from f32."""
    params, state, x = weights_and_input
    got = _port(params, x, torch.bfloat16)
    ref = _jax(params, state, x, jnp.bfloat16)
    exact = _jax(params, state, x, jnp.float32)
    assert np.abs(got - ref).mean() <= 3e-2
    assert np.abs(got - exact).max() <= 1.5 * np.abs(ref - exact).max()


def test_state_dict_keys_are_checkpoint_paths():
    params, _ = jax_create_model(CONFIG).init(jax.random.PRNGKey(0))
    flat = jax_params_to_torch(jax.device_get(params))
    model = UNetGenerator(CONFIG, torch.Generator().manual_seed(0))
    assert set(model.state_dict()) == set(flat)
    for key, value in model.state_dict().items():
        assert tuple(value.shape) == tuple(flat[key].shape), key
    assert "down.0.0.conv.w" in flat and "head.b" in flat


def test_random_init_is_seeded_and_distributed():
    a = UNetGenerator(CONFIG, torch.Generator().manual_seed(3)).state_dict()
    b = UNetGenerator(CONFIG, torch.Generator().manual_seed(3)).state_dict()
    for key in a:
        assert torch.equal(a[key], b[key]), key
    w = a["up.1.dc.0.conv.w"]
    assert abs(w.std().item() - 0.02) < 2e-3
    head = a["head.w"]  # glorot_uniform: |w| <= sqrt(6 / (fan_in + fan_out))
    assert head.abs().max().item() <= (6.0 / (32 + 3)) ** 0.5
    assert torch.equal(a["down.0.0.norm.gamma"], torch.ones(16))


@pytest.mark.parametrize("change,error", [
    ({"type": "no_such_model"}, KeyError),
])
def test_unported_configs_raise(change, error):
    with pytest.raises(error):
        create_model({**CONFIG, **change})


@pytest.mark.parametrize("config", [
    {"type": "resnet_generator", "filters": 4},
    {"type": "simple_discriminator", "filters": [8, 16], "kernels": [4, 4],
     "normalization": "instancenorm"},
])
def test_resnet_recipe_models_build(config):
    model = create_model(config, torch.Generator().manual_seed(0))
    with torch.no_grad():
        y = model(torch.zeros(1, 16, 3, 16))
    assert y.shape == ((1, 16, 3, 16) if "resnet" in config["type"]
                       else (1, 4, 1, 4))
