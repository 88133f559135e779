"""The T recipe's bf16 gradients (``configs/unet_transpose.yaml``: U-Nets
with ``expansion: transpose``, full width and depth) against the JAX
package's, on the CPU.

At seeded weights with every affine norm's beta at 0, whole channels do
not sit on either side of a ReLU kink, so a bf16 step's gradients land
far from the f32 step's: the generators' about their own size away, in
both packages. The port's bf16 step (NHCW, the kernels' plain versions)
must be no farther from JAX's f32 gradients than 1.5x the JAX bf16 step's
own distance from them, per network (``chip_smoke.py``'s RATIO for the
card's bf16 step against the plain one). Batch 1 at 64x64, seeded uniform
input; both JAX gradients under ``jax.jit``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import RATIO
from cyclegan_tpu import steps as jax_steps
from cyclegan_tpu.losses import get_loss_obj as jax_loss_obj
from cyclegan_tpu.models import create_model as jax_create_model
from cyclegan_tpu_torch import steps
from cyclegan_tpu_torch.config import yaml2namespace
from cyclegan_tpu_torch.losses import get_losses
from cyclegan_tpu_torch.ops import layout
from cyclegan_tpu_torch.weights import (jax_params_to_torch,
                                        models_to_jax_params)

CONFIG = yaml2namespace("configs/unet_transpose.yaml")
WEIGHTS = {k: float(v) for k, v in CONFIG.loss_weights.items()}
NETWORKS = steps.NETWORKS


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs in several worker processes."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def point():
    models = steps.build_models(CONFIG, seed=0)
    for model in models.values():
        for key, p in model.named_parameters():
            if key.endswith("beta"):
                assert not p.detach().any()
    real_a, real_b = (np.random.default_rng(s).uniform(
        -1, 1, (1, 64, 64, 3)).astype(np.float32) for s in (2, 3))
    return models, real_a, real_b


def _flat(grads):
    return np.concatenate([grads[k].ravel() for k in sorted(grads)])


@pytest.fixture(scope="module")
def jax_grads(point):
    """{dtype name: {network: flat gradient}} of JAX's train-step
    surrogate in f32 and bf16 compute."""
    models, real_a, real_b = point
    params = models_to_jax_params(models)
    jax_models = {n: jax_create_model(CONFIG.generator if n.startswith("g")
                                      else CONFIG.discriminator)
                  for n in NETWORKS}
    state = {n: jax.eval_shape(jax_models[n].init, jax.random.PRNGKey(0))[1]
             for n in NETWORKS}
    out = {}
    for name, dtype in (("f32", jnp.float32), ("bf16", jnp.bfloat16)):
        def surrogate(p, a, b, dtype=dtype):
            total, _, _ = jax_steps._forward_losses(
                p, state, jax_models, jax_loss_obj(CONFIG.loss), WEIGHTS, a,
                b, train=True, rng=None, stop_grads=True,
                compute_dtype=dtype)
            return total

        grads = jax.jit(jax.grad(surrogate))(
            jax.tree.map(jnp.asarray, params), jnp.asarray(real_a),
            jnp.asarray(real_b))
        out[name] = {n: _flat({k: v.numpy() for k, v in jax_params_to_torch(
            jax.tree.map(np.asarray, grads[n])).items()}) for n in NETWORKS}
    return out


def test_port_bf16_gradients_within_ratio_of_jax_bf16(point, jax_grads):
    models, real_a, real_b = point
    with layout.nhcw():
        surrogate, _ = steps._forward_losses(
            models, get_losses(CONFIG.loss), WEIGHTS,
            torch.from_numpy(real_a), torch.from_numpy(real_b),
            torch.bfloat16, stop_grads=True)
    named = {n: list(models[n].named_parameters()) for n in NETWORKS}
    values = iter(torch.autograd.grad(
        surrogate, [p for n in NETWORKS for _, p in named[n]]))
    port = {n: _flat({k: next(values).numpy() for k, _ in named[n]})
            for n in NETWORKS}
    for n in NETWORKS:
        ref = jax_grads["f32"][n]
        norm = np.linalg.norm(ref)
        jax_dist = np.linalg.norm(jax_grads["bf16"][n] - ref) / norm
        port_dist = np.linalg.norm(port[n] - ref) / norm
        assert port_dist <= RATIO * jax_dist, (n, port_dist, jax_dist)
