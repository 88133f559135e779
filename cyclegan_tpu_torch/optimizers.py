"""Optimizers by config (cyclegan_tpu/optimizers.py ``get_optimizer``).

Adam takes beta_1 from the config, beta_2 0.999 and Keras' epsilon 1e-7
(torch defaults to 1e-8). torch's update, lr * m_hat / (sqrt(v_hat) + eps)
with both moments bias-corrected, is optax's. RMSprop, SGD and the
adabelief-tf semantics wait for the trainer slice.
"""

from __future__ import annotations

from typing import Any, Iterable, Mapping

import torch

ADAM_BETA_2 = 0.999
KERAS_EPSILON = 1e-7
_NOT_YET = ("rmsprop", "sgd", "adabelief")


def get_optimizer(optimizer_config: Mapping[str, Any],
                  params: Iterable[torch.nn.Parameter]
                  ) -> torch.optim.Optimizer:
    """A torch optimizer over ``params`` from a {name, learning_rate, ...}
    config. A name of the JAX package not ported yet raises
    NotImplementedError; an unknown name raises ValueError, as JAX's."""
    name = optimizer_config["name"]
    learning_rate = float(optimizer_config["learning_rate"])
    if name == "adam":
        return torch.optim.Adam(
            params, lr=learning_rate,
            betas=(float(optimizer_config["beta_1"]), ADAM_BETA_2),
            eps=KERAS_EPSILON)
    if name in _NOT_YET:
        raise NotImplementedError(
            f"optimizer {name!r} is not ported yet (ROADMAP.md queue 1, "
            f"item 2: the trainer slice)")
    raise ValueError(f"Optimizer {name} not found.")
