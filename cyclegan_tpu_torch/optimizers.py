"""Optimizers by config (cyclegan_tpu/optimizers.py ``get_optimizer``).

- adam: beta_1 from the config, beta_2 0.999 and Keras' epsilon 1e-7
  (torch defaults to 1e-8). torch's update, lr * m_hat / (sqrt(v_hat) +
  eps) with both moments bias-corrected, is optax's. The config may set
  ``epsilon`` and ``weight_decay`` (coupled, torch's: g += wd * p before
  the moments): U-GAT-IT's 1e-8 and 1e-4.
- rmsprop: ``torch.optim.RMSprop`` with alpha 0.9 and eps 1e-7, which is
  optax's ``rmsprop(decay=0.9, eps=1e-7, eps_in_sqrt=False)``: both start
  nu at 0 and update by lr * g / (sqrt(nu) + eps).
- sgd: ``torch.optim.SGD``, lr * g.
- adabelief: ``AdaBeliefTF``, the adabelief-tf semantics of the JAX
  package's ``adabelief_tf_update``: eps inside the s EMA, and the update
  RAdam-rectified, bias-corrected momentum before the gate opens.
"""

from __future__ import annotations

from typing import Any, Iterable, Mapping

import numpy as np
import torch

ADAM_BETA_2 = 0.999
KERAS_EPSILON = 1e-7
RMSPROP_DECAY = 0.9


class AdaBeliefTF(torch.optim.Optimizer):
    """AdaBelief as ``adabelief_tf.AdaBeliefOptimizer`` (the JAX package's
    ``adabelief_tf_update``; defaults of adabelief-tf 0.2.1: eps 1e-14,
    rectify, sma_threshold 5, no weight decay, no amsgrad):

      m = b1 m + (1 - b1) g
      s = b2 s + (1 - b2) (g - m)^2 + eps
      m_hat = m / (1 - b1^t);  s_hat = s / (1 - b2^t)
      sma_t >= sma_threshold:  w -= lr r_t m_hat / (sqrt(s_hat) + eps)
      else:                    w -= lr m_hat

    with RAdam's sma_t and r_t. The step count lives on the host (one per
    optimizer, optax's ``count``), so the scalar terms, computed in f32 as
    JAX computes them, and the gate are host numbers: a step never reads
    the card. Per parameter the state holds ``step`` (a CPU f32 tensor, as
    torch Adam's), ``m`` and ``s``.
    """

    def __init__(self, params, lr: float, b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-14, rectify: bool = True,
                 sma_threshold: float = 5.0):
        super().__init__(params, dict(lr=lr, b1=b1, b2=b2, eps=eps,
                                      rectify=rectify,
                                      sma_threshold=sma_threshold))

    @staticmethod
    def coefficients(t: int, b1: float, b2: float, rectify: bool,
                     sma_threshold: float):
        """(1 - b1^t, 1 - b2^t, r_t or None where the gate is shut), in f32
        as ``adabelief_tf_update`` computes them."""
        f = np.float32
        tf = f(t)
        bc1 = f(1) - f(b1) ** tf
        bc2 = f(1) - f(b2) ** tf
        if not rectify:
            return bc1, bc2, f(1)
        sma_inf = 2.0 / (1.0 - b2) - 1.0
        sma_t = f(sma_inf) - f(2) * tf * (f(b2) ** tf) / bc2
        if not sma_t >= sma_threshold:
            return bc1, bc2, None
        r_t = np.sqrt(f(sma_t - 4) * f(sma_t - 2) * f(sma_inf)
                      / (f((sma_inf - 4) * (sma_inf - 2)) * sma_t))
        return bc1, bc2, f(r_t)

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        for group in self.param_groups:
            params = [p for p in group["params"] if p.grad is not None]
            if not params:
                continue
            b1, b2, eps, lr = (group["b1"], group["b2"], group["eps"],
                               group["lr"])
            for p in params:
                state = self.state[p]
                if not state:
                    state["step"] = torch.zeros((), dtype=torch.float32)
                    state["m"] = torch.zeros_like(
                        p, memory_format=torch.preserve_format)
                    state["s"] = torch.zeros_like(
                        p, memory_format=torch.preserve_format)
                state["step"] += 1
            t = int(self.state[params[0]]["step"])
            grads = [p.grad for p in params]
            ms = [self.state[p]["m"] for p in params]
            ss = [self.state[p]["s"] for p in params]
            torch._foreach_mul_(ms, b1)
            torch._foreach_add_(ms, grads, alpha=1.0 - b1)
            diff = torch._foreach_sub(grads, ms)
            torch._foreach_mul_(diff, diff)
            torch._foreach_mul_(diff, 1.0 - b2)
            torch._foreach_mul_(ss, b2)
            torch._foreach_add_(ss, diff)
            torch._foreach_add_(ss, eps)
            bc1, bc2, r_t = self.coefficients(
                t, b1, b2, group["rectify"], group["sma_threshold"])
            updates = torch._foreach_div(ms, float(bc1))
            if r_t is not None:
                denom = torch._foreach_div(ss, float(bc2))
                torch._foreach_sqrt_(denom)
                torch._foreach_add_(denom, eps)
                torch._foreach_mul_(updates, float(r_t))
                torch._foreach_div_(updates, denom)
            torch._foreach_add_(params, updates, alpha=-lr)
        return loss


def get_optimizer(optimizer_config: Mapping[str, Any],
                  params: Iterable[torch.nn.Parameter]
                  ) -> torch.optim.Optimizer:
    """A torch optimizer over ``params`` from a {name, learning_rate, ...}
    config; an unknown name raises ValueError, as JAX's."""
    name = optimizer_config["name"]
    learning_rate = float(optimizer_config["learning_rate"])
    if name == "adam":
        return torch.optim.Adam(
            params, lr=learning_rate,
            betas=(float(optimizer_config["beta_1"]), ADAM_BETA_2),
            eps=float(optimizer_config.get("epsilon", KERAS_EPSILON)),
            weight_decay=float(optimizer_config.get("weight_decay", 0.0)))
    if name == "rmsprop":
        return torch.optim.RMSprop(params, lr=learning_rate,
                                   alpha=RMSPROP_DECAY, eps=KERAS_EPSILON)
    if name == "sgd":
        return torch.optim.SGD(params, lr=learning_rate)
    if name == "adabelief":
        return AdaBeliefTF(params, lr=learning_rate)
    raise ValueError(f"Optimizer {name} not found.")
