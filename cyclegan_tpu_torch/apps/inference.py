"""Batched inference over trained checkpoints
(cyclegan_tpu/apps/inference.py ``InferenceSession``).

Loads the model config and the two generators' weights from a model
folder and stylizes uint8 image batches. The generator runs in the NHCW
layout (``layout.nhcw()``) between one transpose in and one out, so on the
card every conv, norm, pool and junction of the forward is a hand-written
kernel. The
generators are the modules training updates; serving freezes them
(``requires_grad_(False)``, eval mode) and runs under ``inference_mode``,
so no backward state is kept and the norm kernel writes no statistics.
"""

from __future__ import annotations

from pathlib import Path
from typing import Union

import numpy as np
import torch

from cyclegan_tpu_torch.config import yaml2namespace
from cyclegan_tpu_torch.data.augment import denormalize_to_uint8, normalize
from cyclegan_tpu_torch.models import create_model
from cyclegan_tpu_torch.ops import layout
from cyclegan_tpu_torch.utils.checkpoint import load_pytree
from cyclegan_tpu_torch.weights import jax_params_to_torch, module_to_jax_params

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
_GENERATORS = {"a2b": "g_AB", "b2a": "g_BA"}


class InferenceSession:
    """Loads g_AB and g_BA from a trained model folder and stylizes images.

    ``compute_dtype="bfloat16"`` casts the parameters and the normalized
    input to bf16 (the serving mode); ``"float32"`` keeps the parity
    numerics. Output is uint8 either way. ``device`` defaults to ``cuda``
    and raises where there is no card; pass ``device="cpu"`` to run the
    plain PyTorch versions of the kernels.
    """

    def __init__(self, model_dir: Union[str, Path],
                 compute_dtype: str = "float32",
                 device: Union[str, torch.device] = "cuda"):
        if compute_dtype not in _DTYPES:
            raise ValueError(f"compute_dtype {compute_dtype!r} not in "
                             f"{sorted(_DTYPES)}")
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "InferenceSession: no CUDA device; pass device='cpu' to run "
                "on the CPU")
        self.compute_dtype = _DTYPES[compute_dtype]

        model_dir = Path(model_dir)
        config_path = model_dir / "model_config.yaml"
        if not config_path.exists():  # pre-final-epoch checkpoints
            config_path = model_dir / "config.yaml"
        self.model_config = yaml2namespace(config_path)

        # Only the generators serve; their random init is a template for
        # the checkpoint's shapes and is overwritten entirely.
        self.models = {name: create_model(self.model_config.generator,
                                          torch.Generator().manual_seed(0))
                       for name in _GENERATORS.values()}
        template = {"params": {name: module_to_jax_params(m)
                               for name, m in self.models.items()}}
        restored = load_pytree(model_dir / "checkpoint.npz", template)
        for name, model in self.models.items():
            model.load_state_dict(
                jax_params_to_torch(restored["params"][name]), strict=True)
            model.requires_grad_(False)
            model.eval()
            # the JAX session casts the f32 params per call; once is the same
            model.to(device=self.device, dtype=self.compute_dtype)

    @torch.inference_mode()
    def stylize(self, images: np.ndarray, direction: str = "a2b") -> np.ndarray:
        """uint8 RGB batch (N, H, W, 3) -> stylized uint8 RGB batch."""
        model = self.models[_GENERATORS[direction]]
        x = torch.as_tensor(np.asarray(images)).to(self.device)
        x = normalize(x) if x.dtype == torch.uint8 else x.to(torch.float32)
        x = x.to(self.compute_dtype)
        with layout.nhcw():
            y = layout.from_nhcw(model(layout.to_nhcw(x)))
        return denormalize_to_uint8(y.to(torch.float32)).cpu().numpy()
