"""Batched inference over trained checkpoints
(cyclegan_tpu/apps/inference.py ``InferenceSession``).

Loads the model config and the four networks' weights from a model folder
and stylizes uint8 image batches with the generators. ``tpu_layout``
picks the layout as the JAX session does, with "CUDA" for "TPU": NHCW
(``layout.nhcw()``, between one transpose in and one out), where every
conv, norm, pool and junction of the forward is a hand-written kernel on
the card, or NHWC, the JAX session's XLA path: library convolutions
(cuDNN, TF32 off in f32) and torch ops, no kernel. ``"auto"`` is NHCW on
a CUDA device in bf16 and NHWC otherwise. The layout is scoped on the
calling thread, so sessions of either layout serve side by side on
threads. The networks are the modules training updates; serving freezes
them (``requires_grad_(False)``, eval mode) and runs under
``inference_mode``, so no backward state is kept and the norm kernel
writes no statistics. A batch-norm network serves on its moving
statistics, restored from the checkpoint's ``model_state`` and kept f32
whatever ``compute_dtype`` casts the parameters to (as the JAX session
keeps ``model_state`` f32).

``spatial_devices=N`` > 1 shards each image's H axis over the N ranks of
an initialized process group (JAX ``apps/inference.py:44-60, 141-165``):
every rank calls ``stylize`` on the same full batch, runs its strip
through the generator (conv halos and norm sums exchanged,
``ops/spatialctx.py``; the kernels on the strip in NHCW) and gets the whole
output back, gathered over the ranks.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, NamedTuple, Tuple, Union

import numpy as np
import torch
from torch import nn

from cyclegan_tpu_torch import tracing
from cyclegan_tpu_torch.config import yaml2namespace
from cyclegan_tpu_torch.data.augment import denormalize_to_uint8, normalize
from cyclegan_tpu_torch.data.codec import resize_rgb
from cyclegan_tpu_torch.models import create_model, generated_image
from cyclegan_tpu_torch.ops import cuda_norm, layout, spatialctx
from cyclegan_tpu_torch.parallel import spatial as spatial_mesh
from cyclegan_tpu_torch.utils.checkpoint import load_pytree
from cyclegan_tpu_torch.weights import (
    load_jax_params,
    models_to_jax_params,
    models_to_jax_state,
)

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
_GENERATORS = {"a2b": "g_AB", "b2a": "g_BA"}
# each network and the model config section that builds it
_NETWORKS = {"d_A": "discriminator", "d_B": "discriminator",
             "g_AB": "generator", "g_BA": "generator"}


class _InferenceState(NamedTuple):
    """The four networks, the slice of ``TrainState`` that
    ``steps.make_validate_step`` reads (duck-typed)."""

    models: Dict[str, nn.Module]


class InferenceSession:
    """Loads the four networks from a trained model folder and stylizes
    images with g_AB and g_BA.

    ``compute_dtype="bfloat16"`` casts the parameters and the normalized
    input to bf16 (the serving mode); ``"float32"`` keeps the parity
    numerics. Output is uint8 either way. ``tpu_layout``: True, False or
    "auto" (see the module docstring); ``self.tpu_layout`` is the bool it
    resolved to. ``device`` defaults to ``cuda`` and raises where there is
    no card; pass ``device="cpu"`` to run the plain PyTorch versions of the
    kernels. ``spatial_devices`` > 1 needs a process group of that many
    ranks (the module docstring); ``self.spatial_mesh`` is its mesh.
    """

    def __init__(self, model_dir: Union[str, Path],
                 compute_dtype: str = "float32",
                 tpu_layout: Union[str, bool] = "auto",
                 spatial_devices: int = 0,
                 device: Union[str, torch.device] = "cuda"):
        if compute_dtype not in _DTYPES:
            raise ValueError(f"compute_dtype {compute_dtype!r} not in "
                             f"{sorted(_DTYPES)}")
        self.spatial_mesh = None
        if int(spatial_devices) > 1:
            import torch.distributed as dist

            world = (dist.get_world_size() if dist.is_available()
                     and dist.is_initialized() else 0)
            if world != int(spatial_devices):
                raise RuntimeError(
                    f"InferenceSession(spatial_devices={spatial_devices}) "
                    f"needs an initialized process group of "
                    f"{spatial_devices} ranks (have "
                    f"{world or 'none'}): start one process per device "
                    f"and call parallel.init_distributed in each")
            self.spatial_mesh = spatial_mesh.create_spatial_mesh(
                data=1, spatial=int(spatial_devices))
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "InferenceSession: no CUDA device; pass device='cpu' to run "
                "on the CPU")
        self.compute_dtype = _DTYPES[compute_dtype]
        if isinstance(tpu_layout, str) and tpu_layout.lower() == "auto":
            tpu_layout = (self.device.type == "cuda"
                          and compute_dtype == "bfloat16")
        self.tpu_layout = bool(tpu_layout)

        model_dir = Path(model_dir)
        config_path = model_dir / "model_config.yaml"
        if not config_path.exists():  # pre-final-epoch checkpoints
            config_path = model_dir / "config.yaml"
        self.model_config = yaml2namespace(config_path)

        # The random init is a template for the checkpoint's shapes and is
        # overwritten entirely.
        self.models = {
            name: create_model(getattr(self.model_config, section),
                               torch.Generator().manual_seed(0))
            for name, section in _NETWORKS.items()}
        template = {"params": models_to_jax_params(self.models),
                    "model_state": models_to_jax_state(self.models)}
        restored = load_pytree(model_dir / "checkpoint.npz", template)
        load_jax_params(self.models, restored["params"],
                        restored["model_state"])
        for model in self.models.values():
            model.requires_grad_(False)
            model.eval()
            model.to(device=self.device)
            # the JAX session casts the f32 params per call; once is the
            # same. The buffers (moving statistics) stay f32.
            for p in model.parameters():
                p.data = p.data.to(self.compute_dtype)
        self.state = _InferenceState(self.models)

    @torch.inference_mode()
    def stylize(self, images: np.ndarray, direction: str = "a2b") -> np.ndarray:
        """uint8 RGB batch (N, H, W, 3) -> stylized uint8 RGB batch; float
        input is taken as already in [-1, 1]. A ``tracing`` root
        ``stylize`` with the spans ``h2d``, ``forward`` and ``d2h``; on a
        card each of the two copies waits for the stream, a ``sync``."""
        model = self.models[_GENERATORS[direction]]
        on_card = self.device.type == "cuda"
        with tracing.span("stylize"):
            with tracing.span("h2d"):
                x = torch.as_tensor(np.asarray(images)).to(self.device)
                if on_card:
                    tracing.count("sync")
                x = (normalize(x) if x.dtype == torch.uint8
                     else x.to(torch.float32))
                x = x.to(self.compute_dtype)
            with tracing.span("forward"):
                y = self._forward(model, x)
            with tracing.span("d2h"):
                out = denormalize_to_uint8(y.to(torch.float32)).cpu().numpy()
                if on_card:
                    tracing.count("sync")
        return out

    def _forward(self, model: nn.Module, x: torch.Tensor) -> torch.Tensor:
        """The generator's image on the normalized batch (a U-GAT-IT
        generator's first output), in the session's layout (on this rank's
        strip, gathered, under a spatial mesh)."""
        mesh = self.spatial_mesh
        if mesh is not None:
            x = spatial_mesh.shard_spatial(mesh, x, data_axis=None)
        with spatial_mesh.scope(mesh):
            if self.tpu_layout:
                with layout.nhcw():
                    y = layout.from_nhcw(generated_image(
                        model(layout.to_nhcw(x))))
            else:
                with layout.nhwc(), cuda_norm.scope(False):
                    y = generated_image(model(x))
            if mesh is not None:
                y = spatialctx.gather_h(y)
        return y

    def prediction_triple(self, image_bgr: np.ndarray,
                          size: Tuple[int, int] = (256, 256)):
        """(original RGB, A->B stylized, B->A stylized) at ``size``
        ((width, height), as cv2 takes it): the display triple of the
        JAX package's ``predict.py``."""
        rgb = np.ascontiguousarray(np.asarray(image_bgr)[..., ::-1])
        resized = resize_rgb(rgb, size)
        batch = resized[np.newaxis]
        ab = self.stylize(batch, "a2b")[0]
        ba = self.stylize(batch, "b2a")[0]
        return resized, ab, ba
