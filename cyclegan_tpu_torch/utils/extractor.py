"""The pretrained feature-extractor file format, its interpreter in torch
ops and its writer from Keras (cyclegan_tpu/utils/extractor.py
``FORMAT_VERSION``, ``build_forward``, ``load_extractor``,
``export_keras_extractor``): real FID as a weight-file drop-in.

**Format** (one ``.npz``, the JAX package's):

- key ``__graph__``: a JSON string (0-d ``str_`` array),
  ``{"format_version": 1, "image_size": int, "preprocess": "inception",
  "input": name, "output": name, "layers": [...]}``, each layer
  ``{"name", "type", "inputs": [names], ...type-specific params}``. The
  types: ``input``, ``conv2d`` (strides, padding, use_bias, activation
  linear or relu), ``batchnorm`` (epsilon; gamma and beta optional),
  ``activation`` (relu), ``maxpool2d`` and ``avgpool2d`` (pool_size,
  strides, padding; the average counts only in-bounds elements, as TF's
  SAME does), ``concat`` (channels) and ``globalavgpool``;
- every other key: ``<layer_name>/<weight_name>`` arrays (``kernel`` HWIO,
  ``bias``, ``gamma``, ``beta``, ``moving_mean``, ``moving_variance``).

``load_extractor(path)`` returns an ``(N, H, W, 3) uint8 or [-1, 1]
float -> (N, D) float64`` callable for ``utils.quality.compute_quality``
and ``apps/evaluate.py --extractor``. It runs on the given device in f32,
with the library convolution's TF32 off, as the JAX interpreter runs f32.
``export_keras_extractor(model, path)`` writes such a file from a Keras
functional model; TensorFlow comes in with the caller's model, and this
module never imports it.
"""

from __future__ import annotations

import json
import math
from pathlib import Path
from typing import Callable, Dict, List, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from cyclegan_tpu_torch.ops.conv import LibraryConv

FORMAT_VERSION = 1
_SUPPORTED = ("conv2d", "batchnorm", "activation", "maxpool2d",
              "avgpool2d", "concat", "globalavgpool", "input")


def _tf_pads(size: int, window: int, stride: int,
             padding: str) -> Tuple[int, int]:
    """TF's (before, after) padding of one axis: none for VALID; for SAME
    an output of ceil(size / stride), the odd pad after."""
    if padding == "VALID":
        return 0, 0
    out = math.ceil(size / stride)
    total = max((out - 1) * stride + window - size, 0)
    return total // 2, total - total // 2


def _pad_nchw(x: torch.Tensor, window: Sequence[int], strides: Sequence[int],
              padding: str, value: float = 0.0) -> torch.Tensor:
    ph = _tf_pads(x.shape[2], window[0], strides[0], padding)
    pw = _tf_pads(x.shape[3], window[1], strides[1], padding)
    if not any(ph + pw):
        return x
    return F.pad(x, (*pw, *ph), value=value)


def conv2d_tf(x: torch.Tensor, kernel: torch.Tensor,
              strides: Sequence[int], padding: str) -> torch.Tensor:
    """``lax.conv_general_dilated`` with TF padding ("SAME" or "VALID") on
    NCHW x and an HWIO kernel: the library convolution on the explicitly
    padded input, f32 with TF32 off (``ops/conv.py`` ``LibraryConv``)."""
    if strides[0] != strides[1]:
        raise ValueError(f"conv2d strides {tuple(strides)}: only equal "
                         f"strides are supported")
    xp = _pad_nchw(x, kernel.shape[:2], strides, padding)
    return LibraryConv.apply(xp, kernel.permute(3, 2, 0, 1), None,
                             int(strides[0]), 0, False, 0, 1)


def to_unit_range(x: torch.Tensor) -> torch.Tensor:
    """uint8 -> [-1, 1]; a float batch already in [-1, 1] passes through.
    The test is on the whole batch (max |x| > 2), as in the JAX package."""
    x = x.to(torch.float32)
    return torch.where(x.abs().max() > 2.0, x / 127.5 - 1.0, x)


def resize_square(x: torch.Tensor, size: int) -> torch.Tensor:
    """``jax.image.resize(x, (n, size, size, c), "bilinear")`` on NCHW x:
    half-pixel bilinear, antialiased (the kernel widened to the scale) when
    it shrinks, as JAX's default ``antialias=True`` does."""
    if x.shape[2] == size and x.shape[3] == size:
        return x
    return F.interpolate(x, size=(size, size), mode="bilinear",
                         align_corners=False,
                         antialias=x.shape[2] > size)


def _avg_pool_tf(x: torch.Tensor, pool, strides, padding) -> torch.Tensor:
    """TF AveragePooling2D: with SAME padding the mean counts only the
    in-bounds elements."""
    area = float(pool[0] * pool[1])
    summed = F.avg_pool2d(_pad_nchw(x, pool, strides, padding), pool,
                          strides) * area
    if padding == "VALID":
        return summed / area
    ones = torch.ones_like(x[:1, :1])
    counts = F.avg_pool2d(_pad_nchw(ones, pool, strides, padding), pool,
                          strides) * area
    return summed / counts


def build_forward(graph: Dict, weights: Dict[str, np.ndarray],
                  device="cuda") -> Callable:
    """The graph as a function ``(N, H, W, 3) tensor -> (N, D)`` of torch
    ops on ``device``, weights moved there once."""
    layers: List[Dict] = graph["layers"]
    by_name = {l["name"]: l for l in layers}
    for l in layers:
        if l["type"] not in _SUPPORTED:
            raise ValueError(
                f"extractor layer {l['name']!r}: unsupported type "
                f"{l['type']!r} (format v{FORMAT_VERSION} supports "
                f"{_SUPPORTED})")
    w = {k: torch.as_tensor(np.asarray(v, np.float32), device=device)
         for k, v in weights.items()}
    image_size = int(graph["image_size"])
    out_name = graph["output"]
    if out_name not in by_name:
        raise ValueError(f"output layer {out_name!r} not in graph")

    def channel(v: torch.Tensor) -> torch.Tensor:
        return v[:, None, None]

    def forward(x: torch.Tensor) -> torch.Tensor:
        x = to_unit_range(x).permute(0, 3, 1, 2)
        x = resize_square(x, image_size)
        acts: Dict[str, torch.Tensor] = {}
        for l in layers:
            kind, name = l["type"], l["name"]
            if kind == "input":
                acts[name] = x
                continue
            ins = [acts[i] for i in l["inputs"]]
            if kind == "conv2d":
                y = conv2d_tf(ins[0], w[f"{name}/kernel"], l["strides"],
                              l["padding"].upper())
                if l.get("use_bias"):
                    y = y + channel(w[f"{name}/bias"])
                if l.get("activation", "linear") == "relu":
                    y = F.relu(y)
                acts[name] = y
            elif kind == "batchnorm":
                eps = float(l.get("epsilon", 1e-3))
                y = ((ins[0] - channel(w[f"{name}/moving_mean"]))
                     * channel(torch.rsqrt(w[f"{name}/moving_variance"]
                                           + eps)))
                if f"{name}/gamma" in w:
                    y = y * channel(w[f"{name}/gamma"])
                if f"{name}/beta" in w:
                    y = y + channel(w[f"{name}/beta"])
                acts[name] = y
            elif kind == "activation":
                if l["activation"] != "relu":
                    raise ValueError(
                        f"{name}: unsupported activation {l['activation']!r}")
                acts[name] = F.relu(ins[0])
            elif kind == "maxpool2d":
                pool, strides = l["pool_size"], l["strides"]
                acts[name] = F.max_pool2d(
                    _pad_nchw(ins[0], pool, strides, l["padding"].upper(),
                              -math.inf), pool, strides)
            elif kind == "avgpool2d":
                acts[name] = _avg_pool_tf(ins[0], l["pool_size"],
                                          l["strides"], l["padding"].upper())
            elif kind == "concat":
                acts[name] = torch.cat(ins, dim=1)
            elif kind == "globalavgpool":
                acts[name] = ins[0].mean(dim=(2, 3))
        out = acts[out_name]
        # a spatial output goes back to NHWC, as the JAX function returns it
        return out.permute(0, 2, 3, 1) if out.dim() == 4 else out

    return forward


def load_extractor(path, device="cuda") -> Callable:
    """Load an extractor ``.npz`` into a numpy-in, float64-numpy-out
    callable for ``utils.quality.compute_quality(extractor=...)``, run on
    ``device`` (cuda by default; cpu for the plain torch ops)."""
    path = Path(path)
    with np.load(path, allow_pickle=False) as z:
        if "__graph__" not in z:
            raise ValueError(f"{path}: missing __graph__ key — not an "
                             "extractor file (see utils/extractor.py)")
        graph = json.loads(str(z["__graph__"]))
        if int(graph.get("format_version", -1)) != FORMAT_VERSION:
            raise ValueError(
                f"{path}: format_version {graph.get('format_version')} "
                f"!= supported {FORMAT_VERSION}")
        weights = {k: z[k] for k in z.files if k != "__graph__"}
    fwd = build_forward(graph, weights, device)

    @torch.inference_mode()
    def extractor(images) -> np.ndarray:
        x = torch.as_tensor(np.asarray(images), device=device)
        return fwd(x).cpu().numpy().astype(np.float64)

    extractor.graph = graph  # introspection for tests and tools
    return extractor


def _history_names(args) -> List[str]:
    """The names of the layers whose outputs a Keras node's serialized
    ``args`` reference (``__keras_tensor__`` entries), in order."""
    names: List[str] = []

    def walk(obj):
        if isinstance(obj, dict):
            if obj.get("class_name") == "__keras_tensor__":
                names.append(obj["config"]["keras_history"][0])
            else:
                for v in obj.values():
                    walk(v)
        elif isinstance(obj, (list, tuple)):
            for v in obj:
                walk(v)

    walk(args)
    return names


def _endpoint_name(spec) -> str:
    """A layer name out of Keras' ``input_layers`` / ``output_layers``,
    serialized as [name, node, tensor] or a list of such triples."""
    if isinstance(spec[0], str):
        return spec[0]
    return spec[0][0]


def export_keras_extractor(model, path, image_size: int = 299) -> Path:
    """Serialize a Keras functional CNN (e.g.
    ``tf.keras.applications.InceptionV3(weights=..., include_top=False,
    pooling="avg")``) into the extractor format, walking
    ``model.get_config()`` and reading each layer's weights. Raises on any
    layer type outside the supported set."""
    cfg = model.get_config()
    layers: List[Dict] = []
    weights: Dict[str, np.ndarray] = {}
    for lc in cfg["layers"]:
        cls, name, c = lc["class_name"], lc["name"], lc["config"]
        inputs = _history_names(
            [n.get("args", []) for n in lc.get("inbound_nodes", [])])
        entry = {"name": name, "inputs": inputs}
        if cls == "InputLayer":
            entry["type"] = "input"
        elif cls == "Conv2D":
            entry.update(
                type="conv2d", strides=list(c["strides"]),
                padding=c["padding"], use_bias=bool(c["use_bias"]),
                activation=c.get("activation", "linear"))
        elif cls == "BatchNormalization":
            entry.update(type="batchnorm", epsilon=float(c["epsilon"]))
        elif cls == "Activation":
            entry.update(type="activation", activation=c["activation"])
        elif cls in ("MaxPooling2D", "AveragePooling2D"):
            entry.update(
                type="maxpool2d" if cls == "MaxPooling2D" else "avgpool2d",
                pool_size=list(c["pool_size"]),
                strides=list(c["strides"] or c["pool_size"]),
                padding=c["padding"])
        elif cls == "Concatenate":
            entry["type"] = "concat"
            if c.get("axis", -1) not in (-1, 3):
                raise ValueError(f"{name}: concat axis must be channels")
        elif cls == "GlobalAveragePooling2D":
            entry["type"] = "globalavgpool"
        else:
            raise ValueError(
                f"layer {name!r}: unsupported Keras layer {cls!r}")
        layers.append(entry)
        for wvar in model.get_layer(name).weights:
            wname = wvar.name.split("/")[-1].split(":")[0]
            weights[f"{name}/{wname}"] = np.asarray(wvar)

    graph = {
        "format_version": FORMAT_VERSION,
        "image_size": int(image_size),
        "preprocess": "inception",
        "input": _endpoint_name(cfg["input_layers"]),
        "output": _endpoint_name(cfg["output_layers"]),
        "layers": layers,
    }
    path = Path(path)
    np.savez_compressed(path, __graph__=np.asarray(json.dumps(graph)),
                        **weights)
    return path
