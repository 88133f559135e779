"""Import the reference's trained-model artifact into a checkpoint folder
(cyclegan_tpu/apps/import_reference.py).

The reference ships a trained model as four Keras SavedModels, four
optimizer-slot ``.npy`` files, fixed sample images and two configs. This
turns such a folder into the folder both packages load (``checkpoint.npz``
with the JAX ``TrainState``'s leaves, the samples, the configs with
``new: false``), with the exact weights and Adam state, so training
resumes where the reference stopped:

    python -m cyclegan_tpu_torch.apps.import_reference \\
        --model_dir /path/to/model_instances/model \\
        --output model_instances/imported [--no-optimizer] [--device cpu]

TensorFlow is not needed: each SavedModel's variables are read from its
tensor bundle (``<dir>/variables/variables``) by ``utils/tensor_bundle.py``.
Keras functional models store weights under

    layer_with_weights-<N>/<attr>/.ATTRIBUTES/VARIABLE_VALUE

where ``<N>`` counts weight-bearing layers in graph-construction order and
``<attr>`` is ``kernel``/``bias`` (convs) or ``gamma``/``beta`` (instance
norm); ``enumerate_slots`` maps layer N onto the parameter tree of each
architecture, as the JAX importer does.

The optimizer ``.npy`` is ``np.save(optimizer.get_weights())``: a pickled
object array ``[iterations, m_0..m_{n-1}, v_0..v_{n-1}]`` in
``model.trainable_variables`` order (``trainable_leaves``), which becomes
torch Adam's ``exp_avg`` / ``exp_avg_sq`` and its step count (optax's
``mu``, ``nu`` and ``count``, ``utils/checkpoint.py``). Loading it
unpickles it, so import only folders from a source you trust.
"""

from __future__ import annotations

import argparse
import logging
import re
import shutil
from collections import defaultdict
from pathlib import Path
from typing import Any, Dict, List, MutableMapping, Sequence, Tuple

import numpy as np

logger = logging.getLogger(__name__)

NETWORKS = ("g_AB", "g_BA", "d_A", "d_B")

# (tf_attr -> our_key) maps per slot kind
_CONV = (("kernel", "w"),)
_CONV_BIAS = (("kernel", "w"), ("bias", "b"))
_NORM = (("gamma", "gamma"), ("beta", "beta"))

Slot = Tuple[Tuple[Tuple[str, str], ...], MutableMapping[str, Any]]


def network_arch(model_config, name: str) -> str:
    """The architecture type of network ``name`` in a model config: the
    generator's for g_AB and g_BA, the discriminator's for d_A and d_B."""
    return model_config["generator" if name.startswith("g")
                        else "discriminator"]["type"]


def enumerate_slots(arch_type: str, params: Dict[str, Any]) -> List[Slot]:
    """Ordered (attr-map, target-dict) slots matching the Keras
    graph-construction order of the reference model's weight-bearing
    layers."""
    slots: List[Slot] = []
    if arch_type == "unet_generator":
        # double_conv levels down, bottom, [convt + norm when expansion is
        # not upsample] + double_conv up, head
        for level in params["down"]:
            for block in level:
                slots.append((_CONV, block["conv"]))
                slots.append((_NORM, block["norm"]))
        for block in params["bottom"]:
            slots.append((_CONV, block["conv"]))
            slots.append((_NORM, block["norm"]))
        for level in params["up"]:
            if "convt" in level:
                slots.append((_CONV_BIAS, level["convt"]))
                slots.append((_NORM, level["convt_norm"]))
            for block in level["dc"]:
                slots.append((_CONV, block["conv"]))
                slots.append((_NORM, block["norm"]))
        slots.append((_CONV_BIAS, params["head"]))
    elif arch_type == "strided_unet":
        for level in params["down"]:
            slots.append((_CONV_BIAS, level["conv"]))
            slots.append((_NORM, level["norm"]))
        slots.append((_CONV_BIAS, params["bottom"]))
        for level in params["up"]:
            slots.append((_CONV_BIAS, level["convt"]))
            slots.append((_NORM, level["norm"]))
        slots.append((_CONV_BIAS, params["last"]))
    elif arch_type == "resnet_generator":
        # all norms non-affine (no params)
        slots.append((_CONV_BIAS, params["stem"]))
        for p in params["down"]:
            slots.append((_CONV_BIAS, p))
        for block in params["res"]:
            slots.append((_CONV_BIAS, block["conv1"]))
            slots.append((_CONV_BIAS, block["conv2"]))
        for p in params["up"]:
            slots.append((_CONV_BIAS, p))
        slots.append((_CONV_BIAS, params["head"]))
    elif arch_type == "simple_discriminator":
        # non-affine norms
        for block in params["blocks"]:
            slots.append((_CONV_BIAS, block["conv"]))
        slots.append((_CONV_BIAS, params["head"]))
    else:
        raise ValueError(f"unknown architecture {arch_type!r}")
    return slots


_LAYER_KEY = re.compile(
    r"^layer_with_weights-(\d+)/([A-Za-z_]+)/\.ATTRIBUTES/VARIABLE_VALUE$"
)
# Keys a TF-2.7 ``model.save()`` checkpoint carries besides the weights:
# per-variable optimizer-slot mirrors (``.../.OPTIMIZER_SLOT/optimizer/m``),
# the optimizer's own state (``optimizer/iter``, hyperparameters), Keras
# bookkeeping (``keras_api``, metric counters), the serialized object
# graph and the save counter. All are skipped: the weights come from the
# layer keys, the optimizer slots from the separate ``<name>_optimizer.npy``.
_SLOT_KEY = re.compile(
    r"^layer_with_weights-(\d+)/([A-Za-z_]+)/\.OPTIMIZER_SLOT/"
)
_EXPECTED_AUX_PREFIXES = (
    "optimizer/",
    "save_counter",
    "_CHECKPOINTABLE_OBJECT_GRAPH",
    "keras_api",
    "signatures",
)


def read_savedmodel_layers(saved_model_dir) -> List[Dict[str, np.ndarray]]:
    """A Keras SavedModel's weights as an ordered list of {attr: array}
    per weight-bearing layer, read from its variables bundle without
    TensorFlow (``utils/tensor_bundle.py``); only the layer keys' tensors
    are decoded.

    Every other key is classified and logged (optimizer slots and
    bookkeeping at INFO, anything unrecognized at WARNING) and skipped. No
    layer key, or layer indices with a gap, raise ``ValueError``."""
    from cyclegan_tpu_torch.utils.tensor_bundle import TensorBundle

    bundle = TensorBundle(Path(saved_model_dir) / "variables" / "variables")
    layers: Dict[int, Dict[str, np.ndarray]] = defaultdict(dict)
    skipped: Dict[str, List[str]] = defaultdict(list)
    for key in bundle.entries:
        m = _LAYER_KEY.match(key)
        if m:
            layers[int(m.group(1))][m.group(2)] = bundle.tensor(key)
        elif _SLOT_KEY.match(key):
            skipped["optimizer-slot"].append(key)
        elif any(key.startswith(p) for p in _EXPECTED_AUX_PREFIXES):
            skipped["bookkeeping"].append(key)
        elif key.startswith("layer_with_weights-"):
            # a layer attribute nested deeper than <attr>/.ATTRIBUTES:
            # nothing the reference's models hold
            skipped["UNRECOGNIZED-layer-key"].append(key)
        else:
            skipped["unrecognized"].append(key)
    for kind, keys in sorted(skipped.items()):
        emit = logger.warning if "unrecognized" in kind.lower() else \
            logger.info
        emit("%s: skipped %d %s key(s), e.g. %s",
             saved_model_dir, len(keys), kind, sorted(keys)[0])
    if not layers:
        raise ValueError(
            f"no layer_with_weights-* variables found in {saved_model_dir} — "
            "not a Keras SavedModel?"
        )
    indices = sorted(layers)
    if indices != list(range(len(indices))):
        missing = sorted(set(range(indices[-1] + 1)) - set(indices))
        raise ValueError(
            f"{saved_model_dir}: layer_with_weights indices are not "
            f"contiguous (found {indices}, missing {missing}) — truncated "
            "or hand-edited checkpoint?"
        )
    return [layers[i] for i in indices]


def import_params_into(arch_type: str, params: Dict[str, Any],
                       layer_vars: Sequence[Dict[str, np.ndarray]]) -> None:
    """Copy reference weights into a parameter tree (the JAX layout,
    ``weights.module_to_jax_params``), in place, with shape validation on
    every leaf."""
    slots = enumerate_slots(arch_type, params)
    if len(slots) != len(layer_vars):
        raise ValueError(
            f"{arch_type}: SavedModel has {len(layer_vars)} weight-bearing "
            f"layers, our params expect {len(slots)} — config mismatch?"
        )
    for i, ((attr_map, target), lv) in enumerate(zip(slots, layer_vars)):
        for tf_attr, our_key in attr_map:
            if tf_attr not in lv:
                raise ValueError(
                    f"{arch_type} layer {i}: expected attribute {tf_attr!r}, "
                    f"SavedModel has {sorted(lv)}"
                )
            value = np.asarray(lv[tf_attr])
            expected = np.asarray(target[our_key]).shape
            if tuple(value.shape) != tuple(expected):
                raise ValueError(
                    f"{arch_type} layer {i} {tf_attr}: shape {value.shape} "
                    f"!= expected {expected}"
                )
            target[our_key] = value.astype(np.float32)


def trainable_leaves(arch_type: str, tree: Dict[str, Any]
                     ) -> List[Tuple[MutableMapping, str]]:
    """(dict, key) references to trainable leaves in
    ``model.trainable_variables`` order: layer order, then attr order
    within a layer (kernel, bias / gamma, beta)."""
    refs: List[Tuple[MutableMapping, str]] = []
    for attr_map, target in enumerate_slots(arch_type, tree):
        for _tf_attr, our_key in attr_map:
            refs.append((target, our_key))
    return refs


def import_adam_npy_into(arch_type: str, model, optimizer, npy_path) -> int:
    """Load the reference's ``<name>_optimizer.npy`` (Keras
    ``optimizer.get_weights()``: [iterations, m..., v...]) into the torch
    Adam ``optimizer`` of ``model``, in place: ``exp_avg``, ``exp_avg_sq``
    and every parameter's ``step`` (optax's ``mu``, ``nu``, ``count``).
    Returns the iterations."""
    import torch

    from cyclegan_tpu_torch.utils.checkpoint import restore_optimizer
    from cyclegan_tpu_torch.weights import module_to_jax_params

    weights = list(np.load(npy_path, allow_pickle=True))
    iterations = int(np.asarray(weights[0]))
    slot_arrays = weights[1:]
    if len(slot_arrays) % 2 != 0:
        raise ValueError(
            f"{npy_path}: expected [iterations, m..., v...], got "
            f"{len(weights)} arrays"
        )
    n = len(slot_arrays) // 2
    ms, vs = slot_arrays[:n], slot_arrays[n:]
    if not isinstance(optimizer, torch.optim.Adam):
        raise ValueError(
            "optimizer state is not adam; cannot import .npy slots")

    def zeros(p):
        return np.zeros(tuple(p.shape), np.float32)

    mu = module_to_jax_params(model, zeros)
    nu = module_to_jax_params(model, zeros)
    mu_refs = trainable_leaves(arch_type, mu)
    nu_refs = trainable_leaves(arch_type, nu)
    if len(mu_refs) != n:
        raise ValueError(
            f"{npy_path}: {n} slot pairs but {len(mu_refs)} trainable leaves"
        )
    for (d, k), m_arr in zip(mu_refs, ms):
        if tuple(np.asarray(m_arr).shape) != tuple(np.asarray(d[k]).shape):
            raise ValueError(
                f"{npy_path}: m slot shape {np.asarray(m_arr).shape} != "
                f"param shape {np.asarray(d[k]).shape}"
            )
        d[k] = np.asarray(m_arr, np.float32)
    for (d, k), v_arr in zip(nu_refs, vs):
        d[k] = np.asarray(v_arr, np.float32)
    restore_optimizer(model, optimizer,
                      [{"count": np.int32(iterations), "mu": mu, "nu": nu},
                       {}], iterations)
    return iterations


def import_reference_model(model_dir, output_dir,
                           strict_optimizer: bool = True,
                           device: str = "cuda") -> Path:
    """Convert a reference ``model_instances/<name>`` folder into ours,
    building the train state on ``device``. Returns the output Path."""
    from cyclegan_tpu_torch.config import namespace2yaml, yaml2namespace
    from cyclegan_tpu_torch.steps import build_models, init_train_state
    from cyclegan_tpu_torch.utils import jax_random
    from cyclegan_tpu_torch.utils.checkpoint import (
        save_pytree,
        train_state_tree,
    )
    from cyclegan_tpu_torch.weights import (
        load_jax_params,
        models_to_jax_params,
        models_to_jax_state,
    )

    model_dir = Path(model_dir)
    output_dir = Path(output_dir)
    output_dir.mkdir(parents=True, exist_ok=True)

    model_config = yaml2namespace(model_dir / "model_config.yaml")
    train_config = yaml2namespace(model_dir / "train_config.yaml")
    state = init_train_state(build_models(model_config), train_config,
                             device=device)
    arch_types = {name: network_arch(model_config, name)
                  for name in NETWORKS}

    params = models_to_jax_params(state.models)
    for name in NETWORKS:
        import_params_into(arch_types[name], params[name],
                           read_savedmodel_layers(model_dir / name))
    load_jax_params(state.models, params, models_to_jax_state(state.models))

    max_step = 0
    for name in NETWORKS:
        npy = model_dir / f"{name}_optimizer.npy"
        if npy.exists():
            try:
                iters = import_adam_npy_into(arch_types[name],
                                             state.models[name],
                                             state.optimizers[name], npy)
                max_step = max(max_step, iters)
            except ValueError:
                if strict_optimizer:
                    raise
        elif strict_optimizer:
            raise FileNotFoundError(npy)
    state.step = max_step
    # the key JAX's init_train_state(PRNGKey(0), ...) keeps
    rng = jax_random.split(jax_random.prng_key(0), len(NETWORKS) + 1)[-1]
    save_pytree(output_dir / "checkpoint.npz", train_state_tree(state, rng))

    for sample in ("a_samples.npy", "b_samples.npy"):
        src = model_dir / sample
        if src.exists():
            shutil.copyfile(src, output_dir / sample)

    # configs marked resumable (new: false resumes)
    model_config.new = False
    namespace2yaml(output_dir / "model_config.yaml", model_config)
    namespace2yaml(output_dir / "train_config.yaml", train_config)
    return output_dir


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        description="Import a reference-trained model directory "
        "(4 SavedModels + optimizer .npy + samples) into a checkpoint "
        "directory, without TensorFlow."
    )
    parser.add_argument("--model_dir", required=True,
                        help="reference model_instances/<name> directory")
    parser.add_argument("--output", required=True,
                        help="destination directory (checkpoint.npz + "
                        "configs)")
    parser.add_argument("--no-optimizer", action="store_true",
                        help="import weights only (fresh optimizer state)")
    parser.add_argument("--device", default="cuda",
                        help="torch device the train state is built on "
                        "(cuda by default; cpu where there is no card)")
    args = parser.parse_args(argv)
    out = import_reference_model(
        args.model_dir, args.output, strict_optimizer=not args.no_optimizer,
        device=args.device,
    )
    print(f"imported reference model -> {out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
