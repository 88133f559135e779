"""Hand-written CUDA kernels for the H100 and what every wrapper shares.

``launches`` counts, per kernel, the launches its wrapper made; a wrapper
adds one right after its kernel launched and nowhere else, so a run can
show that the main path went through the kernels.
"""

from __future__ import annotations

import collections
import ctypes

import torch

from cyclegan_tpu_torch.kernels._build import build_dir, check, function

# K1-K4 serve and train; K5-K8 are their backward kernels; K9 (the reflect
# conv), its weight gradient K9-dW and K10 (the fold of its input gradient)
# serve and train the ResNet recipe; K11 (the plain channel concat) and
# K12 (its split) those of the transpose-expansion and strided U-Nets; K13
# (the NHWC instance norm) the NHWC layout's norms with ``pallas_norm``;
# K14 (``ada_norm``, U-GAT-IT's AdaLIN and ILN) and its backward K15
# (``ada_norm_bwd``) the U-GAT-IT generator's, one count per call of their
# three launches.
# ``conv_dw_simt`` counts the launches of K5's and K9-dW's CUDA-core design
# (f32, and bf16 outside the TMA domain), which ``conv_dw`` and
# ``conv_reflect_dw`` count as well; a bf16 train step at 256x256 makes none.
# ``conv_same_simt`` likewise counts those of K1's and K9's CUDA-core design
# (f32 only), which ``conv_same`` and ``conv_reflect`` count as well; a bf16
# forward or train step makes none.
KERNELS = ("conv_same", "instance_norm_act", "sum2x2", "concat_up2",
           "conv_dw", "instance_norm_act_bwd", "dup2x2", "split_pool2",
           "conv_reflect", "conv_reflect_dw", "reflect_fold", "concat2",
           "split2", "instance_norm_nhwc", "ada_norm", "ada_norm_bwd",
           "conv_dw_simt", "conv_same_simt")
launches = {name: 0 for name in KERNELS}
# the path of each launch of K3, K4, K7, K8 and K10, "<kernel>.vector" (16-
# or 8-byte units) or "<kernel>.element", of K13,
# "instance_norm_nhwc.resident", ".streamed" or ".element", and of K5 and
# K9-dW, "conv_dw.ring" / "conv_reflect_dw.ring" (the tap-ring design) or
# ".simt" (the CUDA-core one), counted beside ``launches``
paths = collections.Counter()

P = ctypes.c_void_p
I = ctypes.c_int
L = ctypes.c_longlong
F = ctypes.c_float


def reset_launches() -> None:
    for name in KERNELS:
        launches[name] = 0
    paths.clear()


def launched() -> int:
    """All launches counted so far, each once: the ``_simt`` tallies count
    launches that their kernel's own name counts as well."""
    return (sum(launches.values()) - launches["conv_dw_simt"]
            - launches["conv_same_simt"])


def dtype_suffix(t: torch.Tensor) -> str:
    if t.dtype == torch.bfloat16:
        return "bf16"
    if t.dtype == torch.float32:
        return "f32"
    raise TypeError(f"kernels take float32 or bfloat16, got {t.dtype}")


def check_cuda(name: str, *tensors) -> None:
    """Every tensor a kernel reads or writes: on the current CUDA device,
    contiguous, of one dtype."""
    ref = tensors[0]
    for t in tensors:
        if t is None:
            continue
        if not t.is_cuda:
            raise ValueError(f"{name}: tensor on {t.device}, expected CUDA")
        if t.device.index != torch.cuda.current_device():
            raise ValueError(f"{name}: tensor on {t.device}, not the "
                             f"current device cuda:{torch.cuda.current_device()}")
        if t.dtype != ref.dtype:
            raise TypeError(f"{name}: mixed dtypes {ref.dtype} and {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: tensor of shape {tuple(t.shape)} is "
                             f"not contiguous")


def dispatch(name: str, cuda_fn, plain_fn, x: torch.Tensor, *args, **kw):
    """The port's kernel choice, by the device of ``x``, the first tensor:
    on a card ``cuda_fn`` (the kernel ``name``'s launch), on the CPU
    ``plain_fn`` (its plain version); any other device raises."""
    if x.is_cuda:
        return cuda_fn(x, *args, **kw)
    if x.device.type == "cpu":
        return plain_fn(x, *args, **kw)
    raise ValueError(f"{name}: no kernel for device {x.device}")


def ptr(t) -> int | None:
    return None if t is None else t.data_ptr()


def stream() -> int:
    return torch.cuda.current_stream().cuda_stream


__all__ = ["KERNELS", "launches", "launched", "paths", "reset_launches",
           "build_dir", "check", "function", "check_cuda", "dispatch",
           "dtype_suffix", "ptr", "stream"]
