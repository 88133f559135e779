"""Activation layout: NHWC (the default) or NHCW (cyclegan_tpu/ops/layout.py).

NHWC ``[B, H, W, C]`` is the JAX package's default and its XLA path; its
counterpart here runs the library convolutions and torch ops. NHCW
``[B, H, C, W]`` is the layout of the TPU kernels, and the port's kernels
K1-K12 take what their TPU counterparts took. A train step or a serving
session picks one with the ``nhcw()`` scope, with one transpose of the
batch in (and one out); every op in ``ops`` reads the scope for its axes.
Parameters, checkpoints and configs are the same in both layouts.

The scope belongs to the thread that enters it, as the JAX package scopes
the layout per trace: a thread that never entered one reads NHWC, and two
sessions serving on two threads (the HTTP server's) do not see each
other's layout.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Optional, Sequence

import torch

from cyclegan_tpu_torch.ops.cuda_concat import concat2_nhcw



class _Scope(threading.local):
    layout = "NHWC"  # what a thread reads before it enters a scope


_SCOPE = _Scope()


def current() -> str:
    return _SCOPE.layout


def is_nhcw() -> bool:
    return _SCOPE.layout == "NHCW"


@contextlib.contextmanager
def _scoped(name: str, enabled: bool):
    prev = _SCOPE.layout
    _SCOPE.layout = name if enabled else prev
    try:
        yield
    finally:
        _SCOPE.layout = prev


def nhcw(enabled: bool = True):
    """Scope the NHCW layout (a no-op with ``enabled=False``)."""
    return _scoped("NHCW", enabled)


def nhwc(enabled: bool = True):
    """Scope the NHWC layout inside an NHCW scope (a no-op with
    ``enabled=False``)."""
    return _scoped("NHWC", enabled)


def scope(name: str):
    """Scope the layout ``name``, as ``current()`` returns it: a function
    that runs after its caller's scope has closed (a rematerialized
    forward) re-enters the layout it was first run in."""
    if name not in ("NHWC", "NHCW"):
        raise ValueError(f"layout {name!r} not in ('NHCW', 'NHWC')")
    return _scoped(name, True)


def to_nhcw(x: torch.Tensor) -> torch.Tensor:
    """NHWC -> NHCW, contiguous."""
    return x.transpose(2, 3).contiguous()


def from_nhcw(x: torch.Tensor) -> torch.Tensor:
    """NHCW -> NHWC, contiguous."""
    return x.transpose(2, 3).contiguous()


def channel_axis() -> int:
    return 2 if is_nhcw() else 3


def spatial_axes() -> tuple:
    return (1, 3) if is_nhcw() else (1, 2)


def concat_channels(xs: Sequence[torch.Tensor]) -> torch.Tensor:
    """Concat over the channel axis. In NHCW two pieces go through K11 and
    its split K12 (``cuda_concat.concat2_nhcw``) on the card and their
    plain versions on the CPU; anything else is ``torch.cat``, as the JAX
    package sends it to ``jnp.concatenate``."""
    if is_nhcw() and len(xs) == 2:
        return concat2_nhcw(*xs)
    return torch.cat(list(xs), dim=channel_axis())


def channel_param(p: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    """Shape a per-channel vector [C] to broadcast over the layout:
    [C, 1] in NHCW, [C] in NHWC."""
    if p is None:
        return None
    return p[:, None] if is_nhcw() else p
