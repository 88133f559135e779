"""Process meshes and batch sharding (cyclegan_tpu/parallel/mesh.py).

The JAX package runs one process per host over a ``jax.sharding.Mesh`` of
its devices. The port runs one process per device, PyTorch's way: a
``Mesh`` is the ranks of ``torch.distributed``'s default process group on
a row-major grid with named axes, ``("data",)`` or ``("data",
"spatial")``, and a process group per axis and per set of axes. Rank r is
the grid point ``unravel(r)``, so the last axis (spatial) is innermost, as
``create_spatial_mesh`` lays it out in JAX.

Data parallelism: each data rank takes its slice of the batch
(``shard_batch``), the parameters are replicated (``replicate`` broadcasts
them from rank 0 once), and the train step averages the gradients and
metrics over the mesh with one ``all_reduce`` each (``steps.py``). A single
process is a mesh of one, through the same code.
"""

from __future__ import annotations

import itertools
import math
from typing import Any, Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist
from torch import nn


class Mesh:
    """The ranks of the default process group on a grid ``sizes`` with
    axes ``axis_names``; every process holds one point. ``shape`` maps each
    axis to its size, ``coords`` to this rank's index along it."""

    def __init__(self, sizes: Sequence[int], axis_names: Sequence[str]):
        if not dist.is_available() or not dist.is_initialized():
            raise RuntimeError(
                "a mesh needs an initialized torch.distributed process "
                "group: call parallel.init_distributed (or "
                "torch.distributed.init_process_group) in every process "
                "first")
        sizes = tuple(int(s) for s in sizes)
        self.axis_names = tuple(axis_names)
        self.shape: Dict[str, int] = dict(zip(self.axis_names, sizes))
        self.size = math.prod(sizes)
        world = dist.get_world_size()
        if self.size > world:
            raise ValueError(f"requested {self.size} devices, have {world}")
        if self.size < world:
            raise ValueError(
                f"a mesh of {self.size} devices in a group of {world} "
                f"processes: every process holds one point of the mesh")
        self.rank = dist.get_rank()
        self.coords: Dict[str, int] = {
            name: int(i) for name, i in zip(
                self.axis_names, np.unravel_index(self.rank, sizes))}
        self.backend = str(dist.get_backend())
        # new_group is collective: every rank creates every group, in
        # one order, and keeps the ones it belongs to
        self._groups: Dict[Tuple[str, ...], Any] = {}
        for r in range(1, len(sizes) + 1):
            for axes in itertools.combinations(self.axis_names, r):
                if len(axes) == len(sizes):
                    self._groups[axes] = dist.group.WORLD
                    continue
                for ranks in self._partition(axes):
                    grp = dist.new_group(ranks)
                    if self.rank in ranks:
                        self._groups[axes] = grp

    def _partition(self, axes):
        """The rank lists of the groups along ``axes``: the grid points
        that share every other coordinate."""
        sizes = [self.shape[a] for a in self.axis_names]
        grid = np.arange(self.size).reshape(sizes)
        moved = np.moveaxis(grid, [self.axis_names.index(a) for a in axes],
                            range(-len(axes), 0))
        return [sorted(int(r) for r in block.reshape(-1))
                for block in moved.reshape(-1, math.prod(
                    self.shape[a] for a in axes))]

    def axis_size(self, axis: Optional[str]) -> int:
        return 1 if axis is None else self.shape.get(axis, 1)

    def index(self, axis: Optional[str]) -> int:
        return 0 if axis is None else self.coords.get(axis, 0)

    def group(self, axes: Union[str, Sequence[str], None] = None):
        """The process group of the ranks that differ only along ``axes``
        (a name, a sequence of names, or None for the whole mesh). Axes
        the mesh lacks are left out; none left gives None."""
        if axes is None:
            axes = self.axis_names
        elif isinstance(axes, str):
            axes = (axes,)
        key = tuple(a for a in self.axis_names if a in axes)
        return self._groups.get(key)

    def __repr__(self) -> str:
        return (f"Mesh({self.shape}, rank {self.rank} at {self.coords}, "
                f"{self.backend})")


def create_mesh(num_devices: Optional[int] = None,
                axis_name: str = "data") -> Mesh:
    """A 1-D data-parallel mesh over the process group (all of it by
    default; ``num_devices`` must then be its size)."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    return Mesh([world if num_devices is None else int(num_devices)],
                (axis_name,))


def create_mesh_2d(replica: int, data: int,
                   axis_names: Sequence[str] = ("replica", "data")) -> Mesh:
    """A 2-D (replica, data) mesh: batches shard over both axes (pass
    ``mesh_axis=("replica", "data")`` to ``shard_batch``)."""
    return Mesh([replica, data], axis_names)


def _map(fn, tree):
    if isinstance(tree, (torch.Tensor, np.ndarray)):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, v) for v in tree)
    raise TypeError(f"cannot shard a {type(tree).__name__}")


def _block(x, dim: int, parts: int, i: int):
    n = x.shape[dim] // parts
    index = [slice(None)] * x.ndim
    index[dim] = slice(i * n, (i + 1) * n)
    out = x[tuple(index)]
    return out.contiguous() if isinstance(out, torch.Tensor) else out


def shard_batch(mesh: Mesh, tree: Any,
                axis_name: Union[str, Sequence[str], None] = "data",
                batch_dim: int = 0,
                spatial_axis: Optional[str] = None) -> Any:
    """This rank's block of every leaf (tensor or array) of ``tree``: dim
    ``batch_dim`` split over ``axis_name`` (None: not split; several axes:
    split over their product, the first outermost) and, with
    ``spatial_axis``, the dim after it (the image H axis) over that axis
    (``parallel/spatial.py``). Raises ValueError up front where a dim does
    not divide."""
    axes = (() if axis_name is None else (axis_name,)
            if isinstance(axis_name, str) else tuple(axis_name))
    n = math.prod(mesh.axis_size(a) for a in axes)
    i = 0
    for a in axes:
        i = i * mesh.axis_size(a) + mesh.index(a)
    name = axis_name if isinstance(axis_name, str) else axes

    def one(x):
        if x.shape[batch_dim] % n != 0:
            raise ValueError(
                f"batch dimension {x.shape[batch_dim]} is not divisible by "
                f"the mesh size {n} along axis {name!r} "
                f"({dict(mesh.shape)}); choose a batch_size that is a "
                f"multiple of the device count")
        if spatial_axis is not None:
            from cyclegan_tpu_torch.parallel.spatial import (
                check_spatial_divisibility,
            )

            check_spatial_divisibility(x.shape[batch_dim + 1], mesh,
                                       spatial_axis)
        out = _block(x, batch_dim, n, i)
        if spatial_axis is not None:
            out = _block(out, batch_dim + 1, mesh.axis_size(spatial_axis),
                         mesh.index(spatial_axis))
        return out

    return _map(one, tree)


def _tensors(tree):
    """The tensors to replicate: a module's parameters and buffers, a
    train state's networks, and those of dicts and sequences of them."""
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, nn.Module):
        yield from tree.parameters()
        yield from tree.buffers()
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)
    elif hasattr(tree, "models"):  # steps.TrainState
        yield from _tensors(tree.models)


@torch.no_grad()
def replicate(mesh: Mesh, tree: Any) -> Any:
    """Broadcast every parameter and buffer of ``tree`` (a tensor, a
    module, a ``steps.TrainState``, or dicts and sequences of them) from
    rank 0 to the mesh, in place; returns ``tree``. The optimizers' state
    is not sent: a fresh one is empty and a restored one is the same
    file on every rank."""
    group = mesh.group()
    for t in _tensors(tree):
        dist.broadcast(t.data, src=0, group=group)
    return tree
