"""Spatial partitioning: the image H axis over a mesh axis
(cyclegan_tpu/parallel/spatial.py).

Activations shard their H axis over the ``spatial`` axis of a ``(data,
spatial)`` mesh, parameters stay replicated, and the ops exchange what
they need across strips explicitly (``ops/spatialctx.py``): the K-1
boundary rows of each conv, the sums of each norm. This is the JAX
package's explicit-halo path (its ``shard_map`` spatial mode, which runs
the kernel pack on local blocks); the port has no partitioner, so its
spatial runs are always that path, whatever ``dp_shard_map`` says about
the data axis. ``data=1`` spreads each image over every rank;
``spatial=1`` is plain data parallelism.
"""

from __future__ import annotations

from typing import Any, Callable, Optional, Sequence, Tuple

from cyclegan_tpu_torch.ops import spatialctx
from cyclegan_tpu_torch.parallel.mesh import Mesh, _block, _map


def create_spatial_mesh(data: int = 1, spatial: int = 1,
                        axis_names: Sequence[str] = ("data", "spatial")
                        ) -> Mesh:
    """2-D ``(data, spatial)`` mesh, the spatial axis innermost: ranks
    ``d * spatial + s`` hold the strips of one data slice."""
    return Mesh([data, spatial], axis_names)


def check_spatial_divisibility(height: int, mesh: Mesh,
                               axis_name: str = "spatial",
                               min_rows_per_shard: int = 1) -> None:
    """Fail fast (a clear message) when H does not divide over the spatial
    axis, or leaves strips thinner than ``min_rows_per_shard``."""
    n = mesh.axis_size(axis_name)
    if height % n != 0:
        raise ValueError(
            f"image height {height} is not divisible by the spatial mesh "
            f"axis size {n} ({dict(mesh.shape)}); pick a resolution that "
            f"is a multiple of the spatial device count")
    if height // n < min_rows_per_shard:
        raise ValueError(
            f"image height {height} over {n} spatial shards leaves "
            f"{height // n} rows per shard (< {min_rows_per_shard}); "
            f"use fewer spatial devices for this resolution")


def spatial_shardings(mesh: Mesh, data_axis: Optional[str] = "data",
                      spatial_axis: str = "spatial"
                      ) -> Tuple[Callable, Callable]:
    """(replicated, activation) rules for a spatial(+data) mesh: what
    this rank keeps of a tensor. Replicated keeps it whole; an NHWC (or
    NHCW) activation keeps its batch block along ``data_axis`` (None for
    pure spatial runs) and its H strip along ``spatial_axis``. W and C are
    not split."""

    def replicated(x):
        return x

    def activation(x):
        if data_axis is not None:
            x = _block(x, 0, mesh.axis_size(data_axis),
                       mesh.index(data_axis))
        return _block(x, 1, mesh.axis_size(spatial_axis),
                      mesh.index(spatial_axis))

    return replicated, activation


def shard_spatial(mesh: Mesh, tree: Any, data_axis: Optional[str] = "data",
                  spatial_axis: str = "spatial") -> Any:
    """This rank's block of NHWC host arrays or tensors: batch over
    ``data_axis`` (where the mesh has it), H over ``spatial_axis``."""
    if data_axis is not None and data_axis not in mesh.shape:
        data_axis = None
    _, activation = spatial_shardings(mesh, data_axis, spatial_axis)

    def put(x):
        if data_axis is not None:
            n = mesh.axis_size(data_axis)
            if x.shape[0] % n != 0:
                raise ValueError(
                    f"batch {x.shape[0]} not divisible by data axis {n}")
        check_spatial_divisibility(x.shape[1], mesh, spatial_axis)
        return activation(x)

    return _map(put, tree)


def scope(mesh: Optional[Mesh], spatial_axis: Optional[str] = "spatial"):
    """The ``ops/spatialctx.py`` scope of this rank's strip (a no-op
    without a mesh, an axis, or more than one strip)."""
    n = mesh.axis_size(spatial_axis) if mesh is not None else 1
    if n <= 1:
        return spatialctx.spatial(None, 1, enabled=False)
    return spatialctx.spatial(mesh.group(spatial_axis), n,
                              mesh.index(spatial_axis))


def make_spatial_forward(model, mesh: Mesh,
                         spatial_axis: str = "spatial") -> Callable:
    """A generator forward on H-sharded activations: ``fwd(x) -> y``, x and
    y this rank's block (``shard_spatial``'s), in the caller's layout.
    The convs exchange their halos and the norms sum their statistics over
    the spatial axis; the output keeps the input's sharding, so chained
    applications never gather."""

    def fwd(x):
        with scope(mesh, spatial_axis):
            return model(x)

    return fwd
