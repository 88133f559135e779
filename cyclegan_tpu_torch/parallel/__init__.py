"""Process-mesh parallelism (cyclegan_tpu/parallel): data parallelism and
H-axis spatial sharding, one process per device."""

from cyclegan_tpu_torch.parallel.launch import init_distributed, run_ranks
from cyclegan_tpu_torch.parallel.mesh import (
    Mesh,
    create_mesh,
    create_mesh_2d,
    replicate,
    shard_batch,
)
from cyclegan_tpu_torch.parallel.spatial import (
    create_spatial_mesh,
    make_spatial_forward,
    shard_spatial,
    spatial_shardings,
)

__all__ = [
    "create_mesh",
    "create_mesh_2d",
    "shard_batch",
    "replicate",
    "create_spatial_mesh",
    "make_spatial_forward",
    "shard_spatial",
    "spatial_shardings",
    "Mesh",
    "init_distributed",
    "run_ranks",
]
