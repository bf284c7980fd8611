"""Device meshes, sharding rules, stage placement and the distributed
bootstrap."""

from .mesh import (
    MeshSpec,
    best_effort_mesh,
    data_sharding,
    host_cpu_mesh,
    make_mesh,
    replicated,
    shard_params,
)
from .partition import PartitionRules, logical_to_sharding

__all__ = [
    "MeshSpec",
    "PartitionRules",
    "best_effort_mesh",
    "data_sharding",
    "host_cpu_mesh",
    "logical_to_sharding",
    "make_mesh",
    "replicated",
    "shard_params",
]
