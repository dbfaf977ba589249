"""Mesh-parallel scale-out (port of ``hnsw_rs_tpu/parallel``): query
data-parallelism over a replicated index, and sharded sub-index search
with a top-k merge, in one process over a device mesh or one process per
shard group on ``torch.distributed`` (SURVEY.md §2.6)."""

from .mesh import Mesh, make_mesh
from .replicated import ReplicatedHNSW
from .sharded import ShardedHNSW

__all__ = [
    "Mesh",
    "make_mesh",
    "ReplicatedHNSW",
    "ShardedHNSW",
]
