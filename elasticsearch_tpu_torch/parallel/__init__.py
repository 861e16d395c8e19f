"""Whole-index execution: device meshes, sharded indexes, stacked search.

Counterpart of `elasticsearch_tpu/parallel/` (the JAX package). The
reference's analogs are OperationRouting / AbstractSearchAsyncAction /
SearchPhaseController: the per-shard fan-out and the coordinator's
reduce, redesigned as one program over a stack of every shard. The port
runs that program over a (data, shards) grid of device slots from one
process: each slot's fold of the stack is scored on its device, batched
over the entry axis where the reference uses `shard_map`, and the pages
come to the index's device for the merge, where the reference uses
collectives.
"""

from .mesh import (
    DATA_AXIS,
    SHARD_AXIS,
    coord_device,
    fold_factor,
    make_mesh,
    mesh_shape,
    single_device_mesh,
)
from .mesh_executor import MeshExecutor, MeshUnavailable
from .sharded import (
    ShardedIndex,
    ShardedTopK,
    Stacked,
    build_mesh_knn_step,
    build_mesh_text_step,
    build_sharded_bm25_step,
    build_sharded_knn_step,
    rrf_fuse,
)

__all__ = [
    "DATA_AXIS",
    "SHARD_AXIS",
    "coord_device",
    "fold_factor",
    "make_mesh",
    "mesh_shape",
    "single_device_mesh",
    "MeshExecutor",
    "MeshUnavailable",
    "ShardedIndex",
    "ShardedTopK",
    "Stacked",
    "build_mesh_knn_step",
    "build_mesh_text_step",
    "build_sharded_bm25_step",
    "build_sharded_knn_step",
    "rrf_fuse",
]
