"""Whole-index execution: device meshes, sharded indexes, stacked search.

Counterpart of `elasticsearch_tpu/parallel/` (the JAX package). The
reference's analogs are OperationRouting / AbstractSearchAsyncAction /
SearchPhaseController: the per-shard fan-out and the coordinator's
reduce, redesigned as one program over a stack of every shard. The port
runs that program on one device (the index's own), batched over the
entry axis where the reference uses `shard_map` and collectives.
"""

from .mesh import (
    DATA_AXIS,
    SHARD_AXIS,
    fold_factor,
    make_mesh,
    mesh_shape,
    single_device_mesh,
)
from .mesh_executor import MeshExecutor, MeshUnavailable
from .sharded import (
    ShardedIndex,
    ShardedTopK,
    build_mesh_knn_step,
    build_mesh_text_step,
    build_sharded_bm25_step,
    build_sharded_knn_step,
    rrf_fuse,
)

__all__ = [
    "DATA_AXIS",
    "SHARD_AXIS",
    "fold_factor",
    "make_mesh",
    "mesh_shape",
    "single_device_mesh",
    "MeshExecutor",
    "MeshUnavailable",
    "ShardedIndex",
    "ShardedTopK",
    "build_mesh_knn_step",
    "build_mesh_text_step",
    "build_sharded_bm25_step",
    "build_sharded_knn_step",
    "rrf_fuse",
]
