"""Cluster layer: index registry, routing, persisted metadata.

Reference analogs: org.elasticsearch.cluster.** / indices.** — reduced
to the single-writer subset a fixed-topology TPU pod needs (SURVEY.md
§2.7: "the Raft subset needed for a fixed-topology TPU pod is tiny;
document leader = process 0").
"""

from .indices import IndexService
from .service import ClusterError, ClusterService, IndexNotFoundError

__all__ = ["IndexService", "ClusterService", "ClusterError", "IndexNotFoundError"]
