"""Snapshots: incremental backup/restore of indices to blob repositories.

Reference analogs: org.elasticsearch.snapshots.SnapshotsService /
SnapshotShardsService and repositories.blobstore.BlobStoreRepository
(SURVEY.md §2.1 Snapshots row): incremental segment-level snapshots into
a blob store, restore-as-recovery-source.
"""

from .repository import FsRepository, SnapshotError, SnapshotMissingError

__all__ = ["FsRepository", "SnapshotError", "SnapshotMissingError"]
