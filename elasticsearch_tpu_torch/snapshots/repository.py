"""Filesystem blob-store repository with content-addressed blobs.

Reference analog: BlobStoreRepository.snapshotShard/restoreShard +
the fs repository module (SURVEY.md §2.1). The TPU-native engine's
segments are immutable directories committed by an atomic manifest, so
a shard snapshot is exactly its committed file set; blobs are deduped
by sha256, which makes successive snapshots of an unchanged shard
incremental for free (the same property ES gets from immutable Lucene
segment files).

Repository layout:
    <location>/index.json        snapshot catalog (generation-bumped,
                                 atomically replaced — the index-N file)
    <location>/blobs/<sha256>    content-addressed file payloads
"""

from __future__ import annotations

import hashlib
import json
import os
import threading
import time
from typing import Dict, List, Optional

# one mutation lock per repository LOCATION (several FsRepository
# instances — e.g. one per in-process node — may point at the same
# directory): create() writes content-addressed blobs BEFORE committing
# its catalog entry, so a concurrent delete()'s _gc_blobs scan would see
# them as unreferenced and unlink them out from under the new snapshot.
# Serializing create/delete closes that window (the reference holds the
# repository generation lock across BlobStoreRepository mutations).
_LOCATION_LOCKS: Dict[str, threading.RLock] = {}
_LOCATION_LOCKS_GUARD = threading.Lock()


def _location_lock(location: str) -> threading.RLock:
    key = os.path.abspath(location)
    with _LOCATION_LOCKS_GUARD:
        return _LOCATION_LOCKS.setdefault(key, threading.RLock())


class SnapshotError(Exception):
    def __init__(self, reason: str, status: int = 400,
                 err_type: str = "snapshot_exception"):
        super().__init__(reason)
        self.reason = reason
        self.status = status
        self.err_type = err_type


class SnapshotMissingError(SnapshotError):
    def __init__(self, repo: str, name: str):
        super().__init__(
            f"[{repo}:{name}] is missing", 404, "snapshot_missing_exception"
        )


class FsRepository:
    def __init__(self, name: str, location: str):
        self.name = name
        self.location = location
        self._mutation_lock = _location_lock(location)
        os.makedirs(os.path.join(location, "blobs"), exist_ok=True)

    # ---- catalog (the index-N generation file) ----

    def _catalog_path(self) -> str:
        return os.path.join(self.location, "index.json")

    def _read_catalog(self) -> dict:
        try:
            with open(self._catalog_path(), encoding="utf-8") as f:
                return json.load(f)
        except (FileNotFoundError, json.JSONDecodeError):
            return {"generation": 0, "snapshots": {}}

    def _write_catalog(self, catalog: dict) -> None:
        catalog["generation"] = int(catalog.get("generation", 0)) + 1
        tmp = self._catalog_path() + ".tmp"
        with open(tmp, "w", encoding="utf-8") as f:
            json.dump(catalog, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, self._catalog_path())

    # ---- blobs ----

    def _blob_path(self, digest: str) -> str:
        return os.path.join(self.location, "blobs", digest)

    def _put_blob(self, data: bytes) -> str:
        digest = hashlib.sha256(data).hexdigest()
        path = self._blob_path(digest)
        if not os.path.exists(path):  # dedup = incrementality
            tmp = path + ".tmp"
            with open(tmp, "wb") as f:
                f.write(data)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, path)
        return digest

    def _get_blob(self, digest: str) -> bytes:
        with open(self._blob_path(digest), "rb") as f:
            return f.read()

    # ---- snapshot lifecycle ----

    def create(self, snap: str, index_payloads: Dict[str, dict]) -> dict:
        """index_payloads: index name → {"settings", "mappings", "uuid",
        "num_shards", "shards": {sid: {"files": {rel: bytes}} |
        {"docs": [...]}}}. Returns the catalog entry. Serialized with
        delete() so the GC can never unlink blobs written by a
        not-yet-committed create."""
        with self._mutation_lock:
            return self._create_locked(snap, index_payloads)

    def _create_locked(self, snap: str, index_payloads: Dict[str, dict]) -> dict:
        catalog = self._read_catalog()
        if snap in catalog["snapshots"]:
            raise SnapshotError(
                f"[{self.name}:{snap}] snapshot with the same name already "
                "exists",
                400,
                "invalid_snapshot_name_exception",
            )
        start = int(time.time() * 1000)
        indices_meta: Dict[str, dict] = {}
        total_files = 0
        for iname, payload in index_payloads.items():
            shards_meta: Dict[str, dict] = {}
            for sid, shard in payload["shards"].items():
                if "files" in shard:
                    files = {
                        rel: self._put_blob(data)
                        for rel, data in shard["files"].items()
                    }
                    total_files += len(files)
                    shards_meta[str(sid)] = {"mode": "files", "files": files}
                else:
                    docs_blob = json.dumps(shard["docs"]).encode("utf-8")
                    shards_meta[str(sid)] = {
                        "mode": "docs",
                        "docs_blob": self._put_blob(docs_blob),
                        "doc_count": len(shard["docs"]),
                    }
            indices_meta[iname] = {
                "settings": payload.get("settings") or {},
                "mappings": payload.get("mappings") or {},
                "uuid": payload.get("uuid"),
                "num_shards": int(payload.get("num_shards", 1)),
                "shards": shards_meta,
            }
        entry = {
            "snapshot": snap,
            "uuid": hashlib.sha1(
                f"{self.name}:{snap}:{start}".encode()
            ).hexdigest()[:22],
            "state": "SUCCESS",
            "indices": indices_meta,
            "start_time_in_millis": start,
            "end_time_in_millis": int(time.time() * 1000),
        }
        catalog["snapshots"][snap] = entry
        self._write_catalog(catalog)
        return entry

    def get(self, snap: str) -> dict:
        catalog = self._read_catalog()
        entry = catalog["snapshots"].get(snap)
        if entry is None:
            raise SnapshotMissingError(self.name, snap)
        return entry

    def list(self) -> List[dict]:
        return list(self._read_catalog()["snapshots"].values())

    def delete(self, snap: str) -> None:
        with self._mutation_lock:
            catalog = self._read_catalog()
            if snap not in catalog["snapshots"]:
                raise SnapshotMissingError(self.name, snap)
            del catalog["snapshots"][snap]
            self._write_catalog(catalog)
            self._gc_blobs(catalog)

    def _gc_blobs(self, catalog: dict) -> None:
        """Removes blobs no surviving snapshot references (the cleanup
        BlobStoreRepository runs after deletes)."""
        referenced = set()
        for entry in catalog["snapshots"].values():
            for imeta in entry["indices"].values():
                for smeta in imeta["shards"].values():
                    if smeta["mode"] == "files":
                        referenced.update(smeta["files"].values())
                    else:
                        referenced.add(smeta["docs_blob"])
        blob_dir = os.path.join(self.location, "blobs")
        for fname in os.listdir(blob_dir):
            if fname not in referenced and not fname.endswith(".tmp"):
                try:
                    os.remove(os.path.join(blob_dir, fname))
                except OSError:
                    pass

    # ---- restore reads ----

    def shard_files(self, snap: str, index: str, sid: int) -> Optional[Dict[str, bytes]]:
        smeta = self._shard_meta(snap, index, sid)
        if smeta["mode"] != "files":
            return None
        return {rel: self._get_blob(d) for rel, d in smeta["files"].items()}

    def shard_docs(self, snap: str, index: str, sid: int) -> Optional[list]:
        smeta = self._shard_meta(snap, index, sid)
        if smeta["mode"] != "docs":
            return None
        return json.loads(self._get_blob(smeta["docs_blob"]))

    def _shard_meta(self, snap: str, index: str, sid: int) -> dict:
        entry = self.get(snap)
        imeta = entry["indices"].get(index)
        if imeta is None:
            raise SnapshotError(
                f"snapshot [{self.name}:{snap}] has no index [{index}]",
                404,
                "index_not_found_exception",
            )
        return imeta["shards"][str(sid)]
