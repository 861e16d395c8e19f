"""Per-shard write engine: versioned CAS indexing, refresh, flush, merge.

Reference analog: org.elasticsearch.index.engine.InternalEngine — the
orchestration of Lucene's IndexWriter + Translog behind IndexShard
(SURVEY.md §3.2): `InternalEngine.index/delete/get` with per-_id
versioned uniqueness (LiveVersionMap), `refresh` making ops searchable
(NRT reader), `flush` = durable commit + translog trim, sequence numbers
(LocalCheckpointTracker), and recovery replaying the translog tail
(`recoverFromTranslog`).

TPU-native redesign: a "Lucene commit" becomes an atomically-replaced
JSON manifest naming immutable columnar segment directories (the arrays
the device mmaps/uploads), plus per-segment live-doc bitmaps and doc
versions persisted as .npy sidecars. Updates/deletes never mutate a
segment — they flip live_docs bits (soft-deletes) and new doc versions
land in the next refresh's segment, exactly Lucene's delete-and-reinsert
model, which is also what keeps device-resident postings immutable.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
import time as _time
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..analysis import AnalysisRegistry
from ..common.faults import faults
from ..cuts import DISK, not_ported
from ..search.executor import ShardReader
from .mapping import DocumentParser, Mappings
from .segment import Segment
from .translog import (
    DEFAULT_SYNC_INTERVAL,
    DURABILITY_REQUEST,
    Translog,
    bump_durability_stat,
)


class EngineError(Exception):
    pass


class VersionConflictError(EngineError):
    """version_conflict_engine_exception (HTTP 409)."""


@dataclass
class OpResult:
    doc_id: str
    result: str  # created | updated | deleted | not_found | noop
    version: int
    seq_no: int
    primary_term: int


@dataclass
class _VersionEntry:
    version: int
    seq_no: int
    deleted: bool


@dataclass
class _BufferedDoc:
    source: dict
    version: int
    seq_no: int
    parsed: Optional[object] = None  # ParsedDocument, reused by refresh
    ts: float = 0.0  # monotonic ack time — refresh-lag accounting


class ShardEngine:
    """One shard: in-memory indexing buffer + immutable segments + WAL."""

    def __init__(
        self,
        mappings: Mappings,
        analysis: AnalysisRegistry,
        path: Optional[str] = None,
        shard_id: int = 0,
        durability: str = DURABILITY_REQUEST,
        sync_interval: float = DEFAULT_SYNC_INTERVAL,
        primary_term: int = 1,
        codec: str = "default",
        device_build: bool = False,
        device="cuda",
    ):
        self.mappings = mappings
        self.analysis = analysis
        self.parser = DocumentParser(mappings, analysis)
        self.path = path
        self.shard_id = shard_id
        self.primary_term = primary_term
        self.codec = codec
        # torch-backend indices prefer the device segment-build pipeline
        # (index/segment_build.py; ES_TPU_DEVICE_BUILD still overrides),
        # on the index's device
        self.device_build = device_build
        self.device = device
        self._lock = threading.RLock()
        # serializes refreshes (sync AND concurrent) without blocking
        # writes/reads: the double-buffered build runs outside _lock
        self._refresh_mutex = threading.Lock()
        # bumped by every committed segment-set change (refresh, merge)
        # so a concurrent half-build can detect it was superseded and
        # discard itself instead of installing a duplicate segment
        self._refresh_epoch = 0

        self.segments: List[Segment] = []
        self.live_docs: List[Optional[np.ndarray]] = []
        self.seg_versions: List[np.ndarray] = []  # int64 per-doc version
        self.seg_seqnos: List[np.ndarray] = []  # int64 per-doc seq_no
        self.seg_names: List[str] = []
        self.committed_generation = 0
        self.committed_seq_no = -1

        # live version map: _id → newest (version, seq_no, deleted)
        self._versions: Dict[str, _VersionEntry] = {}
        # _id → (segment index, local doc) for the newest *searchable* copy
        self._locations: Dict[str, Tuple[int, int]] = {}
        # unrefreshed ops, in arrival order per _id (newest wins)
        self._buffer: Dict[str, _BufferedDoc] = {}
        self._buffered_deletes: Dict[str, _VersionEntry] = {}

        self._next_seq = 0
        # an in-memory merge not yet reflected in the on-disk manifest
        self._merge_uncommitted = False
        # bumped whenever the searchable state changes (refresh/merge) —
        # lets callers cache readers/executors per generation
        self.change_generation = 0
        # IndexingStats / RefreshStats / FlushStats / MergeStats counters
        self.op_stats = {
            "index_total": 0,
            "index_time_in_nanos": 0,
            "delete_total": 0,
            "refresh_total": 0,
            "flush_total": 0,
            "merge_total": 0,
        }
        self.translog: Optional[Translog] = None
        if path is not None:
            # flush and recovery write and read segments through
            # Segment.save/load, which the port does not have yet: its
            # engines are in-memory
            raise not_ported(
                "an on-disk shard (Segment.save/load and the native codec)",
                DISK,
            )

    # ------------------------------------------------------------------
    # write path (InternalEngine.index / delete)
    # ------------------------------------------------------------------

    def index(
        self,
        doc_id: str,
        source: dict,
        op_type: str = "index",
        if_seq_no: Optional[int] = None,
        if_primary_term: Optional[int] = None,
    ) -> OpResult:
        with self._lock:
            cur = self._versions.get(doc_id)
            exists = cur is not None and not cur.deleted
            if op_type == "create" and exists:
                raise VersionConflictError(
                    f"[{doc_id}]: version conflict, document already exists "
                    f"(current version [{cur.version}])"
                )
            if if_seq_no is not None or if_primary_term is not None:
                if (
                    cur is None
                    or cur.deleted
                    or (if_seq_no is not None and cur.seq_no != if_seq_no)
                    or (
                        if_primary_term is not None
                        and self.primary_term != if_primary_term
                    )
                ):
                    have = (cur.seq_no, self.primary_term) if cur else (-1, 0)
                    raise VersionConflictError(
                        f"[{doc_id}]: version conflict, required seqNo "
                        f"[{if_seq_no}], primary term [{if_primary_term}], "
                        f"current document has seqNo [{have[0]}] and primary "
                        f"term [{have[1]}]"
                    )
            # parse up front: mapping errors must reject the op, not poison
            # the next refresh — and refresh reuses the parse (analysis is
            # the write path's hot loop; don't pay it twice)
            t0 = _time.perf_counter_ns()
            parsed = self.parser.parse(doc_id, source)
            version = (cur.version + 1) if cur is not None else 1
            seq_no = self._next_seq
            self._next_seq += 1
            self._versions[doc_id] = _VersionEntry(version, seq_no, False)
            self._buffer[doc_id] = _BufferedDoc(
                source, version, seq_no, parsed, ts=_time.monotonic()
            )
            self._buffered_deletes.pop(doc_id, None)
            if self.translog is not None:
                self.translog.add(
                    {
                        "op": "index",
                        "id": doc_id,
                        "source": source,
                        "seq_no": seq_no,
                        "version": version,
                    }
                )
            self.op_stats["index_total"] += 1
            self.op_stats["index_time_in_nanos"] += _time.perf_counter_ns() - t0
            return OpResult(
                doc_id,
                "updated" if exists else "created",
                version,
                seq_no,
                self.primary_term,
            )

    def delete(
        self,
        doc_id: str,
        if_seq_no: Optional[int] = None,
        if_primary_term: Optional[int] = None,
    ) -> OpResult:
        with self._lock:
            cur = self._versions.get(doc_id)
            exists = cur is not None and not cur.deleted
            if if_seq_no is not None and (cur is None or cur.seq_no != if_seq_no):
                raise VersionConflictError(
                    f"[{doc_id}]: version conflict on delete"
                )
            if if_primary_term is not None and self.primary_term != if_primary_term:
                raise VersionConflictError(
                    f"[{doc_id}]: version conflict on delete"
                )
            seq_no = self._next_seq
            self._next_seq += 1
            if not exists:
                return OpResult(doc_id, "not_found", 1, seq_no, self.primary_term)
            version = cur.version + 1
            entry = _VersionEntry(version, seq_no, True)
            self._versions[doc_id] = entry
            self._buffer.pop(doc_id, None)
            self._buffered_deletes[doc_id] = entry
            if self.translog is not None:
                self.translog.add(
                    {"op": "delete", "id": doc_id, "seq_no": seq_no, "version": version}
                )
            self.op_stats["delete_total"] += 1
            return OpResult(doc_id, "deleted", version, seq_no, self.primary_term)

    # ------------------------------------------------------------------
    # replica apply (InternalEngine.index on a replica: no CAS — the
    # primary already assigned version+seqno; replicas dedup by seqno,
    # the LiveVersionMap "op came out of order" check)
    # ------------------------------------------------------------------

    def index_replica(
        self, doc_id: str, source: dict, version: int, seq_no: int
    ) -> OpResult:
        with self._lock:
            cur = self._versions.get(doc_id)
            self._next_seq = max(self._next_seq, seq_no + 1)
            if cur is not None and cur.seq_no >= seq_no:
                return OpResult(doc_id, "noop", cur.version, cur.seq_no,
                                self.primary_term)
            parsed = self.parser.parse(doc_id, source)
            self._versions[doc_id] = _VersionEntry(version, seq_no, False)
            self._buffer[doc_id] = _BufferedDoc(
                source, version, seq_no, parsed, ts=_time.monotonic()
            )
            self._buffered_deletes.pop(doc_id, None)
            if self.translog is not None:
                self.translog.add(
                    {
                        "op": "index",
                        "id": doc_id,
                        "source": source,
                        "seq_no": seq_no,
                        "version": version,
                    }
                )
            self.op_stats["index_total"] += 1
            return OpResult(doc_id, "created", version, seq_no, self.primary_term)

    def delete_replica(self, doc_id: str, version: int, seq_no: int) -> OpResult:
        with self._lock:
            cur = self._versions.get(doc_id)
            self._next_seq = max(self._next_seq, seq_no + 1)
            if cur is not None and cur.seq_no >= seq_no:
                return OpResult(doc_id, "noop", cur.version, cur.seq_no,
                                self.primary_term)
            entry = _VersionEntry(version, seq_no, True)
            self._versions[doc_id] = entry
            self._buffer.pop(doc_id, None)
            self._buffered_deletes[doc_id] = entry
            if self.translog is not None:
                self.translog.add(
                    {"op": "delete", "id": doc_id, "seq_no": seq_no,
                     "version": version}
                )
            self.op_stats["delete_total"] += 1
            return OpResult(doc_id, "deleted", version, seq_no, self.primary_term)

    # ------------------------------------------------------------------
    # read path (Engine.get — realtime)
    # ------------------------------------------------------------------

    def get(self, doc_id: str, realtime: bool = True) -> Optional[dict]:
        with self._lock:
            cur = self._versions.get(doc_id)
            if realtime:
                if cur is None or cur.deleted:
                    return None
                buf = self._buffer.get(doc_id)
                if buf is not None:
                    return {
                        "_id": doc_id,
                        "_version": buf.version,
                        "_seq_no": buf.seq_no,
                        "_primary_term": self.primary_term,
                        "_source": buf.source,
                    }
            loc = self._locations.get(doc_id)
            if loc is None:
                return None
            si, local = loc
            live = self.live_docs[si]
            if live is not None and not live[local]:
                return None
            return {
                "_id": doc_id,
                "_version": int(self.seg_versions[si][local]),
                "_seq_no": int(self.seg_seqnos[si][local]),
                "_primary_term": self.primary_term,
                "_source": self.segments[si].sources[local],
            }

    # ------------------------------------------------------------------
    # refresh (make buffered ops searchable)
    # ------------------------------------------------------------------

    def _apply_stale_flips(self) -> bool:
        """Applies buffered deletes/updates to older segments via
        live_docs bits (caller holds self._lock). Returns True when any
        bit flipped."""
        changed = False
        stale = list(self._buffer) + list(self._buffered_deletes)
        for doc_id in stale:
            loc = self._locations.get(doc_id)
            if loc is None:
                continue
            si, local = loc
            if self.live_docs[si] is None:
                self.live_docs[si] = np.ones(
                    self.segments[si].num_docs, dtype=bool
                )
            if self.live_docs[si][local]:
                self.live_docs[si][local] = False
                changed = True
            if doc_id in self._buffered_deletes:
                self._locations.pop(doc_id, None)
        self._buffered_deletes.clear()
        return changed

    def _build_from_items(self, items):
        """(segment, versions, seqnos) for a captured buffer snapshot —
        the heavy step; safe to run outside self._lock (the captured
        _BufferedDoc entries are immutable). Routed through the
        device/host segment-build pipeline (index/segment_build.py)."""
        from . import segment_build

        docs = [
            buf.parsed
            if buf.parsed is not None
            else self.parser.parse(doc_id, buf.source)
            for doc_id, buf in items
        ]
        seg = segment_build.build_segment(
            self.mappings,
            docs,
            shard_id=self.shard_id,
            prefer_device=self.device_build,
            device=self.device,
        )
        versions = np.asarray([buf.version for _, buf in items], np.int64)
        seqnos = np.asarray([buf.seq_no for _, buf in items], np.int64)
        return seg, versions, seqnos

    def _note_refresh_lag(self, items) -> None:
        from . import segment_build

        ts = [buf.ts for _, buf in items if buf.ts > 0.0]
        if ts:
            segment_build.note_refresh_lag(
                (_time.monotonic() - min(ts)) * 1000.0
            )

    def refresh(self) -> bool:
        """Builds a new segment from the buffer; returns True if one was
        created or deletes were applied. Blocking variant: the build
        runs under the engine lock (flush/recovery/REST `_refresh` call
        this; the background refresher uses `refresh_concurrent`)."""
        from . import segment_build

        with self._lock:
            # crash here = power loss with the buffer un-refreshed: the
            # translog already holds every acked op, so recovery replays
            faults.check("engine.refresh", shard=self.shard_id)
            changed = self._apply_stale_flips()
            items = list(self._buffer.items())
            if items:
                seg, versions, seqnos = self._build_from_items(items)
                si = len(self.segments)
                for local, (doc_id, _buf) in enumerate(items):
                    self._locations[doc_id] = (si, local)
                self.segments.append(seg)
                self.live_docs.append(None)
                self.seg_versions.append(versions)
                self.seg_seqnos.append(seqnos)
                self.seg_names.append(f"seg_{self.committed_generation}_{si}")
                self._buffer.clear()
                self._note_refresh_lag(items)
                changed = True
            if changed:
                self.change_generation += 1
                self._refresh_epoch += 1
                self.op_stats["refresh_total"] += 1
                segment_build.note("refreshes")
            return changed

    def refresh_concurrent(self) -> bool:
        """Double-buffered NRT refresh: the next generation's segment
        builds OUTSIDE the engine lock — writes keep landing in the
        buffer and searches keep serving the current generation — and
        the swap is one atomic generation bump under the lock. A
        mid-build failure (injected `engine.refresh`/`build.device`
        fault, device error) discards the half-build and keeps the old
        generation serving; ops stay in the buffer (and the translog)
        for the next cycle. An explicit refresh/merge landing during
        the build supersedes it (epoch check) — the half-build is
        discarded, never installed twice. Writes captured in the
        snapshot but superseded during the build (newer version or
        delete) install dead-on-arrival via the new segment's live
        bitmap, so the swap can never resurrect an overwritten doc."""
        from . import segment_build

        with self._refresh_mutex:
            with self._lock:
                faults.check("engine.refresh", shard=self.shard_id)
                flips = self._apply_stale_flips()
                items = list(self._buffer.items())
                epoch = self._refresh_epoch
                if not items:
                    if flips:
                        self.change_generation += 1
                        self._refresh_epoch += 1
                        self.op_stats["refresh_total"] += 1
                        segment_build.note("refreshes")
                    return flips
            t0 = _time.perf_counter()
            try:
                seg, versions, seqnos = self._build_from_items(items)
            except BaseException:
                # half-build discarded; the flips (acked deletes) still
                # become visible so a failed build can't extend their
                # invisibility window
                segment_build.note("generations_discarded")
                with self._lock:
                    if flips and self._refresh_epoch == epoch:
                        self.change_generation += 1
                        self._refresh_epoch += 1
                raise
            segment_build.note(
                "overlap_ms", (_time.perf_counter() - t0) * 1000.0
            )
            with self._lock:
                if self._refresh_epoch != epoch:
                    # a blocking refresh/merge swapped mid-build: its
                    # segment already holds these ops — discard ours
                    segment_build.note("generations_discarded")
                    return True
                si = len(self.segments)
                live = None
                for local, (doc_id, buf) in enumerate(items):
                    cur_buf = self._buffer.get(doc_id)
                    if cur_buf is not None and cur_buf.seq_no == buf.seq_no:
                        del self._buffer[doc_id]
                    cur = self._versions.get(doc_id)
                    if (
                        cur is not None
                        and cur.seq_no == buf.seq_no
                        and not cur.deleted
                    ):
                        self._locations[doc_id] = (si, local)
                    else:
                        # superseded during the build: dead on arrival
                        if live is None:
                            live = np.ones(len(items), dtype=bool)
                        live[local] = False
                self.segments.append(seg)
                self.live_docs.append(live)
                self.seg_versions.append(versions)
                self.seg_seqnos.append(seqnos)
                self.seg_names.append(f"seg_{self.committed_generation}_{si}")
                self._note_refresh_lag(items)
                self.change_generation += 1
                self._refresh_epoch += 1
                self.op_stats["refresh_total"] += 1
                segment_build.note("refreshes")
                segment_build.note("concurrent_refreshes")
            return True

    @property
    def dirty(self) -> bool:
        """True when a refresh would change the searchable state."""
        return bool(self._buffer) or bool(self._buffered_deletes)

    # ------------------------------------------------------------------
    # flush (durable commit) & merge
    # ------------------------------------------------------------------

    def flush(self) -> None:
        """Refresh + persist segments + atomic manifest commit + translog
        trim (IndexShard.flush → Lucene commit + trimUnreferencedReaders).

        Crash-safe commit protocol (the reference fsyncs every segment
        file before the commit point and never mutates committed files):
          1. every new segment dir is fully written AND fsynced first
             (versions/seqnos sidecars are immutable per segment and are
             written exactly once, with the segment);
          2. mutable live-doc bitmaps go to fresh per-generation names
             (``live-<gen>.npy``) — committed files are never rewritten;
          3. the manifest referencing them is atomically replaced and the
             shard directory fsynced;
          4. only then is the translog trimmed and old files GC'd.
        A power loss at any step leaves either the old commit (all its
        files untouched) or the new one (all its files durable)."""
        with self._lock:
            faults.check("engine.flush", shard=self.shard_id, stage="start")
            self.refresh()
            self.op_stats["flush_total"] += 1
            if self.path is None:
                return
            if (
                not self._merge_uncommitted
                and self.committed_seq_no == self._next_seq - 1
                and os.path.exists(os.path.join(self.path, "manifest.json"))
            ):
                # nothing since the last commit — idempotent flush, the
                # manifest (and thus snapshot blobs) stays byte-identical
                return
            from .segment import fsync_dir, fsync_path

            self.committed_generation += 1
            gen = self.committed_generation
            if self.translog is not None:
                self.translog.roll_generation()
            seg_entries = []
            for si, seg in enumerate(self.segments):
                name = self.seg_names[si]
                seg_dir = os.path.join(self.path, name)
                sentinel = os.path.join(seg_dir, "segment.json")
                if os.path.exists(sentinel):
                    # a crashed earlier flush can leave a SAME-NAMED dir
                    # holding a different segmentation (recovery rebuilds
                    # the replayed buffer as one segment, reusing low
                    # indices) — committing the manifest over the stale
                    # dir would silently lose acked docs. Verify the
                    # sentinel actually describes THIS segment; torn or
                    # mismatched dirs are quarantined and rewritten.
                    try:
                        with open(sentinel, encoding="utf-8") as f:
                            ondisk = json.load(f)
                        stale = int(ondisk.get("num_docs", -1)) != seg.num_docs
                    except (OSError, ValueError):
                        stale = True
                    if stale:
                        shutil.rmtree(seg_dir, ignore_errors=True)
                        bump_durability_stat("quarantined_segments")
                if not os.path.exists(sentinel):
                    # sidecars FIRST: segment.json is the "segment fully
                    # persisted" sentinel (checked above), so everything
                    # it references must be durable before seg.save
                    # atomically commits it — otherwise a crash between
                    # the two leaves a sentinel whose sidecars are torn
                    # and the skip branch would never repair them
                    os.makedirs(seg_dir, exist_ok=True)
                    np.save(
                        os.path.join(seg_dir, "versions.npy"),
                        self.seg_versions[si],
                    )
                    np.save(
                        os.path.join(seg_dir, "seqnos.npy"), self.seg_seqnos[si]
                    )
                    fsync_path(os.path.join(seg_dir, "versions.npy"))
                    fsync_path(os.path.join(seg_dir, "seqnos.npy"))
                    # fsyncs its files + dir, commits segment.json last
                    seg.save(seg_dir, codec=self.codec)
                live = self.live_docs[si]
                live_gen = None
                if live is not None:
                    live_gen = gen
                    live_path = os.path.join(seg_dir, f"live-{gen}.npy")
                    np.save(live_path, live)
                    fsync_path(live_path)
                    fsync_dir(seg_dir)
                seg_entries.append({"name": name, "live_gen": live_gen})
            committed_seq = self._next_seq - 1
            manifest = {
                "format_version": 2,
                "generation": gen,
                "segments": seg_entries,
                "max_seq_no": committed_seq,
                "primary_term": self.primary_term,
            }
            # every segment file is durable but the commit point is not:
            # a crash here must recover the PREVIOUS commit + WAL replay
            faults.check("engine.flush", shard=self.shard_id,
                         stage="pre_manifest")
            tmp = os.path.join(self.path, "manifest.json.tmp")
            with open(tmp, "w", encoding="utf-8") as f:
                json.dump(manifest, f)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, os.path.join(self.path, "manifest.json"))
            fsync_dir(self.path)
            # the commit is durable; the translog is not yet trimmed — a
            # crash here recovers from the NEW commit (replay skips ops
            # its max_seq_no covers) and the next flush re-trims
            faults.check("engine.flush", shard=self.shard_id,
                         stage="post_manifest")
            self.committed_seq_no = committed_seq
            self._merge_uncommitted = False
            if self.translog is not None:
                self.translog.trim_unreferenced(committed_seq)
            self._gc_segments(seg_entries)

    def _gc_segments(self, referenced: List[dict]) -> None:
        assert self.path is not None
        keep = {e["name"] for e in referenced} | {"translog"}
        live_gens = {e["name"]: e["live_gen"] for e in referenced}
        for fname in os.listdir(self.path):
            full = os.path.join(self.path, fname)
            if not os.path.isdir(full):
                continue
            if fname not in keep:
                shutil.rmtree(full, ignore_errors=True)
                continue
            # drop superseded per-generation live bitmaps
            want = live_gens.get(fname)
            for sub in os.listdir(full):
                if sub.startswith("live-") and sub.endswith(".npy"):
                    g = sub[len("live-") : -len(".npy")]
                    if not g.isdigit() or want is None or int(g) != want:
                        try:
                            os.remove(os.path.join(full, sub))
                        except OSError:
                            pass
                elif sub == "live.npy" and want is not None:
                    # pre-format-v2 mutable bitmap superseded by live-<gen>
                    try:
                        os.remove(os.path.join(full, sub))
                    except OSError:
                        pass

    def maybe_merge(self, max_segments: int = 8) -> bool:
        """Segment-count merge policy (TieredMergePolicy, crudely): when
        the shard accumulates more than ``max_segments`` segments, rebuild
        all live docs into one. Columnar segments can't be concatenated
        (term dictionaries and norms are per-segment), so a merge re-parses
        retained sources — the analog of Lucene rewriting merged segments."""
        with self._lock:
            if len(self.segments) <= max_segments:
                return False
            # crash here = power loss mid-merge: nothing on disk moved
            # yet (the merge result only becomes durable at flush)
            faults.check("engine.merge", shard=self.shard_id)
            from . import segment_build

            docs = []
            versions: List[int] = []
            seqnos: List[int] = []
            new_locations: Dict[str, Tuple[int, int]] = {}
            local = 0
            for si, seg in enumerate(self.segments):
                live = self.live_docs[si]
                for d in range(seg.num_docs):
                    if live is not None and not live[d]:
                        continue
                    doc_id = seg.doc_ids[d]
                    docs.append(self.parser.parse(doc_id, seg.sources[d]))
                    versions.append(int(self.seg_versions[si][d]))
                    seqnos.append(int(self.seg_seqnos[si][d]))
                    new_locations[doc_id] = (0, local)
                    local += 1
            # merges are the biggest builds of all — they ride the same
            # device/host build pipeline as refresh
            merged = segment_build.build_segment(
                self.mappings, docs, shard_id=self.shard_id,
                prefer_device=self.device_build,
                device=self.device,
            )
            self.segments = [merged]
            self.live_docs = [None]
            self.seg_versions = [np.asarray(versions, np.int64)]
            self.seg_seqnos = [np.asarray(seqnos, np.int64)]
            self.seg_names = [f"seg_{self.committed_generation}_m0"]
            self._locations = new_locations
            self.change_generation += 1
            # a merge rewrites the segment list: any concurrent refresh
            # build captured before it must discard itself
            self._refresh_epoch += 1
            self.op_stats["merge_total"] += 1
            self._merge_uncommitted = True
            return True

    def merge_concurrent(self, max_segments: int = 8) -> bool:
        """Double-buffered merge: same policy as `maybe_merge`, but the
        merged segment — the biggest build a shard ever does — runs
        OUTSIDE the engine lock, so writes keep landing in the buffer
        and searches keep serving the current generation while it
        builds. The swap is one atomic generation bump under the lock,
        guarded by the same epoch check as `refresh_concurrent`: any
        refresh or merge that swapped mid-build supersedes this one
        (the half-build is discarded; the next tick re-evaluates the
        policy against the NEW segment list). Docs captured in the
        snapshot but superseded during the build (newer version or
        delete) install dead-on-arrival via the merged segment's live
        bitmap. Holds `_refresh_mutex` for the duration, so a merge
        delays the next background refresh but never blocks the write
        path — that is the pacing bound tier-1 gates."""
        from . import segment_build

        with self._refresh_mutex:
            with self._lock:
                if len(self.segments) <= max_segments:
                    return False
                # crash here = power loss mid-merge: nothing on disk
                # moved yet (the result only becomes durable at flush)
                faults.check("engine.merge", shard=self.shard_id)
                epoch = self._refresh_epoch
                rows: List[Tuple[str, str, int, int]] = []
                for si, seg in enumerate(self.segments):
                    live = self.live_docs[si]
                    for d in range(seg.num_docs):
                        if live is not None and not live[d]:
                            continue
                        rows.append(
                            (
                                seg.doc_ids[d],
                                seg.sources[d],
                                int(self.seg_versions[si][d]),
                                int(self.seg_seqnos[si][d]),
                            )
                        )
            t0 = _time.perf_counter()
            try:
                docs = [
                    self.parser.parse(doc_id, src)
                    for doc_id, src, _v, _s in rows
                ]
                merged = segment_build.build_segment(
                    self.mappings, docs, shard_id=self.shard_id,
                    prefer_device=self.device_build,
                    device=self.device,
                )
            except BaseException:
                # half-build discarded; the old segment list keeps
                # serving and the policy retries next tick
                segment_build.note("generations_discarded")
                raise
            segment_build.note(
                "overlap_ms", (_time.perf_counter() - t0) * 1000.0
            )
            with self._lock:
                if self._refresh_epoch != epoch:
                    # a refresh/merge swapped mid-build: the segment
                    # list we merged no longer exists — discard
                    segment_build.note("generations_discarded")
                    return False
                live = None
                new_locations: Dict[str, Tuple[int, int]] = {}
                for local, (doc_id, _src, _v, seq) in enumerate(rows):
                    cur = self._versions.get(doc_id)
                    if (
                        cur is not None
                        and cur.seq_no == seq
                        and not cur.deleted
                    ):
                        new_locations[doc_id] = (0, local)
                    else:
                        # superseded during the build: dead on arrival
                        if live is None:
                            live = np.ones(len(rows), dtype=bool)
                        live[local] = False
                self.segments = [merged]
                self.live_docs = [live]
                self.seg_versions = [
                    np.asarray([v for _i, _s, v, _q in rows], np.int64)
                ]
                self.seg_seqnos = [
                    np.asarray([q for _i, _s, _v, q in rows], np.int64)
                ]
                self.seg_names = [f"seg_{self.committed_generation}_m0"]
                self._locations = new_locations
                self.change_generation += 1
                self._refresh_epoch += 1
                self.op_stats["merge_total"] += 1
                self._merge_uncommitted = True
                segment_build.note("concurrent_merges")
            return True

    # ------------------------------------------------------------------
    # recovery (open an existing shard directory)
    # ------------------------------------------------------------------

    def _recover(self, durability: str,
                 sync_interval: float = DEFAULT_SYNC_INTERVAL) -> None:
        assert self.path is not None

        manifest_path = os.path.join(self.path, "manifest.json")
        # a crash between the manifest tmp-write and its os.replace
        # leaves manifest.json.tmp behind; remove it before anything
        # else can mistake it for state
        tmp_manifest = manifest_path + ".tmp"
        if os.path.exists(tmp_manifest):
            try:
                os.remove(tmp_manifest)
                bump_durability_stat("orphan_manifests_removed")
            except OSError:
                pass
        committed_seq = -1
        manifest = None
        if os.path.exists(manifest_path):
            with open(manifest_path, encoding="utf-8") as f:
                manifest = json.load(f)
        # quarantine segment directories the commit does NOT reference:
        # they are partially-written leftovers of a crashed flush. Left
        # in place, a post-replay flush could collide with a stale
        # same-named dir and commit a manifest over the WRONG bytes —
        # the replayed ops re-materialize their docs, so deleting the
        # orphans loses nothing.
        referenced = set()
        if manifest is not None:
            for entry in manifest["segments"]:
                referenced.add(entry if isinstance(entry, str)
                               else entry["name"])
        for fname in os.listdir(self.path):
            full = os.path.join(self.path, fname)
            if not os.path.isdir(full) or fname == "translog":
                continue
            if fname not in referenced:
                shutil.rmtree(full, ignore_errors=True)
                bump_durability_stat("quarantined_segments")
        if manifest is not None:
            self.committed_generation = manifest["generation"]
            committed_seq = manifest["max_seq_no"]
            self.primary_term = manifest.get("primary_term", self.primary_term)
            for si, entry in enumerate(manifest["segments"]):
                if isinstance(entry, str):  # format_version 1
                    name, live_gen = entry, None
                else:
                    name, live_gen = entry["name"], entry.get("live_gen")
                seg_dir = os.path.join(self.path, name)
                seg = Segment.load(seg_dir)
                self.segments.append(seg)
                self.seg_names.append(name)
                self.seg_versions.append(
                    np.load(os.path.join(seg_dir, "versions.npy"))
                )
                self.seg_seqnos.append(np.load(os.path.join(seg_dir, "seqnos.npy")))
                if live_gen is not None:
                    live_path = os.path.join(seg_dir, f"live-{live_gen}.npy")
                else:
                    live_path = os.path.join(seg_dir, "live.npy")
                self.live_docs.append(
                    np.load(live_path) if os.path.exists(live_path) else None
                )
            # rebuild the version map from segments (newest segment wins)
            for si, seg in enumerate(self.segments):
                live = self.live_docs[si]
                for d, doc_id in enumerate(seg.doc_ids):
                    if live is not None and not live[d]:
                        continue
                    self._locations[doc_id] = (si, d)
                    self._versions[doc_id] = _VersionEntry(
                        int(self.seg_versions[si][d]),
                        int(self.seg_seqnos[si][d]),
                        False,
                    )
        self.committed_seq_no = committed_seq
        self._next_seq = committed_seq + 1
        self.translog = Translog(
            os.path.join(self.path, "translog"),
            durability=durability,
            sync_interval=sync_interval,
            shard_id=self.shard_id,
        )
        # replay the translog tail (ops newer than the commit)
        replayed = 0
        for op in self.translog.read_ops_after(committed_seq):
            seq_no = op["seq_no"]
            self._next_seq = max(self._next_seq, seq_no + 1)
            doc_id = op["id"]
            if op["op"] == "index":
                self._versions[doc_id] = _VersionEntry(op["version"], seq_no, False)
                self._buffer[doc_id] = _BufferedDoc(op["source"], op["version"], seq_no)
                self._buffered_deletes.pop(doc_id, None)
            else:
                entry = _VersionEntry(op["version"], seq_no, True)
                self._versions[doc_id] = entry
                self._buffer.pop(doc_id, None)
                self._buffered_deletes[doc_id] = entry
            replayed += 1
        if replayed:
            bump_durability_stat("replayed_ops", replayed)
            bump_durability_stat("tail_replays")
            self.refresh()

    # ------------------------------------------------------------------
    # readers & stats
    # ------------------------------------------------------------------

    def reader(self) -> ShardReader:
        """Point-in-time snapshot of the searchable state (live_docs are
        copied so concurrent deletes don't mutate an open reader)."""
        with self._lock:
            return ShardReader(
                list(self.segments),
                self.mappings,
                self.analysis,
                [None if l is None else l.copy() for l in self.live_docs],
            )

    @property
    def num_docs(self) -> int:
        with self._lock:
            n = 0
            for si, seg in enumerate(self.segments):
                live = self.live_docs[si]
                n += seg.num_docs if live is None else int(live.sum())
            return n

    @property
    def max_seq_no(self) -> int:
        return self._next_seq - 1

    def translog_stats(self) -> dict:
        """The per-shard slice of the `_nodes/stats` translog block."""
        with self._lock:
            out = {
                "uncommitted_ops": max(
                    0, (self._next_seq - 1) - self.committed_seq_no
                ),
                "uncommitted_bytes": 0,
                "last_fsync_age_ms": None,
                "pending_ops": 0,
                "durability": None,
            }
            if self.translog is not None:
                tl = self.translog.stats()
                out["uncommitted_bytes"] = tl["uncommitted_bytes"]
                out["last_fsync_age_ms"] = tl["last_fsync_age_ms"]
                out["pending_ops"] = tl["pending_ops"]
                out["durability"] = tl["durability"]
            return out

    def close(self) -> None:
        with self._lock:
            if self.translog is not None:
                self.translog.close()

    def crash(self) -> None:
        """Simulated power loss (the durability harness's teardown): NO
        flush, NO refresh, NO translog sync — the translog drops its
        acked-but-unfsynced tail exactly like the page cache on a dead
        box, and the in-memory state is abandoned. Reopening the same
        path afterwards exercises the real recovery path."""
        with self._lock:
            if self.translog is not None:
                self.translog.crash()
