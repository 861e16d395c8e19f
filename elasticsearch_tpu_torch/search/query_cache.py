"""Device-resident query & request caching.

Reference analogs (SURVEY.md §2.1 caching rows):

* ``FilterBitsetCache`` — org.apache.lucene.search.LRUQueryCache behind
  Elasticsearch's IndicesQueryCache: filter-context queries evaluate
  once per (shard, searchable-state generation, segment) into a bitset
  that is reused across requests. On the torch backend the cached
  bitset is a DEVICE-RESIDENT ``torch.bool`` tensor on the executor's
  device, which the scoring functions consume directly (device memory is
  the cache medium, charged to the ``query_cache`` ledger category); the
  NumPy oracle caches host-side packed bitmaps (``np.packbits``, one bit
  per doc).

* ``ShardRequestCache`` — org.elasticsearch.indices.IndicesRequestCache:
  whole shard-level responses for ``size: 0`` / aggregation-only
  requests, keyed by the canonical request bytes. Entries are stored as
  JSON strings so hits deserialize to fresh objects (no aliasing into
  the cache).

Invalidation model (both caches): the cache key embeds the shard
engine's ``change_generation`` — the counter ``index/engine.py`` bumps
whenever the searchable state changes (refresh that applied anything,
merge). A refresh-after-update/delete therefore can NEVER serve a stale
entry; superseded generations are purged eagerly when the shard's
executor regenerates and lazily by LRU pressure otherwise.

Memory policy (degrade-don't-fail, mirroring common/memory.py): before
an insert would exceed the cache budget or the HBM ledger, LRU entries
are EVICTED; if the entry still cannot fit the insert is skipped and
counted as a degraded allocation — the breaker never trips on a cache
fill, because an uncached filter is an optimization lost, not an error.
"""

from __future__ import annotations

import json
import os
import threading
from collections import OrderedDict
from typing import Any, Dict, Iterable, List, Optional, Tuple


class CacheCtx:
    """Identity of one shard's searchable state for cache keying:
    ``shard_key`` is "<index uuid>[<shard id>]", ``generation`` the
    engine's change_generation at executor creation, ``backend`` tags
    the bitset flavor ("torch" device tensors vs "np" packed host bits)
    so the two executors over one shard never alias entries."""

    __slots__ = ("shard_key", "generation", "backend")

    def __init__(self, shard_key: str, generation: int, backend: str):
        self.shard_key = shard_key
        self.generation = generation
        self.backend = backend

    @property
    def index_uuid(self) -> str:
        return self.shard_key.split("[", 1)[0]


def _zeroed_stats() -> Dict[str, int]:
    return {
        "memory_size_in_bytes": 0,
        "hit_count": 0,
        "miss_count": 0,
        "evictions": 0,
        "cache_count": 0,
    }


class _LruStatsMixin:
    """Shared LRU bookkeeping: entries ordered by recency, byte
    accounting, node-level + per-index-uuid counters."""

    def __init__(self):
        self._lock = threading.RLock()
        self._entries: "OrderedDict[Tuple, Tuple[Any, int]]" = OrderedDict()
        self._mem = 0
        self._node = _zeroed_stats()
        self._by_uuid: Dict[str, Dict[str, int]] = {}

    def _uuid_stats(self, uuid: str) -> Dict[str, int]:
        st = self._by_uuid.get(uuid)
        if st is None:
            st = self._by_uuid[uuid] = _zeroed_stats()
        return st

    def _count(self, uuid: str, stat: str, delta: int = 1) -> None:
        self._node[stat] += delta
        self._uuid_stats(uuid)[stat] += delta

    def _key_uuid(self, key: Tuple) -> str:
        return str(key[0]).split("[", 1)[0]

    def _pop_entry(self, key: Tuple, stat: str) -> int:
        _, nbytes = self._entries.pop(key)
        self._mem -= nbytes
        uuid = self._key_uuid(key)
        self._count(uuid, "memory_size_in_bytes", -nbytes)
        self._count(uuid, "cache_count", -1)
        if stat:
            self._count(uuid, stat)
        return nbytes

    def node_stats(self) -> Dict[str, int]:
        with self._lock:
            return dict(self._node)

    def stats_for_index(self, uuid: str) -> Dict[str, int]:
        with self._lock:
            return dict(self._by_uuid.get(uuid) or _zeroed_stats())

    def clear(self, uuids: Optional[Iterable[str]] = None) -> int:
        """Drops entries (for the given index uuids, or everything).
        Returns the number of entries removed."""
        wanted = set(uuids) if uuids is not None else None
        with self._lock:
            victims = [
                k
                for k in self._entries
                if wanted is None or self._key_uuid(k) in wanted
            ]
            for k in victims:
                self._release(k, self._pop_entry(k, ""))
            return len(victims)

    # subclasses release external accounting (the HBM ledger) here
    def _release(self, key: Tuple, nbytes: int) -> None:  # pragma: no cover
        pass


def _query_cache_budget() -> int:
    """Byte budget for cached filter bitsets: an explicit override, else
    a 10% share of the HBM ledger budget (the shape of ES's default
    ``indices.queries.cache.size: 10%``)."""
    env = os.environ.get("ES_TPU_QUERY_CACHE_BUDGET_BYTES")
    if env:
        return int(env)
    from ..common.memory import hbm_ledger

    return hbm_ledger.budget // 10


class FilterBitsetCache(_LruStatsMixin):
    """LRU cache of evaluated filter-context bitsets, keyed
    (shard_key, backend, generation, segment index, canonical filter
    key). Bytes are charged to the HBM ledger's ``query_cache``
    category; eviction runs BEFORE the ledger would trip."""

    CATEGORY = "query_cache"

    def get(self, ctx: CacheCtx, si: int, fkey: str):
        key = (ctx.shard_key, ctx.backend, ctx.generation, si, fkey)
        with self._lock:
            entry = self._entries.get(key)
            if entry is None:
                self._count(ctx.index_uuid, "miss_count")
                return None
            self._entries.move_to_end(key)
            self._count(ctx.index_uuid, "hit_count")
            return entry[0]

    def put(self, ctx: CacheCtx, si: int, fkey: str, mask, nbytes: int) -> bool:
        """Inserts a bitset, LRU-evicting to make room; returns False
        (and counts a degraded allocation) when the bitset cannot fit
        even with the cache emptied."""
        from ..common.memory import hbm_ledger

        key = (ctx.shard_key, ctx.backend, ctx.generation, si, fkey)
        with self._lock:
            if key in self._entries:
                return True
            budget = _query_cache_budget()
            while self._entries and (
                self._mem + nbytes > budget
                or not hbm_ledger.would_fit(nbytes)
            ):
                old = next(iter(self._entries))
                self._release(old, self._pop_entry(old, "evictions"))
            if self._mem + nbytes > budget or not hbm_ledger.would_fit(nbytes):
                hbm_ledger.note_degraded()
                return False
            hbm_ledger.add(self.CATEGORY, nbytes, breaker=False)
            self._entries[key] = (mask, nbytes)
            self._mem += nbytes
            uuid = ctx.index_uuid
            self._count(uuid, "memory_size_in_bytes", nbytes)
            self._count(uuid, "cache_count")
            return True

    def invalidate_shard(self, shard_key: str, keep_generation: int) -> int:
        """Eagerly drops every generation but ``keep_generation`` for one
        shard (called when the shard's executor regenerates after a
        refresh/merge — the key's generation already guarantees no stale
        HIT; this reclaims the superseded bitsets' HBM)."""
        with self._lock:
            victims = [
                k
                for k in self._entries
                if k[0] == shard_key and k[2] != keep_generation
            ]
            for k in victims:
                self._release(k, self._pop_entry(k, "evictions"))
            return len(victims)

    def _release(self, key: Tuple, nbytes: int) -> None:
        from ..common.memory import hbm_ledger

        hbm_ledger.release(self.CATEGORY, nbytes)


def _request_cache_budget() -> int:
    env = os.environ.get("ES_TPU_REQUEST_CACHE_BUDGET_BYTES")
    if env:
        return int(env)
    return 64 * 1024 * 1024


class ShardRequestCache(_LruStatsMixin):
    """LRU cache of whole shard-level responses for size:0/agg-only
    requests, keyed (shard_key, refresh generation, canonical request
    bytes). Host memory with its own byte budget (request responses are
    JSON, not device arrays)."""

    def get(self, shard_key: str, generation: int, body_key: str):
        key = (shard_key, generation, body_key)
        with self._lock:
            entry = self._entries.get(key)
            uuid = self._key_uuid(key)
            if entry is None:
                self._count(uuid, "miss_count")
                return None
            self._entries.move_to_end(key)
            self._count(uuid, "hit_count")
        # deserialize OUTSIDE the lock: hits must hand back fresh
        # objects (reducers mutate responses)
        return json.loads(entry[0])

    def put(self, shard_key: str, generation: int, body_key: str,
            response: dict) -> bool:
        try:
            blob = json.dumps(response)
        except (TypeError, ValueError):
            return False  # non-JSON payload (exotic agg partial): skip
        nbytes = len(blob) + len(body_key)
        key = (shard_key, generation, body_key)
        with self._lock:
            if key in self._entries:
                return True
            # purge superseded generations of this shard eagerly: the
            # refresh that bumped the generation made them unreachable
            stale = [
                k
                for k in self._entries
                if k[0] == shard_key and k[1] != generation
            ]
            for k in stale:
                self._pop_entry(k, "evictions")
            budget = _request_cache_budget()
            if nbytes > budget:
                return False
            while self._entries and self._mem + nbytes > budget:
                old = next(iter(self._entries))
                self._pop_entry(old, "evictions")
            self._entries[key] = (blob, nbytes)
            self._mem += nbytes
            uuid = self._key_uuid(key)
            self._count(uuid, "memory_size_in_bytes", nbytes)
            self._count(uuid, "cache_count")
            return True

    def invalidate_shard(self, shard_key: str, keep_generation: int) -> int:
        with self._lock:
            victims = [
                k
                for k in self._entries
                if k[0] == shard_key and k[1] != keep_generation
            ]
            for k in victims:
                self._pop_entry(k, "evictions")
            return len(victims)


# keys whose presence anywhere in a search body makes the response
# non-deterministic or side-effectful — never request-cached (the
# reference's "requests that use now/scripts are not cached")
_RC_FORBIDDEN_KEYS = frozenset(
    {
        "script",
        "script_fields",
        "script_score",
        "random_score",
        "percolate",
        "more_like_this",
        "pit",
        "search_after",
    }
)


def request_cacheable_body(node: Any) -> bool:
    """True when no forbidden key appears anywhere in the body tree."""
    if isinstance(node, dict):
        return all(
            k not in _RC_FORBIDDEN_KEYS and request_cacheable_body(v)
            for k, v in node.items()
        )
    if isinstance(node, (list, tuple)):
        return all(request_cacheable_body(v) for v in node)
    return True


# process-wide singletons (node-level caches, like IndicesQueryCache /
# IndicesRequestCache being node services in the reference)
filter_cache = FilterBitsetCache()
request_cache = ShardRequestCache()
