"""Device-memory accounting: the HBM ledger + circuit breaker.

Reference analogs: HierarchyCircuitBreakerService (parent + child
breakers; CircuitBreakingException → HTTP 429) and the fielddata /
request breakers (SURVEY.md §2.1 Memory management row). The TPU-native
resource is HBM: device-resident postings tiles, doc-value columns,
vectors, norm caches, and dense hot-term rows all charge the ledger at
upload. When a WOULD-BE upload cannot fit, the allocator either
degrades (dense hot rows are an optimization — the chunked scorer path
covers correctness without them) or trips the breaker.

Categories in use: `postings`/`doc_values`/`vectors`/`norms`/`dense`
(index-resident uploads), `query_cache` (device filter bitsets, own
LRU budget), `serving` — the serving pipeline's persistent padded
staging slabs (executor_jax.staging_slab: fixed-size rings of reusable
query-operand buffers, sized to workers × (pipeline_depth + 1), charged
once at first use and released with the executor) — and `mesh`, the
mesh-parallel serving stacks (parallel/mesh_executor.py: per-snapshot
device views of an index's live (shard, segment) entries, charged at
build — once for the whole stack, as the reference charges it, however
many slots and ``data`` copies hold it — and released on generation
rebuild/close; a stack that cannot fit DEGRADES the request to the
per-shard path instead of tripping the breaker). `rerank` holds the second-stage reranker's shard-level
`rank_vectors` token columns (search/rescorer.py; a column that cannot
fit DEGRADES TO SKIP — the request keeps its first-stage ranking).
`impacts` holds the learned-sparse impact-tile columns
(executor_jax.impact_scorer: per-(segment, field, storage-mode) uploads
of the impact-ordered doc/value planes, int8 or fp32; a column that
cannot fit DEGRADES to the dense fp32 host oracle — exact answers,
just not device-served). Per-category bytes surface as child breakers
in `_nodes/stats` (child_breakers())."""

from __future__ import annotations

import collections
import os
import threading
from typing import Dict


class CircuitBreakingException(Exception):
    """es analog: circuit_breaking_exception, HTTP 429."""

    def __init__(self, reason: str, bytes_wanted: int, limit: int):
        super().__init__(reason)
        self.reason = reason
        self.bytes_wanted = bytes_wanted
        self.limit = limit
        self.status = 429
        self.err_type = "circuit_breaking_exception"


# The reference budget left 4 GiB of a 16 GiB TPU v5e to the compiler's
# scratch and the accumulators; the port keeps the same share free.
_BUDGET_SHARE = 12 / 16


def _default_budget() -> int:
    """`ES_TPU_HBM_BUDGET_BYTES` when set; else the card's total memory
    (`torch.cuda.mem_get_info`) times the reference's headroom share;
    else, with no card, the reference's fixed 12 GiB so the ledger
    behaves the same on the CPU."""
    env = os.environ.get("ES_TPU_HBM_BUDGET_BYTES")
    if env:
        return int(env)
    import torch

    if torch.cuda.is_available():
        _free, total = torch.cuda.mem_get_info()
        return int(total * _BUDGET_SHARE)
    return 12 * 1024**3


class HbmLedger:
    """Byte accounting per category with a hard budget.

    Not a malloc hook — PyTorch's caching allocator owns real allocation. This tracks the
    framework's OWN resident uploads (the analog of ES accounting its
    own BigArrays rather than the JVM heap) so admission control can
    refuse or degrade before the device OOMs.
    """

    def __init__(self, budget: int | None = None):
        # resolved on first use, so importing the module touches no card
        self._budget = budget
        self._lock = threading.Lock()
        self._by_category: Dict[str, int] = {}
        # releases waiting to be applied under the lock: `release` runs
        # from `weakref.finalize` callbacks (ops/wand.py), which the
        # collector may fire on a thread that already holds the lock
        self._pending: "collections.deque[tuple[str, int]]" = (
            collections.deque()
        )
        self.stats_counters = {"tripped": 0, "degraded": 0}

    @property
    def budget(self) -> int:
        if self._budget is None:
            self._budget = _default_budget()
        return self._budget

    @budget.setter
    def budget(self, value: int) -> None:
        self._budget = value

    def _apply_pending(self) -> None:
        """Applies queued releases; the caller holds the lock."""
        while self._pending:
            category, nbytes = self._pending.popleft()
            left = self._by_category.get(category, 0) - nbytes
            if left <= 0:
                self._by_category.pop(category, None)
            else:
                self._by_category[category] = left

    @property
    def used(self) -> int:
        with self._lock:
            self._apply_pending()
            return sum(self._by_category.values())

    def would_fit(self, nbytes: int) -> bool:
        return self.used + nbytes <= self.budget

    def add(self, category: str, nbytes: int, breaker: bool = True) -> None:
        """Charges the ledger; raises CircuitBreakingException when the
        budget would be exceeded and `breaker` is set (non-breaker adds
        record overage instead — better a tracked overage than a lying
        ledger)."""
        with self._lock:
            self._apply_pending()
            used = sum(self._by_category.values())
            if breaker and used + nbytes > self.budget:
                self.stats_counters["tripped"] += 1
                raise CircuitBreakingException(
                    f"[hbm] Data too large: would use "
                    f"{used + nbytes} bytes, limit {self.budget}",
                    bytes_wanted=nbytes,
                    limit=self.budget,
                )
            self._by_category[category] = (
                self._by_category.get(category, 0) + nbytes
            )

    def release(self, category: str, nbytes: int) -> None:
        """Never blocks: queues the release (a deque append is atomic)
        and applies it at once when the lock is free. A finalizer that
        runs while its own thread holds the lock leaves it queued for
        the next locked call, so it cannot deadlock or change the dict
        under a sum."""
        self._pending.append((category, nbytes))
        if self._lock.acquire(blocking=False):
            try:
                self._apply_pending()
            finally:
                self._lock.release()

    def note_degraded(self) -> None:
        with self._lock:
            self._apply_pending()
            self.stats_counters["degraded"] += 1

    def stats(self) -> dict:
        with self._lock:
            self._apply_pending()
            used = sum(self._by_category.values())
            return {
                "limit_size_in_bytes": self.budget,
                "estimated_size_in_bytes": used,
                "by_category": dict(self._by_category),
                "tripped": self.stats_counters["tripped"],
                "degraded_allocations": self.stats_counters["degraded"],
            }

    def child_breakers(self) -> Dict[str, dict]:
        """ES-style child-breaker entries, one per ledger category
        (postings tiles, norms, dense rows, query_cache bitsets, …) —
        the per-category byte usage the `_nodes/stats` breakers section
        surfaces next to the `hbm` parent."""
        with self._lock:
            self._apply_pending()
            return {
                f"hbm.{cat}": {
                    "limit_size_in_bytes": self.budget,
                    "estimated_size_in_bytes": nbytes,
                }
                for cat, nbytes in sorted(self._by_category.items())
            }


# process-wide ledger (one device per process in this deployment shape)
hbm_ledger = HbmLedger()

