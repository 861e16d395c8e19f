"""Coordinator-side merge of per-shard results.

Reference analog: SearchPhaseController.reducedQueryPhase /
QueryPhaseResultConsumer (server/.../action/search/) — merge-sort the
per-shard top-k by (score desc, shard asc, doc asc), sum totals, keep
max_score. The device-side equivalent for mesh-resident shards is the
all_gather merge in parallel/sharded.py; this host-side version serves
the engine/REST path where each shard produced a TopDocs via its
executor.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence

from .executor import Hit, TopDocs


@dataclass
class ShardHit:
    score: float
    shard: int
    segment: int
    local_doc: int
    doc_id: str


class _Rev:
    """Reverses comparison for desc string columns in merge keys."""

    __slots__ = ("v",)

    def __init__(self, v):
        self.v = v

    def __lt__(self, other):
        return other.v < self.v

    def __eq__(self, other):
        return other.v == self.v


def _col_key(value, spec):
    missing_rank = 1 if spec["missing"] == "_last" else -1
    if value is None or (isinstance(value, float) and value != value):
        return (missing_rank, 0)
    if spec["order"] == "desc":
        if isinstance(value, (int, float)):
            return (0, -value)
        return (0, _Rev(value))
    return (0, value)


def merge_sorted(
    shard_results: Sequence[Optional[TopDocs]],
    shard_sort_values: Sequence[Sequence[list]],
    sort_specs: Sequence[dict],
    from_: int,
    size: int,
) -> tuple:
    """Coordinator merge for field-sorted results: compare raw sort
    values per column with direction/missing applied (TopFieldDocs merge
    in SearchPhaseController). Returns (total, None, hits, hit_sorts).

    A ``None`` entry is a FAILED shard (the partial-results contract of
    the fault-tolerant fan-out): it contributes nothing, and surviving
    shards keep their original shard indices for tie-breaks so a
    degraded merge is the healthy merge minus the failed shards' hits."""
    total = sum(td.total for td in shard_results if td is not None)
    entries = []
    for si, td in enumerate(shard_results):
        if td is None:
            continue
        svals = shard_sort_values[si]
        for i, h in enumerate(td.hits):
            vals = svals[i] if i < len(svals) else []
            key = tuple(
                _col_key(v, spec) for v, spec in zip(vals, sort_specs)
            )
            entries.append((key, si, h.segment, h.local_doc, h, vals))
    entries.sort(key=lambda e: e[:4])
    page = entries[from_ : from_ + size]
    hits = [
        ShardHit(
            score=h.score,
            shard=si,
            segment=h.segment,
            local_doc=h.local_doc,
            doc_id=h.doc_id,
        )
        for _, si, _, _, h, _ in page
    ]
    hit_sorts = [vals for *_, vals in page]
    return total, None, hits, hit_sorts


def merge_top_docs(
    shard_results: Sequence[Optional[TopDocs]], from_: int = 0, size: int = 10
) -> tuple:
    """Returns (total, max_score, List[ShardHit]) for the global page.
    ``None`` entries are failed shards (see merge_sorted): skipped, with
    surviving shard indices preserved for the (score, shard, doc)
    tie-break ordering."""
    total = sum(td.total for td in shard_results if td is not None)
    max_score: Optional[float] = None
    entries: List[tuple] = []
    for si, td in enumerate(shard_results):
        if td is None:
            continue
        if td.max_score is not None:
            max_score = (
                td.max_score if max_score is None else max(max_score, td.max_score)
            )
        for h in td.hits:
            entries.append((-h.score, si, h.segment, h.local_doc, h))
    entries.sort(key=lambda e: e[:4])
    page = entries[from_ : from_ + size]
    hits = [
        ShardHit(
            score=h.score,
            shard=si,
            segment=h.segment,
            local_doc=h.local_doc,
            doc_id=h.doc_id,
        )
        for _, si, _, _, h in page
    ]
    return total, max_score, hits
