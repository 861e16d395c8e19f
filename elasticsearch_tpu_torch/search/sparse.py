"""Learned-sparse routing + observability for the `sparse_vector` path.

The decision layer between the DSL and the impact scorers
(ops/impact.py): an index picks its impact storage via
`index.sparse.quantization` (`int8` — the default, 4x smaller postings
with per-term symmetric scales — or `none` for full-fidelity fp32); a
request opts into the fp32 column regardless via a body-level
`"exact": true` (the same escape hatch the ANN tier honors). Pruning
is always the exact impact-ordered block-max pass — it never changes
the returned hits, only how many tiles get scored — so there is no
recall knob to resolve here; the only lossy choice is int8 storage,
and even that is held to a recall@10 ≥ 0.95 floor.

The dense host oracle (NumpyExecutor's term-at-a-time fp32 scorer)
stays: an injected `sparse.score` fault, an HBM budget that would not
hold the column, or a segment without the column take it, as in the
reference. Any other device failure reaches the caller.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass


@dataclass(frozen=True)
class SparseSpec:
    """Resolved per-request sparse serving parameters. Frozen/hashable
    so it can ride the batcher's group key (int8 and fp32 servings of
    the same field never share a launch) and key the executor's
    per-generation column cache."""

    quantized: bool


def resolve(settings, body_exact: bool) -> SparseSpec:
    """SparseSpec for one sparse_vector query under one index's
    settings. Unlike ANN there is no exact-vs-approximate fork in the
    *plan* — only the storage column changes."""
    quant = str(settings.get("sparse.quantization", "int8")) == "int8"
    if body_exact and quant:
        note("exact_searches")
        quant = False
    return SparseSpec(quantized=quant)


# ---------------------------------------------------------------------------
# observability: the `sparse` block of `_nodes/stats`
# ---------------------------------------------------------------------------

_STATS_LOCK = threading.Lock()
SPARSE_STATS = {
    "searches": 0,  # (job × segment) scorings served from impact tiles
    "quantized_searches": 0,  # of those, served from the int8 column
    "exact_searches": 0,  # body-level exact:true escape-hatch routings
    "fallbacks": 0,  # injected fault / budget degrade → host dense oracle
    "tiles_scored": 0,  # Σ tiles actually launched
    "tiles_pruned": 0,  # Σ tail tiles dropped by block-max bounds
    "pruned_searches": 0,  # scorings where at least one tile dropped
    # bytes of the impact VALUE planes actually uploaded vs what the
    # same planes would cost at fp32 — the int8 compression ratio (4x
    # per plane). The doc-id planes are identical in both modes and are
    # counted in `ledger_bytes` with the rest of the upload.
    "impact_bytes": 0,
    "impact_fp32_equivalent_bytes": 0,
}


def note(key: str, n: int = 1) -> None:
    with _STATS_LOCK:
        SPARSE_STATS[key] += n


def note_search(
    jobs: int, quantized: bool, tiles_scored: int, tiles_pruned: int
) -> None:
    """One impact-tile scoring of `jobs` queries against one segment."""
    with _STATS_LOCK:
        SPARSE_STATS["searches"] += jobs
        if quantized:
            SPARSE_STATS["quantized_searches"] += jobs
        SPARSE_STATS["tiles_scored"] += tiles_scored
        SPARSE_STATS["tiles_pruned"] += tiles_pruned
        if tiles_pruned:
            SPARSE_STATS["pruned_searches"] += jobs


def stats_snapshot() -> dict:
    """The `sparse` stats block (ledger bytes from the `impacts` device
    memory category joined in)."""
    from ..common.memory import hbm_ledger

    with _STATS_LOCK:
        out = dict(SPARSE_STATS)
    out["ledger_bytes"] = int(
        hbm_ledger.stats()["by_category"].get("impacts", 0)
    )
    return out


def reset_stats() -> None:
    """Test hook: zero the counters."""
    with _STATS_LOCK:
        for k in SPARSE_STATS:
            SPARSE_STATS[k] = 0
