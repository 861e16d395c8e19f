"""ANN (IVF) routing + observability for the vector serving path.

The decision layer between the DSL and the kernels: an index opts into
IVF via `index.knn.type: ivf` (with `index.knn.nlist` / default
`index.knn.nprobe` knobs and the existing `index.knn.quantization`
selector for the int8 twin); a request opts back OUT via `?exact=true`
(or a body-level `"exact": true`), and each `knn` section may override
`nprobe`. Segments below the small-segment floor
(`ES_TPU_ANN_MIN_DOCS`, default 4096) always score exact, so
correctness never depends on cluster quality for tiny segments.

The exact brute-force path is the float oracle and is never removed:
every ANN failure (injected `ann.probe` fault, HBM budget breach,
missing index) deterministically falls back to it.
"""

from __future__ import annotations

import os
import threading
from dataclasses import dataclass
from typing import List, Optional

ANN_MIN_DOCS_ENV = "ES_TPU_ANN_MIN_DOCS"
ANN_MIN_DOCS_DEFAULT = 4096
DEFAULT_NPROBE = 8


def ann_min_docs() -> int:
    """Small-segment exact floor (read per call so tests can lower it)."""
    raw = os.environ.get(ANN_MIN_DOCS_ENV, "")
    try:
        v = int(raw) if raw else ANN_MIN_DOCS_DEFAULT
    except ValueError:
        v = ANN_MIN_DOCS_DEFAULT
    return max(0, v)


@dataclass(frozen=True)
class AnnSpec:
    """Resolved per-request ANN parameters. Frozen/hashable so it can
    ride the batcher's kNN group key (jobs with different probe widths
    or build shapes never share a launch) and key the executor's
    per-generation index cache."""

    nlist: int  # 0 = auto (~sqrt N per segment)
    nprobe: int
    quantized: bool
    min_docs: int


def resolve(settings, sec, body_exact: bool) -> Optional[AnnSpec]:
    """AnnSpec for one knn section under one index's settings, or None
    for the exact path. `settings` is the index's flat settings dict."""
    if str(settings.get("knn.type", "exact")) != "ivf":
        return None
    if body_exact:
        note("exact_searches")
        return None
    nprobe = sec.nprobe
    if nprobe is None:
        try:
            nprobe = int(settings.get("knn.nprobe", DEFAULT_NPROBE))
        except (TypeError, ValueError):
            nprobe = DEFAULT_NPROBE
    try:
        nlist = int(settings.get("knn.nlist", 0))
    except (TypeError, ValueError):
        nlist = 0
    quant = str(settings.get("knn.quantization", "none")) == "int8"
    return AnnSpec(
        nlist=max(0, nlist),
        nprobe=max(1, int(nprobe)),
        quantized=quant,
        min_docs=ann_min_docs(),
    )


def annotate(secs: List, settings, body: Optional[dict]) -> None:
    """Resolves + attaches the AnnSpec to each parsed KnnSection (the
    `ann` field the executors and plan extractors consult)."""
    body_exact = bool((body or {}).get("exact"))
    for sec in secs or []:
        sec.ann = resolve(settings, sec, body_exact)


# ---------------------------------------------------------------------------
# observability: the `knn.ann` block of `_nodes/stats`
# ---------------------------------------------------------------------------

_STATS_LOCK = threading.Lock()
ANN_STATS = {
    "ann_searches": 0,  # (job × segment) scorings served by IVF probes
    "exact_searches": 0,  # ?exact=true escape-hatch routings
    "small_segment_exact": 0,  # under-floor segments served exact
    "exact_fallbacks": 0,  # probe-path failures → brute force
    "probes": 0,  # Σ nprobe over ann_searches
    "clusters_scanned": 0,  # Σ probed clusters (== probes, capped at nlist)
    "clusters_total": 0,  # Σ nlist over ann_searches
    "builds": 0,  # k-means index builds
    "build_ms": 0.0,  # Σ build wall time
}


def note(key: str, n: int = 1) -> None:
    with _STATS_LOCK:
        ANN_STATS[key] += n


def note_search(nprobe: int, nlist: int, jobs: int = 1) -> None:
    """One probed scoring of `jobs` queries against one segment."""
    scanned = min(nprobe, nlist)
    with _STATS_LOCK:
        ANN_STATS["ann_searches"] += jobs
        ANN_STATS["probes"] += nprobe * jobs
        ANN_STATS["clusters_scanned"] += scanned * jobs
        ANN_STATS["clusters_total"] += nlist * jobs



def note_build(build_ms: float) -> None:
    with _STATS_LOCK:
        ANN_STATS["builds"] += 1
        ANN_STATS["build_ms"] += build_ms


def stats_snapshot() -> dict:
    """The `knn.ann` stats block (ledger bytes from the `ann` HBM
    category joined in)."""
    from ..common.memory import hbm_ledger

    with _STATS_LOCK:
        out = dict(ANN_STATS)
    out["build_ms"] = round(out["build_ms"], 2)
    out["ledger_bytes"] = int(
        hbm_ledger.stats()["by_category"].get("ann", 0)
    )
    return out


def reset_stats() -> None:
    """Test hook: zero the counters."""
    with _STATS_LOCK:
        for k in ANN_STATS:
            ANN_STATS[k] = 0 if k != "build_ms" else 0.0
