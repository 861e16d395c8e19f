"""Late-interaction reranker registry + the host float oracle.

The second-stage model of the multi-stage ranking shape (PAPERS.md:
"Integrating Neural Reranking Models in Multi-Stage Ranking
Architectures"): a ColBERT-style maxsim scorer over per-doc
token-embedding matrices stored in the index as a `rank_vectors`
mapped field (index/mapping.py, index/segment.MultiVectorField).

    maxsim(Q, D) = Σ_q max_t  q · d_t

The registry resolves one frozen `RerankModel` per (index, field) from
the mappings + index settings (`index.rerank.quantization: int8`
mirrors the kNN int8 path: per-token symmetric scales, 4x less HBM per
gather). The device kernels live in ops/rerank.py and the wiring in
search/rescorer.py; `host_maxsim` below is the numpy float oracle every
device result is parity-tested against, and the scorer the numpy
backend serves rescore requests with.

Stats here back the `rescore` block of `_nodes/stats` (device/host/
skipped/fallback counters, kernel wall time, a window-size histogram,
and the `rerank` HBM ledger bytes).
"""

from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Optional

import numpy as np

from ..index.mapping import RANK_VECTORS


@dataclass(frozen=True)
class RerankModel:
    """Resolved per-(index, field) late-interaction reranker. Frozen/
    hashable so it can ride batcher group keys and the executor's
    per-generation rerank-column cache."""

    field: str
    dims: int
    similarity: str  # dot_product | cosine (rows unit-normalized at build)
    quantized: bool


def resolve_model(mappings, settings, field: str) -> Optional[RerankModel]:
    """RerankModel for one rank_vectors field under one index's
    settings, or None when the field is absent / not rank_vectors."""
    mf = mappings.get(field)
    if mf is None or mf.type != RANK_VECTORS:
        return None
    quant = str(settings.get("rerank.quantization", "none")) == "int8"
    return RerankModel(
        field=field,
        dims=int(mf.dims),
        similarity=mf.similarity,
        quantized=quant,
    )


# ---------------------------------------------------------------------------
# host float oracle (the exact reference; also the numpy-backend scorer)
# ---------------------------------------------------------------------------


def host_maxsim(
    query_vecs: np.ndarray,  # f32 [Qt, d]
    doc_toks: np.ndarray,  # f32 [T, d] (unit rows for cosine fields)
) -> float:
    """Σ_q max_t q·d_t — 0.0 for docs without tokens (a candidate
    missing the rank_vectors field contributes nothing, so its blended
    score reduces to query_weight · first_stage)."""
    if doc_toks.shape[0] == 0:
        return 0.0
    dots = query_vecs.astype(np.float32) @ doc_toks.astype(np.float32).T
    return float(dots.max(axis=1).sum())


def host_maxsim_quantized(
    query_vecs: np.ndarray,  # f32 [Qt, d]
    doc_toks_q: np.ndarray,  # int8 [T, d]
    scales: np.ndarray,  # f32 [T]
) -> float:
    """The int8 twin's oracle: the same (q · v_int8) · scale float path
    the device kernel takes (ops/rerank), so int8 parity is testable."""
    if doc_toks_q.shape[0] == 0:
        return 0.0
    dots = (
        query_vecs.astype(np.float32) @ doc_toks_q.astype(np.float32).T
    ) * scales.astype(np.float32)[None, :]
    return float(dots.max(axis=1).sum())


def prepare_query_vectors(
    query_vectors, dims: int, similarity: str
) -> np.ndarray:
    """f32 [Qt, d] query-token matrix; cosine models normalize query
    rows exactly like the stored doc rows (maxsim over unit rows)."""
    q = np.asarray(query_vectors, np.float32)
    if q.ndim != 2 or q.shape[1] != dims:
        from ..search.dsl import QueryParseError

        raise QueryParseError(
            f"[rescore] query_vectors must be [n_tokens, {dims}] "
            f"(got shape {tuple(q.shape)})"
        )
    if similarity == "cosine":
        norms = np.linalg.norm(q, axis=1, keepdims=True)
        q = q / np.where(norms == 0, 1.0, norms)
    return q


def quantize_tokens(toks: np.ndarray):
    """Symmetric per-token-vector int8 (the ops/ivf scheme verbatim):
    (int8 rows, f32 scales)."""
    vf32 = toks.astype(np.float32)
    maxabs = np.abs(vf32).max(axis=1) if len(vf32) else np.zeros(0)
    scales = (maxabs / 127.0).astype(np.float32)
    safe = np.where(scales == 0, 1.0, scales)
    qv = np.rint(vf32 / safe[:, None]).clip(-127, 127).astype(np.int8)
    return qv, scales


# ---------------------------------------------------------------------------
# observability: the `rescore` block of `_nodes/stats`
# ---------------------------------------------------------------------------

_STATS_LOCK = threading.Lock()
RESCORE_STATS = {
    "device_rescores": 0,  # requests reranked by the maxsim kernel
    "host_rescores": 0,  # requests reranked by the host oracle
    "skipped": 0,  # degrade-to-skip (HBM) / missing column / mode off
    "fallbacks": 0,  # rerank-path failures → first-stage ranking
    "kernel_ms": 0.0,  # Σ maxsim kernel wall time (dispatch+collect)
    "windows": {},  # window-size histogram (post-clamp, str keys)
}


def note(key: str, n: int = 1) -> None:
    with _STATS_LOCK:
        RESCORE_STATS[key] += n


def note_rescore(window: int, device: bool, kernel_ms: float = 0.0) -> None:
    with _STATS_LOCK:
        RESCORE_STATS["device_rescores" if device else "host_rescores"] += 1
        RESCORE_STATS["kernel_ms"] += kernel_ms
        w = str(int(window))
        RESCORE_STATS["windows"][w] = RESCORE_STATS["windows"].get(w, 0) + 1


def stats_snapshot() -> dict:
    """The `rescore` stats block (`rerank` HBM ledger bytes joined in)."""
    from ..common.memory import hbm_ledger

    with _STATS_LOCK:
        out = {k: (dict(v) if isinstance(v, dict) else v)
               for k, v in RESCORE_STATS.items()}
    out["kernel_ms"] = round(out["kernel_ms"], 2)
    out["ledger_bytes"] = int(
        hbm_ledger.stats()["by_category"].get("rerank", 0)
    )
    return out


def reset_stats() -> None:
    """Test hook: zero the counters."""
    with _STATS_LOCK:
        for k in RESCORE_STATS:
            if k == "windows":
                RESCORE_STATS[k] = {}
            elif k == "kernel_ms":
                RESCORE_STATS[k] = 0.0
            else:
                RESCORE_STATS[k] = 0
