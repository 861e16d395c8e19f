"""The `rescore` search phase: second-stage late-interaction reranking.

Reference analogs: org.elasticsearch.search.rescore — RescorerBuilder /
QueryRescorer (the `rescore` body element: window_size, query_weight,
rescore_query_weight) — with the rescore query replaced by a
late-interaction `rank_vectors` scorer (models/rerank.py): the
production multi-stage ranking shape (cheap first stage feeding a
ColBERT-style maxsim reranker over the top-k).

Execution shape (the GPUSparse lesson): the first stage's fused top-k
candidates already live on device at merge time, so reranking rides the
QueryBatcher as its own `rerank` job family BETWEEN merge and fetch —
one maxsim kernel launch per group (ops/rerank.py), one packed download
— instead of a host round trip per candidate. Sources are fetched only
AFTER the window is re-sorted. The numpy host oracle (host_rescore_*)
serves the numpy backend and is the float reference every device result
is parity-tested against. Only an injected `rerank.score` fault, a
rerank column over the device-memory budget or ES_TPU_RERANK=off keep
the first-stage ranking; any other failure fails the request
(cluster/indices.py `_apply_rescore`).

DSL:

    "rescore": {
      "window_size": 50,
      "query": {
        "rescore_query": {"rank_vectors": {
            "field": "tok_emb", "query_vectors": [[...], ...]}},
        "query_weight": 1.0,
        "rescore_query_weight": 1.0
      }
    }

Window contract (QueryRescorer): the top `window_size` candidates are
re-sorted by `query_weight·first + rescore_query_weight·maxsim`
(ties keep first-stage order); candidates past the window keep their
first-stage score and order below the window.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np

from ..models import rerank as rerank_model
from . import dsl
from .executor import Hit, TopDocs


@dataclass(frozen=True)
class RescoreSpec:
    """Parsed `rescore` element. Frozen/hashable (vectors as tuples) so
    (spec, model) can ride batcher group keys."""

    field: str
    query_vectors: tuple  # tuple of tuples of float
    window_size: int
    query_weight: float = 1.0
    rescore_query_weight: float = 1.0


def parse_rescore(
    body: dict, validate_size: bool = True
) -> Optional[RescoreSpec]:
    """Parses (and request-scope validates) the body's `rescore`
    element; None when absent. `validate_size=False` skips the
    window-vs-page check — the shard re-parse sees the coordinator's
    collapsed size, so only the coordinator validates it."""
    raw = body.get("rescore")
    if raw is None:
        return None
    if isinstance(raw, list):
        if len(raw) != 1:
            raise dsl.QueryParseError(
                "[rescore] supports exactly one rescorer (this build)"
            )
        raw = raw[0]
    if not isinstance(raw, dict):
        raise dsl.QueryParseError("[rescore] malformed, expected an object")
    if validate_size and "sort" in body:
        raise dsl.QueryParseError(
            "Cannot use [sort] option in conjunction with [rescore]."
        )
    qblock = raw.get("query")
    if not isinstance(qblock, dict):
        raise dsl.QueryParseError("[rescore] requires a [query] element")
    rq = qblock.get("rescore_query")
    if not isinstance(rq, dict) or len(rq) != 1:
        raise dsl.QueryParseError(
            "[rescore] requires a [rescore_query]"
        )
    qname, params = next(iter(rq.items()))
    if qname != "rank_vectors":
        raise dsl.QueryParseError(
            f"[rescore] unsupported rescore_query [{qname}]: only "
            "[rank_vectors] late-interaction rescoring is supported "
            "(this build)"
        )
    if not isinstance(params, dict) or "field" not in params:
        raise dsl.QueryParseError("[rank_vectors] requires [field]")
    qv = params.get("query_vectors")
    if not isinstance(qv, list) or not qv:
        raise dsl.QueryParseError(
            "[rank_vectors] requires a non-empty [query_vectors] array"
        )
    rows = qv if isinstance(qv[0], (list, tuple)) else [qv]
    try:
        vecs = tuple(tuple(float(x) for x in row) for row in rows)
    except (TypeError, ValueError):
        raise dsl.QueryParseError(
            "[rank_vectors] query_vectors must be numeric vectors"
        )
    if len({len(r) for r in vecs}) != 1:
        raise dsl.QueryParseError(
            "[rank_vectors] query_vectors rows must share one dimension"
        )
    try:
        window = int(raw.get("window_size", 10))
    except (TypeError, ValueError):
        raise dsl.QueryParseError(
            f"[rescore] failed to parse [window_size]: "
            f"{raw.get('window_size')!r}"
        )
    if window < 1:
        raise dsl.QueryParseError(
            f"[rescore] [window_size] must be greater than 0, got "
            f"[{window}]"
        )
    if validate_size:
        size = int(body.get("size", 10))
        from_ = int(body.get("from", 0))
        if window < size + from_:
            # KnnSearchBuilder-style request-scoped 400: a window
            # smaller than the page would silently leave page hits
            # un-rescored
            raise dsl.QueryParseError(
                f"[rescore] [window_size] must be at least the request "
                f"page (from + size = {size + from_}), got [{window}]"
            )
    try:
        qw = float(qblock.get("query_weight", 1.0))
        rw = float(qblock.get("rescore_query_weight", 1.0))
    except (TypeError, ValueError):
        raise dsl.QueryParseError(
            "[rescore] failed to parse rescore weights"
        )
    return RescoreSpec(
        field=str(params["field"]),
        query_vectors=vecs,
        window_size=window,
        query_weight=qw,
        rescore_query_weight=rw,
    )


# ---------------------------------------------------------------------------
# batcher plan (the `rerank` job family's payload)
# ---------------------------------------------------------------------------


class RerankPlan:
    """One request's rerank job: the prepared query-token matrix plus
    the first-stage candidates (global doc encoding over the shard's
    concatenated `rank_vectors` column). `sig` groups jobs that can
    share a maxsim launch: same model, same padded shapes, same blend
    weights and static window."""

    __slots__ = (
        "model", "spec", "qtoks", "first", "gdocs", "wb", "qb",
        "win_static", "sig", "field",
    )

    def __init__(self, model, spec: RescoreSpec, qtoks: np.ndarray,
                 first: np.ndarray, gdocs: np.ndarray):
        from ..ops import scoring

        self.model = model
        self.spec = spec
        self.qtoks = qtoks  # f32 [Qt, d] (prepared/normalized)
        self.first = first  # f32 [W_real] first-stage scores (desc)
        self.gdocs = gdocs  # i64 [W_real] global (segment-base + doc)
        self.field = model.field
        self.wb = max(16, scoring.next_bucket(max(len(first), 1), 16))
        self.qb = max(4, scoring.next_bucket(max(len(qtoks), 1), 4))
        self.win_static = min(int(spec.window_size), self.wb)
        self.sig = (
            model, self.wb, self.qb, self.win_static,
            float(spec.query_weight), float(spec.rescore_query_weight),
        )


def build_plan(reader, model, spec: RescoreSpec, cands) -> RerankPlan:
    """cands: [(score, segment, local_doc)] in first-stage order (score
    desc, (segment, doc) asc). Encodes (segment, doc) as global doc ids
    over the shard-level concatenated rerank column (segment bases are
    cumulative segment sizes — the same encoding rerank_column uses)."""
    bases = np.zeros(len(reader.segments) + 1, np.int64)
    np.cumsum([s.num_docs for s in reader.segments], out=bases[1:])
    qtoks = rerank_model.prepare_query_vectors(
        spec.query_vectors, model.dims, model.similarity
    )
    first = np.asarray([c[0] for c in cands], np.float32)
    gdocs = np.asarray(
        [bases[c[1]] + c[2] for c in cands], np.int64
    )
    return RerankPlan(model, spec, qtoks, first, gdocs)


def apply_perm_to_topdocs(
    td: TopDocs, scores: np.ndarray, perm: np.ndarray
) -> TopDocs:
    """Rebuilds a TopDocs from the rerank result: `perm[i]` is the
    first-stage rank now sitting at position i, `scores[i]` its blended
    (or retained first-stage) score."""
    hits: List[Hit] = []
    for s, p in zip(scores, perm):
        if not np.isfinite(s):
            break
        h = td.hits[int(p)]
        hits.append(
            Hit(score=float(s), segment=h.segment,
                local_doc=h.local_doc, doc_id=h.doc_id)
        )
    return TopDocs(
        total=td.total,
        hits=hits,
        max_score=hits[0].score if hits else None,
        relation=td.relation,
    )


# ---------------------------------------------------------------------------
# host float oracle application (numpy backend + parity reference)
# ---------------------------------------------------------------------------


def host_blend(
    reader, model, spec: RescoreSpec, cands
) -> Tuple[np.ndarray, np.ndarray]:
    """(scores, perm) for first-stage candidates [(score, segment,
    doc)], numpy float path — the reference the device kernel is
    parity-tested against. Same window/ordering contract."""
    qtoks = rerank_model.prepare_query_vectors(
        spec.query_vectors, model.dims, model.similarity
    )
    n = len(cands)
    w = min(int(spec.window_size), n)
    blended = np.empty(w, np.float64)
    for i, (score, si, doc) in enumerate(cands[:w]):
        mvf = reader.segments[si].multi_vectors.get(model.field)
        if mvf is None:
            msim = 0.0
        else:
            s0 = int(mvf.tok_offsets[doc])
            s1 = int(mvf.tok_offsets[doc + 1])
            msim = rerank_model.host_maxsim(qtoks, mvf.tok_vectors[s0:s1])
        blended[i] = (
            np.float32(spec.query_weight) * np.float32(score)
            + np.float32(spec.rescore_query_weight) * np.float32(msim)
        )
    order = sorted(range(w), key=lambda i: (-blended[i], i))
    perm = np.asarray(order + list(range(w, n)), np.int32)
    scores = np.concatenate(
        [
            blended[order].astype(np.float32),
            np.asarray([c[0] for c in cands[w:]], np.float32),
        ]
    )
    return scores, perm


def host_rescore_topdocs(reader, model, spec: RescoreSpec,
                         td: TopDocs) -> TopDocs:
    """Applies the host-oracle rescore to one shard's TopDocs."""
    cands = [(h.score, h.segment, h.local_doc) for h in td.hits]
    scores, perm = host_blend(reader, model, spec, cands)
    rerank_model.note_rescore(min(spec.window_size, len(cands)),
                              device=False)
    return apply_perm_to_topdocs(td, scores, perm)
