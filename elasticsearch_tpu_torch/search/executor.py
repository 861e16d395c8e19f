"""Shard-level query execution — NumPy oracle executor.

Reference analog: the QueryPhase hot path — SearchService.executeQueryPhase
→ QueryPhase.execute → ContextIndexSearcher.search with Lucene
Weight/Scorer iterators (server/.../search/query/QueryPhase.java).

Execution model (TPU-native, shared by this oracle and the JAX executor in
ops/): every query node evaluates to a dense pair over a segment's docs —
(match_mask: bool[N], scores: float32[N]) — composed with elementwise
AND/OR/sum instead of Lucene's doc-at-a-time iterator trees. The NumPy
version is the *semantics oracle*: the JAX/Pallas path must match it
exactly (tests enforce parity), and it doubles as the measured CPU
baseline for BASELINE.md.

Lucene semantics honored here:
  - shard-level term statistics (df, ttf summed across segments, deletes
    ignored) feed idf/avgdl — as IndexSearcher collectionStatistics does;
  - fields with omitted norms (keyword) score with encodedNorm == 1;
  - bool minimum_should_match defaults: 1 when no must/filter, else 0;
  - top-k ordering is (score desc, global doc asc), global doc order =
    segment order × local doc id (Lucene docBase);
  - match_phrase is evaluated as a conjunction then position-verified
    against re-analyzed stored source (positions are not yet columnar;
    see ROADMAP).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..analysis import AnalysisRegistry
from ..index.mapping import (
    DENSE_VECTOR,
    KEYWORD,
    TEXT,
    DATE,
    BOOLEAN,
    Mappings,
    parse_date_millis,
)
from ..index.segment import Segment
from ..models import bm25
from ..models.similarity import score_vectors
from . import dsl
from .dsl import (
    BoolQuery,
    ConstantScoreQuery,
    ExistsQuery,
    KnnQueryWrapper,
    KnnSection,
    MatchAllQuery,
    MatchNoneQuery,
    MatchPhraseQuery,
    MatchQuery,
    MultiMatchQuery,
    Query,
    QueryParseError,
    RangeQuery,
    TermQuery,
    TermsQuery,
)


@dataclass
class Hit:
    score: float
    segment: int
    local_doc: int
    doc_id: str


@dataclass
class TopDocs:
    total: int
    hits: List[Hit]
    max_score: Optional[float] = None
    # Lucene TotalHits.Relation: "eq" when total is exact, "gte" when a
    # pruned collection proved at least `total` matches (WANDScorer under
    # totalHitsThreshold)
    relation: str = "eq"


class ShardReader:
    """A point-in-time view over a shard's segments (ReaderContext analog)."""

    def __init__(
        self,
        segments: List[Segment],
        mappings: Mappings,
        analysis: AnalysisRegistry,
        live_docs: Optional[List[Optional[np.ndarray]]] = None,
    ):
        self.segments = segments
        self.mappings = mappings
        self.analysis = analysis
        self.live_docs = live_docs or [None] * len(segments)

    # ---- shard-level statistics (IndexSearcher.collectionStatistics) ----

    def field_stats(self, field: str) -> Tuple[int, int]:
        """(doc_count, sum_total_term_freq) across segments."""
        dc = 0
        ttf = 0
        for seg in self.segments:
            pf = seg.postings.get(field)
            if pf is not None:
                dc += pf.stats.doc_count
                ttf += pf.stats.sum_total_term_freq
        return dc, ttf

    def term_stats(self, field: str, term: str) -> Tuple[int, int]:
        """(doc_freq, total_term_freq) across segments (deletes ignored,
        as Lucene does)."""
        df = 0
        ttf = 0
        for seg in self.segments:
            pf = seg.postings.get(field)
            if pf is None:
                continue
            tid = pf.term_id(term)
            if tid >= 0:
                df += int(pf.term_df[tid])
                ttf += int(pf.term_total_tf[tid])
        return df, ttf

    def num_docs(self) -> int:
        return sum(s.num_docs for s in self.segments)


import contextvars

# global term statistics for the CURRENT request in DFS mode:
# {"fields": {field: [doc_count, sum_ttf]},
#  "terms": {field: {term: doc_freq}}}
DFS_STATS: contextvars.ContextVar = contextvars.ContextVar(
    "dfs_stats", default=None
)

# per-request device-array cache for DFS norm uploads (kept OUT of the
# DFS stats dict, which rides the wire as JSON)
DFS_NORM_CACHE: contextvars.ContextVar = contextvars.ContextVar(
    "dfs_norm_cache", default=None
)

# "profile": true phase accounting for the CURRENT request: executors
# add device_scoring_ns / device_transfer_ns / host_merge_ns entries
# (the per-kernel breakdown SURVEY §5 asks profile=true to return)
PROFILE_CTX: contextvars.ContextVar = contextvars.ContextVar(
    "profile_ctx", default=None
)


class NumpyExecutor:
    """The oracle: executes a query tree densely per segment."""

    def __init__(self, reader: ShardReader, k1: float = bm25.DEFAULT_K1, b: float = bm25.DEFAULT_B):
        self.reader = reader
        self.k1 = k1
        self.b = b
        self._weight_cache: Dict[Tuple[str, str], float] = {}
        self._norm_cache: Dict[str, np.ndarray] = {}
        # filter-bitset cache identity; None (executors constructed
        # outside IndexService) disables the node-level cache
        self.cache_ctx = None
        self._seg_index = {id(s): i for i, s in enumerate(reader.segments)}

    # ---- filter-context evaluation via the node-level bitset cache ----

    def filter_mask(self, q: Query, seg: Segment) -> np.ndarray:
        """Match mask of one filter-context clause on one segment,
        reusing the node-level bitset cache (LRUQueryCache analog; host
        entries are np.packbits bitmaps). Falls back to direct
        evaluation when uncached/uncacheable — bit-identical either way
        (filter context ignores scores)."""
        ctx = self.cache_ctx
        if ctx is None or not dsl.is_cacheable_filter(q):
            return self._exec(q, seg)[0]
        from .query_cache import filter_cache

        si = self._seg_index.get(id(seg))
        if si is None:
            return self._exec(q, seg)[0]
        fkey = dsl.canonical_key(q)
        packed = filter_cache.get(ctx, si, fkey)
        if packed is not None:
            return np.unpackbits(packed, count=seg.num_docs).astype(bool)
        mask = self._exec(q, seg)[0]
        bits = np.packbits(mask.astype(np.uint8))
        filter_cache.put(ctx, si, fkey, bits, int(bits.nbytes))
        return mask

    # ---- term weight / norm cache (BM25Similarity.scorer) ----
    #
    # DFS mode (search_type=dfs_query_then_fetch): the coordinator's
    # aggregated cross-shard statistics ride a request-scoped context
    # variable (DFS_STATS) and override the shard-local stats WITHOUT
    # touching the per-executor caches (SearchPhaseController
    # .aggregateDfs feeding Weight creation, SURVEY §2.1 DFS row).

    def _field_cache(self, field: str) -> np.ndarray:
        dfs = DFS_STATS.get()
        if dfs is not None and field in dfs.get("fields", {}):
            dc, ttf = dfs["fields"][field]
            avgdl = bm25.avg_field_length(ttf, dc)
            return bm25.norm_inverse_cache(avgdl, self.k1, self.b)
        cache = self._norm_cache.get(field)
        if cache is None:
            dc, ttf = self.reader.field_stats(field)
            avgdl = bm25.avg_field_length(ttf, dc)
            cache = bm25.norm_inverse_cache(avgdl, self.k1, self.b)
            self._norm_cache[field] = cache
        return cache

    def _term_weight(self, field: str, term: str) -> float:
        dfs = DFS_STATS.get()
        if dfs is not None and field in dfs.get("fields", {}):
            df = dfs.get("terms", {}).get(field, {}).get(term)
            if df is not None:
                dc, _ = dfs["fields"][field]
                return float(bm25.idf(dc, df)) if df > 0 else 0.0
            # a term the DFS walker missed (analyzer edge) falls back to
            # shard-local stats rather than silently scoring 0
        key = (field, term)
        w = self._weight_cache.get(key)
        if w is None:
            df, _ = self.reader.term_stats(field, term)
            dc, _ = self.reader.field_stats(field)
            w = float(bm25.idf(dc, df)) if df > 0 else 0.0
            self._weight_cache[key] = w
        return w

    # ---- entry point ----

    def search(
        self,
        query: Optional[Query],
        size: int = 10,
        from_: int = 0,
        knn: Optional[List[KnnSection]] = None,
        min_score: Optional[float] = None,
    ) -> TopDocs:
        return self.execute(query, size, from_, knn, min_score)[0]

    def execute(
        self,
        query: Optional[Query],
        size: int = 10,
        from_: int = 0,
        knn: Optional[List[KnnSection]] = None,
        min_score: Optional[float] = None,
    ) -> Tuple[TopDocs, List[np.ndarray]]:
        """(TopDocs, per-segment match masks) — masks feed the agg phase
        so query execution isn't paid twice."""
        # knn sections: per-segment candidates, then a *global* top-k cut
        # across segments (SearchPhaseController.mergeKnnResults semantics)
        knn_sets = [self._knn_topk_global(sec) for sec in (knn or [])]
        per_segment: List[Tuple[np.ndarray, np.ndarray]] = []
        for si, seg in enumerate(self.reader.segments):
            mask, scores = self._execute_root(query, knn_sets, si, seg)
            live = self.reader.live_docs[si]
            if live is not None:
                mask = mask & live
            if min_score is not None:
                mask = mask & (scores >= min_score)
            per_segment.append((mask, scores))

        total = int(sum(m.sum() for m, _ in per_segment))
        # global collection: (score desc, global doc asc)
        all_scores = []
        all_keys = []
        for si, (mask, scores) in enumerate(per_segment):
            idx = np.nonzero(mask)[0]
            all_scores.append(scores[idx])
            all_keys.append([(si, int(i)) for i in idx])
        if all_scores:
            flat_scores = np.concatenate(all_scores)
        else:
            flat_scores = np.zeros(0, np.float32)
        flat_keys = [k for ks in all_keys for k in ks]
        order = sorted(
            range(len(flat_keys)), key=lambda i: (-float(flat_scores[i]), flat_keys[i])
        )
        top = order[from_ : from_ + size]
        hits = [
            Hit(
                score=float(flat_scores[i]),
                segment=flat_keys[i][0],
                local_doc=flat_keys[i][1],
                doc_id=self.reader.segments[flat_keys[i][0]].doc_ids[flat_keys[i][1]],
            )
            for i in top
        ]
        max_score = float(flat_scores.max()) if len(flat_scores) else None
        return (
            TopDocs(total=total, hits=hits, max_score=max_score),
            [m for m, _ in per_segment],
        )

    def execute_sorted(
        self,
        query: Optional[Query],
        sort_specs: List[dict],
        size: int = 10,
        from_: int = 0,
        knn: Optional[List[KnnSection]] = None,
        min_score: Optional[float] = None,
        search_after: Optional[List] = None,
    ) -> Tuple[TopDocs, List[np.ndarray], List[List]]:
        """Field-sorted collection (FieldSortBuilder / SortField analog).

        Returns (TopDocs, masks, sort_values per hit). Sort keys: field
        doc values (numeric/date/boolean/keyword), _score, _doc; missing
        values follow the `missing` policy (_last default)."""
        knn_sets = [self._knn_topk_global(sec) for sec in (knn or [])]
        per_segment = []
        for si, seg in enumerate(self.reader.segments):
            mask, scores = self._execute_root(query, knn_sets, si, seg)
            live = self.reader.live_docs[si]
            if live is not None:
                mask = mask & live
            if min_score is not None:
                mask = mask & (scores >= min_score)
            per_segment.append((mask, scores))
        total = int(sum(m.sum() for m, _ in per_segment))

        cand_rows: List[np.ndarray] = []  # per key: concatenated arrays
        seg_idx: List[np.ndarray] = []
        doc_idx: List[np.ndarray] = []
        score_arr: List[np.ndarray] = []
        key_cols: List[List[np.ndarray]] = [[] for _ in sort_specs]
        raw_cols: List[List[np.ndarray]] = [[] for _ in sort_specs]
        doc_base = 0
        for si, (mask, scores) in enumerate(per_segment):
            seg = self.reader.segments[si]
            seg_base, doc_base = doc_base, doc_base + seg.num_docs
            idx = np.nonzero(mask)[0]
            if not len(idx):
                continue
            seg_idx.append(np.full(len(idx), si))
            doc_idx.append(idx)
            score_arr.append(scores[idx])
            for ki, spec in enumerate(sort_specs):
                sort_key, raw = _sort_key_values(
                    spec, seg, idx, scores[idx], self.reader.mappings, seg_base
                )
                if sort_key is None:  # string column: rank globally below
                    sort_key = np.zeros(0)
                key_cols[ki].append(sort_key)
                raw_cols[ki].append(raw)
        if not seg_idx:
            return TopDocs(total=total, hits=[], max_score=None), [
                m for m, _ in per_segment
            ], []
        segs = np.concatenate(seg_idx)
        docs = np.concatenate(doc_idx)
        scrs = np.concatenate(score_arr)
        raws = [np.concatenate(c) for c in raw_cols]
        keys = []
        after_keys = []
        for ki, spec in enumerate(sort_specs):
            cols = key_cols[ki]
            after_v = search_after[ki] if search_after is not None else None
            if any(len(c) == 0 for c in cols):
                key, ak = _rank_strings(raws[ki], spec, after_v)
            else:
                key = np.concatenate(cols)
                ak = _numeric_after_key(after_v, spec)
            keys.append(key)
            after_keys.append(ak)
        if search_after is not None:
            # keep only docs strictly after the cursor in key space
            # (SearchAfterBuilder: the cursor is the last hit's sort values)
            gt = np.zeros(len(segs), bool)
            eq = np.ones(len(segs), bool)
            for ki, ak in enumerate(after_keys):
                col = keys[ki]
                gt |= eq & (col > ak)
                eq &= col == ak
            mask_after = gt  # strictly greater (ties skipped, as ES does
            # when the tiebreak column is included in the sort)
            segs, docs, scrs = segs[mask_after], docs[mask_after], scrs[mask_after]
            keys = [k[mask_after] for k in keys]
            raws = [r[mask_after] for r in raws]
            if not len(segs):
                return (
                    TopDocs(total=total, hits=[], max_score=None),
                    [m for m, _ in per_segment],
                    [],
                )
        # lexsort: last key is primary → reverse; tiebreak (seg, doc)
        order = np.lexsort(tuple([docs, segs] + keys[::-1]))
        top = order[from_ : from_ + size]
        hits = [
            Hit(
                score=float(scrs[i]),
                segment=int(segs[i]),
                local_doc=int(docs[i]),
                doc_id=self.reader.segments[int(segs[i])].doc_ids[int(docs[i])],
            )
            for i in top
        ]
        sort_values = [[_to_jsonable(raws[ki][i]) for ki in range(len(sort_specs))] for i in top]
        return (
            TopDocs(total=total, hits=hits, max_score=None),
            [m for m, _ in per_segment],
            sort_values,
        )

    def _execute_root(
        self,
        query: Optional[Query],
        knn_sets: List[List[Tuple[np.ndarray, np.ndarray]]],
        si: int,
        seg: Segment,
    ) -> Tuple[np.ndarray, np.ndarray]:
        n = seg.num_docs
        if query is None and not knn_sets:
            query = MatchAllQuery()
        if query is not None:
            mask, scores = self._exec(query, seg)
        else:
            mask = np.zeros(n, dtype=bool)
            scores = np.zeros(n, dtype=np.float32)
        # knn winners become additional SHOULD-like exact doc/score sets
        # (KnnScoreDocQuery semantics: scores add where both match)
        for ks in knn_sets:
            kmask, kscores = ks[si]
            scores = np.where(kmask, scores + kscores, scores).astype(np.float32)
            mask = mask | kmask
        return mask, scores

    def _knn_topk_global(self, sec: KnnSection) -> List[Tuple[np.ndarray, np.ndarray]]:
        """Per-segment knn candidates cut to the global top-k of the shard:
        per segment keep num_candidates, then keep only the k best
        (score desc, global doc asc) across all segments."""
        per_seg = [
            self._exec_knn(sec, si, seg)
            for si, seg in enumerate(self.reader.segments)
        ]
        entries = []  # (score, si, doc)
        for si, (mask, scores) in enumerate(per_seg):
            for doc in np.nonzero(mask)[0]:
                entries.append((float(scores[doc]), si, int(doc)))
        entries.sort(key=lambda t: (-t[0], t[1], t[2]))
        keep = entries[: sec.k]
        out = []
        for si, (mask, scores) in enumerate(per_seg):
            new_mask = np.zeros_like(mask)
            for s, ksi, doc in keep:
                if ksi == si:
                    new_mask[doc] = True
            out.append((new_mask, scores))
        return out

    # ---- node dispatch ----

    def _exec(self, q: Query, seg: Segment) -> Tuple[np.ndarray, np.ndarray]:
        n = seg.num_docs
        if isinstance(q, MatchAllQuery):
            return np.ones(n, bool), np.full(n, np.float32(q.boost), np.float32)
        if isinstance(q, MatchNoneQuery):
            return np.zeros(n, bool), np.zeros(n, np.float32)
        if isinstance(q, MatchQuery):
            return self._exec_match(q, seg)
        if isinstance(q, MatchPhraseQuery):
            return self._exec_phrase(q, seg)
        if isinstance(q, TermQuery):
            return self._exec_term(q, seg)
        if isinstance(q, TermsQuery):
            return self._exec_terms(q, seg)
        if isinstance(q, RangeQuery):
            return self._exec_range(q, seg)
        if isinstance(q, ExistsQuery):
            return self._exec_exists(q, seg)
        if isinstance(q, BoolQuery):
            return self._exec_bool(q, seg)
        if isinstance(q, ConstantScoreQuery):
            m = self.filter_mask(q.filter_query, seg)
            return m, np.where(m, np.float32(q.boost), np.float32(0)).astype(np.float32)
        if isinstance(q, MultiMatchQuery):
            return self._exec_multi_match(q, seg)
        if isinstance(q, KnnQueryWrapper):
            si = self.reader.segments.index(seg)
            return self._exec_knn(q.knn, si, seg)
        if isinstance(q, dsl.SparseVectorQuery):
            return self._exec_sparse(q, seg)
        if isinstance(q, dsl.IdsQuery):
            return self._exec_ids(q, seg)
        if isinstance(q, (dsl.PrefixQuery, dsl.WildcardQuery, dsl.RegexpQuery)):
            return self._exec_pattern(q, seg)
        if isinstance(q, dsl.FuzzyQuery):
            return self._exec_fuzzy(q, seg)
        if isinstance(q, dsl.DisMaxQuery):
            return self._exec_dis_max(q, seg)
        if isinstance(q, dsl.BoostingQuery):
            return self._exec_boosting(q, seg)
        if isinstance(q, dsl.FunctionScoreQuery):
            return self._exec_function_score(q, seg)
        if isinstance(q, dsl.MatchPhrasePrefixQuery):
            return self._exec_match_phrase_prefix(q, seg)
        if isinstance(q, dsl.SpanTermQuery):
            return self._score_term_dense(seg, q.field, q.value, q.boost)
        if isinstance(q, dsl.SpanNearQuery):
            return self._exec_span_near(q, seg)
        if isinstance(q, dsl.MoreLikeThisQuery):
            return self._exec(self._rewrite_mlt(q), seg)
        if isinstance(q, dsl.GeoDistanceQuery):
            return self._exec_geo_distance(q, seg)
        if isinstance(q, dsl.GeoBoundingBoxQuery):
            return self._exec_geo_bbox(q, seg)
        if isinstance(q, dsl.NestedQuery):
            return self._exec_nested(q, seg)
        if isinstance(q, dsl.PercolateQuery):
            return self._exec_percolate(q, seg)
        if isinstance(q, dsl.ScriptScoreQuery):
            return self._exec_script_score(q, seg)
        if isinstance(q, dsl.ScriptQuery):
            return self._exec_script_query(q, seg)
        if isinstance(q, dsl.QueryStringQuery):
            return self._exec(rewrite_query_string(q, self.reader.mappings), seg)
        raise QueryParseError(f"unsupported query node [{type(q).__name__}]")

    # ---- expanded / compound leaves ----

    def _exec_ids(self, q: "dsl.IdsQuery", seg: Segment) -> Tuple[np.ndarray, np.ndarray]:
        n = seg.num_docs
        wanted = set(q.values)
        mask = np.fromiter(
            (d in wanted for d in seg.doc_ids), bool, count=n
        ) if n else np.zeros(0, bool)
        return mask, np.where(mask, np.float32(q.boost), 0).astype(np.float32)

    def _expand_terms(self, q, seg: Segment) -> List[str]:
        """MultiTermQuery rewrite: expand the pattern against the sorted
        term dictionary (constant-score rewrite, the ES default)."""
        import bisect
        import fnmatch
        import re as _re

        pf = seg.postings.get(q.field)
        if pf is None:
            return []
        terms = pf.terms
        value = q.value.lower() if q.case_insensitive else q.value
        if isinstance(q, dsl.PrefixQuery):
            if q.case_insensitive:
                return [t for t in terms if t.lower().startswith(value)]
            # scan forward from the insertion point: O(matches), and no
            # sentinel-character upper bound to miss astral-plane terms
            lo = bisect.bisect_left(terms, value)
            out = []
            for i in range(lo, len(terms)):
                if not terms[i].startswith(value):
                    break
                out.append(terms[i])
            return out
        if isinstance(q, dsl.WildcardQuery):
            rx = _re.compile(
                fnmatch.translate(value), _re.IGNORECASE if q.case_insensitive else 0
            )
            return [t for t in terms if rx.match(t)]
        # regexp: Lucene anchors the pattern to the whole term
        flags = _re.IGNORECASE if q.case_insensitive else 0
        try:
            rx = _re.compile(q.value, flags)
        except _re.error as e:
            raise QueryParseError(f"invalid regexp [{q.value}]: {e}")
        return [t for t in terms if rx.fullmatch(t)]

    def _exec_pattern(self, q, seg: Segment) -> Tuple[np.ndarray, np.ndarray]:
        n = seg.num_docs
        matched = self._expand_terms(q, seg)
        mask = np.zeros(n, bool)
        for t in matched:
            m, _ = self._score_term_dense(seg, q.field, t, 1.0)
            mask |= m
        return mask, np.where(mask, np.float32(q.boost), 0).astype(np.float32)

    def _fuzzy_terms(self, q: "dsl.FuzzyQuery", seg: Segment) -> List[str]:
        """FuzzyQuery expansion against the term dictionary (bounded by
        max_expansions, Lucene FuzzyTermsEnum semantics)."""
        pf = seg.postings.get(q.field)
        if pf is None:
            return []
        max_edits = _fuzziness_edits(q.fuzziness, q.value)
        prefix = q.value[: q.prefix_length]
        cands: List[str] = []
        for t in pf.terms:
            if abs(len(t) - len(q.value)) > max_edits:
                continue
            if prefix and not t.startswith(prefix):
                continue
            if _levenshtein_at_most(q.value, t, max_edits):
                cands.append(t)
                if len(cands) >= q.max_expansions:
                    break
        return cands

    def _exec_fuzzy(self, q: "dsl.FuzzyQuery", seg: Segment) -> Tuple[np.ndarray, np.ndarray]:
        n = seg.num_docs
        cands = self._fuzzy_terms(q, seg)
        mask = np.zeros(n, bool)
        for t in cands:
            m, _ = self._score_term_dense(seg, q.field, t, 1.0)
            mask |= m
        return mask, np.where(mask, np.float32(q.boost), 0).astype(np.float32)

    def _exec_dis_max(self, q: "dsl.DisMaxQuery", seg: Segment) -> Tuple[np.ndarray, np.ndarray]:
        n = seg.num_docs
        masks, scores = [], []
        for sub in q.queries:
            m, s = self._exec(sub, seg)
            masks.append(m)
            scores.append(np.where(m, s, 0))
        mask = np.any(masks, axis=0)
        mat = np.stack(scores)
        best = mat.max(axis=0)
        total = best + np.float32(q.tie_breaker) * (mat.sum(axis=0) - best)
        total = (total * np.float32(q.boost)).astype(np.float32)
        return mask, np.where(mask, total, 0).astype(np.float32)

    def _exec_boosting(self, q: "dsl.BoostingQuery", seg: Segment) -> Tuple[np.ndarray, np.ndarray]:
        pm, ps = self._exec(q.positive, seg)
        nm, _ = self._exec(q.negative, seg)
        scores = np.where(nm, ps * np.float32(q.negative_boost), ps)
        scores = (scores * np.float32(q.boost)).astype(np.float32)
        return pm, np.where(pm, scores, 0).astype(np.float32)

    def _exec_match_phrase_prefix(
        self, q: "dsl.MatchPhrasePrefixQuery", seg: Segment
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Phrase with the LAST term prefix-expanded (max_expansions);
        each expansion is position-verified like match_phrase; a doc's
        score is the best matching expansion's conjunction score."""
        n = seg.num_docs
        mf = self.reader.mappings.get(q.field)
        if mf is None or mf.type != TEXT:
            return np.zeros(n, bool), np.zeros(n, np.float32)
        analyzer_name = q.analyzer or mf.search_analyzer or mf.analyzer
        toks = self.reader.analysis.get(analyzer_name).analyze(q.query)
        terms = [t.text for t in toks]
        if not terms:
            return np.zeros(n, bool), np.zeros(n, np.float32)
        pf = seg.postings.get(q.field)
        if pf is None:
            return np.zeros(n, bool), np.zeros(n, np.float32)
        expansions = self._expand_terms(
            dsl.PrefixQuery(field=q.field, value=terms[-1]), seg
        )[: q.max_expansions]
        if not expansions:
            return np.zeros(n, bool), np.zeros(n, np.float32)
        qpos = [t.position for t in toks]
        rel = [p - qpos[0] for p in qpos]
        fixed = terms[:-1]
        total_mask = np.zeros(n, bool)
        total_scores = np.zeros(n, np.float32)
        for exp in expansions:
            full = fixed + [exp]
            conj = np.ones(n, bool)
            sc = np.zeros(n, np.float32)
            for t in full:
                m, s = self._score_term_dense(seg, q.field, t, q.boost)
                conj &= m
                sc = (sc + np.where(m, s, 0)).astype(np.float32)
            cand = np.nonzero(conj)[0]
            if not len(cand):
                continue
            vmask = np.zeros(n, bool)
            if len(full) == 1:
                vmask[cand] = True
            elif pf.has_positions:
                tids = [pf.term_id(t) for t in full]
                for doc in cand:
                    pos_of: Dict[str, List[int]] = {}
                    ok = True
                    for t, tid in zip(full, tids):
                        if t in pos_of:
                            continue
                        ps = (
                            pf.doc_positions(tid, int(doc))
                            if tid >= 0
                            else None
                        )
                        if ps is None:
                            ok = False
                            break
                        pos_of[t] = ps.tolist()
                    vmask[doc] = ok and _phrase_match(
                        pos_of, full, rel, q.slop
                    )
            else:
                # positionless segment: conjunction approximation
                vmask[cand] = True
            total_mask |= vmask
            total_scores = np.maximum(
                total_scores, np.where(vmask, sc, 0)
            ).astype(np.float32)
        return total_mask, np.where(total_mask, total_scores, 0).astype(
            np.float32
        )

    def _exec_span_near(
        self, q: "dsl.SpanNearQuery", seg: Segment
    ) -> Tuple[np.ndarray, np.ndarray]:
        """span_near over span_terms: a doc matches when one position
        per clause can be chosen whose total span fits within slop
        (in_order optionally enforces clause order). Scores sum the
        clause term scores (SpanWeight's simpler sloppy-freq scoring is
        approximated; documented)."""
        n = seg.num_docs
        field = q.clauses[0].field if q.clauses else ""
        pf = seg.postings.get(field)
        if pf is None or not pf.has_positions:
            return np.zeros(n, bool), np.zeros(n, np.float32)
        terms = [c.value for c in q.clauses]
        conj = np.ones(n, bool)
        sc = np.zeros(n, np.float32)
        for t in terms:
            m, s = self._score_term_dense(seg, field, t, q.boost)
            conj &= m
            sc = (sc + np.where(m, s, 0)).astype(np.float32)
        tids = [pf.term_id(t) for t in terms]
        if any(tid < 0 for tid in tids):
            return np.zeros(n, bool), np.zeros(n, np.float32)
        mask = np.zeros(n, bool)
        k = len(terms)
        for doc in np.nonzero(conj)[0]:
            plists = [pf.doc_positions(tid, int(doc)) for tid in tids]
            if any(p is None for p in plists):
                continue
            mask[doc] = _span_near_match(
                [p.tolist() for p in plists], q.slop, q.in_order, k
            )
        return mask, np.where(mask, sc, 0).astype(np.float32)

    def _rewrite_mlt(self, q: "dsl.MoreLikeThisQuery") -> "dsl.BoolQuery":
        """MLT → should-bool of the top tf-idf 'interesting' terms from
        the liked texts/docs (MoreLikeThisQuery.createQuery)."""
        fields = list(q.fields)
        if not fields:
            fields = [
                f.name
                for f in self.reader.mappings.fields.values()
                if f.type == TEXT and "." not in f.name
            ]
        tf: Dict[Tuple[str, str], int] = {}
        exclude_ids: List[str] = []
        for like in q.like:
            if isinstance(like, dict):
                doc_id = like.get("_id")
                if doc_id is None:
                    continue
                exclude_ids.append(str(doc_id))
                src = None
                for seg in self.reader.segments:
                    try:
                        loc = seg.doc_ids.index(str(doc_id))
                        src = seg.sources[loc]
                        break
                    except ValueError:
                        continue
                if src is None:
                    continue
                for f in fields:
                    for v in _extract_field(src, f):
                        self._mlt_count(f, str(v), tf)
            else:
                for f in fields:
                    self._mlt_count(f, str(like), tf)
        scored = []
        for (f, term), freq in tf.items():
            if freq < q.min_term_freq:
                continue
            df, _ = self.reader.term_stats(f, term)
            if df < q.min_doc_freq:
                continue
            dc, _ = self.reader.field_stats(f)
            idf = float(bm25.idf(dc, df)) if df > 0 else 0.0
            scored.append((freq * idf, f, term))
        scored.sort(key=lambda x: (-x[0], x[1], x[2]))
        should: List[dsl.Query] = [
            dsl.TermQuery(field=f, value=t)
            for _, f, t in scored[: q.max_query_terms]
        ]
        must_not: List[dsl.Query] = (
            [dsl.IdsQuery(values=exclude_ids)] if exclude_ids else []
        )
        return dsl.BoolQuery(
            should=should or [dsl.MatchNoneQuery()],
            must_not=must_not,
            minimum_should_match=q.minimum_should_match,
            boost=q.boost,
        )

    def _mlt_count(self, field: str, text: str, tf: Dict[Tuple[str, str], int]):
        for t in search_field_terms(
            self.reader.mappings, self.reader.analysis, field, text
        ):
            tf[(field, t)] = tf.get((field, t), 0) + 1

    def _geo_columns(self, seg: Segment, field: str):
        lat = seg.numerics.get(f"{field}.lat")
        lon = seg.numerics.get(f"{field}.lon")
        if lat is None or lon is None:
            n = seg.num_docs
            z = np.zeros(n)
            return z, z, np.zeros(n, bool)
        return lat.values, lon.values, lat.exists & lon.exists

    def _exec_geo_distance(
        self, q: "dsl.GeoDistanceQuery", seg: Segment
    ) -> Tuple[np.ndarray, np.ndarray]:
        lat, lon, have = self._geo_columns(seg, q.field)
        dist = _haversine_m(q.lat, q.lon, lat, lon)
        mask = have & (dist <= q.distance_m)
        return mask, np.where(mask, np.float32(q.boost), 0).astype(np.float32)

    def _exec_geo_bbox(
        self, q: "dsl.GeoBoundingBoxQuery", seg: Segment
    ) -> Tuple[np.ndarray, np.ndarray]:
        lat, lon, have = self._geo_columns(seg, q.field)
        lat_ok = (lat <= q.top) & (lat >= q.bottom)
        if q.left <= q.right:
            lon_ok = (lon >= q.left) & (lon <= q.right)
        else:  # dateline-crossing box
            lon_ok = (lon >= q.left) | (lon <= q.right)
        mask = have & lat_ok & lon_ok
        return mask, np.where(mask, np.float32(q.boost), 0).astype(np.float32)

    def _exec_nested(
        self, q: "dsl.NestedQuery", seg: Segment
    ) -> Tuple[np.ndarray, np.ndarray]:
        """nested: the inner query must hold within ONE object of the
        nested array (per-doc _source evaluation — the semantics the
        reference realizes with hidden child docs). Constant score."""
        n = seg.num_docs
        mask = np.zeros(n, bool)
        for d in range(n):
            src = seg.sources[d]
            if src is None:
                continue
            objs = _nested_objects(src, q.path)
            for obj in objs:
                if self._nested_obj_match(obj, q.query, q.path):
                    mask[d] = True
                    break
        return mask, np.where(mask, np.float32(q.boost), 0).astype(np.float32)

    def _nested_obj_match(self, obj: dict, spec: dict, path: str) -> bool:
        if not isinstance(spec, dict) or len(spec) != 1:
            raise QueryParseError("[nested] inner query malformed")
        kind, params = next(iter(spec.items()))

        def rel_value(field: str):
            rel = field[len(path) + 1:] if field.startswith(path + ".") else field
            node: Any = obj
            for part in rel.split("."):
                node = node.get(part) if isinstance(node, dict) else None
                if node is None:
                    return []
            return node if isinstance(node, list) else [node]

        def analyzed_terms(field: str, text: str) -> List[str]:
            return search_field_terms(
                self.reader.mappings, self.reader.analysis, field, text
            )

        if kind == "bool":
            musts = params.get("must", [])
            shoulds = params.get("should", [])
            must_nots = params.get("must_not", [])
            filters = params.get("filter", [])
            if any(
                not self._nested_obj_match(obj, c, path)
                for c in list(musts) + list(filters)
            ):
                return False
            if any(self._nested_obj_match(obj, c, path) for c in must_nots):
                return False
            if shoulds and not (musts or filters):
                return any(
                    self._nested_obj_match(obj, c, path) for c in shoulds
                )
            return True
        if kind in ("term", "match"):
            field, spec2 = next(iter(params.items()))
            want = (
                spec2.get("value" if kind == "term" else "query")
                if isinstance(spec2, dict)
                else spec2
            )
            vals = rel_value(field)
            if kind == "term":
                return any(str(v) == str(want) for v in vals)
            qterms = set(analyzed_terms(field, str(want)))
            for v in vals:
                if qterms & set(analyzed_terms(field, str(v))):
                    return True
            return False
        if kind == "terms":
            field, wants = next(iter(params.items()))
            vals = {str(v) for v in rel_value(field)}
            return any(str(w) in vals for w in wants)
        if kind == "range":
            field, cond = next(iter(params.items()))
            for v in rel_value(field):
                try:
                    x = float(v)
                except (TypeError, ValueError):
                    continue
                ok = True
                if "gte" in cond and not x >= float(cond["gte"]):
                    ok = False
                if "gt" in cond and not x > float(cond["gt"]):
                    ok = False
                if "lte" in cond and not x <= float(cond["lte"]):
                    ok = False
                if "lt" in cond and not x < float(cond["lt"]):
                    ok = False
                if ok:
                    return True
            return False
        if kind == "exists":
            return bool(rel_value(params.get("field", "")))
        raise QueryParseError(
            f"[nested] unsupported inner query [{kind}] (this build "
            "supports bool/term/match/terms/range/exists)"
        )

    def _exec_percolate(
        self, q: "dsl.PercolateQuery", seg: Segment
    ) -> Tuple[np.ndarray, np.ndarray]:
        """percolate: a stored-query doc matches when its query matches
        ANY of the provided documents. The candidate documents are
        indexed once into a scratch single-doc-per-entry reader (the
        percolator's MemoryIndex analog) and every stored query executes
        against it."""
        n = seg.num_docs
        mask = np.zeros(n, bool)
        doc_ex = getattr(q, "_doc_executor", None)
        if doc_ex is None:
            from ..index.engine import ShardEngine
            from ..index.mapping import Mappings

            # a COPY of the mappings: dynamic-mapping the candidate
            # doc's fields must never mutate the live index mapping
            scratch_mappings = Mappings(self.reader.mappings.to_json())
            scratch = ShardEngine(scratch_mappings, self.reader.analysis)
            for i, doc in enumerate(q.documents):
                scratch.index(f"_percolate_{i}", doc)
            scratch.refresh()
            doc_ex = NumpyExecutor(scratch.reader(), self.k1, self.b)
            # memoized on the (per-request) query node: every segment of
            # every shard reuses the one scratch index
            q._doc_executor = doc_ex
        parsed_cache = getattr(q, "_parsed_cache", None)
        if parsed_cache is None:
            parsed_cache = {}
            q._parsed_cache = parsed_cache
        for d in range(n):
            src = seg.sources[d]
            if src is None:
                continue
            stored_vals = [
                v for v in _extract_field(src, q.field) if isinstance(v, dict)
            ]
            if not stored_vals:
                continue
            stored = stored_vals[0]
            key = id(src)
            node = parsed_cache.get(key)
            if node is None:
                try:
                    node = dsl.parse_query(stored)
                except dsl.QueryParseError:
                    continue  # index-time validation makes this rare
                parsed_cache[key] = node
            td = doc_ex.search(node, size=1)
            mask[d] = td.total > 0
        return mask, np.where(mask, np.float32(q.boost), 0).astype(np.float32)

    def _exec_script_score(
        self, q: "dsl.ScriptScoreQuery", seg: Segment
    ) -> Tuple[np.ndarray, np.ndarray]:
        """ScriptScoreQuery: the script runs per matching doc with
        doc-value + vector-function bindings (host-side, exactly where
        the reference runs painless)."""
        from ..script import ScriptError, script_service

        mask, base = self._exec(q.query, seg)
        scores = np.zeros(seg.num_docs, np.float32)
        try:
            for d in np.nonzero(mask)[0]:
                scores[d] = script_service.run_score(
                    q.script,
                    _source_field_lookup(seg, int(d)),
                    score=float(base[d]),
                )
        except ScriptError as e:
            raise QueryParseError(str(e))
        if q.min_score is not None:
            mask = mask & (scores >= np.float32(q.min_score))
        scores = (scores * np.float32(q.boost)).astype(np.float32)
        return mask, np.where(mask, scores, 0).astype(np.float32)

    def _exec_script_query(
        self, q: "dsl.ScriptQuery", seg: Segment
    ) -> Tuple[np.ndarray, np.ndarray]:
        from ..script import ScriptError, script_service

        n = seg.num_docs
        mask = np.zeros(n, bool)
        try:
            for d in range(n):
                mask[d] = script_service.run_filter(
                    q.script, _source_field_lookup(seg, d)
                )
        except ScriptError as e:
            raise QueryParseError(str(e))
        return mask, np.where(mask, np.float32(q.boost), 0).astype(np.float32)

    def _exec_function_score(
        self, q: "dsl.FunctionScoreQuery", seg: Segment
    ) -> Tuple[np.ndarray, np.ndarray]:
        n = seg.num_docs
        mask, base = self._exec(q.query, seg)
        fvals: List[np.ndarray] = []
        for fn in q.functions:
            if fn.filter is not None:
                fmask, _ = self._exec(fn.filter, seg)
            else:
                fmask = np.ones(n, bool)
            val = np.ones(n, np.float32)
            if fn.field_value_factor is not None:
                val = _field_value_factor(fn.field_value_factor, seg)
            elif fn.random_score is not None:
                seed = fn.random_score.get("seed", 0)
                val = np.asarray(
                    [_stable_random(seed, d) for d in seg.doc_ids], np.float32
                ) if n else np.zeros(0, np.float32)
            elif fn.script_score is not None:
                from ..script import ScriptError, script_service

                script = fn.script_score.get("script")
                val = np.zeros(n, np.float32)
                try:
                    for d in np.nonzero(fmask & mask)[0]:
                        val[d] = script_service.run_score(
                            script,
                            _source_field_lookup(seg, int(d)),
                            score=float(base[d]),
                        )
                except ScriptError as e:
                    raise QueryParseError(str(e))
            if fn.weight is not None:
                val = val * np.float32(fn.weight)
            # functions only apply where their filter matches; identity
            # elsewhere depends on score_mode (multiply→1, sum→0)
            fvals.append(np.where(fmask, val, np.nan))
        if fvals:
            mat = np.stack(fvals)
            present = ~np.isnan(mat)
            any_fn = present.any(axis=0)
            zed = np.where(present, mat, 0.0)
            if q.score_mode == "multiply":
                combined = np.where(present, mat, 1.0).prod(axis=0)
            elif q.score_mode == "sum":
                combined = zed.sum(axis=0)
            elif q.score_mode == "avg":
                cnt = np.maximum(present.sum(axis=0), 1)
                combined = zed.sum(axis=0) / cnt
            elif q.score_mode == "max":
                combined = np.where(present, mat, -np.inf).max(axis=0)
            elif q.score_mode == "min":
                combined = np.where(present, mat, np.inf).min(axis=0)
            elif q.score_mode == "first":
                first_idx = present.argmax(axis=0)
                combined = mat[first_idx, np.arange(n)]
            else:
                raise QueryParseError(f"unknown score_mode [{q.score_mode}]")
            combined = np.where(any_fn, combined, 1.0).astype(np.float32)
            if q.max_boost is not None:
                combined = np.minimum(combined, np.float32(q.max_boost))
            bm = q.boost_mode
            if bm == "multiply":
                scores = base * combined
            elif bm == "sum":
                scores = base + combined
            elif bm == "replace":
                scores = combined
            elif bm == "avg":
                scores = (base + combined) / 2
            elif bm == "max":
                scores = np.maximum(base, combined)
            elif bm == "min":
                scores = np.minimum(base, combined)
            else:
                raise QueryParseError(f"unknown boost_mode [{bm}]")
        else:
            scores = base
        scores = (scores * np.float32(q.boost)).astype(np.float32)
        if q.min_score is not None:
            mask = mask & (scores >= np.float32(q.min_score))
        return mask, np.where(mask, scores, 0).astype(np.float32)

    # ---- leaves ----

    def _score_term_dense(
        self, seg: Segment, field: str, term: str, boost: float
    ) -> Tuple[np.ndarray, np.ndarray]:
        """TermQuery scoring: dense (mask, scores) for one term."""
        n = seg.num_docs
        mask = np.zeros(n, bool)
        scores = np.zeros(n, np.float32)
        pf = seg.postings.get(field)
        if pf is None:
            return mask, scores
        tid = pf.term_id(term)
        if tid < 0:
            return mask, scores
        start = int(pf.term_tile_start[tid])
        count = int(pf.term_tile_count[tid])
        doc_rows = pf.doc_ids[start : start + count].ravel()
        tf_rows = pf.tfs[start : start + count].ravel()
        valid = doc_rows >= 0
        docs = doc_rows[valid]
        tfs = tf_rows[valid]
        mf = self.reader.mappings.get(field)
        omit_norms = mf is not None and mf.type != TEXT
        if omit_norms:
            norm_bytes = np.ones(len(docs), np.int64)
        else:
            norm_bytes = pf.norms[docs].astype(np.int64)
        weight = np.float32(boost) * np.float32(self._term_weight(field, term))
        cache = self._field_cache(field)
        s = bm25.score_freqs(tfs, norm_bytes, weight, cache)
        mask[docs] = True
        scores[docs] = s
        return mask, scores

    def _exec_match(self, q: MatchQuery, seg: Segment) -> Tuple[np.ndarray, np.ndarray]:
        mf = self.reader.mappings.get(q.field)
        n = seg.num_docs
        if mf is None:
            return np.zeros(n, bool), np.zeros(n, np.float32)
        if mf.type != TEXT:
            # match on keyword/numeric degrades to a term query (ES behavior)
            return self._exec_term(TermQuery(field=q.field, value=q.query, boost=q.boost), seg)
        analyzer_name = q.analyzer or mf.search_analyzer or mf.analyzer
        terms = [t.text for t in self.reader.analysis.get(analyzer_name).analyze(q.query)]
        if not terms:
            # analyzes to no tokens → matches nothing (MatchNoDocsQuery)
            return np.zeros(n, bool), np.zeros(n, np.float32)
        masks = []
        scores = np.zeros(n, np.float32)
        for t in terms:
            m, s = self._score_term_dense(seg, q.field, t, q.boost)
            masks.append(m)
            scores = (scores + s).astype(np.float32)
        stacked = np.stack(masks)
        if q.operator == "and":
            mask = stacked.all(axis=0)
        else:
            msm = dsl.parse_minimum_should_match(q.minimum_should_match, len(terms))
            msm = max(1, msm)
            mask = stacked.sum(axis=0) >= msm
        return mask, np.where(mask, scores, 0).astype(np.float32)

    def _exec_phrase(self, q: MatchPhraseQuery, seg: Segment) -> Tuple[np.ndarray, np.ndarray]:
        mf = self.reader.mappings.get(q.field)
        n = seg.num_docs
        if mf is None or mf.type != TEXT:
            return np.zeros(n, bool), np.zeros(n, np.float32)
        analyzer_name = q.analyzer or mf.search_analyzer or mf.analyzer
        analyzer = self.reader.analysis.get(analyzer_name)
        qtoks = analyzer.analyze(q.query)
        terms = [t.text for t in qtoks]
        if not terms:
            return np.zeros(n, bool), np.zeros(n, np.float32)
        # conjunction prefilter
        conj, scores = self._exec_match(
            MatchQuery(field=q.field, query=q.query, operator="and",
                       analyzer=analyzer_name, boost=q.boost),
            seg,
        )
        # position verification against the columnar position index
        # (Lucene PositionsEnum semantics) — never re-analyzes _source
        qpos = [t.position for t in qtoks]
        rel = [p - qpos[0] for p in qpos]
        mask = np.zeros(n, bool)
        pf = seg.postings.get(q.field)
        if pf is not None and pf.has_positions:
            tids = [pf.term_id(t) for t in terms]
            for doc in np.nonzero(conj)[0]:
                pos_of: Dict[str, List[int]] = {}
                ok = True
                for t, tid in zip(terms, tids):
                    if t in pos_of:
                        continue
                    ps = pf.doc_positions(tid, int(doc)) if tid >= 0 else None
                    if ps is None:
                        ok = False
                        break
                    pos_of[t] = ps.tolist()
                mask[doc] = ok and _phrase_match(pos_of, terms, rel, q.slop)
            return mask, np.where(mask, scores, 0).astype(np.float32)
        # legacy segments without stored positions: re-analyze _source
        for doc in np.nonzero(conj)[0]:
            src = seg.sources[doc] or {}
            value = _extract_field(src, q.field)
            ok = False
            for v in value:
                toks = analyzer.analyze(str(v))
                pos_of = {}
                for t in toks:
                    pos_of.setdefault(t.text, []).append(t.position)
                if _phrase_match(pos_of, terms, rel, q.slop):
                    ok = True
                    break
            mask[doc] = ok
        return mask, np.where(mask, scores, 0).astype(np.float32)

    def _exec_term(self, q: TermQuery, seg: Segment) -> Tuple[np.ndarray, np.ndarray]:
        n = seg.num_docs
        mf = self.reader.mappings.get(q.field)
        if q.field == "_id":
            mask = np.zeros(n, bool)
            for i, d in enumerate(seg.doc_ids):
                if d == str(q.value):
                    mask[i] = True
            return mask, np.where(mask, np.float32(q.boost), 0).astype(np.float32)
        if mf is None:
            return np.zeros(n, bool), np.zeros(n, np.float32)
        if mf.type in (TEXT, KEYWORD):
            return self._score_term_dense(
                seg, q.field, dsl.term_token(q.value), q.boost
            )
        # numeric/date/boolean: doc-values equality, constant score
        nf = seg.numerics.get(q.field)
        if nf is None:
            return np.zeros(n, bool), np.zeros(n, np.float32)
        target = _coerce_numeric(mf.type, q.value)
        mask = nf.exists & (nf.values == target)
        return mask, np.where(mask, np.float32(q.boost), 0).astype(np.float32)

    def _exec_terms(self, q: TermsQuery, seg: Segment) -> Tuple[np.ndarray, np.ndarray]:
        n = seg.num_docs
        mask = np.zeros(n, bool)
        for v in q.values:
            m, _ = self._exec_term(TermQuery(field=q.field, value=v), seg)
            mask |= m
        # terms query is constant-scoring (boost)
        return mask, np.where(mask, np.float32(q.boost), 0).astype(np.float32)

    def _exec_range(self, q: RangeQuery, seg: Segment) -> Tuple[np.ndarray, np.ndarray]:
        n = seg.num_docs
        mf = self.reader.mappings.get(q.field)
        if mf is None:
            return np.zeros(n, bool), np.zeros(n, np.float32)
        if mf.type in (TEXT, KEYWORD):
            of = seg.ordinals.get(q.field)
            if of is None:
                return np.zeros(n, bool), np.zeros(n, np.float32)
            terms = of.ord_terms
            lo, hi = 0, len(terms)
            if q.gte is not None:
                lo = _bisect_left(terms, str(q.gte))
            if q.gt is not None:
                lo = max(lo, _bisect_right(terms, str(q.gt)))
            if q.lte is not None:
                hi = min(hi, _bisect_right(terms, str(q.lte)))
            if q.lt is not None:
                hi = min(hi, _bisect_left(terms, str(q.lt)))
            # multi-value: any of the doc's ordinals in [lo, hi)
            in_range = (of.mv_ords >= lo) & (of.mv_ords < hi)
            hit_counts = np.diff(np.concatenate([[0], np.cumsum(in_range)])[of.mv_offsets])
            mask = hit_counts > 0
            return mask, np.where(mask, np.float32(q.boost), 0).astype(np.float32)
        nf = seg.numerics.get(q.field)
        if nf is None:
            return np.zeros(n, bool), np.zeros(n, np.float32)
        mask = nf.exists.copy()
        conv = (lambda v: parse_date_millis(v)) if mf.type == DATE else float
        if q.gte is not None:
            mask &= nf.values >= conv(q.gte)
        if q.gt is not None:
            mask &= nf.values > conv(q.gt)
        if q.lte is not None:
            mask &= nf.values <= conv(q.lte)
        if q.lt is not None:
            mask &= nf.values < conv(q.lt)
        return mask, np.where(mask, np.float32(q.boost), 0).astype(np.float32)

    def _exec_exists(self, q: ExistsQuery, seg: Segment) -> Tuple[np.ndarray, np.ndarray]:
        n = seg.num_docs
        mask = np.zeros(n, bool)
        pf = seg.postings.get(q.field)
        if pf is not None:
            mask |= pf.norms > 0
        nf = seg.numerics.get(q.field)
        if nf is not None:
            mask |= nf.exists
        vf = seg.vectors.get(q.field)
        if vf is not None:
            mask |= vf.exists
        of = seg.ordinals.get(q.field)
        if of is not None:
            mask |= of.ords >= 0
        return mask, np.where(mask, np.float32(q.boost), 0).astype(np.float32)

    # ---- compounds ----

    def _exec_bool(self, q: BoolQuery, seg: Segment) -> Tuple[np.ndarray, np.ndarray]:
        n = seg.num_docs
        mask = np.ones(n, bool)
        scores = np.zeros(n, np.float32)
        any_positive = bool(q.must or q.filter or q.should)
        for c in q.must:
            m, s = self._exec(c, seg)
            mask &= m
            scores = (scores + s).astype(np.float32)
        for c in q.filter:
            mask &= self.filter_mask(c, seg)
        if q.should:
            smasks = []
            sscores = np.zeros(n, np.float32)
            for c in q.should:
                m, s = self._exec(c, seg)
                smasks.append(m)
                sscores = (sscores + np.where(m, s, 0)).astype(np.float32)
            stacked = np.stack(smasks)
            match_count = stacked.sum(axis=0)
            default_msm = 0 if (q.must or q.filter) else 1
            msm = (
                dsl.parse_minimum_should_match(q.minimum_should_match, len(q.should))
                if q.minimum_should_match is not None
                else default_msm
            )
            if msm > 0:
                mask &= match_count >= msm
            scores = (scores + np.where(match_count > 0, sscores, 0)).astype(np.float32)
        elif not any_positive:
            # only must_not: everything matches with score 0
            pass
        for c in q.must_not:
            m, _ = self._exec(c, seg)
            mask &= ~m
        if q.boost != 1.0:
            scores = (scores * np.float32(q.boost)).astype(np.float32)
        return mask, np.where(mask, scores, 0).astype(np.float32)

    def _exec_multi_match(self, q: MultiMatchQuery, seg: Segment) -> Tuple[np.ndarray, np.ndarray]:
        n = seg.num_docs
        fields = expand_match_fields(self.reader.mappings, q.fields)
        if not fields:
            return np.zeros(n, bool), np.zeros(n, np.float32)
        per_field: List[Tuple[np.ndarray, np.ndarray]] = []
        for fname, fboost in fields:
            if q.type == "phrase":
                m, s = self._exec_phrase(
                    MatchPhraseQuery(
                        field=fname, query=q.query, boost=q.boost * fboost
                    ),
                    seg,
                )
            else:
                m, s = self._exec_match(
                    MatchQuery(field=fname, query=q.query, operator=q.operator,
                               boost=q.boost * fboost),
                    seg,
                )
            per_field.append((m, s))
        masks = np.stack([m for m, _ in per_field])
        score_mat = np.stack([s for _, s in per_field])
        mask = masks.any(axis=0)
        if q.type == "best_fields":
            best = score_mat.max(axis=0)
            if q.tie_breaker:
                rest = score_mat.sum(axis=0) - best
                total = (best + np.float32(q.tie_breaker) * rest).astype(np.float32)
            else:
                total = best
        else:  # most_fields / cross_fields (round 1: summed per-field scores)
            total = score_mat.sum(axis=0, dtype=np.float32)
        return mask, np.where(mask, total, 0).astype(np.float32)

    # ---- knn ----

    def _exec_sparse(
        self, q: "dsl.SparseVectorQuery", seg: Segment
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Dense fp32 learned-sparse scorer — THE float oracle for the
        impact-tile device path. Term-at-a-time np.add.at in sorted
        query-term order: a doc occurs at most once in a term's
        postings, so each score cell accumulates exactly one f32 add
        per term, in term order — the same per-cell order the device
        kernel scatters (ops/impact.py lays tiles out per term in the
        identical sorted order), which is what makes the unquantized
        device path bit-equal to this function."""
        n = seg.num_docs
        sf = (seg.sparse or {}).get(q.field)
        if sf is None:
            return np.zeros(n, bool), np.zeros(n, np.float32)
        scores = np.zeros(n, np.float32)
        mask = np.zeros(n, bool)
        boost = np.float32(q.boost)
        for t, w in sorted(q.query_vector.items()):
            tid = sf.term_id(t)
            if tid < 0:
                continue
            docs, ws = sf.term_postings(tid)
            tw = np.float32(boost * np.float32(w))
            np.add.at(scores, docs, tw * ws)
            mask[docs] = True
        return mask, np.where(mask, scores, 0).astype(np.float32)

    def _exec_knn(self, sec: KnnSection, si: int, seg: Segment) -> Tuple[np.ndarray, np.ndarray]:
        n = seg.num_docs
        vf = seg.vectors.get(sec.field)
        if vf is None:
            return np.zeros(n, bool), np.zeros(n, np.float32)
        scores = score_vectors(
            np.asarray(sec.query_vector, np.float32),
            vf.vectors,
            vf.similarity,
            vf.unit_vectors,
        )
        mask = vf.exists.copy()
        if sec.filter is not None:
            mask &= self.filter_mask(sec.filter, seg)
        live = self.reader.live_docs[si]
        if live is not None:
            mask = mask & live
        if sec.similarity is not None:
            mask &= scores >= np.float32(sec.similarity)
        # per-shard: keep only top num_candidates, then top k overall
        cand = min(sec.num_candidates, int(mask.sum()))
        if cand < int(mask.sum()):
            masked = np.where(mask, scores, -np.inf)
            kth = np.partition(masked, -cand)[-cand]
            mask &= masked >= kth
        # top-level k cut happens at merge; apply boost
        out = (scores * np.float32(sec.boost)).astype(np.float32)
        return mask, np.where(mask, out, 0).astype(np.float32)


# ---- helpers ----

def parse_sort(sort_body) -> List[dict]:
    """Normalizes the request's "sort" into [{field, order, missing}]."""
    specs = []
    for entry in sort_body if isinstance(sort_body, list) else [sort_body]:
        if isinstance(entry, str):
            specs.append(
                {
                    "field": entry,
                    "order": "desc" if entry == "_score" else "asc",
                    "missing": "_last",
                }
            )
        elif isinstance(entry, dict) and len(entry) == 1:
            field, cfg = next(iter(entry.items()))
            if isinstance(cfg, str):
                specs.append({"field": field, "order": cfg, "missing": "_last"})
            elif isinstance(cfg, dict):
                specs.append(
                    {
                        "field": field,
                        "order": cfg.get(
                            "order", "desc" if field == "_score" else "asc"
                        ),
                        "missing": cfg.get("missing", "_last"),
                    }
                )
            else:
                raise QueryParseError(f"malformed sort entry [{entry}]")
        else:
            raise QueryParseError(f"malformed sort entry [{entry}]")
    return specs


def _sort_key_values(spec, seg, idx, scores, mappings, doc_base=0):
    """(lexsort-ready key array, raw response values) for matching docs.

    Keys live in "ascending key space": desc orders negate the value, and
    the `missing` policy fills ±inf in key space so _last/_first hold for
    either direction (SortField.setMissingValue semantics). Keyword keys
    are float ord ranks within the segment — NOTE: cross-segment keyword
    sort uses per-segment ranks, which is correct only because the merge
    re-sorts on the raw string values at the coordinator.
    """
    field = spec["field"]
    desc = spec["order"] == "desc"
    missing = spec["missing"]
    n = len(idx)
    if field == "_score":
        raw = scores.astype(np.float64)
        return (-raw if desc else raw), raw
    if field == "_doc":
        # global doc id = cumulative segment docBase + local id, so
        # cross-segment ordering is segment-major (Lucene docBase
        # semantics) and search_after cursors are unambiguous
        raw = (idx + doc_base).astype(np.float64)
        return (-raw if desc else raw), raw
    mf = mappings.get(field)
    if mf is not None and mf.type in (KEYWORD, TEXT):
        # string keys are only comparable globally: return key=None and
        # let execute_sorted rank the concatenated raw values
        of = seg.ordinals.get(field)
        if of is None:
            return None, np.full(n, None, object)
        ords = of.ords[idx]
        raw = np.asarray(
            [of.ord_terms[o] if o >= 0 else None for o in ords], object
        )
        return None, raw
    nf = seg.numerics.get(field)
    if nf is None:
        vals = np.zeros(n)
        have = np.zeros(n, bool)
    else:
        vals = nf.values[idx]
        have = nf.exists[idx]
    key_vals = -vals if desc else vals
    if missing == "_first":
        fill_key = -np.inf
        raw = np.where(have, vals, np.nan)
    elif missing == "_last":
        fill_key = np.inf
        raw = np.where(have, vals, np.nan)
    else:
        # concrete missing value: docs sort (and report) AS that value
        mv = float(missing)
        fill_key = -mv if desc else mv
        raw = np.where(have, vals, mv)
    key = np.where(have, key_vals, fill_key)
    return key.astype(np.float64), raw


def _rank_strings(raw: np.ndarray, spec: dict, after_value=None):
    """Global ascending-key-space ranks for a string sort column; the
    search_after cursor (if any) is ranked in the same space."""
    have = np.asarray([v is not None for v in raw])
    vals = {v for v in raw if v is not None}
    if after_value is not None:
        vals.add(str(after_value))
    uniq = {v: i for i, v in enumerate(sorted(vals))}
    key = np.asarray([float(uniq[v]) if v is not None else 0.0 for v in raw])
    desc = spec["order"] == "desc"
    if desc:
        key = -key
    fill = np.inf if spec["missing"] == "_last" else -np.inf
    key = np.where(have, key, fill)
    ak = None
    if after_value is not None:
        ak = float(uniq[str(after_value)])
        if desc:
            ak = -ak
    elif after_value is None:
        ak = fill  # null cursor = the missing fill position
    return key, ak


def _numeric_after_key(after_value, spec: dict):
    if after_value is None:
        # null cursor = the doc before had a missing value
        return np.inf if spec["missing"] == "_last" else -np.inf
    v = float(after_value)
    return -v if spec["order"] == "desc" else v


def _to_jsonable(v):
    if v is None:
        return None
    if isinstance(v, (np.floating, np.integer)):
        f = float(v)
        if np.isnan(f):
            return None
        return int(f) if f.is_integer() and abs(f) < 2**53 else f
    return v


def filter_source(src: Optional[dict], spec):
    """_source request option: false, list of patterns, or
    {includes, excludes} (FetchSourcePhase / XContentMapValues.filter)."""
    import fnmatch

    if src is None or spec is None or spec is True:
        return src
    if spec is False:
        return None
    if isinstance(spec, str):
        spec = [spec]
    if isinstance(spec, list):
        includes, excludes = spec, []
    else:
        includes = spec.get("includes", []) or []
        excludes = spec.get("excludes", []) or []
        if isinstance(includes, str):
            includes = [includes]
        if isinstance(excludes, str):
            excludes = [excludes]

    def walk(node, path):
        if not isinstance(node, dict):
            return node
        out = {}
        for k, v in node.items():
            p = f"{path}.{k}" if path else k
            if excludes and any(fnmatch.fnmatch(p, e) for e in excludes):
                continue
            if isinstance(v, dict):
                sub = walk(v, p)
                if sub or _included(p, includes, prefix_ok=True):
                    if includes and not _included(p, includes, prefix_ok=True):
                        continue
                    out[k] = sub
            else:
                if not includes or _included(p, includes):
                    out[k] = v
        return out

    return walk(src, "")


def _included(path, includes, prefix_ok=False):
    import fnmatch

    for inc in includes:
        if fnmatch.fnmatch(path, inc):
            return True
        if inc.startswith(path + "."):
            return True  # an ancestor of an included leaf
        if path.startswith(inc + "."):
            return True  # a descendant of an included object
        if prefix_ok and fnmatch.fnmatch(path, inc + "*"):
            return True
    return False


def _fuzziness_edits(fuzziness: str, term: str) -> int:
    """Fuzziness.AUTO: 0 edits for length<3, 1 for 3-5, else 2."""
    f = str(fuzziness).upper()
    if f.startswith("AUTO"):
        n = len(term)
        return 0 if n < 3 else (1 if n <= 5 else 2)
    try:
        return max(0, min(int(float(f)), 2))
    except ValueError:
        raise QueryParseError(f"invalid fuzziness [{fuzziness}]")


def _levenshtein_at_most(a: str, b: str, k: int) -> bool:
    if a == b:
        return True
    if k == 0:
        return False
    if abs(len(a) - len(b)) > k:
        return False
    prev = list(range(len(b) + 1))
    for i, ca in enumerate(a, 1):
        cur = [i]
        row_min = i
        for j, cb in enumerate(b, 1):
            cur.append(min(prev[j] + 1, cur[-1] + 1, prev[j - 1] + (ca != cb)))
            row_min = min(row_min, cur[-1])
        if row_min > k:
            return False
        prev = cur
    return prev[-1] <= k


def levenshtein_distance(a: str, b: str) -> int:
    """Exact edit distance (unbounded variant of _levenshtein_at_most
    above — keep the two in sync)."""
    if a == b:
        return 0
    if not a or not b:
        return max(len(a), len(b))
    prev = list(range(len(b) + 1))
    for i, ca in enumerate(a, 1):
        cur = [i]
        for j, cb in enumerate(b, 1):
            cur.append(min(prev[j] + 1, cur[-1] + 1, prev[j - 1] + (ca != cb)))
        prev = cur
    return prev[-1]


def search_field_terms(
    mappings, analysis, field: str, text: str, override: Optional[str] = None
) -> List[str]:
    """Search-time analysis of one value: the field's search analyzer
    (or analyzer, or `standard`), falling back to the raw value when the
    analyzer name is unknown. Shared by DFS stats gathering, MLT term
    selection, and nested-object matching."""
    mf = mappings.get(field)
    name = override or (
        (mf.search_analyzer or mf.analyzer) if mf is not None else "standard"
    )
    try:
        return analysis.get(name).terms(str(text))
    except ValueError:
        return [str(text)]


def _span_near_match(
    plists: List[List[int]], slop: int, in_order: bool, k: int
) -> bool:
    """One-position-per-clause arrangement with span width - k <= slop;
    in_order additionally requires strictly increasing positions in
    clause order (SpanNearQuery/NearSpansOrdered semantics, simplified)."""
    if k == 0:
        return False
    if k == 1:
        return len(plists[0]) > 0
    if in_order:
        # for each start position, greedily pick the smallest admissible
        # position in each subsequent clause (minimal-span witness)
        for p0 in plists[0]:
            prev = p0
            ok = True
            for lst in plists[1:]:
                nxt = next((p for p in lst if p > prev), None)
                if nxt is None:
                    ok = False
                    break
                prev = nxt
            if ok and (prev - p0 + 1) - k <= slop:
                return True
        return False
    # unordered: smallest window covering one position from every list
    events = sorted(
        (p, li) for li, lst in enumerate(plists) for p in lst
    )
    from collections import defaultdict

    need = k
    have: Dict[int, int] = defaultdict(int)
    missing = need
    lo = 0
    for hi, (p, li) in enumerate(events):
        if have[li] == 0:
            missing -= 1
        have[li] += 1
        while missing == 0:
            span = p - events[lo][0] + 1
            if span - k <= slop:
                return True
            lp, lli = events[lo]
            have[lli] -= 1
            if have[lli] == 0:
                missing += 1
            lo += 1
    return False


_EARTH_RADIUS_M = 6371008.7714  # GeoUtils.EARTH_MEAN_RADIUS


def _haversine_m(lat1, lon1, lat2, lon2):
    """Vectorized haversine distance in meters (GeoDistance.ARC)."""
    la1, lo1 = np.radians(lat1), np.radians(lon1)
    la2, lo2 = np.radians(lat2), np.radians(lon2)
    dlat = la2 - la1
    dlon = lo2 - lo1
    a = (
        np.sin(dlat / 2.0) ** 2
        + np.cos(la1) * np.cos(la2) * np.sin(dlon / 2.0) ** 2
    )
    return 2.0 * _EARTH_RADIUS_M * np.arcsin(np.sqrt(np.clip(a, 0, 1)))


def _nested_objects(src: dict, path: str) -> List[dict]:
    node: Any = src
    for part in path.split("."):
        node = node.get(part) if isinstance(node, dict) else None
        if node is None:
            return []
    if isinstance(node, dict):
        return [node]
    return [o for o in node if isinstance(o, dict)] if isinstance(node, list) else []


def _source_field_lookup(seg: Segment, local: int):
    """doc['field'] resolver for scripts: dotted-path lookup into the
    stored source (ScriptDocValues backed by _source — the reference
    reads typed doc values; sources carry the same values here,
    including dense vectors)."""
    src = seg.sources[local]

    def lookup(field: str) -> list:
        node = src
        for part in field.split("."):
            if isinstance(node, dict):
                node = node.get(part)
            else:
                node = None
                break
        if node is None:
            return []
        return node if isinstance(node, list) else [node]

    return lookup


def _field_value_factor(cfg: dict, seg: Segment) -> np.ndarray:
    """FieldValueFactorFunction: factor * modifier(doc_value)."""
    field = cfg.get("field")
    if field is None:
        raise QueryParseError("[field_value_factor] requires [field]")
    n = seg.num_docs
    nf = seg.numerics.get(field)
    missing = cfg.get("missing")
    if nf is None:
        if missing is None:
            vals = np.zeros(n)
            have = np.zeros(n, bool)
        else:
            vals = np.full(n, float(missing))
            have = np.ones(n, bool)
    else:
        vals, have = nf.values, nf.exists
        if missing is not None:
            vals = np.where(have, vals, float(missing))
            have = np.ones(n, bool)
    v = vals * float(cfg.get("factor", 1.0))
    modifier = cfg.get("modifier", "none")
    mods = {
        "none": lambda x: x,
        "log": lambda x: np.log10(np.maximum(x, 1e-30)),
        "log1p": lambda x: np.log10(x + 1),
        "log2p": lambda x: np.log10(x + 2),
        "ln": lambda x: np.log(np.maximum(x, 1e-30)),
        "ln1p": lambda x: np.log1p(x),
        "ln2p": lambda x: np.log(x + 2),
        "square": lambda x: x * x,
        "sqrt": lambda x: np.sqrt(np.maximum(x, 0)),
        "reciprocal": lambda x: 1.0 / np.where(x == 0, 1e30, x),
    }
    if modifier not in mods:
        raise QueryParseError(f"unknown modifier [{modifier}]")
    out = mods[modifier](v).astype(np.float32)
    return np.where(have, out, 0.0).astype(np.float32)


def _stable_random(seed, doc_id: str) -> float:
    """Deterministic per-doc pseudo-random in [0,1) (RandomScoreFunction)."""
    import hashlib

    h = hashlib.md5(f"{seed}:{doc_id}".encode()).digest()
    return int.from_bytes(h[:8], "big") / 2**64


def rewrite_query_string(q: "dsl.QueryStringQuery", mappings) -> "dsl.Query":
    """query_string lite → bool tree. Supports: bare terms, field:term,
    quoted phrases, AND/OR/NOT connectives (first connective wins as the
    group operator), +term/-term prefixes in simple mode."""
    import re as _re

    default_fields = q.fields or (
        [q.default_field] if q.default_field and q.default_field != "*" else ["*"]
    )
    tokens = _re.findall(r'(?:[\w.*]+:)?"[^"]*"|\S+', q.query)
    must: List[dsl.Query] = []
    should: List[dsl.Query] = []
    must_not: List[dsl.Query] = []
    operator = q.default_operator
    pending: List[Tuple[str, dsl.Query]] = []  # (polarity, query)
    saw_and = False
    i = 0
    while i < len(tokens):
        tok = tokens[i]
        i += 1
        up = tok.upper()
        if up == "AND" and not q.simple:
            saw_and = True
            continue
        if up == "OR" and not q.simple:
            continue
        if up == "NOT" and not q.simple:
            if i < len(tokens):
                sub = _qs_leaf(tokens[i], default_fields)
                if sub is not None:
                    pending.append(("not", sub))
                i += 1
            continue
        polarity = ""
        if q.simple and tok[:1] in "+-" and len(tok) > 1:
            polarity = tok[0]
            tok = tok[1:]
        sub = _qs_leaf(tok, default_fields)
        if sub is None:
            continue
        pending.append(("must" if polarity == "+" else "not" if polarity == "-" else "", sub))
    use_and = saw_and or operator == "and"
    for pol, sub in pending:
        if pol == "not":
            must_not.append(sub)
        elif pol == "must" or use_and:
            must.append(sub)
        else:
            should.append(sub)
    return dsl.BoolQuery(
        must=must, should=should, must_not=must_not, boost=q.boost,
        # should is only mandatory when it stands alone (bool default)
        minimum_should_match="1" if (should and not must) else None,
    )


def _qs_leaf(tok: str, default_fields: List[str]) -> Optional["dsl.Query"]:
    field = None
    if ":" in tok and not tok.startswith('"'):
        field, _, tok = tok.partition(":")
    if not tok:
        return None
    fields = [field] if field else default_fields
    if tok.startswith('"') and tok.endswith('"') and len(tok) >= 2:
        phrase = tok[1:-1]
        if len(fields) == 1 and fields[0] != "*":
            return dsl.MatchPhraseQuery(field=fields[0], query=phrase)
        return dsl.MultiMatchQuery(query=phrase, fields=fields, type="phrase")
    if "*" in tok or "?" in tok:
        if len(fields) == 1 and fields[0] != "*":
            return dsl.WildcardQuery(field=fields[0], value=tok)
        # wildcard over unspecified fields: unsupported → match nothing
        return dsl.MatchNoneQuery()
    if len(fields) == 1 and fields[0] != "*":
        return dsl.MatchQuery(field=fields[0], query=tok)
    return dsl.MultiMatchQuery(query=tok, fields=fields)


def expand_match_fields(mappings, patterns) -> List[Tuple[str, float]]:
    """Expands multi_match field patterns (``title^2``, ``body``, ``*``,
    ``name.*``) against the mapping's text/keyword fields — the
    QueryParserHelper.resolveMappingFields analog."""
    import fnmatch

    from ..index.mapping import KEYWORD as _KW, TEXT as _TX

    out: List[Tuple[str, float]] = []
    for f in patterns:
        boost = 1.0
        name = f
        if "^" in f:
            name, _, b = f.partition("^")
            boost = float(b)
        if "*" in name or "?" in name:
            # snapshot: concurrent dynamic mapping may grow the dict
            for fname, mf in sorted(list(mappings.fields.items())):
                if mf.type in (_TX, _KW) and fnmatch.fnmatch(fname, name):
                    out.append((fname, boost))
        else:
            out.append((name, boost))
    return out


def _extract_field(src: dict, path: str):
    node = src
    for part in path.split("."):
        if isinstance(node, dict) and part in node:
            node = node[part]
        else:
            return []
    return node if isinstance(node, list) else [node]


def _phrase_match(pos_of: Dict[str, List[int]], terms: List[str], rel: List[int], slop: int) -> bool:
    """Exact phrase when slop=0: all terms at consecutive relative positions.
    Sloppy phrases use a simple window check (admits standard slop cases)."""
    first = pos_of.get(terms[0], [])
    for p0 in first:
        if slop == 0:
            if all(p0 + r in pos_of.get(t, []) for t, r in zip(terms[1:], rel[1:])):
                return True
        else:
            ok = True
            for t, r in zip(terms[1:], rel[1:]):
                cands = pos_of.get(t, [])
                if not any(abs(p - (p0 + r)) <= slop for p in cands):
                    ok = False
                    break
            if ok:
                return True
    return False


def _coerce_numeric(ftype: str, value) -> float:
    if ftype == BOOLEAN:
        if isinstance(value, bool):
            return 1.0 if value else 0.0
        return 1.0 if value == "true" else 0.0
    if ftype == DATE:
        return parse_date_millis(value)
    return float(value)


def _bisect_left(arr: List[str], x: str) -> int:
    import bisect

    return bisect.bisect_left(arr, x)


def _bisect_right(arr: List[str], x: str) -> int:
    import bisect

    return bisect.bisect_right(arr, x)
