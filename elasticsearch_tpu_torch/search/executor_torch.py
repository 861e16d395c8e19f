"""PyTorch shard executor — the port's counterpart of the JAX package's
`search/executor_jax.py` (`JaxExecutor`).

Mirrors the NumPy oracle (executor.py) node for node, but evaluates on
device tensors: postings tiles live in device memory, leaves score via
the gather→BM25→scatter functions in ops/scoring.py, and collection is a
top-k that breaks ties by the lowest doc.

The port covers the shard query phase of `match` (BM25),
`match_all`/`match_none`, `bool`, `multi_match` (best_fields /
most_fields), `dis_max`, the filter-context leaves (`term`, `terms`,
`range`, `exists`, `ids`, `constant_score`), `match_phrase` and
`multi_match` `type: phrase` (a device conjunction, then the positions
verified on the host), `prefix`/`wildcard`/`regexp`/`fuzzy` (expanded on
the host, scored in one device pass), kNN (top-level `knn`
sections, with or without a `filter`, brute force or through the IVF
indexes of ops/ivf.py, built by `warm_ann`; the `knn` query node) and
sorted collection on one numeric key (`execute_sorted_device`), plus
the surface the serving batcher drives: the fused routes for large
segments (`fused_scorer` → `fused_plan` →
`FusedScorer.search_async`; `fused_scorer_mf` → `fused_plan_field` →
`MultiFusedScorer.search_async`), the chunked block-max route for small
ones (`block_index`, `chunked_scorer`), `segment_topk`, the filtered-bool
route (`search_plan_filtered`), the learned-sparse impact scorers
(`impact_scorer`, uploaded at build by `warm_impacts`), the keyword
terms-aggs pass (`execute_with_terms_aggs`) and the state of the device
aggregations engine (search/aggs_device.py), and device-resident live
and live ∧ exists masks built once per executor (= reader generation).
Filter-context clauses go through the node-level bitset cache
(search/query_cache.py) as device `torch.bool` tensors; `exists` and a
`sparse_vector` node inside a tree are the oracle's host mask and
scores, uploaded, as in the reference, and so is every other query node
(function_score, spans, nested, geo, the script nodes, ...).

Numeric doc values stay float64 on the device, so a `date` range at
epoch-millisecond precision compares exactly (float32 spacing near
1.7e12 ms is 131,072 ms).

Per-segment tensors are uploaded once, lazily per field, and charged to
the device-memory ledger (common/memory.py) — the analog of Lucene's
"open a reader once, search many times".
"""

from __future__ import annotations

import threading
import time
from types import SimpleNamespace
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..index.mapping import DATE, KEYWORD, TEXT, parse_date_millis
from ..index.segment import Segment
from ..common.faults import InjectedFault, faults
from ..models import bm25
from ..ops import ivf, scoring
from . import ann as ann_mod
from . import dsl
from .dsl import (
    BoolQuery,
    ConstantScoreQuery,
    DisMaxQuery,
    IdsQuery,
    KnnQueryWrapper,
    KnnSection,
    MatchAllQuery,
    MatchNoneQuery,
    MatchPhraseQuery,
    MatchQuery,
    MultiMatchQuery,
    Query,
    RangeQuery,
    TermQuery,
    TermsQuery,
)
from .executor import (
    Hit,
    NumpyExecutor,
    ShardReader,
    TopDocs,
    _coerce_numeric,
    expand_match_fields,
)

# segments below this size take the batcher's chunked block-max path (or
# the per-query path); above it the per-segment fused launch with dense
# hot rows pays off
FUSED_MIN_DOCS = 100_000
# device-memory budget for dense hot-term tf rows, bytes (uint8 per doc per term)
DENSE_ROWS_HBM_BUDGET = 512 * 1024 * 1024

# phrase routes taken (`conjunction`: the device conjunction and the host
# position verify; `oracle`: a segment without positions), the
# conjunction's candidates and the verify's wall time
PHRASE_STATS = {"conjunction": 0, "oracle": 0, "candidates": 0, "verify_s": 0.0}
_PHRASE_LOCK = threading.Lock()


def _note_phrase(route: str, candidates: int = 0, verify_s: float = 0.0) -> None:
    with _PHRASE_LOCK:
        PHRASE_STATS[route] += 1
        PHRASE_STATS["candidates"] += candidates
        PHRASE_STATS["verify_s"] += verify_s


class DevicePostings:
    def __init__(self, pf, device):
        self.doc_ids = torch.from_numpy(np.ascontiguousarray(pf.doc_ids)).to(device)
        self.tfs = torch.from_numpy(np.ascontiguousarray(pf.tfs)).to(device)


def _tree_nbytes(v) -> int:
    if isinstance(v, torch.Tensor):
        return v.numel() * v.element_size()
    if hasattr(v, "nbytes"):
        return int(v.nbytes)
    if isinstance(v, (tuple, list)):
        return sum(_tree_nbytes(x) for x in v)
    if hasattr(v, "__dict__"):
        return sum(_tree_nbytes(x) for x in vars(v).values())
    return 0


class _LazyDeviceMap:
    """Per-field device uploads, materialized on first use. Every upload
    charges the device-memory ledger; `charge` is a (category, nbytes,
    breaker) recorder owned by the executor so close() can release
    exactly what was charged."""

    def __init__(self, names, build, charge=None, category="other"):
        self._names = set(names)
        self._build = build
        self._cache: Dict[str, object] = {}
        self._lock = threading.Lock()
        self._charge = charge
        self._category = category

    def get(self, name, default=None):
        if name not in self._names:
            return default
        v = self._cache.get(name)
        if v is None:
            with self._lock:
                v = self._cache.get(name)
                if v is None:
                    v = self._build(name)
                    if self._charge is not None:
                        self._charge(self._category, _tree_nbytes(v), False)
                    self._cache[name] = v
        return v

    def __getitem__(self, name):
        v = self.get(name)
        if v is None:
            raise KeyError(name)
        return v


class DeviceSegment:
    """Device-resident mirror of a Segment's postings and vectors (lazy
    per field)."""

    def __init__(self, seg: Segment, device, charge=None):
        self.seg = seg
        self.device = device
        self.postings = _LazyDeviceMap(
            seg.postings, lambda f: DevicePostings(seg.postings[f], device),
            charge=charge, category="postings",
        )

        def _vec(f):
            vf = seg.vectors[f]
            mat = vf.unit_vectors if vf.similarity == "cosine" else vf.vectors
            if charge is not None:
                # vectors are the big uploads: trip the breaker BEFORE
                # shipping them
                charge(
                    "vectors",
                    int(mat.nbytes) + int(vf.exists.nbytes),
                    True,
                    precheck_only=True,
                )
            out = (
                torch.from_numpy(np.ascontiguousarray(mat)).to(device),
                torch.from_numpy(np.ascontiguousarray(vf.exists)).to(device),
            )
            if charge is not None:
                charge("vectors", _tree_nbytes(out), False)
            return out

        self.vectors = _LazyDeviceMap(seg.vectors, _vec)
        # numeric doc values keep float64 (dates are epoch millis, exact
        # only in float64), exists is bool
        self.numerics = _LazyDeviceMap(
            seg.numerics,
            lambda f: (
                _host_to(seg.numerics[f].values, device, np.float64),
                _host_to(seg.numerics[f].exists, device, bool),
            ),
            charge=charge, category="doc_values",
        )
        # multi-value ordinal CSR for device range masks on keywords
        self.ordinals = _LazyDeviceMap(
            seg.ordinals,
            lambda f: (
                _host_to(seg.ordinals[f].mv_ords, device, np.int32),
                _host_to(seg.ordinals[f].mv_offsets, device, np.int32),
            ),
            charge=charge, category="doc_values",
        )
        self._adopt_charge = charge
        # bytes taken over from the previous generation (adopt_from)
        self.adopted_bytes = 0

    def adopt_from(self, other: "DeviceSegment") -> None:
        """Cross-generation reuse: a refresh appends segments but never
        mutates existing ones, so the NEW executor generation adopts the
        previous generation's device uploads for every already-uploaded
        field of this (same, immutable) segment instead of re-shipping
        them. Adopted bytes are re-charged to THIS executor's ledger
        records — the old executor's close() releases its own — so
        accounting stays per-generation while the tensors are shared."""
        for mine, theirs, cat in (
            (self.postings, other.postings, "postings"),
            (self.numerics, other.numerics, "doc_values"),
            (self.vectors, other.vectors, "vectors"),
            (self.ordinals, other.ordinals, "doc_values"),
        ):
            with theirs._lock:
                items = dict(theirs._cache)
            for k, v in items.items():
                if k in mine._names and k not in mine._cache:
                    mine._cache[k] = v
                    nbytes = _tree_nbytes(v)
                    self.adopted_bytes += nbytes
                    if self._adopt_charge is not None:
                        self._adopt_charge(cat, nbytes, False)


def _host_to(host, device, dtype) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(host, dtype=dtype)).to(device)


def _const_scores(mask: torch.Tensor, boost: float) -> torch.Tensor:
    """float32 `boost` where `mask`, else 0 (a constant-score leaf)."""
    return torch.where(mask, float(np.float32(boost)), 0.0).to(torch.float32)


class TorchExecutor:
    """Walks the query tree producing dense device (mask, scores) pairs.

    `device` defaults to "cuda": the CPU is used only when the caller
    asks for it. `fused_min_docs` is the segment size from which
    `fused_scorer` builds the fused route (FUSED_MIN_DOCS by default).
    `reuse_from`, the previous generation's executor, lends its uploads
    of the segments both generations share (DeviceSegment.adopt_from)."""

    def __init__(
        self,
        reader: ShardReader,
        k1: float = bm25.DEFAULT_K1,
        b: float = bm25.DEFAULT_B,
        device="cuda",
        fused_min_docs: int = FUSED_MIN_DOCS,
        reuse_from: "Optional[TorchExecutor]" = None,
    ):
        self.reader = reader
        self.k1 = k1
        self.b = b
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "TorchExecutor: device 'cuda' was asked for and no CUDA "
                "device is available (pass device='cpu' to run on the CPU)"
            )
        self.fused_min_docs = fused_min_docs
        # device-memory ledger integration: every upload is charged and
        # released when the executor is discarded; see common/memory.py
        self._charges: List[Tuple[str, int]] = []
        self._charges_lock = threading.Lock()
        self._closed = False
        # filter-bitset cache identity (set by IndexService._executor);
        # None disables the node-level cache (bare executors)
        self.cache_ctx = None
        self.device_segments = [
            DeviceSegment(s, self.device, charge=self._charge)
            for s in reader.segments
        ]
        if reuse_from is not None:
            # NRT generation lifecycle: segments are immutable and a
            # refresh only appends, so the new generation adopts the
            # old one's uploads for unchanged segments — the swap
            # re-uploads only the NEW segments' columns
            prev = {id(ds.seg): ds for ds in reuse_from.device_segments}
            for ds in self.device_segments:
                old = prev.get(id(ds.seg))
                if old is not None:
                    ds.adopt_from(old)
        # the oracle is reused for stats and term weights
        self._oracle = NumpyExecutor(reader, k1, b)
        self._inv_norm_cache: Dict[Tuple[int, str], torch.Tensor] = {}
        self._fused_scorers: Dict[Tuple[int, str], object] = {}
        self._fused_parts: Dict[Tuple[int, str], object] = {}
        self._fused_mf: Dict[Tuple[int, tuple], object] = {}
        self._id_maps: Dict[int, Dict[str, int]] = {}
        self._seg_weights: Dict[Tuple[int, str], np.ndarray] = {}
        self._df_maps: Dict[str, Dict[str, int]] = {}
        self._shard_dfs: Dict[Tuple[str, str], int] = {}
        self._block_indexes: Dict[Tuple[int, str], object] = {}
        self._chunked_scorers: Dict[Tuple[int, str], object] = {}
        self._live_masks: Dict[int, Optional[torch.Tensor]] = {}
        self._knn_masks: Dict[Tuple[int, str], torch.Tensor] = {}
        self._deleted_count: Optional[int] = None
        self._entry_docs_dev_cache: Dict[Tuple[int, str], Optional[torch.Tensor]] = {}
        # device-aggregations engine caches (search/aggs_device.py):
        # per-(segment, field) column exactness profiles plus the int32
        # offset / value-ordinal / permutation agg columns (charged to
        # the `aggs` ledger category, released with the executor on a
        # generation bump — exactly the invalidation the agg plans need)
        self._agg_profiles: Dict[Tuple[int, str], object] = {}
        self._agg_cols: Dict[tuple, object] = {}
        # learned-sparse serving (ops/impact.py, search/sparse.py):
        # per-(segment, field, storage mode) ImpactScorers over the
        # impact-ordered postings column, charged to the `impacts`
        # ledger category; a column that would not fit the budget is
        # served by the host dense oracle (None cached)
        self._impact_scorers: Dict[tuple, object] = {}
        # IVF indexes (ops/ivf.py) per (segment, field, build shape), and
        # sort-rank columns per (segment, field, desc): both charged to
        # the ledger and released with the executor (= generation)
        self._ann_indexes: Dict[tuple, object] = {}
        self._sort_rank_cache: Dict[tuple, tuple] = {}
        # shard-level rank_vectors columns per RerankModel (the rescore
        # phase's gather arrays), charged to the `rerank` ledger
        # category; a column that would not fit is cached as None
        self._rerank_columns: Dict[tuple, Optional[dict]] = {}
        # cache-miss builds are guarded so concurrent callers can't
        # duplicate a dense hot-row build; RLock because fused_scorer →
        # _inv_norm/_segment_weights nest
        self._build_lock = threading.RLock()

    def _to_device(self, host: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(host)).to(self.device)

    def _charge(
        self, category: str, nbytes: int, breaker: bool,
        precheck_only: bool = False,
    ) -> None:
        from ..common.memory import CircuitBreakingException, hbm_ledger

        if precheck_only:
            if breaker and nbytes and not hbm_ledger.would_fit(nbytes):
                hbm_ledger.stats_counters["tripped"] += 1
                raise CircuitBreakingException(
                    f"[hbm] Data too large for [{category}]: "
                    f"{nbytes} bytes would exceed the budget",
                    bytes_wanted=nbytes,
                    limit=hbm_ledger.budget,
                )
            return
        with self._charges_lock:
            if self._closed:
                # a caller kept using this executor after close(): don't
                # record bytes nobody will ever release
                return
            hbm_ledger.add(category, nbytes, breaker=False)
            self._charges.append((category, nbytes))

    def close(self) -> None:
        """Releases this executor's ledger charges (the tensors themselves
        are freed by PyTorch when the references die)."""
        from ..common.memory import hbm_ledger

        with self._charges_lock:
            self._closed = True
            charges, self._charges = self._charges, []
        for category, nbytes in charges:
            hbm_ledger.release(category, nbytes)

    def prewarm(self, settings=None) -> None:
        """Generation-lifecycle prewarm (the NRT refresher calls this
        right after a generation swap, BEFORE queries observe the new
        executor): uploads the serving-hot device columns and builds the
        per-generation serving caches — postings, inverse norms,
        block-max indexes and chunked scorers, vector columns, the IVF
        indexes (`index.knn.type: ivf`), the impact scorers and the
        rerank token columns — so the first query after a refresh pays
        neither uploads nor k-means. A column is skipped only when the
        ledger refuses it (breaker or degrade) or on an injected fault;
        any other error propagates (the reference swallows every
        exception here, which would hide a failed upload or build)."""
        from ..common.memory import CircuitBreakingException
        from ..index.mapping import RANK_VECTORS
        from ..models import rerank as rerank_model

        settings = settings or {}
        skippable = (CircuitBreakingException, InjectedFault)
        for si, seg in enumerate(self.reader.segments):
            n = seg.num_docs
            if n == 0:
                continue
            ds = self.device_segments[si]
            for fname in seg.postings:
                try:
                    ds.postings.get(fname)
                    self._inv_norm(si, fname, n)
                    self.block_index(si, fname)
                    self.chunked_scorer(si, fname)
                except skippable:
                    pass
            for fname in seg.vectors:
                try:
                    ds.vectors.get(fname)
                except skippable:
                    pass
        # IVF indexes and impact scorers degrade to None (cached) when
        # the ledger cannot fit them
        self.warm_ann(settings)
        self.warm_impacts(settings)
        for fname, mf in list(self.reader.mappings.fields.items()):
            if getattr(mf, "type", None) == RANK_VECTORS:
                model = rerank_model.resolve_model(
                    self.reader.mappings, settings, fname
                )
                if model is not None:
                    self.rerank_column(model)

    # ---- filter-context evaluation via the device bitset cache ----

    def filter_mask(self, q: Query, si: int) -> torch.Tensor:
        """Match mask of one filter-context clause on one segment. Cached
        bitsets are device `torch.bool` tensors (`query_cache` ledger
        category, one byte per doc) that the scoring functions consume
        directly — a hit skips the whole filter sub-tree."""
        ctx = self.cache_ctx
        if ctx is None or not dsl.is_cacheable_filter(q):
            return self._exec(q, si)[0]
        from .query_cache import filter_cache

        fkey = dsl.canonical_key(q)
        cached = filter_cache.get(ctx, si, fkey)
        if cached is not None:
            return cached
        mask = self._exec(q, si)[0].to(torch.bool)
        filter_cache.put(ctx, si, fkey, mask, int(mask.numel()))
        return mask

    def combined_filter_mask(self, fclauses, si: int) -> torch.Tensor:
        """AND of the (cached) filter bitsets and the resident live-docs
        mask — the live operand the fused and chunked scorers take."""
        mask = None
        for c in fclauses:
            m = self.filter_mask(c, si)
            mask = m if mask is None else (mask & m)
        live = self.live_mask(si)
        if live is not None:
            mask = live if mask is None else (mask & live)
        if mask is None:
            mask = torch.ones(
                self.reader.segments[si].num_docs, dtype=torch.bool, device=self.device
            )
        return mask

    # ---- bitset-masked plan serving (the filtered-bool route) ----

    def search_plan_filtered(
        self, stripped, fclauses, k: int, tth, mappings, analysis
    ) -> Optional[TopDocs]:
        """Serving path for a bool query whose filter clauses resolve to
        cached bitsets: the scoring part reduces to a flat Match/Serve
        plan and the combined bitset rides the scorers' live operand, so
        a warm cache skips filter evaluation entirely. None when the
        scoring part can't be planned (the caller takes the tree walk,
        which also consumes the cached bitsets)."""
        from .batcher import extract_match_plan, extract_serve_plan

        mplan = None
        splan = None
        if (
            isinstance(stripped, BoolQuery)
            and len(stripped.must) == 1
            and not stripped.should
            and stripped.boost == 1.0
            and isinstance(stripped.must[0], MatchQuery)
        ):
            # single-must match: the single-field fused/chunked engine
            # (with block-max pruning when totals are untracked)
            mplan = extract_match_plan(stripped.must[0], mappings, analysis, tth)
        if mplan is None:
            splan = extract_serve_plan(stripped, mappings, analysis)
            if splan is None:
                return None
        kb = 16 if k <= 16 else scoring.next_bucket(k, 16)
        cands: List[Tuple[float, int, int]] = []
        total = 0
        pruned = False
        for si, seg in enumerate(self.reader.segments):
            n = seg.num_docs
            if n == 0:
                continue
            base = self.combined_filter_mask(fclauses, si)
            if mplan is not None:
                got = self._match_segment_filtered(mplan, si, base, kb)
            else:
                got = self._serve_segment_filtered(splan, si, base, kb)
            if got is None:
                # small segment / slot overflow: dense scoring with the
                # bitset masked straight into the top-k
                mask, sc = self._exec(stripped, si)
                mask = mask & base
                s, d = scoring.topk_hits(sc, mask, min(kb, n))
                got = (s.cpu().numpy(), d.cpu().numpy(), int(mask.sum()), False)
            s, d, tot, seg_pruned = got
            pruned = pruned or seg_pruned
            total += tot
            finite = np.isfinite(s)
            for sc_, doc in zip(s[finite], d[finite]):
                cands.append((float(sc_), si, int(doc)))
        cands.sort(key=lambda c: (-c[0], c[1], c[2]))
        hits = [
            Hit(score=s, segment=si, local_doc=d, doc_id=self.reader.segments[si].doc_ids[d])
            for s, si, d in cands[:k]
        ]
        return TopDocs(
            total=total,
            hits=hits,
            max_score=hits[0].score if hits else None,
            # pruned tiles make the collected count a lower bound
            relation="gte" if pruned else "eq",
        )

    def _match_segment_filtered(self, plan, si: int, base, kb: int):
        """(scores[k], docs[k], total, pruned) for one MatchPlan on one
        segment, the filter bitset masking the scorers; None → dense
        fallback."""
        field = plan.field
        n = self.reader.segments[si].num_docs
        kk = min(kb, n)
        fs = self.fused_scorer(si, field)
        if fs is not None:
            fplan = self.fused_plan(fs, si, field, plan.terms, plan.boost, plan.msm)
            if fplan is not None:
                # single-request path: a 1-row launch
                s, d, tot = fs.search([fplan], kk, plan.msm > 1, live=base, rows=1)
                return s[0], d[0], int(tot[0]), False
        bmx = self.block_index(si, field)
        cs = self.chunked_scorer(si, field)
        if bmx is None or cs is None:
            return None
        # pruning only when totals are untracked: a term's doc_freq
        # can't prove >= cap FILTERED matches, so the unfiltered path's
        # capped-total shortcut is unsound here
        rp = bmx.row_plan(plan.terms, plan.boost, plan.wand_ok and plan.tth_cap == 0)
        tl, wl = rp.first()
        acc, cnt = cs.score_into(*cs.new_acc(plan.msm > 1, rows=1), [tl], [wl])
        pruned = False
        if rp.hot:
            theta, accmax = cs.threshold(acc, kk, live=base)
            # blocks with zero filter-passing docs can never contribute
            # a candidate — mask them out of the survival test
            bs = bmx.tiling.block_size
            nb = bmx.tiling.n_blocks
            padded = np.zeros(nb * bs, bool)
            padded[:n] = base.cpu().numpy()
            block_live = padded.reshape(nb, bs).any(axis=1)
            tl, wl, pruned = rp.kept(accmax[0], theta[0], block_live=block_live)
            acc, cnt = cs.score_into(acc, cnt, [tl], [wl])
        msm_arr = np.asarray([plan.msm], np.int32)
        s, d, tot = cs.finalize(acc, cnt, msm_arr, kk, live=base)
        return s[0], d[0], int(tot[0]), pruned

    def _serve_segment_filtered(self, plan, si: int, base, kb: int):
        """(scores[k], docs[k], total, pruned) for one ServePlan on one
        segment through the multi-field fused scorer with the bitset as
        its live operand; None → dense fallback."""
        n = self.reader.segments[si].num_docs
        fs = self.fused_scorer_mf(si, plan.fields)
        if fs is None:
            return None
        sections = []
        for g in plan.groups:
            parts = self.fused_parts(si, g.field)
            if parts is None:
                return None
            sec = self.fused_plan_field(si, g.field, parts, g.terms, plan.boost)
            if sec is None:
                return None
            sections.append(sec)
        s, d, tot = fs.search(
            [(sections, plan.msm)], min(kb, n), plan.combine, plan.tie, live=base, rows=1
        )
        return s[0], d[0], int(tot[0]), False

    # ---- per-(segment, field) dense inverse-norm array ----

    def _inv_norm_host(self, si: int, field: str, n: int) -> np.ndarray:
        cache = self._oracle._field_cache(field)  # DFS-aware
        pf = self.reader.segments[si].postings.get(field)
        mf = self.reader.mappings.get(field)
        if pf is None:
            return np.zeros(n, np.float32)
        if mf is not None and mf.type != TEXT:
            # omitted norms → encodedNorm 1 for every doc
            return np.full(n, cache[1], np.float32)
        return cache[pf.norms.astype(np.int64)]

    def _inv_norm(self, si: int, field: str, n: int) -> torch.Tensor:
        from .executor import DFS_NORM_CACHE, DFS_STATS

        dfs = DFS_STATS.get()
        if dfs is not None and field in dfs.get("fields", {}):
            # DFS avgdl differs from the shard's — cached per request
            # (DFS_NORM_CACHE contextvar) so each (segment, field) norm
            # array uploads at most once per request
            req_cache = DFS_NORM_CACHE.get()
            key = (id(self), si, field)
            if req_cache is not None:
                arr = req_cache.get(key)
                if arr is not None:
                    return arr
            arr = self._to_device(self._inv_norm_host(si, field, n))
            if req_cache is not None:
                req_cache[key] = arr
            return arr
        key = (si, field)
        arr = self._inv_norm_cache.get(key)
        if arr is None:
            with self._build_lock:
                arr = self._inv_norm_cache.get(key)
                if arr is not None:
                    return arr
                host = self._inv_norm_host(si, field, n)
                arr = self._to_device(host)
                self._charge("norms", int(host.nbytes), False)
                self._inv_norm_cache[key] = arr
        return arr

    # ---- entry point (mirrors NumpyExecutor.search) ----

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
        knn_sets = [self._knn_topk_global(sec) for sec in (knn or [])]
        device_pairs: List[Tuple[torch.Tensor, torch.Tensor]] = []
        for si, seg in enumerate(self.reader.segments):
            n = seg.num_docs
            if query is None and not knn_sets:
                q: Optional[Query] = MatchAllQuery()
            else:
                q = query
            mask, scores = self._exec(q, si) if q is not None else self._empty(n)
            for ks in knn_sets:
                kmask, kscores = ks[si]
                scores = torch.where(kmask, scores + kscores, scores)
                mask = mask | kmask
            live = self.live_mask(si)
            if live is not None:
                mask = mask & live
            if min_score is not None:
                mask = mask & (scores >= np.float32(min_score))
            device_pairs.append((mask, scores))
        per_segment: List[Tuple[np.ndarray, np.ndarray]] = [
            (m.cpu().numpy(), s.cpu().numpy()) for m, s in device_pairs
        ]

        # global collection (same ordering as the oracle): score desc,
        # (segment, doc) asc — vectorized over the matching docs only
        total = int(sum(m.sum() for m, _ in per_segment))
        cand_scores: List[np.ndarray] = []
        cand_seg: List[np.ndarray] = []
        cand_doc: List[np.ndarray] = []
        for si, (mask, scores) in enumerate(per_segment):
            idx = np.nonzero(mask)[0]
            if len(idx):
                cand_scores.append(scores[idx].astype(np.float64))
                cand_seg.append(np.full(len(idx), si, np.int64))
                cand_doc.append(idx.astype(np.int64))
        masks = [m for m, _ in per_segment]
        if not cand_scores:
            return TopDocs(total=total, hits=[], max_score=None), masks
        s = np.concatenate(cand_scores)
        sg = np.concatenate(cand_seg)
        dc = np.concatenate(cand_doc)
        need = from_ + size
        if need < len(s):
            part = np.argpartition(-s, need)[: need + 1]
            # keep enough candidates to break ties deterministically: take
            # everything scoring >= the partition's lowest kept score
            thresh = s[part].min()
            keep = np.nonzero(s >= thresh)[0]
            s, sg, dc = s[keep], sg[keep], dc[keep]
        order = np.lexsort((dc, sg, -s))
        max_score = float(s[order[0]])
        top = order[from_ : from_ + size]
        hits = [
            Hit(
                score=float(s[i]),
                segment=int(sg[i]),
                local_doc=int(dc[i]),
                doc_id=self.reader.segments[int(sg[i])].doc_ids[int(dc[i])],
            )
            for i in top
        ]
        return TopDocs(total=total, hits=hits, max_score=max_score), masks

    # ---- node dispatch ----

    def _empty(self, n: int) -> Tuple[torch.Tensor, torch.Tensor]:
        return (
            torch.zeros(n, dtype=torch.bool, device=self.device),
            torch.zeros(n, dtype=torch.float32, device=self.device),
        )

    def _exec(self, q: Query, si: int) -> Tuple[torch.Tensor, torch.Tensor]:
        n = self.reader.segments[si].num_docs
        if isinstance(q, MatchAllQuery):
            return (
                torch.ones(n, dtype=torch.bool, device=self.device),
                torch.full((n,), np.float32(q.boost), dtype=torch.float32, device=self.device),
            )
        if isinstance(q, MatchNoneQuery):
            return self._empty(n)
        if isinstance(q, MatchQuery):
            return self._exec_match(q, si)
        if isinstance(q, TermQuery):
            return self._exec_term(q, si)
        if isinstance(q, TermsQuery):
            return self._exec_terms(q, si)
        if isinstance(q, RangeQuery):
            return self._exec_range(q, si)
        if isinstance(q, BoolQuery):
            return self._exec_bool(q, si)
        if isinstance(q, ConstantScoreQuery):
            m = self.filter_mask(q.filter_query, si)
            return m, _const_scores(m, q.boost)
        if isinstance(q, MultiMatchQuery):
            return self._exec_multi_match(q, si)
        if isinstance(q, KnnQueryWrapper):
            return self._exec_knn_query(q.knn, si)
        if isinstance(q, IdsQuery):
            return self._exec_ids(q, si)
        if isinstance(q, MatchPhraseQuery):
            return self._exec_phrase(q, si)
        if isinstance(
            q, (dsl.PrefixQuery, dsl.WildcardQuery, dsl.RegexpQuery, dsl.FuzzyQuery)
        ):
            # constant-score rewrite: the dictionary expansion stays on
            # the host, the expanded terms score in one device pass
            return self._exec_expanded(q, si)
        if isinstance(q, DisMaxQuery):
            return self._exec_dis_max(q, si)
        # every other node is the oracle's host mask and scores, uploaded,
        # as the reference routes it: `exists` (cheap and static), a
        # `sparse_vector` inside a tree (the dense fp32 oracle; a bare one
        # rides the batcher's impact-tile family), function_score,
        # match_phrase_prefix, spans, more_like_this, geo, nested,
        # boosting, script, script_score, ...
        hm, hs = self._oracle._exec(q, self.reader.segments[si])
        return scoring.upload(hm, self.device), scoring.upload(hs, self.device)

    # ---- text leaves via the tile scorer ----

    def term_tiles(
        self, si: int, field: str, terms: List[str], boost: float
    ) -> Tuple[List[int], List[float]]:
        """Unpadded (tile indices, per-tile weights) for terms in one
        field of one segment — the host-side query plan the device eats."""
        pf = self.reader.segments[si].postings.get(field)
        tile_idx: List[int] = []
        tile_w: List[float] = []
        if pf is None:
            return tile_idx, tile_w
        for t in terms:
            tid = pf.term_id(t)
            if tid < 0:
                continue
            start = int(pf.term_tile_start[tid])
            count = int(pf.term_tile_count[tid])
            w = np.float32(boost) * np.float32(self._oracle._term_weight(field, t))
            tile_idx.extend(range(start, start + count))
            tile_w.extend([float(w)] * count)
        return tile_idx, tile_w

    def _field_terms_scored(
        self, si: int, field: str, terms: List[str], boost: float
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(scores, match_counts) for a list of terms in one field."""
        n = self.reader.segments[si].num_docs
        zeros = (
            torch.zeros(n, dtype=torch.float32, device=self.device),
            torch.zeros(n, dtype=torch.int32, device=self.device),
        )
        dp = self.device_segments[si].postings.get(field)
        if dp is None:
            return zeros
        tile_idx, tile_w = self.term_tiles(si, field, terms, boost)
        if not tile_idx:
            return zeros
        idx, w, v = scoring.pad_tiles(
            np.asarray(tile_idx, np.int32), np.asarray(tile_w, np.float32)
        )
        idx_t = scoring.upload(idx, self.device).long()
        return scoring.score_tiles(
            dp.doc_ids[idx_t],
            dp.tfs[idx_t],
            scoring.upload(w, self.device),
            scoring.upload(v, self.device),
            self._inv_norm(si, field, n),
            n,
        )

    def _exec_expanded(self, q, si: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """prefix/wildcard/regexp/fuzzy: host term-dictionary expansion,
        then the expanded terms score as one device pass (constant
        score)."""
        seg = self.reader.segments[si]
        if isinstance(q, dsl.FuzzyQuery):
            terms = self._oracle._fuzzy_terms(q, seg)
        else:
            terms = self._oracle._expand_terms(q, seg)
        if not terms:
            return self._empty(seg.num_docs)
        _, cnt = self._field_terms_scored(si, q.field, terms, 1.0)
        mask = cnt >= 1
        return mask, _const_scores(mask, q.boost)

    def _exec_phrase(self, q: MatchPhraseQuery, si: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """Phrase = device conjunction scoring + host position verify
        against the columnar position index (PositionsEnum analog): one
        device→host copy of the conjunction mask, the positions checked
        per candidate on the host, the verified mask uploaded. BM25
        weights stay on the device. A segment without positions takes
        the oracle's route, as in the reference."""
        from .executor import _phrase_match

        seg = self.reader.segments[si]
        n = seg.num_docs
        mf = self.reader.mappings.get(q.field)
        if mf is None or mf.type != TEXT:
            return self._empty(n)
        analyzer_name = q.analyzer or mf.search_analyzer or mf.analyzer
        qtoks = self.reader.analysis.get(analyzer_name).analyze(q.query)
        terms = [t.text for t in qtoks]
        if not terms:
            return self._empty(n)
        conj, scores = self._exec_match(
            MatchQuery(field=q.field, query=q.query, operator="and",
                       analyzer=analyzer_name, boost=q.boost),
            si,
        )
        pf = seg.postings.get(q.field)
        if pf is None or not pf.has_positions:
            _note_phrase("oracle")
            hm, hs = self._oracle._exec(q, seg)
            return scoring.upload(hm, self.device), scoring.upload(hs, self.device)
        t0 = time.perf_counter()
        cand = np.nonzero(conj.cpu().numpy())[0]
        qpos = [t.position for t in qtoks]
        rel = [p - qpos[0] for p in qpos]
        mask = np.zeros(n, bool)
        tids = [pf.term_id(t) for t in terms]
        for doc in cand:
            pos_of = {}
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
        _note_phrase("conjunction", len(cand), time.perf_counter() - t0)
        dmask = scoring.upload(mask, self.device)
        return dmask, torch.where(dmask, scores, 0.0)

    def _exec_match(self, q: MatchQuery, si: int) -> Tuple[torch.Tensor, torch.Tensor]:
        n = self.reader.segments[si].num_docs
        mf = self.reader.mappings.get(q.field)
        if mf is None:
            return self._empty(n)
        if mf.type != TEXT:
            # match on keyword/numeric is a term query (ES behavior)
            return self._exec_term(TermQuery(field=q.field, value=q.query, boost=q.boost), si)
        analyzer_name = q.analyzer or mf.search_analyzer or mf.analyzer
        terms = self.reader.analysis.get(analyzer_name).terms(q.query)
        if not terms:
            return self._empty(n)
        scores, cnt = self._field_terms_scored(si, q.field, terms, q.boost)
        if q.operator == "and":
            mask = cnt >= len(terms)
        else:
            msm = max(1, dsl.parse_minimum_should_match(q.minimum_should_match, len(terms)))
            mask = cnt >= msm
        return mask, torch.where(mask, scores, 0.0)

    # ---- filter-context leaves ----

    def _id_map(self, si: int) -> Dict[str, int]:
        """_id → local doc map per segment (built once; the analog of
        Lucene's per-segment terms dict on the _id field)."""
        m = self._id_maps.get(si)
        if m is None:
            m = {d: i for i, d in enumerate(self.reader.segments[si].doc_ids)}
            self._id_maps[si] = m
        return m

    def _ids_mask(self, si: int, values) -> torch.Tensor:
        mask = np.zeros(self.reader.segments[si].num_docs, bool)
        idmap = self._id_map(si)
        for v in values:
            loc = idmap.get(str(v))
            if loc is not None:
                mask[loc] = True
        return scoring.upload(mask, self.device)

    def _exec_ids(self, q, si: int) -> Tuple[torch.Tensor, torch.Tensor]:
        m = self._ids_mask(si, q.values)
        return m, _const_scores(m, q.boost)

    def _exec_term(self, q: TermQuery, si: int) -> Tuple[torch.Tensor, torch.Tensor]:
        n = self.reader.segments[si].num_docs
        mf = self.reader.mappings.get(q.field)
        if q.field == "_id":
            m = self._ids_mask(si, [q.value])
            return m, _const_scores(m, q.boost)
        if mf is None:
            return self._empty(n)
        if mf.type in (TEXT, KEYWORD):
            value = q.value
            if isinstance(value, bool):
                value = "true" if value else "false"
            scores, cnt = self._field_terms_scored(si, q.field, [str(value)], q.boost)
            mask = cnt >= 1
            return mask, torch.where(mask, scores, 0.0)
        dn = self.device_segments[si].numerics.get(q.field)
        if dn is None:
            return self._empty(n)
        values, exists = dn
        mask = exists & (values == _coerce_numeric(mf.type, q.value))
        return mask, _const_scores(mask, q.boost)

    def _exec_terms(self, q: TermsQuery, si: int) -> Tuple[torch.Tensor, torch.Tensor]:
        n = self.reader.segments[si].num_docs
        mf = self.reader.mappings.get(q.field)
        if q.field != "_id" and mf is not None and mf.type in (TEXT, KEYWORD):
            # one combined scoring call for all values (constant-score,
            # so only the match counts matter)
            vals = [
                ("true" if v else "false") if isinstance(v, bool) else str(v)
                for v in q.values
            ]
            _, cnt = self._field_terms_scored(si, q.field, vals, 1.0)
            mask = cnt >= 1
            return mask, _const_scores(mask, q.boost)
        if q.field != "_id" and mf is not None:
            dn = self.device_segments[si].numerics.get(q.field)
            if dn is None:
                return self._empty(n)
            values, exists = dn
            targets = np.array([_coerce_numeric(mf.type, v) for v in q.values], np.float64)
            mask = exists & torch.isin(values, scoring.upload(targets, self.device))
            return mask, _const_scores(mask, q.boost)
        m = torch.zeros(n, dtype=torch.bool, device=self.device)
        for v in q.values:
            m = m | self._exec_term(TermQuery(field=q.field, value=v), si)[0]
        return m, _const_scores(m, q.boost)

    def _exec_range(self, q: RangeQuery, si: int) -> Tuple[torch.Tensor, torch.Tensor]:
        seg = self.reader.segments[si]
        n = seg.num_docs
        mf = self.reader.mappings.get(q.field)
        if mf is None:
            return self._empty(n)
        if mf.type in (TEXT, KEYWORD):
            # host bisect on the sorted ord dictionary picks [lo, hi);
            # the multi-value CSR membership count runs on the device
            of = seg.ordinals.get(q.field)
            dof = self.device_segments[si].ordinals.get(q.field)
            if of is None or dof is None:
                return self._empty(n)
            import bisect

            terms = of.ord_terms
            lo, hi = 0, len(terms)
            if q.gte is not None:
                lo = bisect.bisect_left(terms, str(q.gte))
            if q.gt is not None:
                lo = max(lo, bisect.bisect_right(terms, str(q.gt)))
            if q.lte is not None:
                hi = min(hi, bisect.bisect_right(terms, str(q.lte)))
            if q.lt is not None:
                hi = min(hi, bisect.bisect_left(terms, str(q.lt)))
            mv_ords, mv_offsets = dof
            in_range = ((mv_ords >= lo) & (mv_ords < hi)).to(torch.int32)
            csum = torch.cat([
                torch.zeros(1, dtype=torch.int32, device=self.device),
                torch.cumsum(in_range, dim=0, dtype=torch.int32),
            ])
            offs = mv_offsets.long()
            mask = (csum[offs[1:]] - csum[offs[:-1]]) > 0
            return mask, _const_scores(mask, q.boost)
        dn = self.device_segments[si].numerics.get(q.field)
        if dn is None:
            return self._empty(n)
        values, exists = dn
        mask = exists
        # float64 bounds against float64 values: exact at millisecond
        # precision for dates
        conv = parse_date_millis if mf.type == DATE else float
        if q.gte is not None:
            mask = mask & (values >= float(conv(q.gte)))
        if q.gt is not None:
            mask = mask & (values > float(conv(q.gt)))
        if q.lte is not None:
            mask = mask & (values <= float(conv(q.lte)))
        if q.lt is not None:
            mask = mask & (values < float(conv(q.lt)))
        return mask, _const_scores(mask, q.boost)

    # ---- compound nodes ----

    def _exec_bool(self, q: BoolQuery, si: int) -> Tuple[torch.Tensor, torch.Tensor]:
        n = self.reader.segments[si].num_docs
        mask = torch.ones(n, dtype=torch.bool, device=self.device)
        scores = torch.zeros(n, dtype=torch.float32, device=self.device)
        for c in q.must:
            m, s = self._exec(c, si)
            mask = mask & m
            scores = scores + s
        for c in q.filter:
            mask = mask & self.filter_mask(c, si)
        if q.should:
            sscores = torch.zeros(n, dtype=torch.float32, device=self.device)
            match_count = torch.zeros(n, dtype=torch.int32, device=self.device)
            for c in q.should:
                m, s = self._exec(c, si)
                sscores = sscores + torch.where(m, s, 0.0)
                match_count = match_count + m.to(torch.int32)
            default_msm = 0 if (q.must or q.filter) else 1
            msm = (
                dsl.parse_minimum_should_match(q.minimum_should_match, len(q.should))
                if q.minimum_should_match is not None
                else default_msm
            )
            if msm > 0:
                mask = mask & (match_count >= msm)
            scores = scores + torch.where(match_count > 0, sscores, 0.0)
        for c in q.must_not:
            mask = mask & ~self._exec(c, si)[0]
        if q.boost != 1.0:
            scores = scores * float(np.float32(q.boost))
        return mask, torch.where(mask, scores, 0.0)

    def _exec_multi_match(self, q: MultiMatchQuery, si: int) -> Tuple[torch.Tensor, torch.Tensor]:
        n = self.reader.segments[si].num_docs
        fields = expand_match_fields(self.reader.mappings, q.fields)
        if not fields:
            return self._empty(n)
        per_field = [
            self._exec_phrase(
                MatchPhraseQuery(field=fn, query=q.query, boost=q.boost * fb), si
            )
            if q.type == "phrase"
            else self._exec_match(
                MatchQuery(field=fn, query=q.query, operator=q.operator, boost=q.boost * fb), si
            )
            for fn, fb in fields
        ]
        mask = torch.stack([m for m, _ in per_field]).any(dim=0)
        score_mat = torch.stack([s for _, s in per_field])
        if q.type == "best_fields":
            best = score_mat.amax(dim=0)
            if q.tie_breaker:
                rest = score_mat.sum(dim=0) - best
                total = best + float(np.float32(q.tie_breaker)) * rest
            else:
                total = best
        else:
            total = score_mat.sum(dim=0)
        return mask, torch.where(mask, total, 0.0)

    def _exec_dis_max(self, q, si: int) -> Tuple[torch.Tensor, torch.Tensor]:
        masks, scores = [], []
        for sub in q.queries:
            m, s = self._exec(sub, si)
            masks.append(m)
            scores.append(torch.where(m, s, 0.0))
        mask = torch.stack(masks).any(dim=0)
        mat = torch.stack(scores)
        best = mat.amax(dim=0)
        total = best + float(np.float32(q.tie_breaker)) * (mat.sum(dim=0) - best)
        return mask, torch.where(mask, total * float(np.float32(q.boost)), 0.0)

    # ---- knn (device matmul + global top-k cut) ----

    def _knn_candidates(self, sec: KnnSection, si: int) -> torch.Tensor:
        """exists ∧ live (resident) ∧ the section's filter bitset."""
        mask = self.knn_candidates(si, sec.field)
        if sec.filter is not None:
            mask = mask & self.filter_mask(sec.filter, si)
        return mask

    def live_mask(self, si: int) -> Optional[torch.Tensor]:
        """Device bool[n] live-docs mask of one segment (None = no
        deletes), uploaded once per executor (= reader generation)."""
        if si not in self._live_masks:
            with self._build_lock:
                if si not in self._live_masks:
                    live = self.reader.live_docs[si]
                    t = None if live is None else self._to_device(live)
                    if t is not None:
                        self._charge("masks", _tree_nbytes(t), False)
                    self._live_masks[si] = t
        return self._live_masks[si]

    def knn_candidates(self, si: int, field: str) -> torch.Tensor:
        """Device bool[n] exists ∧ live mask of one (segment, vector
        field), uploaded once per executor (= reader generation), so a
        kNN group uploads no per-doc mask."""
        key = (si, field)
        mask = self._knn_masks.get(key)
        if mask is None:
            with self._build_lock:
                mask = self._knn_masks.get(key)
                if mask is None:
                    vf = self.reader.segments[si].vectors[field]
                    host = np.asarray(vf.exists, bool)
                    live = self.reader.live_docs[si]
                    if live is not None:
                        host = host & np.asarray(live, bool)
                    mask = self._to_device(host)
                    self._charge("masks", _tree_nbytes(mask), False)
                    self._knn_masks[key] = mask
        return mask

    def _query_vector(self, sec: KnnSection) -> torch.Tensor:
        """The section's query row, [1, d], through a pinned upload that
        does not wait for the device."""
        return scoring.upload(np.asarray(sec.query_vector, np.float32)[None, :], self.device)

    def _exec_knn_query(self, sec: KnnSection, si: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """knn-as-a-query-node: per-segment num_candidates cut (mirrors
        NumpyExecutor._exec_knn), fully on device."""
        n = self.reader.segments[si].num_docs
        dv = self.device_segments[si].vectors.get(sec.field)
        if dv is None:
            return self._empty(n)
        vectors, _exists = dv
        vf = self.reader.segments[si].vectors[sec.field]
        scores = scoring.knn_scores(self._query_vector(sec), vectors, vf.similarity)[0]
        mask = self._knn_candidates(sec, si)
        if sec.similarity is not None:
            mask = mask & (scores >= np.float32(sec.similarity))
        cand = min(sec.num_candidates, n)
        masked = torch.where(mask, scores, -torch.inf)
        kth = scoring.topk_desc(masked, cand)[0][-1]
        # when fewer than `cand` docs match, kth is -inf and cuts nothing
        # (same as the oracle's "only cut if cand < matches" branch)
        mask = mask & (masked >= kth)
        out = scores * np.float32(sec.boost)
        return mask, torch.where(mask, out, 0.0)

    def _knn_topk_global(self, sec: KnnSection) -> List[Tuple[torch.Tensor, torch.Tensor]]:
        """Per-segment candidates (num_candidates each: brute force, or
        the IVF probe when the section carries an AnnSpec), then the
        shard-wide k cut (score desc, (segment, doc) asc). Only an
        injected `ann.probe` fault or a device-memory degrade sends an
        IVF segment to the exact path; any other error fails the
        request."""
        spec = getattr(sec, "ann", None)
        per_seg = []
        q = None
        for si, seg in enumerate(self.reader.segments):
            if seg.vectors.get(sec.field) is None:
                per_seg.append(None)
                continue
            if q is None:
                q = self._query_vector(sec)
            vf = seg.vectors[sec.field]
            cand_mask = self._knn_candidates(sec, si)
            k = min(sec.num_candidates, seg.num_docs)
            idx = None
            if spec is not None:
                try:
                    faults.check("ann.probe", field=sec.field, segment=si)
                except InjectedFault:
                    ann_mod.note("exact_fallbacks")
                else:
                    idx = self.ann_index(si, sec.field, spec)
            if idx is not None:
                top_s, top_d = ivf.ann_topk_batch(
                    idx, q, torch.ones(1, dtype=torch.bool, device=self.device),
                    cand_mask, spec.nprobe, k, quantized=spec.quantized,
                )
                ann_mod.note_search(spec.nprobe, idx.nlist)
            else:
                vectors, _exists = self.device_segments[si].vectors[sec.field]
                top_s, top_d = scoring.knn_topk(q, vectors, cand_mask, vf.similarity, k)
            per_seg.append((top_s[0].cpu().numpy(), top_d[0].cpu().numpy()))
        # global k cut across segments
        entries = []
        for si, item in enumerate(per_seg):
            if item is None:
                continue
            for s, d in zip(*item):
                if np.isfinite(s) and (
                    sec.similarity is None or s >= sec.similarity
                ):
                    entries.append((-float(s), si, int(d)))
        entries.sort()
        keep = sorted(entries[: sec.k], key=lambda e: e[1])  # by segment
        # the kept (doc, score) pairs of every segment go up in ONE pinned
        # upload (int32 docs, float32 scores bitcast) and are scattered
        # into zeros on the device; scores are the host's float32 values
        packed = np.empty((2, len(keep)), np.int32)
        packed[0] = [d for _, _, d in keep]
        packed[1].view(np.float32)[:] = [-negs * sec.boost for negs, _, _ in keep]
        dev = scoring.upload(packed, self.device) if keep else None
        seg_of = np.asarray([ksi for _, ksi, _ in keep], np.int64)
        out = []
        for si, seg in enumerate(self.reader.segments):
            mask, scores = self._empty(seg.num_docs)
            lo, hi = np.searchsorted(seg_of, [si, si + 1])
            if hi > lo:
                # index_fill_/index_copy_ take the fill value as a kernel
                # argument: `mask[docs] = True` would copy the scalar up
                # from pageable memory
                docs = dev[0, lo:hi].long()
                mask.index_fill_(0, docs, True)
                scores.index_copy_(0, docs, dev[1, lo:hi].view(torch.float32))
            out.append((mask, scores))
        return out

    # ---- serving-path scorer plumbing (batched match route) ----

    def _segment_weights(self, si: int, field: str) -> np.ndarray:
        """float32[n_terms] SHARD-level BM25 idf per local term id of one
        segment (IndexSearcher.collectionStatistics — same stats the
        per-query path uses, so batched scores match the oracle)."""
        key = (si, field)
        w = self._seg_weights.get(key)
        if w is None:
            with self._build_lock:
                w = self._seg_weights.get(key)
                if w is not None:
                    return w
                pf = self.reader.segments[si].postings[field]
                dc, _ = self.reader.field_stats(field)
                if len(self.reader.segments) == 1:
                    df = pf.term_df.astype(np.float64)
                else:
                    dfmap = self._df_map(field)
                    df = np.array([dfmap.get(t, 0) for t in pf.terms], np.float64)
                # same float path as bm25.idf (float64 math, float32 result)
                w = np.float32(np.log(1.0 + (dc - df + 0.5) / (df + 0.5)))
                self._seg_weights[key] = w
        return w

    def _df_map(self, field: str) -> Dict[str, int]:
        m = self._df_maps.get(field)
        if m is None:
            with self._build_lock:
                m = self._df_maps.get(field)
                if m is not None:
                    return m
                m = {}
                for seg in self.reader.segments:
                    pf = seg.postings.get(field)
                    if pf is not None:
                        for t, d in zip(pf.terms, pf.term_df.tolist()):
                            m[t] = m.get(t, 0) + int(d)
                self._df_maps[field] = m
        return m

    def shard_df(self, field: str, term: str) -> int:
        key = (field, term)
        df = self._shard_dfs.get(key)
        if df is None:
            df, _ = self.reader.term_stats(field, term)
            self._shard_dfs[key] = df
        return df

    @property
    def deleted_count(self) -> int:
        if self._deleted_count is None:
            self._deleted_count = int(
                sum(int((~l).sum()) for l in self.reader.live_docs if l is not None)
            )
        return self._deleted_count

    def block_index(self, si: int, field: str):
        """Cached BlockMaxIndex (shard-level stats over the segment's
        block-aligned tiling, on this executor's device) — None when the
        field has no postings."""
        key = (si, field)
        if key in self._block_indexes:
            return self._block_indexes[key]
        with self._build_lock:
            if key in self._block_indexes:
                return self._block_indexes[key]
            from ..ops.wand import BlockMaxIndex, get_tiling

            seg = self.reader.segments[si]
            pf = seg.postings.get(field)
            if pf is None:
                bmx = None  # cache the miss: no re-lock per batch
            else:
                tiling = get_tiling(pf, seg.num_docs, device=self.device)
                bmx = BlockMaxIndex(
                    tiling,
                    self._segment_weights(si, field),
                    self._oracle._field_cache(field),
                )
            self._block_indexes[key] = bmx
            return bmx

    def chunked_scorer(self, si: int, field: str):
        """Cached ChunkedScorer over the block-aligned tiling of one
        segment (the batcher's engine for small segments)."""
        key = (si, field)
        if key in self._chunked_scorers:
            return self._chunked_scorers[key]
        with self._build_lock:
            if key in self._chunked_scorers:
                return self._chunked_scorers[key]
            bmx = self.block_index(si, field)
            if bmx is None:
                cs = None  # cache the miss: no re-lock per batch
            else:
                seg = self.reader.segments[si]
                cs = scoring.ChunkedScorer(
                    bmx.tiling.doc_ids,
                    bmx.tiling.tfs,
                    self._inv_norm(si, field, seg.num_docs),
                    self.live_mask(si),
                    block_size=bmx.tiling.block_size,
                )
            self._chunked_scorers[key] = cs
            return cs

    def segment_topk(self, query: Query, si: int, k: int):
        """(scores[k], docs[k], total) host arrays for one parsed query
        on one segment — the per-segment fallback of a batcher group."""
        seg = self.reader.segments[si]
        n = seg.num_docs
        if n == 0:
            return np.zeros(0, np.float32), np.zeros(0, np.int32), 0
        mask, scores = self._exec(query, si)
        live = self.live_mask(si)
        if live is not None:
            mask = mask & live
        s, d = scoring.topk_hits(scores, mask, min(k, n))
        total = int(mask.sum())
        return s.cpu().numpy(), d.to(torch.int32).cpu().numpy(), total

    def fused_scorer(self, si: int, field: str):
        """Cached single-round-trip FusedScorer for one large segment.
        None for segments below `fused_min_docs` or fields without
        postings."""
        key = (si, field)
        if key in self._fused_scorers:
            return self._fused_scorers[key]
        with self._build_lock:
            if key in self._fused_scorers:
                return self._fused_scorers[key]
            parts = self.fused_parts(si, field)
            fs = None
            if parts is not None:
                fs = scoring.FusedScorer(
                    parts["doc_ids"],
                    parts["tfs"],
                    parts["inv_norm"],
                    self.live_mask(si),
                    parts["dense"],
                )
                fs.hot_rank = parts["hot_rank"]
            self._fused_scorers[key] = fs
            return fs

    def fused_parts(self, si: int, field: str):
        """Cached per-(segment, field) device tensors for fused scoring:
        dict(doc_ids, tfs, inv_norm, dense, hot_rank), or None when the
        field has no postings / the segment is below fused_min_docs."""
        key = (si, field)
        if key in self._fused_parts:
            return self._fused_parts[key]
        with self._build_lock:
            if key in self._fused_parts:
                return self._fused_parts[key]
            parts = self._fused_parts_build(si, field)
            self._fused_parts[key] = parts
            return parts

    def fused_scorer_mf(self, si: int, fields: tuple):
        """Cached MultiFusedScorer over one segment and a field tuple
        (the bool / multi_match serving engine), sharing each field's
        fused parts (dense rows are built once per field); None when any
        field lacks parts."""
        key = (si, tuple(fields))
        if key in self._fused_mf:
            return self._fused_mf[key]
        with self._build_lock:
            if key in self._fused_mf:
                return self._fused_mf[key]
            parts = [self.fused_parts(si, f) for f in fields]
            fs = None
            if all(p is not None for p in parts):
                fs = scoring.MultiFusedScorer(fields, parts, self.live_mask(si))
            self._fused_mf[key] = fs
            return fs

    def fused_plan_field(self, si: int, field: str, parts, terms_flagged, boost: float):
        """One field's section of a MultiFusedScorer plan: (rare_tiles,
        rare_w_signed, hot_ranks, hot_w_signed). The weight's sign says
        whether a term counts toward the match threshold (positive =
        counted). terms_flagged: [(term, term_boost, counted)]. None on
        a slot-budget overflow or a negative weight (the tree walk
        serves those)."""
        pf = self.reader.segments[si].postings.get(field)
        if pf is None:
            return (
                np.empty(0, np.int64), np.empty(0, np.float32),
                np.empty(0, np.int64), np.empty(0, np.float32),
            )
        weights = self._segment_weights(si, field)
        rt: list = []
        rw: list = []
        hr: list = []
        hw: list = []
        for t, tb, counted in terms_flagged:
            tid = pf.term_id(t)
            if tid < 0:
                continue
            w = float(weights[tid]) * boost * tb
            if w < 0.0:
                # a negative weight would corrupt the sign-encoded count
                # flag — the exact path handles it
                return None
            if w == 0.0:
                # a zero weight can't carry the flag in its sign; nudge
                # it to a tiny normal float32 so counted terms still
                # count (the score contribution is ~0 either way)
                w = 1e-30
            if not counted:
                w = -w
            r = parts["hot_rank"].get(tid)
            if r is not None:
                hr.append(r)
                hw.append(w)
            else:
                s0 = int(pf.term_tile_start[tid])
                c = int(pf.term_tile_count[tid])
                rt.extend(range(s0, s0 + c))
                rw.extend([w] * c)
        if len(rt) > scoring.FUSED_T_RARE or len(hr) > scoring.FUSED_H:
            return None
        return (
            np.asarray(rt, np.int64),
            np.asarray(rw, np.float32),
            np.asarray(hr, np.int64),
            np.asarray(hw, np.float32),
        )

    def _fused_parts_build(self, si: int, field: str):
        seg = self.reader.segments[si]
        pf = seg.postings.get(field)
        if pf is None or seg.num_docs < self.fused_min_docs:
            return None
        n = seg.num_docs
        dp = self.device_segments[si].postings[field]
        n_terms = len(pf.terms)
        # per-term max tf (dense rows are uint8: terms with a larger tf
        # anywhere stay sparse for exactness)
        counts = pf.term_tile_count.astype(np.int64)
        starts = pf.term_tile_start.astype(np.int64)
        tile_of = (
            np.arange(int(counts.sum()), dtype=np.int64)
            - np.repeat(np.cumsum(counts) - counts, counts)
            + np.repeat(starts, counts)
        )
        term_of_tile = np.repeat(np.arange(n_terms, dtype=np.int64), counts)
        term_max_tf = np.zeros(n_terms, np.int64)
        np.maximum.at(term_max_tf, term_of_tile, pf.tile_max_tf[tile_of])
        hot_mask = (pf.term_df.astype(np.int64) >= max(1024, n // 128)) & (
            term_max_tf <= scoring.DENSE_TF_MAX
        )
        hot_ids = np.nonzero(hot_mask)[0]
        # device-memory budget for dense rows (uint8 per doc per hot term):
        # the static per-field cap AND the live ledger — when memory is
        # tight the fused path degrades to sparse tiles (an optimization
        # lost, not correctness) and counts it
        from ..common.memory import hbm_ledger

        max_hot = max(0, DENSE_ROWS_HBM_BUDGET // max(n, 1))
        headroom = max(0, hbm_ledger.budget - hbm_ledger.used)
        max_hot = min(max_hot, headroom // max(n + 1, 1))
        if len(hot_ids) > max_hot:
            order = np.argsort(-pf.term_df[hot_ids])
            hot_ids = np.sort(hot_ids[order[:max_hot]])
            hbm_ledger.note_degraded()
        if len(hot_ids):
            sel = np.isin(term_of_tile, hot_ids)
            hot_tiles = tile_of[sel]
            rank_map = {int(t): r for r, t in enumerate(hot_ids)}
            rank_of_tile = np.array(
                [rank_map[int(t)] for t in term_of_tile[sel]], np.int32
            )
            dense = scoring.build_dense_rows(
                dp.doc_ids,
                dp.tfs,
                self._to_device(hot_tiles.astype(np.int32)),
                self._to_device(rank_of_tile),
                n_hot=len(hot_ids),
                n_docs=n,
            )
            self._charge("dense_rows", _tree_nbytes(dense), False)
            hot_rank = rank_map
        else:
            dense = None
            hot_rank = {}
        return {
            "doc_ids": dp.doc_ids,
            "tfs": dp.tfs,
            "inv_norm": self._inv_norm(si, field, n),
            "dense": dense,
            "hot_rank": hot_rank,
        }

    def fused_plan(self, fs, si: int, field: str, terms, boost: float, msm: int):
        """(rare_tiles, rare_w, hot_ranks, hot_w, msm) for FusedScorer,
        or None when the query overflows the fixed slot budgets."""
        pf = self.reader.segments[si].postings[field]
        weights = self._segment_weights(si, field)
        rt: list = []
        rw: list = []
        hr: list = []
        hw: list = []
        for t in terms:
            tid = pf.term_id(t)
            if tid < 0:
                continue
            w = float(weights[tid]) * boost
            r = fs.hot_rank.get(tid)
            if r is not None:
                hr.append(r)
                hw.append(w)
            else:
                s0 = int(pf.term_tile_start[tid])
                c = int(pf.term_tile_count[tid])
                rt.extend(range(s0, s0 + c))
                rw.extend([w] * c)
        if len(rt) > fs.t_rare or len(hr) > fs.n_hot_slots:
            return None
        return (
            np.asarray(rt, np.int64),
            np.asarray(rw, np.float32),
            np.asarray(hr, np.int64),
            np.asarray(hw, np.float32),
            msm,
        )

    # ---- learned-sparse impact columns (ops/impact.py scorers) ----

    def impact_scorer(self, si: int, field: str, quantized: bool):
        """Cached ops/impact.ImpactScorer over one segment's
        impact-ordered sparse postings column — the int8 qweights plane
        or the fp32 weights plane, chosen per SparseSpec — or None when
        the segment has no such column or the upload would not fit the
        device-memory budget (the host dense oracle serves it then).
        Charged to the `impacts` category and cached per executor
        generation, like the agg tables."""
        key = ("sparse", si, field, bool(quantized))
        if key in self._impact_scorers:
            return self._impact_scorers[key]
        with self._build_lock:
            if key in self._impact_scorers:
                return self._impact_scorers[key]
            from ..common.memory import hbm_ledger
            from ..ops import impact as impact_ops
            from . import sparse as sparse_mod

            seg = self.reader.segments[si]
            sf = (getattr(seg, "sparse", None) or {}).get(field)
            sc = None
            if sf is not None and seg.num_docs and sf.n_tiles:
                vals = sf.qweights if quantized else sf.weights
                est = int(sf.doc_ids.nbytes + vals.nbytes)
                if not hbm_ledger.would_fit(est):
                    hbm_ledger.note_degraded()
                else:
                    sc = impact_ops.ImpactScorer(
                        sf.doc_ids, vals, seg.num_docs, self.live_mask(si),
                        device=self.device,
                    )
                    self._charge("impacts", est, False)
                    # the int8 compression headline: the value plane
                    # uploaded vs the same plane at fp32 (doc-id planes
                    # are identical either way — see ledger_bytes)
                    sparse_mod.note("impact_bytes", int(vals.nbytes))
                    sparse_mod.note("impact_fp32_equivalent_bytes", int(sf.weights.nbytes))
            self._impact_scorers[key] = sc
            return sc

    def warm_impacts(self, settings) -> None:
        """Uploads every segment's sparse columns in the index's storage
        mode (`sparse.quantization`) when the executor is built, so the
        first `sparse_vector` request after a refresh pays no upload
        (the reference does this in its generation prewarm)."""
        quant = str(settings.get("sparse.quantization", "int8")) == "int8"
        for si, seg in enumerate(self.reader.segments):
            if seg.num_docs:
                for fname in getattr(seg, "sparse", None) or {}:
                    self.impact_scorer(si, fname, quant)

    # ---- IVF ANN tier (ops/ivf.py): per-segment cluster indexes ----

    def ann_index(self, si: int, field: str, spec):
        """Cached IvfSegmentIndex for one segment's vector column under
        one build shape (spec.nlist / spec.quantized), or None when the
        segment stays exact: below the small-segment floor, no vectors,
        or the device-memory ledger can't fit the build (degrade, never
        trip). Built once per executor generation — a refresh/merge that
        touches the shard regenerates the executor, which re-clusters
        exactly like the agg tables re-profile."""
        seg = self.reader.segments[si]
        n = seg.num_docs
        key = (si, field, int(spec.nlist), bool(spec.quantized), int(spec.min_docs))
        if key in self._ann_indexes:
            return self._ann_indexes[key]
        with self._build_lock:
            if key in self._ann_indexes:
                return self._ann_indexes[key]
            from ..common.memory import hbm_ledger

            idx = None
            vf = seg.vectors.get(field)
            if vf is not None and n >= max(spec.min_docs, 2):
                mat = (
                    vf.unit_vectors
                    if vf.similarity == "cosine" and vf.unit_vectors is not None
                    else vf.vectors
                )
                nlist = spec.nlist or ivf.auto_nlist(n)
                nlist = max(1, min(nlist, n))
                est = ivf.IvfSegmentIndex.estimate_nbytes(
                    n, int(mat.shape[1]), nlist, spec.quantized,
                    itemsize=mat.dtype.itemsize,
                )
                if not hbm_ledger.would_fit(est):
                    hbm_ledger.note_degraded()
                else:
                    # deterministic seed: a pure function of the build
                    # shape, so re-runs reproduce the same centroids
                    # bit for bit
                    seed = (si * 2654435761 + n * 97 + nlist) & 0x7FFFFFFF
                    idx = ivf.IvfSegmentIndex(
                        mat, vf.similarity, nlist, seed,
                        quantized=spec.quantized, device=self.device,
                    )
                    self._charge("ann", idx.nbytes, False)
                    ann_mod.note_build(idx.build_ms)
            elif vf is not None and n:
                ann_mod.note("small_segment_exact")
            self._ann_indexes[key] = idx
            return idx

    def warm_ann(self, settings) -> None:
        """Builds every segment's IVF index in the index's build shape
        when the executor is built (an index with `knn.type: ivf`), so
        k-means runs with the generation, not inside its first kNN
        request (the reference does this in its generation prewarm)."""
        spec = ann_mod.resolve(settings, SimpleNamespace(nprobe=None), False)
        if spec is None:
            return
        for si, seg in enumerate(self.reader.segments):
            if seg.num_docs:
                for fname in seg.vectors:
                    self.ann_index(si, fname, spec)

    # ---- second-stage rerank column (flat rank_vectors gather arrays) ----

    def rerank_column(self, model) -> Optional[dict]:
        """Device-resident shard-level `rank_vectors` column for one
        RerankModel: per-doc CSR bounds over the GLOBAL doc encoding
        (segment base + local doc, the bases rescorer.build_plan uses)
        plus the flat token matrix, tail-padded with `tmax` zero rows so
        the maxsim gather never reads out of bounds. int8 models store
        quantized rows and per-token scales
        (models/rerank.quantize_tokens). Uploaded through pinned copies
        and charged to the `rerank` ledger category. A column that would
        not fit the device-memory budget degrades to SKIP (None is
        cached and returned; the first-stage ranking stands), as in the
        reference. Cached per executor (= reader generation)."""
        key = ("rerank", model)
        if key in self._rerank_columns:
            return self._rerank_columns[key]
        with self._build_lock:
            if key in self._rerank_columns:
                return self._rerank_columns[key]
            from ..common.memory import hbm_ledger
            from ..models import rerank as rerank_model

            n_total = sum(s.num_docs for s in self.reader.segments)
            starts = np.zeros(max(n_total, 1), np.int32)
            counts = np.zeros(max(n_total, 1), np.int32)
            chunks: List[np.ndarray] = []
            tmax = 1
            base = 0
            flat = 0
            for seg in self.reader.segments:
                mvf = seg.multi_vectors.get(model.field)
                n = seg.num_docs
                if mvf is not None and len(mvf.tok_vectors):
                    offs = mvf.tok_offsets.astype(np.int64)
                    starts[base : base + n] = flat + offs[:-1]
                    counts[base : base + n] = np.diff(offs)
                    chunks.append(mvf.tok_vectors)
                    flat += int(offs[-1])
                    tmax = max(tmax, mvf.max_tokens)
                base += n
            dims = int(model.dims) or (int(chunks[0].shape[1]) if chunks else 1)
            toks_host = (
                np.concatenate(chunks, axis=0)
                if chunks
                else np.zeros((0, dims), np.float32)
            )
            pad = np.zeros((tmax, toks_host.shape[1]), toks_host.dtype)
            toks_host = np.concatenate([toks_host, pad], axis=0)
            est = (
                starts.nbytes
                + counts.nbytes
                + toks_host.nbytes
                # the int8 twin replaces the f32 rows but adds scales
                + (toks_host.shape[0] * 4 if model.quantized else 0)
            )
            if not hbm_ledger.would_fit(est):
                hbm_ledger.note_degraded()
                rerank_model.note("skipped")
                self._rerank_columns[key] = None
                return None
            scales_dev = None
            if model.quantized:
                qv, scales = rerank_model.quantize_tokens(toks_host)
                toks_dev = scoring.upload(qv, self.device)
                scales_dev = scoring.upload(scales, self.device)
                nbytes = int(qv.nbytes + scales.nbytes)
            else:
                toks_dev = scoring.upload(toks_host.astype(np.float32), self.device)
                nbytes = int(toks_host.nbytes)
            col = {
                "starts": scoring.upload(starts, self.device),
                "counts": scoring.upload(counts, self.device),
                "toks": toks_dev,
                "scales": scales_dev,
                "tmax": int(tmax),
                "dims": int(toks_host.shape[1]),
                "nbytes": int(nbytes + starts.nbytes + counts.nbytes),
            }
            self._charge("rerank", col["nbytes"], False)
            self._rerank_columns[key] = col
            return col

    # ---- field-sorted collection on one numeric key ----

    def _sort_ranks(self, si: int, field: str, desc: bool):
        """Device int32 rank column for one segment's numeric doc-value
        field: rank orders by (value, doc) asc — or (-value, doc) for
        desc — with missing docs ranked last by doc. The ranks are built
        on the host from the float64 values, so they are exact at any
        magnitude (dates included). Returns (device_ranks,
        host_sorted_values, n_have)."""
        key = (si, field, desc)
        cached = self._sort_rank_cache.get(key)
        if cached is not None:
            return cached
        with self._build_lock:
            cached = self._sort_rank_cache.get(key)
            if cached is not None:
                return cached
            seg = self.reader.segments[si]
            nf = seg.numerics.get(field)
            n = seg.num_docs
            if nf is None:
                ranks_host = np.arange(n, dtype=np.int32)
                sorted_vals = np.zeros(0)
                n_have = 0
            else:
                have = nf.exists
                vals = nf.values
                docs = np.arange(n)
                order_vals = -vals if desc else vals
                have_idx = docs[have]
                order = np.lexsort((have_idx, order_vals[have]))
                ranked = have_idx[order]
                missing = docs[~have]
                ranks_host = np.empty(n, np.int32)
                ranks_host[ranked] = np.arange(len(ranked), dtype=np.int32)
                ranks_host[missing] = np.arange(len(ranked), n, dtype=np.int32)
                sorted_vals = np.sort(vals[have])
                n_have = int(len(ranked))
            arr = scoring.upload(ranks_host, self.device)
            self._charge("sort_ranks", int(ranks_host.nbytes), False)
            cached = (arr, sorted_vals, n_have)
            self._sort_rank_cache[key] = cached
            return cached

    def execute_sorted_device(
        self,
        query: Optional[Query],
        sort_specs,
        size: int = 10,
        search_after=None,
    ):
        """Field-sorted collection on the card for a SINGLE
        numeric/date/bool sort key: per segment a top-k over the rank
        column of the matching docs, then one packed download of every
        segment's k rows and match count. Returns (TopDocs, svals) or
        None when the spec needs the oracle (multi-key, keyword keys,
        `missing` overrides, _score/_doc)."""
        if len(sort_specs) != 1:
            return None
        spec = sort_specs[0]
        field = spec["field"]
        if field in ("_score", "_doc"):
            return None
        mf = self.reader.mappings.get(field)
        if mf is None or not mf.is_numeric():
            return None
        if spec.get("missing") not in (None, "_last"):
            return None
        desc = spec.get("order", "asc") == "desc"
        after_v = None
        if search_after is not None:
            try:
                after_v = float(search_after[0])
            except (TypeError, ValueError):
                return None
        sentinel = -(2**31 - 1)
        parts, widths = [], []  # device [2·kk + 1] int64 per segment
        for si, seg in enumerate(self.reader.segments):
            n = seg.num_docs
            if n == 0:
                continue
            ranks, sorted_vals, n_have = self._sort_ranks(si, field, desc)
            if query is not None:
                mask = self._exec(query, si)[0]
            else:
                mask = torch.ones(n, dtype=torch.bool, device=self.device)
            live = self.live_mask(si)
            if live is not None:
                mask = mask & live
            # hits.total reports the FULL query match count — the
            # search_after cursor narrows the page, never the total
            total = mask.sum(dtype=torch.int64)
            if after_v is not None:
                # strictly-after in VALUE space (ties skipped, matching
                # the oracle): rank >= count of values <=/>= after
                if desc:
                    thr = n_have - int(np.searchsorted(sorted_vals, after_v, side="left"))
                else:
                    thr = int(np.searchsorted(sorted_vals, after_v, side="right"))
                mask = mask & (ranks >= thr)
            kk = min(size, n)
            # smallest ranks win: top-k over negated ranks (distinct, so
            # the order is exact); masked docs sink below every real rank
            neg = torch.where(mask, -ranks, sentinel)
            top_neg, top_d = torch.topk(neg, kk)
            parts.append(torch.cat([top_neg.long(), top_d, total.view(1)]))
            widths.append((si, kk))
        host = torch.cat(parts).cpu().numpy() if parts else np.zeros(0, np.int64)
        entries = []  # (rank, si, doc)
        total = 0
        off = 0
        for si, kk in widths:
            top_neg, top_d = host[off : off + kk], host[off + kk : off + 2 * kk]
            total += int(host[off + 2 * kk])
            off += 2 * kk + 1
            for j in range(kk):
                if top_neg[j] == sentinel:
                    continue
                entries.append((int(-top_neg[j]), si, int(top_d[j])))
        # cross-segment merge: segment-local ranks order identically to
        # values WITHIN a segment; across segments compare actual values
        nf_cols = [seg.numerics.get(field) for seg in self.reader.segments]

        def global_key(e):
            _, si, d = e
            nf = nf_cols[si]
            if nf is None or not nf.exists[d]:
                return (1, 0.0, si, d)  # missing last
            v = float(nf.values[d])
            return (0, -v if desc else v, si, d)

        entries.sort(key=global_key)
        page = entries[:size]
        hits = []
        svals = []
        for _, si, d in page:
            hits.append(
                Hit(
                    score=0.0,
                    segment=si,
                    local_doc=d,
                    doc_id=self.reader.segments[si].doc_ids[d],
                )
            )
            nf = nf_cols[si]
            if nf is None or not nf.exists[d]:
                svals.append([None])
            else:
                v = nf.values[d]
                svals.append([int(v)] if float(v).is_integer() else [float(v)])
        return TopDocs(total=total, hits=hits, max_score=None), svals

    # ---- keyword terms aggregations in the query pass ----

    def _entry_docs_dev(self, si: int, field: str) -> Optional[torch.Tensor]:
        """Device int64 doc index per multi-value ordinal entry (the CSR
        row expansion), cached per (segment, field)."""
        key = (si, field)
        if key in self._entry_docs_dev_cache:
            return self._entry_docs_dev_cache[key]
        with self._build_lock:
            if key in self._entry_docs_dev_cache:
                return self._entry_docs_dev_cache[key]
            of = self.reader.segments[si].ordinals.get(field)
            arr = None
            if of is not None:
                host = np.repeat(
                    np.arange(self.reader.segments[si].num_docs, dtype=np.int64),
                    np.diff(of.mv_offsets),
                )
                arr = scoring.upload(host, self.device)
                self._charge("doc_values", int(host.nbytes), False)
            self._entry_docs_dev_cache[key] = arr
            return arr

    def execute_with_terms_aggs(self, query, agg_nodes, k: int, tth):
        """Query + keyword `terms` aggregations in one pass: per segment
        the downloads are k top-hit rows plus one compact count vector
        per agg (an int32 `index_add_` over the ordinal entries) — never
        the [n_docs] masks. Returns (TopDocs, partials) in the host
        collector's wire shape, or None when any agg needs the host
        collector."""
        from .aggs import _bkey, _int_param, _norm_order, _order_buckets

        for node in agg_nodes:
            if node.type != "terms" or node.subs:
                return None
            f = node.params.get("field")
            if f is None:
                return None
            mf = self.reader.mappings.get(f)
            if mf is None or mf.type != KEYWORD:
                return None
        per_node_counts: List[Dict[str, int]] = [dict() for _ in agg_nodes]
        cands: List[Tuple[float, int, int]] = []
        total = 0
        for si, seg in enumerate(self.reader.segments):
            n = seg.num_docs
            if n == 0:
                continue
            if query is not None:
                mask, scores = self._exec(query, si)
            else:
                mask = torch.ones(n, dtype=torch.bool, device=self.device)
                scores = torch.zeros(n, dtype=torch.float32, device=self.device)
            live = self.live_mask(si)
            if live is not None:
                mask = mask & live
            count_outs = []
            for node in agg_nodes:
                f = node.params["field"]
                of = seg.ordinals.get(f)
                entry_docs = self._entry_docs_dev(si, f)
                if of is None or entry_docs is None:
                    count_outs.append(None)
                    continue
                mv_ords = self.device_segments[si].ordinals[f][0]
                # int32: segment doc counts are int32-bounded by design
                sel = mask[entry_docs].to(torch.int32)
                counts = torch.zeros(len(of.ord_terms), dtype=torch.int32, device=self.device)
                counts.index_add_(0, mv_ords.long(), sel)
                count_outs.append(counts)
            s, d = scoring.topk_hits(scores, mask, min(k, n))
            host_s = s.cpu().numpy()
            host_d = d.cpu().numpy()
            total += int(mask.sum())
            finite = np.isfinite(host_s)
            for sc, doc in zip(host_s[finite], host_d[finite]):
                cands.append((float(sc), si, int(doc)))
            for ni, counts in enumerate(count_outs):
                if counts is None:
                    continue
                host_counts = counts.cpu().numpy()
                of = seg.ordinals[agg_nodes[ni].params["field"]]
                agg = per_node_counts[ni]
                for o in np.nonzero(host_counts)[0]:
                    key = of.ord_terms[o]
                    agg[key] = agg.get(key, 0) + int(host_counts[o])
        cands.sort(key=lambda c: (-c[0], c[1], c[2]))
        hits = [
            Hit(score=s, segment=si, local_doc=d, doc_id=self.reader.segments[si].doc_ids[d])
            for s, si, d in cands[:k]
        ]
        td = TopDocs(total=total, hits=hits, max_score=hits[0].score if hits else None)
        partials = {}
        for ni, node in enumerate(agg_nodes):
            counts = per_node_counts[ni]
            size = _int_param(node, "size", 10)
            shard_size = _int_param(node, "shard_size", max(int(size * 1.5) + 10, size))
            order = _norm_order(node.params.get("order", {"_count": "desc"}))
            top = _order_buckets(counts, order)[:shard_size]
            shard_error = top[-1][1] if len(counts) > shard_size and top else 0
            partials[node.name] = {
                "t": "terms",
                "buckets": {
                    _bkey(key): {"key": key, "doc_count": cnt, "subs": {}}
                    for key, cnt in top
                },
                "sum_docs": sum(counts.values()),
                "size": size,
                "order": order,
                "shard_error": shard_error,
            }
        return td, partials
