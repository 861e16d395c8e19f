"""PyTorch shard executor — the port's counterpart of the JAX package's
`search/executor_jax.py` (`JaxExecutor`).

Mirrors the NumPy oracle (executor.py) node for node, but evaluates on
device tensors: postings tiles live in device memory, leaves score via
the gather→BM25→scatter functions in ops/scoring.py, and collection is a
top-k that breaks ties by the lowest doc.

The port covers the shard query phase of `match` (BM25),
`match_all`/`match_none` and exact brute-force kNN (top-level `knn`
sections and the `knn` query node), plus the surface the serving
batcher drives: the fused route for large segments (`fused_scorer` →
`fused_plan` → `FusedScorer.search_async`), the chunked block-max route
for small ones (`block_index`, `chunked_scorer`), `segment_topk`, and
device-resident live and live ∧ exists masks built once per executor
(= reader generation). Every other query node raises
NotImplementedError naming the slice that brings it (cuts.py).

Per-segment tensors are uploaded once, lazily per field, and charged to
the device-memory ledger (common/memory.py) — the analog of Lucene's
"open a reader once, search many times".
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from .. import cuts
from ..cuts import not_ported
from ..index.mapping import TEXT
from ..index.segment import Segment
from ..models import bm25
from ..ops import scoring
from . import dsl
from .dsl import (
    KnnQueryWrapper,
    KnnSection,
    MatchAllQuery,
    MatchNoneQuery,
    MatchQuery,
    Query,
)
from .executor import Hit, NumpyExecutor, ShardReader, TopDocs

# segments below this size take the batcher's chunked block-max path (or
# the per-query path); above it the per-segment fused launch with dense
# hot rows pays off
FUSED_MIN_DOCS = 100_000
# device-memory budget for dense hot-term tf rows, bytes (uint8 per doc per term)
DENSE_ROWS_HBM_BUDGET = 512 * 1024 * 1024

# the slice of the port that brings each query node not ported yet
_LATER_SLICES = {
    "TermQuery": cuts.FILTERS,
    "TermsQuery": cuts.FILTERS,
    "RangeQuery": cuts.FILTERS,
    "ExistsQuery": cuts.FILTERS,
    "IdsQuery": cuts.FILTERS,
    "ConstantScoreQuery": cuts.FILTERS,
    "BoolQuery": cuts.BOOL,
    "MultiMatchQuery": cuts.BOOL,
    "DisMaxQuery": cuts.BOOL,
    "SparseVectorQuery": cuts.SPARSE,
}


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


class TorchExecutor:
    """Walks the query tree producing dense device (mask, scores) pairs.

    `device` defaults to "cuda": the CPU is used only when the caller
    asks for it. `fused_min_docs` is the segment size from which
    `fused_scorer` builds the fused route (FUSED_MIN_DOCS by default)."""

    def __init__(
        self,
        reader: ShardReader,
        k1: float = bm25.DEFAULT_K1,
        b: float = bm25.DEFAULT_B,
        device="cuda",
        fused_min_docs: int = FUSED_MIN_DOCS,
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
        self.device_segments = [
            DeviceSegment(s, self.device, charge=self._charge)
            for s in reader.segments
        ]
        # the oracle is reused for stats and term weights
        self._oracle = NumpyExecutor(reader, k1, b)
        self._inv_norm_cache: Dict[Tuple[int, str], torch.Tensor] = {}
        self._fused_scorers: Dict[Tuple[int, str], object] = {}
        self._fused_parts: Dict[Tuple[int, str], object] = {}
        self._seg_weights: Dict[Tuple[int, str], np.ndarray] = {}
        self._df_maps: Dict[str, Dict[str, int]] = {}
        self._shard_dfs: Dict[Tuple[str, str], int] = {}
        self._block_indexes: Dict[Tuple[int, str], object] = {}
        self._chunked_scorers: Dict[Tuple[int, str], object] = {}
        self._live_masks: Dict[int, Optional[torch.Tensor]] = {}
        self._knn_masks: Dict[Tuple[int, str], torch.Tensor] = {}
        self._deleted_count: Optional[int] = None
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
        if isinstance(q, KnnQueryWrapper):
            return self._exec_knn_query(q.knn, si)
        name = type(q).__name__
        raise not_ported(
            f"the [{name}] query node", _LATER_SLICES.get(name, cuts.NODES)
        )

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
        idx_t = self._to_device(idx).long()
        return scoring.score_tiles(
            dp.doc_ids[idx_t],
            dp.tfs[idx_t],
            self._to_device(w),
            self._to_device(v),
            self._inv_norm(si, field, n),
            n,
        )

    def _exec_match(self, q: MatchQuery, si: int) -> Tuple[torch.Tensor, torch.Tensor]:
        n = self.reader.segments[si].num_docs
        mf = self.reader.mappings.get(q.field)
        if mf is None:
            return self._empty(n)
        if mf.type != TEXT:
            # match on keyword/numeric is a term query (ES behavior)
            raise not_ported("[match] on a non-text field", cuts.FILTERS)
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

    # ---- knn (device matmul + global top-k cut) ----

    def _knn_candidates(self, sec: KnnSection, si: int) -> torch.Tensor:
        if sec.filter is not None:
            raise not_ported("a kNN [filter]", cuts.FILTERS)
        return self.knn_candidates(si, sec.field)

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
        return self._to_device(np.asarray(sec.query_vector, np.float32))[None, :]

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
        """Per-segment brute-force candidates (num_candidates each), then
        the shard-wide k cut (score desc, (segment, doc) asc). The IVF
        ANN branch of the reference comes with a later slice."""
        if getattr(sec, "ann", None) is not None:
            raise not_ported("IVF approximate kNN (ops/ivf.py)", cuts.IVF)
        per_seg = []
        for si, seg in enumerate(self.reader.segments):
            if seg.vectors.get(sec.field) is None:
                per_seg.append(None)
                continue
            vf = seg.vectors[sec.field]
            cand_mask = self._knn_candidates(sec, si)
            k = min(sec.num_candidates, seg.num_docs)
            vectors, _exists = self.device_segments[si].vectors[sec.field]
            top_s, top_d = scoring.knn_topk(
                self._query_vector(sec), vectors, cand_mask, vf.similarity, k
            )
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
        keep = entries[: sec.k]
        out = []
        for si, seg in enumerate(self.reader.segments):
            n = seg.num_docs
            mask = np.zeros(n, bool)
            scores = np.zeros(n, np.float32)
            for negs, ksi, d in keep:
                if ksi == si:
                    mask[d] = True
                    scores[d] = -negs * sec.boost
            out.append((self._to_device(mask), self._to_device(scores)))
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
