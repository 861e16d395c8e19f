"""Segment-build orchestration for streaming ingest (device or host).

`build_segment` turns a batch of parsed documents into an immutable
`Segment`. The host reference path is `SegmentBuilder.build()` —
unchanged, forever the oracle. The device path (`ES_TPU_DEVICE_BUILD`,
see common/settings.py) keeps the token/hash/string work on the host
(tokenization happened at parse time; term dictionaries sort here) and
materializes the column arrays through the PyTorch ops of
ops/index_build.py on the index's device: postings tiling + norms +
block-max sidecars, BM25 impacts, keyword ordinal CSRs, dense vector
layout, rank_vectors CSR offsets, sparse_vector impact planes.
Device-built columns are BIT-IDENTICAL to the host build for every
column family (tests/test_torch_ingest.py asserts array equality), so
routing is free to change at any time without changing any answer.

Degrade contract (the serving-path pattern applied to the write path):

  - `build.device` fault site fires before the device build; an
    injected error falls back to the host build (counted `fallbacks`),
    a `crash` kind propagates as SimulatedCrash (power loss mid-build);
  - transient device arrays are charged to the `build` ledger
    category; a build that would not fit degrades to the host build
    (counted `degraded`) instead of tripping the breaker;
  - any other failure of the device path fails the build (the
    refresh keeps the old generation serving): unlike the reference,
    which builds on the host after any exception, nothing here hides a
    failed build on the card.

This module also owns the node-wide ingest/refresh stats registry (the
`ingest` block of `_nodes/stats`): refresh counts and lag percentiles,
device-vs-host build counters, concurrent-build overlap, and
generations discarded on mid-build failure.
"""

from __future__ import annotations

import threading
from collections import deque
from typing import List

import numpy as np
import torch

from ..common.faults import InjectedFault, faults
from .mapping import TEXT, Mappings, ParsedDocument
from .segment import (
    MultiVectorField,
    NumericField,
    OrdinalField,
    PostingsField,
    Segment,
    SegmentBuilder,
    SparseField,
    VectorField,
    FieldStats,
    TILE,
    _unit_normalize,
    sparse_plan,
)

# ---------------------------------------------------------------------------
# ingest / refresh observability
# ---------------------------------------------------------------------------

_LOCK = threading.Lock()
INGEST_STATS = {
    "refreshes": 0,  # committed refreshes (all shards, all indices)
    "concurrent_refreshes": 0,  # double-buffered (built outside the lock)
    "concurrent_merges": 0,  # double-buffered merges (built outside the lock)
    "device_builds": 0,  # segments whose columns were built on device
    "host_builds": 0,  # segments built by the host SegmentBuilder
    "fallbacks": 0,  # device-path failures → host build
    "degraded": 0,  # HBM-budget degrades → host build
    "generations_discarded": 0,  # half-builds dropped (fault / superseded)
    "overlap_ms": 0.0,  # build wall time overlapped with serving
    "prewarm_ms": 0.0,  # post-swap executor/mesh prewarm wall time
    "wait_for_waits": 0,  # ?refresh=wait_for blocks on the next swap
}
_REFRESH_LAGS = deque(maxlen=4096)  # worst-doc visibility lag per refresh, ms


class _Degraded(Exception):
    """Internal: device build would not fit the HBM budget."""


def note(key: str, n=1) -> None:
    with _LOCK:
        INGEST_STATS[key] += n


def note_refresh_lag(ms: float) -> None:
    with _LOCK:
        _REFRESH_LAGS.append(float(ms))


def refresh_lag_percentiles() -> dict:
    with _LOCK:
        lags = list(_REFRESH_LAGS)
    if not lags:
        return {"p50_ms": None, "p95_ms": None, "p99_ms": None, "samples": 0}
    arr = np.asarray(lags)
    return {
        "p50_ms": round(float(np.percentile(arr, 50)), 2),
        "p95_ms": round(float(np.percentile(arr, 95)), 2),
        "p99_ms": round(float(np.percentile(arr, 99)), 2),
        "samples": len(lags),
    }


def stats_snapshot() -> dict:
    """The `ingest` block of `_nodes/stats` (joined with the build
    kernel timings and the `build` ledger bytes)."""
    from ..common.memory import hbm_ledger
    from ..ops.index_build import kernel_stats_snapshot

    with _LOCK:
        out = dict(INGEST_STATS)
    out["overlap_ms"] = round(out["overlap_ms"], 2)
    out["prewarm_ms"] = round(out["prewarm_ms"], 2)
    out["refresh_lag"] = refresh_lag_percentiles()
    out["build_kernels"] = kernel_stats_snapshot()
    out["build_ledger_bytes"] = int(
        hbm_ledger.stats()["by_category"].get("build", 0)
    )
    return out


def reset_stats() -> None:
    """Test/bench hook: zero the counters and the lag reservoir."""
    from ..ops.index_build import reset_kernel_stats

    with _LOCK:
        for k, v in list(INGEST_STATS.items()):
            INGEST_STATS[k] = 0.0 if isinstance(v, float) else 0
        _REFRESH_LAGS.clear()
    reset_kernel_stats()


# ---------------------------------------------------------------------------
# build entry point
# ---------------------------------------------------------------------------


def build_segment(
    mappings: Mappings,
    docs: List[ParsedDocument],
    generation: int = 0,
    shard_id: int = 0,
    prefer_device: bool = False,
    device="cuda",
) -> Segment:
    """An immutable Segment from parsed docs, device-built on `device`
    when the `ES_TPU_DEVICE_BUILD` mode (and the owning index's backend,
    via `prefer_device`) says so; bit-identical either way."""
    from ..common.settings import device_build_mode

    builder = SegmentBuilder(mappings, generation)
    for d in docs:
        builder.add(d)
    mode = device_build_mode()
    use_device = mode == "force" or (mode == "auto" and prefer_device)
    if use_device and len(docs):
        try:
            faults.check("build.device", shard=shard_id)
            seg = _device_build(builder, torch.device(device))
            note("device_builds")
            return seg
        except _Degraded:
            note("degraded")
        except InjectedFault:
            if mode == "force":
                raise
            note("fallbacks")
    note("host_builds")
    return builder.build()


def _charge_build(nbytes: int):
    """Transient `build`-category ledger charge for one device-build
    family; raises _Degraded (→ host build) when it would not fit."""
    from ..common.memory import hbm_ledger

    if not hbm_ledger.would_fit(nbytes):
        hbm_ledger.note_degraded()
        raise _Degraded(f"device build of {nbytes} bytes over budget")
    hbm_ledger.add("build", nbytes, breaker=False)
    return nbytes


def _release_build(nbytes: int) -> None:
    from ..common.memory import hbm_ledger

    hbm_ledger.release("build", nbytes)


def _device_build(builder: SegmentBuilder, device) -> Segment:
    """The device mirror of SegmentBuilder.build(): same field
    discovery, same outputs, column materialization on device."""
    from ..ops import index_build as ib

    docs = builder._docs
    n = len(docs)
    postings = {}
    numerics = {}
    ordinals = {}
    vectors = {}
    multi_vectors = {}

    # ---- text fields: tiled postings + positions ----
    text_fields = sorted({f for d in docs for f in d.text_terms})
    for fname in text_fields:
        inv_pos = {}
        lengths = np.zeros(n, dtype=np.int64)
        doc_count = 0
        for local_id, d in enumerate(docs):
            terms = d.text_terms.get(fname)
            if not terms:
                continue
            doc_count += 1
            lengths[local_id] = d.field_lengths.get(fname, len(terms))
            for term, pos in terms:
                inv_pos.setdefault(term, {}).setdefault(local_id, []).append(
                    pos
                )
        inv = {
            t: {d_: len(ps) for d_, ps in pl.items()}
            for t, pl in inv_pos.items()
        }
        pf = _device_postings(ib, inv, lengths, n, doc_count, device)
        SegmentBuilder._attach_positions(pf, inv_pos)
        mf = builder.mappings.get(fname)
        if mf is None or mf.type == TEXT:
            _device_impacts(ib, pf, n, device)
        postings[fname] = pf

    # ---- keyword fields: postings (tf=1) + device ordinal CSR ----
    kw_fields = sorted({f for d in docs for f in d.keyword_terms})
    for fname in kw_fields:
        inv = {}
        lengths = np.zeros(n, dtype=np.int64)
        doc_count = 0
        all_vals: List[List[str]] = []
        for local_id, d in enumerate(docs):
            vals = d.keyword_terms.get(fname) or []
            all_vals.append(vals)
            if vals:
                doc_count += 1
                lengths[local_id] = len(vals)
            for v in set(vals):
                inv.setdefault(v, {})[local_id] = 1
        postings[fname] = _device_postings(ib, inv, lengths, n, doc_count, device)
        ordinals[fname] = _device_ordinals(ib, all_vals, n, device)

    # ---- numerics: cheap dense host columns (identical code path) ----
    num_fields = sorted({f for d in docs for f in d.numeric_values})
    for fname in num_fields:
        values = np.zeros(n, dtype=np.float64)
        exists = np.zeros(n, dtype=bool)
        for local_id, d in enumerate(docs):
            vals = d.numeric_values.get(fname)
            if vals:
                values[local_id] = vals[0]
                exists[local_id] = True
        numerics[fname] = NumericField(values=values, exists=exists)

    # ---- dense vectors: device scatter into the [N, dims] layout ----
    vec_fields = sorted({f for d in docs for f in d.vectors})
    for fname in vec_fields:
        mf = builder.mappings.get(fname)
        dims = (
            mf.dims
            if mf
            else len(
                next(
                    v
                    for d in docs
                    for f2, v in d.vectors.items()
                    if f2 == fname
                )
            )
        )
        rows = []
        idx = []
        for local_id, d in enumerate(docs):
            v = d.vectors.get(fname)
            if v is not None:
                rows.append(np.asarray(v, dtype=np.float32))
                idx.append(local_id)
        sim = mf.similarity if mf else "cosine"
        if rows:
            rmat = np.stack(rows)
            ridx = np.asarray(idx, np.int32)
            nb = _charge_build(
                int(rmat.nbytes) + len(ridx) * 8 + n * (dims * 4 + 1)
            )
            try:
                mat, exists = ib.scatter_rows_device(rmat, ridx, n, device)
            finally:
                _release_build(nb)
        else:
            mat = np.zeros((n, dims), np.float32)
            exists = np.zeros(n, bool)
        vf = VectorField(vectors=mat, exists=exists, similarity=sim)
        if sim == "cosine":
            # float reduction: shared host routine in BOTH paths (like
            # tokenization — normalization is part of doc prep)
            vf.unit_vectors = _unit_normalize(mat)
        vectors[fname] = vf

    # ---- rank_vectors: flat CSR token column, device offsets ----
    mv_fields = sorted({f for d in docs for f in d.multi_vectors})
    for fname in mv_fields:
        mf = builder.mappings.get(fname)
        dims = (
            mf.dims
            if mf and mf.dims
            else len(
                next(
                    row
                    for d in docs
                    for m in (d.multi_vectors.get(fname),)
                    if m
                    for row in m[:1]
                )
            )
        )
        sim = mf.similarity if mf else "cosine"
        counts = np.zeros(n, np.int32)
        chunks: List[np.ndarray] = []
        for local_id, d in enumerate(docs):
            mat = d.multi_vectors.get(fname)
            if mat:
                arr = np.asarray(mat, dtype=np.float32)
                if sim == "cosine":
                    arr = _unit_normalize(arr)
                chunks.append(arr)
                counts[local_id] = len(arr)
        tok = (
            np.concatenate(chunks, axis=0)
            if chunks
            else np.zeros((0, dims), np.float32)
        )
        nb = _charge_build(n * 9 + 4)
        try:
            offsets, exists = ib.csr_offsets_device(counts, n, device)
        finally:
            _release_build(nb)
        multi_vectors[fname] = MultiVectorField(
            tok_vectors=tok,
            tok_offsets=offsets,
            exists=exists,
            similarity=sim,
        )

    # ---- sparse_vector: impact-ordered planes materialized on device.
    # The host owns the layout plan (index/segment.sparse_plan — sort,
    # impact ordering, pruning), so the device twin is bit-identical by
    # construction; the kernel scatters + quantizes. ----
    sparse = {}
    sp_fields = sorted({f for d in docs for f in d.sparse_vectors})
    for fname in sp_fields:
        mf = builder.mappings.get(fname)
        ratio = mf.pruning_ratio if mf else 0.0
        inv_w = {}
        sp_exists = np.zeros(n, dtype=bool)
        for local_id, d in enumerate(docs):
            wmap = d.sparse_vectors.get(fname)
            if not wmap:
                continue
            sp_exists[local_id] = True
            for term, w in wmap.items():
                inv_w.setdefault(term, {})[local_id] = float(w)
        plan = sparse_plan(inv_w, ratio)
        nb = _charge_build(
            ib.estimate_sparse_nbytes(
                len(plan["docs"]), plan["n_tiles"], len(plan["terms"])
            )
        )
        try:
            doc_ids, weights, qweights, scales, tile_max, tile_qmax = (
                ib.sparse_planes_device(plan, device)
            )
        finally:
            _release_build(nb)
        sparse[fname] = SparseField(
            terms=plan["terms"],
            term_df=plan["term_df"],
            term_tile_start=plan["term_tile_start"],
            term_tile_count=plan["term_tile_count"],
            doc_ids=doc_ids,
            weights=weights,
            qweights=qweights,
            scales=scales,
            tile_max=tile_max,
            tile_qmax=tile_qmax,
            exists=sp_exists,
            pruned=int(plan["pruned"]),
        )

    return Segment(
        num_docs=n,
        doc_ids=[d.doc_id for d in docs],
        sources=[d.source for d in docs],
        postings=postings,
        numerics=numerics,
        ordinals=ordinals,
        vectors=vectors,
        generation=builder.generation,
        multi_vectors=multi_vectors,
        sparse=sparse,
    )


def _device_postings(
    ib, inv, lengths: np.ndarray, n: int, doc_count: int, device
) -> PostingsField:
    """PostingsField with the tiled planes materialized on device. The
    host does the dictionary sort and the vectorized layout plan (one
    lexsort — no per-term Python loop over tile rows)."""
    from ..utils.smallfloat import encode_norms

    terms = sorted(inv)
    n_terms = len(terms)
    if n_terms == 0:
        return PostingsField(
            terms=[],
            term_df=np.zeros(0, np.int32),
            term_total_tf=np.zeros(0, np.int64),
            term_tile_start=np.zeros(0, np.int32),
            term_tile_count=np.zeros(0, np.int32),
            doc_ids=np.full((0, TILE), -1, np.int32),
            tfs=np.zeros((0, TILE), np.int32),
            tile_max_tf=np.zeros(0, np.int32),
            tile_min_norm=np.zeros(0, np.uint8),
            norms=encode_norms(lengths),
            stats=FieldStats(doc_count=doc_count),
        )
    # flat (term_id, doc, tf) stream — the residual host hash work
    tid_l: List[int] = []
    doc_l: List[int] = []
    tf_l: List[int] = []
    for tid, t in enumerate(terms):
        plist = inv[t]
        tid_l.extend([tid] * len(plist))
        doc_l.extend(plist.keys())
        tf_l.extend(plist.values())
    tids = np.asarray(tid_l, np.int64)
    docs_arr = np.asarray(doc_l, np.int32)
    tfs_arr = np.asarray(tf_l, np.int32)
    order = np.lexsort((docs_arr, tids))  # term-major, doc asc
    tids = tids[order]
    docs_arr = docs_arr[order]
    tfs_arr = tfs_arr[order]
    term_df = np.bincount(tids, minlength=n_terms).astype(np.int32)
    term_total_tf = np.bincount(
        tids, weights=tfs_arr.astype(np.float64), minlength=n_terms
    ).astype(np.int64)
    term_tile_count = ((term_df + TILE - 1) // TILE).astype(np.int32)
    term_tile_start = np.zeros(n_terms, np.int32)
    if n_terms > 1:
        np.cumsum(term_tile_count[:-1], out=term_tile_start[1:])
    n_tiles = int(term_tile_count.sum())
    est = ib.estimate_postings_nbytes(len(docs_arr), n_tiles, n)
    nb = _charge_build(est)
    try:
        doc_ids, tfs, tile_max_tf, norms, tile_min_norm = (
            ib.postings_tiles_device(
                tids, docs_arr, tfs_arr, term_tile_start, term_df,
                lengths, n_tiles, n, device,
            )
        )
    finally:
        _release_build(nb)
    stats = FieldStats(
        doc_count=doc_count,
        sum_total_term_freq=int(term_total_tf.sum()),
        sum_doc_freq=int(term_df.sum()),
    )
    return PostingsField(
        terms=terms,
        term_df=term_df,
        term_total_tf=term_total_tf,
        term_tile_start=term_tile_start,
        term_tile_count=term_tile_count,
        doc_ids=doc_ids,
        tfs=tfs,
        tile_max_tf=tile_max_tf,
        tile_min_norm=tile_min_norm,
        norms=norms,
        stats=stats,
    )


def _device_impacts(ib, pf: PostingsField, n: int, device) -> None:
    """Attach the precomputed BM25 impacts to a device-built text
    postings column. The 256-entry segment-local inv-norm cache is
    computed on HOST (models/bm25.norm_inverse_cache — the same float
    path the host attach uses), so both builds fold identical bits; the
    device folds it into per-posting int8 impacts."""
    from ..models import bm25

    n_terms = len(pf.terms)
    if pf.n_tiles == 0:
        pf.impacts = np.zeros((0, TILE), np.int8)
        pf.impact_scales = np.zeros(n_terms, np.float32)
        return
    cache = bm25.norm_inverse_cache(
        bm25.avg_field_length(
            pf.stats.sum_total_term_freq, pf.stats.doc_count
        )
    )
    tile_term = np.repeat(
        np.arange(n_terms, dtype=np.int32), pf.term_tile_count
    )
    nb = _charge_build(ib.estimate_impacts_nbytes(pf.n_tiles, n))
    try:
        impacts, scales = ib.text_impacts_device(
            pf.doc_ids, pf.tfs, pf.norms, cache, tile_term, n_terms, n, device
        )
    finally:
        _release_build(nb)
    pf.impacts = impacts
    pf.impact_scales = scales


def _device_ordinals(
    ib, all_vals: List[List[str]], n: int, device
) -> OrdinalField:
    """OrdinalField with the multi-value CSR assembled on device (dedup
    + sort + compaction); the host does only the string work."""
    uniq = sorted({v for vals in all_vals for v in vals})
    ord_of = {v: i for i, v in enumerate(uniq)}
    doc_l: List[int] = []
    ord_l: List[int] = []
    for i, vals in enumerate(all_vals):
        for v in vals:  # dups allowed — the device dedups
            doc_l.append(i)
            ord_l.append(ord_of[v])
    docs_arr = np.asarray(doc_l, np.int32)
    ords_arr = np.asarray(ord_l, np.int32)
    nb = _charge_build(len(docs_arr) * 42 + n * 20 + 4)
    try:
        ords_col, mv_ords, mv_offsets = ib.ordinals_device(
            docs_arr, ords_arr, n, device
        )
    finally:
        _release_build(nb)
    return OrdinalField(
        ord_terms=uniq,
        ords=ords_col,
        mv_ords=mv_ords,
        mv_offsets=mv_offsets,
    )
