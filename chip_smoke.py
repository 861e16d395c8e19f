"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--seed 42] [--docs 1000000] [--vocab 50000] [--dims 768]

Drives the port's shard query phase (`elasticsearch_tpu_torch`) at the
scale of BASELINE configs 1 (BM25 `match`), 2 (`bool`), 3
(`multi_match`), 4 (768-d cosine kNN) and 5 (hybrid BM25 + kNN with RRF):
one segment of 1,000,000 documents with a `body` text field over a
50,000-term Zipf vocabulary (15-34 tokens each), a `title` text field
over a 20,000-term Zipf vocabulary (3-8 tokens), a 768-d unit-vector
`vec` field and bench.py's filter columns (`popularity` integer 0-99,
`day` date over 30 days, `cat` keyword with 16 values), all made from
`--seed`. Phases, each of which stops the run with a non-zero exit on
any failure:

  1. the card's name and power limit, torch/CUDA versions; build the
     hand-written kernels from the checkout (csrc/*.cu, nvcc, sm_90a);
  2. each kernel against its plain PyTorch version on the card at the
     shapes the main path gives it: error, top-10 agreement, and times
     of the kernel, the plain version, one library call, and the bound;
  3. the main path, with every kernel's launch count set to 0 first:
     (a) 64 `match` queries through TorchExecutor.search,
     (b) the same queries as 2 batches of 32 through fused_plan →
         FusedScorer.search_async → merge_segment_topk,
     (c) 32 exact kNN sections (k=10, num_candidates=100),
     (d) QuantizedVectors.search over the same vectors, B=32, k=10,
     (e) 32 `multi_match` (title^2, body, tie_breaker 0.3) as one group
         through fused_plan_field → MultiFusedScorer.search_async →
         merge_segment_topk;
     (a)-(c) and (e) are held to the port's NumPy oracle on 8 queries
     each (same totals and hits, scores within rtol 1e-5), (d) to
     recall@10 >= 0.9 against exact f32 cosine; every kernel must have
     launched; route (c)'s profile must show no pageable host→device
     copy;
  4. serving on the card over HTTP: the port's ElasticsearchTpuServer
     (REST → ClusterService → IndexService → QueryBatcher →
     TorchExecutor) with `/bench` (torch) and `/bench_oracle` (numpy)
     over the same 1M-doc segment, and `/small` / `/small_oracle` (2
     shards, built by two `_bulk?refresh=true` calls and a few deletes,
     so every shard has two small segments and the chunked path runs).
     64 `match`, 32 `knn`, 32 `bool`, 32 `multi_match`, 36 filtered
     `bool` (8 rotating filter terms, 4 `day` ranges at odd-millisecond
     boundaries) and 32 hybrid RRF bodies (`multi_match` + `knn`
     retriever, 8 of them as `rank: {rrf}`) go to `/bench` from 8
     client threads, then from 1, in a client process of their own;
     `/small` gets the same shapes. Served hits are held to the numpy
     indices (same totals and ids, scores within rtol 1e-5; a hybrid
     leg by leg, then its fusion against `rrf_fuse_host` over the
     oracle's legs); `_nodes/stats` must show batched launches, a
     bucket wider than 1, the chunked path, serve launches and filter
     cache hits; every `/bench` hybrid must be fused on the card with
     both legs on the batcher; matmuls must run at float32 precision
     "highest". QPS, p50/p99 per route and client count, one profiled
     batcher group per route (with the host-device synchronisations
     each makes) are printed, and the
     8-client drive is repeated with 1, 2 and 6 batcher workers, at two
     interpreter switch intervals, and once under a host stack sampler
     (measured, not checked);
  5. a `kernels` JSON line and per-phase wall times.

The last line is {"ok": true, "device": {...}}. Without a CUDA device,
or without the rest of the repository beside it, the script exits
non-zero and prints no result.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import multiprocessing
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
from pathlib import Path

import numpy as np

# published peaks of one H100 SXM (NVIDIA data sheet, dense, at 700 W)
PEAK_BYTES_PER_S = 3.35e12
PEAK_BF16_TENSOR_FLOPS = 989e12  # bf16 tensor cores, dense

MATCH_QUERIES = 64
BATCH = 32
KNN_QUERIES = 32
SERVE_QUERIES = 32  # bool, multi_match, filtered bool, hybrid bodies per route
ORACLE_QUERIES = 8
K = 10
TITLE_VOCAB = 20_000  # bench.py's title field
TITLE_LEN = (3, 9)
DAY0 = 1_700_000_000_000  # epoch ms of bench.py's 30-day `day` column
DAY_MS = 86_400_000
RRF_RANK_CONSTANT = 60
CLIENTS = 8  # concurrent HTTP clients in phase 4
SMALL_DOCS = 2000  # docs of the small 2-shard index, in 2 _bulk calls
SMALL_DELETES = 5
SMALL_QUERIES = 16
RTOL = 1e-5
KERNEL_RTOL = 1e-5  # of max|dots|: f32 sums in another order

T0 = time.perf_counter()


def log(msg: str) -> None:
    print(f"[chip_smoke {time.perf_counter() - T0:7.1f}s] {msg}", file=sys.stderr, flush=True)


class SmokeFailure(Exception):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


# ---------------------------------------------------------------------------
# corpus (vectorised; the shape of bench.py's build, on the port's classes)
# ---------------------------------------------------------------------------


def build_postings(rng, vocab: int, lengths: np.ndarray):
    from elasticsearch_tpu_torch.index.segment import (
        INVALID_DOC, TILE, FieldStats, PostingsField,
    )
    from elasticsearch_tpu_torch.utils.smallfloat import encode_norms

    n_docs = len(lengths)
    probs = 1.0 / np.arange(1, vocab + 1)
    probs /= probs.sum()
    total = int(lengths.sum())
    term_stream = rng.choice(vocab, size=total, p=probs).astype(np.int64)
    doc_of = np.repeat(np.arange(n_docs, dtype=np.int64), lengths)
    key = term_stream * n_docs + doc_of
    uniq, counts = np.unique(key, return_counts=True)
    u_t = (uniq // n_docs).astype(np.int64)
    u_d = (uniq % n_docs).astype(np.int32)
    tfs_flat = counts.astype(np.int32)

    term_df = np.bincount(u_t, minlength=vocab).astype(np.int32)
    term_total_tf = np.bincount(u_t, weights=tfs_flat, minlength=vocab).astype(np.int64)
    term_tile_count = ((term_df + TILE - 1) // TILE).astype(np.int32)
    term_tile_start = np.zeros(vocab, np.int32)
    np.cumsum(term_tile_count[:-1], out=term_tile_start[1:])
    n_tiles = int(term_tile_count.sum())
    term_post_start = np.zeros(vocab, np.int64)
    np.cumsum(term_df[:-1].astype(np.int64), out=term_post_start[1:])
    rank = np.arange(len(u_t), dtype=np.int64) - term_post_start[u_t]
    slot = term_tile_start[u_t].astype(np.int64) * TILE + rank
    doc_ids = np.full(n_tiles * TILE, INVALID_DOC, np.int32)
    tfs = np.zeros(n_tiles * TILE, np.int32)
    doc_ids[slot] = u_d
    tfs[slot] = tfs_flat
    doc_ids = doc_ids.reshape(n_tiles, TILE)
    tfs = tfs.reshape(n_tiles, TILE)

    norms = encode_norms(lengths.astype(np.int64))
    valid = doc_ids >= 0
    tile_norms = np.where(valid, norms[np.clip(doc_ids, 0, n_docs - 1)], 255)
    pf = PostingsField(
        terms=[f"w{i:05d}" for i in range(vocab)],  # sorted lexicographically
        term_df=term_df,
        term_total_tf=term_total_tf,
        term_tile_start=term_tile_start,
        term_tile_count=term_tile_count,
        doc_ids=doc_ids,
        tfs=tfs,
        tile_max_tf=tfs.max(axis=1).astype(np.int32),
        tile_min_norm=tile_norms.min(axis=1).astype(np.uint8),
        norms=norms,
        stats=FieldStats(
            doc_count=n_docs,
            sum_total_term_freq=int(term_total_tf.sum()),
            sum_doc_freq=int(term_df.sum()),
        ),
    )
    return pf


def build_corpus(seed: int, n_docs: int, vocab: int, dims: int):
    from elasticsearch_tpu_torch.analysis import AnalysisRegistry
    from elasticsearch_tpu_torch.index.mapping import Mappings
    from elasticsearch_tpu_torch.index.segment import NumericField, OrdinalField, Segment, VectorField
    from elasticsearch_tpu_torch.search.executor import ShardReader

    rng = np.random.default_rng(seed)
    lengths = rng.integers(15, 35, size=n_docs)
    body = build_postings(rng, vocab, lengths)
    vecs = rng.standard_normal((n_docs, dims), dtype=np.float32)
    vecs /= np.linalg.norm(vecs, axis=1, keepdims=True)
    # bench.py's other columns, drawn after the body and the vectors so
    # those stay as earlier runs had them
    title = build_postings(rng, min(TITLE_VOCAB, vocab), rng.integers(*TITLE_LEN, size=n_docs))
    exists = np.ones(n_docs, bool)
    popularity = rng.integers(0, 100, size=n_docs).astype(np.float64)
    day = (DAY0 + rng.integers(0, 30, size=n_docs).astype(np.int64) * DAY_MS).astype(np.float64)
    cat_ords = rng.integers(0, 16, size=n_docs).astype(np.int32)
    seg = Segment(
        num_docs=n_docs,
        doc_ids=[str(i) for i in range(n_docs)],
        sources=[None] * n_docs,
        postings={"body": body, "title": title},
        numerics={
            "popularity": NumericField(values=popularity, exists=exists.copy()),
            "day": NumericField(values=day, exists=exists.copy()),
        },
        ordinals={
            "cat": OrdinalField(
                ord_terms=[f"cat{j:02d}" for j in range(16)], ords=cat_ords,
                mv_ords=cat_ords.copy(), mv_offsets=np.arange(n_docs + 1, dtype=np.int32),
            )
        },
        vectors={
            "vec": VectorField(
                vectors=vecs, exists=exists, similarity="cosine",
                unit_vectors=vecs,
            )
        },
    )
    mappings = Mappings(corpus_mapping(dims))
    return ShardReader([seg], mappings, AnalysisRegistry()), vecs


def corpus_mapping(dims: int) -> dict:
    """bench.py's mapping, without its `sparse_vector` field (ROADMAP
    queue 1 item 8)."""
    return {
        "properties": {
            "title": {"type": "text"},
            "body": {"type": "text"},
            "popularity": {"type": "integer"},
            "day": {"type": "date"},
            "cat": {"type": "keyword"},
            "vec": {"type": "dense_vector", "dims": dims, "similarity": "cosine"},
        }
    }


def match_texts(term_df: np.ndarray, n: int, seed: int, lo: int = 50, hi: int = 8000) -> list:
    """2-4 mid-frequency terms per query (bench.py's make_query_texts)."""
    rng = np.random.default_rng(seed + 7)
    cands = np.argsort(-term_df)[lo:hi]
    out = []
    for _ in range(n):
        k = int(rng.integers(2, 5))
        picked = rng.choice(len(cands), size=k, replace=False)
        out.append(" ".join(f"w{cands[int(i)]:05d}" for i in picked))
    return out


def text_hybrid_bodies(body_df: np.ndarray, title_df: np.ndarray, dims: int, seed: int) -> dict:
    """bench.py's `bool`, `multi_match`, `filtered_bool` and `hybrid_rrf`
    bodies (its build_bodies), SERVE_QUERIES of each, from `seed`. The
    hybrid is the multi_match + knn (k 20, num_candidates 100,
    rank_constant 60) retriever without bench.py's sparse_vector leg,
    every fourth body in the `rank: {rrf}` form; filtered bool gets
    `day_ranges` besides: 4 bodies whose `day` range bounds sit at odd
    milliseconds next to a day boundary (exact only in float64)."""
    rng = np.random.default_rng(seed + 29)
    order = np.argsort(-body_df)
    cands, filt_cands = order[50:8000], order[200:4000]

    def pick(k, pool=cands):
        return [f"w{pool[int(i)]:05d}" for i in rng.choice(len(pool), size=k, replace=False)]

    out = {"bool": []}
    for _ in range(SERVE_QUERIES):
        t = pick(4)
        out["bool"].append({"query": {"bool": {
            "must": [{"term": {"body": t[0]}}],
            "should": [{"match": {"body": f"{t[1]} {t[2]}"}}, {"match": {"body": t[3]}}],
        }}, "size": K})
    t_texts = match_texts(title_df, SERVE_QUERIES, seed + 13, hi=6000)
    out["multi_match"] = [
        {"query": {"multi_match": {"query": t, "fields": ["title^2", "body"], "tie_breaker": 0.3}},
         "size": K}
        for t in t_texts
    ]
    warm = pick(8, filt_cands)
    out["filtered_bool"] = []
    for i in range(SERVE_QUERIES):
        t = pick(3)
        out["filtered_bool"].append({"query": {"bool": {
            "must": [{"term": {"body": t[0]}}],
            "should": [{"match": {"body": f"{t[1]} {t[2]}"}}],
            "filter": [{"term": {"body": warm[i % len(warm)]}}, {"range": {"popularity": {"gte": 20}}}],
        }}, "size": K})
    out["day_ranges"] = []
    for j in range(4):
        d = DAY0 + (3 + 7 * j) * DAY_MS
        t = pick(3, filt_cands)
        day = ({"gte": d + 1, "lt": d + 4 * DAY_MS + 1} if j % 2 == 0
               else {"gt": d - 1, "lte": d + 2 * DAY_MS - 1})
        filters = [{"range": {"day": day}}]
        if j >= 2:
            filters.append({"range": {"cat": {"gte": "cat03", "lt": "cat11"}}})
        scoring = ({"must": [{"match": {"body": f"{t[0]} {t[1]}"}}]} if j % 2 == 0 else
                   {"must": [{"term": {"body": t[0]}}], "should": [{"match": {"body": t[2]}}]})
        out["day_ranges"].append({"query": {"bool": {**scoring, "filter": filters}}, "size": K})
    qv = rng.standard_normal((SERVE_QUERIES, dims)).astype(np.float32)
    qv /= np.linalg.norm(qv, axis=1, keepdims=True)
    out["hybrid_rrf"] = []
    for i, (t, v) in enumerate(zip(t_texts, qv)):
        mm = {"multi_match": {"query": t, "fields": ["title", "body"]}}
        knn = {"field": "vec", "query_vector": [float(x) for x in v], "k": 20, "num_candidates": 100}
        if i % 4 == 3:
            out["hybrid_rrf"].append({"query": mm, "knn": knn, "rank": {"rrf": {"rank_constant": RRF_RANK_CONSTANT}},
                                      "size": K, "_source": False})
        else:
            out["hybrid_rrf"].append({"retriever": {"rrf": {
                "retrievers": [{"standard": {"query": mm}}, {"knn": knn}],
                "rank_constant": RRF_RANK_CONSTANT}}, "size": K, "_source": False})
    return out


def hybrid_legs(body: dict):
    """(BM25 leg body, kNN leg body, rank_window_size) of one hybrid
    body, as IndexService._run_rrf sends them."""
    if "retriever" in body:
        rrf = body["retriever"]["rrf"]
        mm = rrf["retrievers"][0]["standard"]["query"]
        knn = rrf["retrievers"][1]["knn"]
    else:
        rrf, mm, knn = body["rank"]["rrf"], body["query"], body["knn"]
    size = int(body.get("size", 10))
    window = int(rrf.get("rank_window_size", max(max(size, 10), size)))
    return ({"query": mm, "size": window, "_source": False},
            {"knn": knn, "size": window, "_source": False}, window)


# ---------------------------------------------------------------------------
# timing and checks
# ---------------------------------------------------------------------------


def device_ms(fn, device, iters: int = 20, warmup: int = 3) -> float:
    """Mean time of one call, from CUDA events around `iters` calls."""
    import torch

    for _ in range(warmup):
        fn()
    if device.type != "cuda":  # CPU rehearsal only: host clock
        t = time.perf_counter()
        for _ in range(iters):
            fn()
        return (time.perf_counter() - t) * 1e3 / iters
    torch.cuda.synchronize(device)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize(device)
    return start.elapsed_time(end) / iters


def sync(device) -> None:
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def same_ids(ref_ids: list, ref_scores, got_ids: list, what: str) -> None:
    """Ids agree position by position; within a run of oracle scores that
    tie within RTOL, the run's ids agree as a set (both sides order exact
    ties lowest index first; only ulp-level differences reorder a run)."""
    check(len(got_ids) == len(ref_ids), f"{what}: {len(got_ids)} hits != oracle {len(ref_ids)}")
    i = 0
    while i < len(ref_ids):
        j = i + 1
        while j < len(ref_ids) and np.isclose(ref_scores[j], ref_scores[j - 1], rtol=RTOL, atol=0):
            j += 1
        check(set(got_ids[i:j]) == set(ref_ids[i:j]),
              f"{what}: ids {got_ids[i:j]} at ranks {i}-{j - 1} != oracle {ref_ids[i:j]}")
        i = j


def same_hits(ref, got, what: str) -> None:
    """Same totals, same hit count, scores within RTOL, same docs."""
    check(ref.total == got.total, f"{what}: total {got.total} != oracle {ref.total}")
    check(len(ref.hits) == len(got.hits), f"{what}: {len(got.hits)} hits != oracle {len(ref.hits)}")
    rs = np.array([h.score for h in ref.hits])
    gs = np.array([h.score for h in got.hits])
    check(np.allclose(gs, rs, rtol=RTOL, atol=1e-6), f"{what}: scores {gs} != oracle {rs}")
    same_ids([h.doc_id for h in ref.hits], rs, [h.doc_id for h in got.hits], what)


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------


def phase_build() -> dict:
    from elasticsearch_tpu_torch.ops import int8_knn

    t = time.perf_counter()
    lib, compiler_out = int8_knn.build()
    secs = time.perf_counter() - t
    for line in compiler_out.splitlines():
        log(f"nvcc: {line}")
    log(f"built {lib.name} in {secs:.2f}s")
    return {"int8_knn": secs}


def phase_kernels(qv, queries: np.ndarray, device) -> list:
    """Each kernel against its plain version at the main path's shapes."""
    import torch

    from elasticsearch_tpu_torch.ops import int8_knn

    q = np.asarray(queries, np.float32)
    q = q / np.linalg.norm(q, axis=1, keepdims=True)
    q = np.pad(q, ((0, 0), (0, qv.d_pad - q.shape[1])))
    qt = torch.from_numpy(q).to(device)
    B, d = qt.shape
    N = qv.qvecs.shape[0]

    out = int8_knn.int8_dot_scores(qt, qv.qvecs, qv.scales)
    sync(device)
    ref = int8_knn.int8_dot_scores_plain(qt, qv.qvecs, qv.scales)
    sync(device)
    max_abs = float((out - ref).abs().max())
    scale = float(ref.abs().max())
    max_rel = max_abs / scale
    log(f"int8_dot_scores B={B} N={N} d={d}: max_abs_err={max_abs:.3e} max|dots|={scale:.3e} rel={max_rel:.3e}")
    check(bool(torch.isfinite(out).all()), "int8_dot_scores: non-finite output")
    check(max_rel <= KERNEL_RTOL, f"int8_dot_scores: rel err {max_rel:.3e} > {KERNEL_RTOL}")
    # both against float64 products, so agreement is not a shared error
    exact = (qt.double() @ qv.qvecs.double().T) * qv.scales.double()
    rel_f64 = {
        "kernel": float((out.double() - exact).abs().max()) / scale,
        "plain": float((ref.double() - exact).abs().max()) / scale,
    }
    del exact
    log(f"int8_dot_scores rel err vs float64: {rel_f64}")
    check(rel_f64["kernel"] <= KERNEL_RTOL, f"int8_dot_scores: rel err vs f64 {rel_f64['kernel']:.3e}")
    # top-10 docs agree except where plain scores tie within the tolerance
    kd = torch.topk(out, K, dim=1).indices
    rd = torch.topk(ref, K, dim=1).indices
    ks = ref.gather(1, kd).sort(dim=1, descending=True).values
    rs = ref.gather(1, rd).sort(dim=1, descending=True).values
    check(
        bool(((ks - rs).abs() <= KERNEL_RTOL * scale).all()),
        "int8_dot_scores: top-10 differs from the plain version beyond ties",
    )

    ms = device_ms(lambda: int8_knn.int8_dot_scores(qt, qv.qvecs, qv.scales), device)
    plain_ms = device_ms(lambda: int8_knn.int8_dot_scores_plain(qt, qv.qvecs, qv.scales), device)
    # yardstick only: one PyTorch call computing the same function
    library_ms = device_ms(
        lambda: torch.matmul(qt, qv.qvecs.float().T) * qv.scales, device
    )
    nbytes = qt.numel() * 4 + qv.qvecs.numel() + qv.scales.numel() * 4 + B * N * 4
    # the kernel's work: three bf16 passes (hi, mid, lo of each query) on
    # the tensor cores, each product exact, so the f32 function at bf16 rate
    flops = 3 * 2 * B * N * d
    bytes_ms = nbytes / PEAK_BYTES_PER_S * 1e3
    ops_ms = flops / PEAK_BF16_TENSOR_FLOPS * 1e3
    bound_ms = max(bytes_ms, ops_ms)
    return [{
        "name": "int8_dot_scores",
        "route": "cuda",
        "source": "elasticsearch_tpu_torch/csrc/int8_knn.cu",
        "replaces": "elasticsearch_tpu/ops/pallas_knn.py:52",
        "launches": None,  # filled from the main path's run
        "shape": {"B": B, "N": N, "d": d},
        "max_abs_err": max_abs,
        "max_rel_err": max_rel,
        "max_rel_err_vs_f64": rel_f64,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "bound_share": bound_ms / ms,
        "library_ms": library_ms,
        "bytes": nbytes,
        "flops": flops,
    }]


def phase_main(reader, oracle, vecs, qv, seed: int, device) -> dict:
    import torch

    from elasticsearch_tpu_torch.ops import int8_knn, scoring
    from elasticsearch_tpu_torch.search import dsl
    from elasticsearch_tpu_torch.search.executor_torch import TorchExecutor

    times = {}
    pf = reader.segments[0].postings["body"]
    texts = match_texts(pf.term_df, MATCH_QUERIES, seed)
    rng = np.random.default_rng(seed + 11)
    knn_q = rng.standard_normal((KNN_QUERIES, vecs.shape[1])).astype(np.float32)

    # (e)'s queries: multi_match over title^2 and body, as ServePlans
    from elasticsearch_tpu_torch.search.batcher import extract_serve_plan

    mm_texts = match_texts(reader.segments[0].postings["title"].term_df, BATCH, seed + 13, hi=6000)
    mm_queries = [
        dsl.parse_query({"multi_match": {"query": t, "fields": ["title^2", "body"], "tie_breaker": 0.3}})
        for t in mm_texts
    ]
    splans = [extract_serve_plan(q, reader.mappings, reader.analysis) for q in mm_queries]
    check(all(p is not None and p.fields == ("title", "body") for p in splans),
          "a multi_match query did not reduce to a (title, body) ServePlan")

    t = time.perf_counter()
    tex = TorchExecutor(reader, device=device)
    fs = tex.fused_scorer(0, "body")
    check(fs is not None, "fused scorer was not built for the segment")
    fs_mf = tex.fused_scorer_mf(0, ("title", "body"))
    check(fs_mf is not None, "multi-field fused scorer was not built for the segment")

    def mm_plans():
        out = []
        for p in splans:
            secs = [tex.fused_plan_field(0, g.field, tex.fused_parts(0, g.field), g.terms, p.boost)
                    for g in p.groups]
            check(all(x is not None for x in secs), "a multi_match query overflowed the fused slot budget")
            out.append((secs, p.msm))
        return out

    def route_e(plans):
        pend = fs_mf.search_async(plans, K, "max_tie", 0.3, rows=len(plans))
        return scoring.merge_segment_topk([(0, *fs_mf.device_result(pend))], K)

    tex.search(dsl.parse_query({"match": {"body": texts[0]}}), size=K)
    tex.search(None, knn=[dsl.parse_knn({"field": "vec", "query_vector": knn_q[0].tolist(), "k": K})], size=K)
    route_e(mm_plans())
    sync(device)
    times["setup_uploads_s"] = time.perf_counter() - t
    dense_rows = {f: (tex.fused_parts(0, f)["dense"].shape[0] if tex.fused_parts(0, f)["dense"] is not None else 0)
                  for f in ("body", "title")}
    log(f"executor set-up (uploads, dense rows: {dense_rows}) {times['setup_uploads_s']:.2f}s")

    # ---- the main path, with every kernel's count at 0 ----
    int8_knn.int8_dot_scores.launches = 0

    # (a) per-query match route
    t = time.perf_counter()
    res_a = [tex.search(dsl.parse_query({"match": {"body": s}}), size=K) for s in texts]
    sync(device)
    times["a_match_per_query_s"] = time.perf_counter() - t

    # (b) batched fused route
    analyzer = reader.analysis.get(reader.mappings.get("body").analyzer)
    t = time.perf_counter()
    res_b = []
    for b0 in range(0, MATCH_QUERIES, BATCH):
        plans = [tex.fused_plan(fs, 0, "body", analyzer.terms(s), 1.0, 1) for s in texts[b0:b0 + BATCH]]
        check(all(p is not None for p in plans), "a match query overflowed the fused slot budget")
        pending = fs.search_async(plans, K, False, rows=len(plans))
        s_, d_, t_ = fs.device_result(pending)
        res_b.append(scoring.merge_segment_topk([(0, s_, d_, t_)], K))
    sync(device)
    times["b_match_fused_batches_s"] = time.perf_counter() - t

    # (c) exact kNN sections
    secs = [
        dsl.parse_knn({"field": "vec", "query_vector": v.tolist(), "k": K, "num_candidates": 100})
        for v in knn_q
    ]
    t = time.perf_counter()
    res_c = [tex.search(None, knn=[s], size=K) for s in secs]
    sync(device)
    times["c_knn_exact_s"] = time.perf_counter() - t

    # (d) int8 kNN over the same vectors
    t = time.perf_counter()
    qs, qd = qv.search(knn_q, K)
    qd = qd.cpu().numpy()
    times["d_knn_int8_s"] = time.perf_counter() - t

    # (e) multi_match as one multi-field fused group of 32
    t = time.perf_counter()
    plans_e = mm_plans()
    res_e = route_e(plans_e)
    sync(device)
    times["e_multi_match_fused_batch_s"] = time.perf_counter() - t

    launches = {"int8_dot_scores": int8_knn.int8_dot_scores.launches}
    log(f"main path done; launches {launches}")
    check(all(n > 0 for n in launches.values()), f"a kernel never launched on the main path: {launches}")

    # ---- correctness against the oracle ----
    t = time.perf_counter()
    for i in range(ORACLE_QUERIES):
        ref = oracle.search(dsl.parse_query({"match": {"body": texts[i]}}), size=K)
        same_hits(ref, res_a[i], f"(a) match [{texts[i]}]")
        scores, segs, docs, totals = res_b[i // BATCH]
        j = i % BATCH
        check(int(totals[j].sum()) == ref.total, f"(b) total {int(totals[j].sum())} != oracle {ref.total}")
        got = [(float(s), str(int(d))) for s, d in zip(scores[j], docs[j]) if np.isfinite(s)][:K]
        check(len(got) == len(ref.hits), f"(b) {len(got)} hits != oracle {len(ref.hits)}")
        rs = np.array([h.score for h in ref.hits])
        for (gs, _), h in zip(got, ref.hits):
            check(np.isclose(gs, h.score, rtol=RTOL, atol=1e-6), f"(b) score {gs} != oracle {h.score}")
        same_ids([h.doc_id for h in ref.hits], rs, [gd for _, gd in got], f"(b) match [{texts[i]}]")
        ref = oracle.search(None, knn=[secs[i]], size=K)
        same_hits(ref, res_c[i], f"(c) knn query {i}")
        ref = oracle.search(mm_queries[i], size=K)
        scores, _, docs, totals = res_e
        check(int(totals[i].sum()) == ref.total, f"(e) total {int(totals[i].sum())} != oracle {ref.total}")
        got = [(float(s), str(int(d))) for s, d in zip(scores[i], docs[i]) if np.isfinite(s)][:K]
        check(len(got) == len(ref.hits), f"(e) {len(got)} hits != oracle {len(ref.hits)}")
        for (gs, _), h in zip(got, ref.hits):
            check(np.isclose(gs, h.score, rtol=RTOL, atol=1e-6), f"(e) score {gs} != oracle {h.score}")
        same_ids([h.doc_id for h in ref.hits], np.array([h.score for h in ref.hits]),
                 [gd for _, gd in got], f"(e) multi_match [{mm_texts[i]}]")
    # (d) recall@10 against exact f32 cosine, computed on the card
    vt = tex.device_segments[0].vectors["vec"][0]
    qt = torch.from_numpy(knn_q).to(device)
    _, exact = scoring.knn_topk(qt, vt, torch.ones(vt.shape[0], dtype=torch.bool, device=device), "cosine", K)
    exact = exact.cpu().numpy()
    recall = float(np.mean([len(set(exact[i]) & set(qd[i])) / K for i in range(KNN_QUERIES)]))
    log(f"(d) int8 recall@{K} = {recall:.4f}")
    check(recall >= 0.9, f"(d) int8 recall@{K} {recall:.4f} < 0.9")
    times["oracle_checks_s"] = time.perf_counter() - t
    for res, name in ((res_a, "a"), (res_c, "c")):
        check(all(r.hits and np.isfinite(r.hits[0].score) for r in res), f"({name}) empty or non-finite result")
    q0 = dsl.parse_query({"match": {"body": texts[0]}})
    plans0 = [tex.fused_plan(fs, 0, "body", analyzer.terms(s), 1.0, 1) for s in texts[:BATCH]]
    profile = profile_routes({
        "a_match_one_query": lambda: tex.search(q0, size=K),
        "b_match_fused_batch32": lambda: scoring.merge_segment_topk(
            [(0, *fs.device_result(fs.search_async(plans0, K, False, rows=BATCH)))], K
        ),
        "c_knn_one_query": lambda: tex.search(None, knn=[secs[0]], size=K),
        "d_knn_int8_batch32": lambda: qv.search(knn_q, K)[1].cpu(),
        "e_multi_match_fused_batch32": lambda: route_e(plans_e),
    }, device) if device.type == "cuda" else {}
    if profile:
        # the query vector and the global cut's (doc, score) pairs go up
        # through pinned memory: a pageable copy would wait for the device
        pageable = profile["c_knn_one_query"]["pageable_htod"]
        log(f"(c) pageable host-to-device copies: {pageable}, device time "
            f"{profile['c_knn_one_query']['device_us']:.0f}us")
        check(pageable == 0, f"(c) made {pageable} pageable host-to-device copies")
    return {"times": times, "launches": launches, "int8_recall_at_10": recall,
            "totals_a": [r.total for r in res_a[:ORACLE_QUERIES]],
            "totals_e": [int(t.sum()) for t in res_e[3][:ORACLE_QUERIES]], "profile": profile}


def _device_us(evt, names=("self_device_time_total", "self_cuda_time_total")) -> float:
    for name in names:
        v = getattr(evt, name, None)
        if v is not None:
            return float(v)
    return 0.0


# host ranges named while profiling (ops/scoring.topk_desc, see
# named_topk_desc); the profiler mirrors each on the device timeline as
# an annotation spanning the range's kernels and the gaps between them,
# so it is never summed with the kernels
RANGES = ("topk_desc",)


@contextlib.contextmanager
def named_topk_desc():
    """Runs every `ops/scoring.topk_desc` call inside the host range
    "topk_desc" until the block ends. The port itself names no range, so
    its calls outside a profile carry none."""
    import torch

    from elasticsearch_tpu_torch.ops import int8_knn, scoring

    plain = scoring.topk_desc

    def named(x, k):
        with torch.profiler.record_function("topk_desc"):
            return plain(x, k)

    scoring.topk_desc = int8_knn.topk_desc = named
    try:
        yield
    finally:
        scoring.topk_desc = int8_knn.topk_desc = plain


def _range_kernel_us(prof, name: str) -> float:
    """Device time of the kernels launched inside every host range
    `name` traced on this thread: the kernels of its ops, summed."""
    from torch.autograd import DeviceType

    total = 0.0
    stack = [e for e in prof.events() if e.name == name and e.device_type == DeviceType.CPU]
    seen = set()
    while stack:
        e = stack.pop()
        if id(e) in seen:
            continue
        seen.add(id(e))
        total += sum(k.duration for k in e.kernels if k.name not in RANGES)
        stack.extend(e.cpu_children)
    return total


def profile_routes(routes: dict, device) -> dict:
    """One profiled run of each route: wall time, device time summed
    over kernels, the device's idle share of the wall, and the top
    kernels by device time. Profiling adds host overhead, so these walls
    are above the untraced ones in phase 3."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    out = {}
    for name, fn in routes.items():
        fn()  # warm
        sync(device)
        with named_topk_desc(), profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t = time.perf_counter()
            fn()
            sync(device)
            wall_us = (time.perf_counter() - t) * 1e6
        # device activity only (kernels, copies, memsets): the aten ops
        # that launched them carry the same time again
        dev = [
            e for e in prof.key_averages()
            if e.device_type != DeviceType.CPU and _device_us(e) > 0
        ]
        evts = [e for e in dev if e.key not in RANGES]
        busy = sum(_device_us(e) for e in evts)
        top = sorted(evts, key=_device_us, reverse=True)[:6]
        # ops/scoring.topk_desc's kernels (traced only for calls made on
        # this thread)
        topk = _range_kernel_us(prof, "topk_desc")
        # "Memcpy HtoD (Pageable -> Device)": a copy that waits for the
        # device (ops/scoring.upload's pinned copies are "Pinned")
        pageable = sum(e.count for e in dev if "Pageable" in e.key and "HtoD" in e.key)
        out[name] = {
            "wall_us": wall_us,
            "device_us": busy,
            "device_idle_share": max(0.0, 1.0 - busy / wall_us) if wall_us else None,
            "topk_desc_device_us": topk,
            "topk_desc_share_of_device": topk / busy if busy else None,
            "pageable_htod": pageable,
            "top_kernels_us": [[e.key[:80], _device_us(e), e.count] for e in top],
        }
        log(f"profile {name}: wall {wall_us:.0f}us device {busy:.0f}us topk_desc {topk:.0f}us "
            f"pageable HtoD {pageable}")
    return out


# ---------------------------------------------------------------------------
# phase 4: serving over HTTP
# ---------------------------------------------------------------------------


class Http:
    """A JSON client of the port's server on this machine's loopback."""

    def __init__(self, port: int):
        self.base = f"http://127.0.0.1:{port}"

    def call(self, method: str, path: str, body=None, ndjson=None):
        data = None
        headers = {}
        if ndjson is not None:
            data = "".join(json.dumps(x) + "\n" for x in ndjson).encode()
            headers["Content-Type"] = "application/x-ndjson"
        elif body is not None:
            data = json.dumps(body).encode()
            headers["Content-Type"] = "application/json"
        req = urllib.request.Request(self.base + path, data=data, method=method, headers=headers)
        try:
            with urllib.request.urlopen(req, timeout=600) as r:
                return r.status, json.loads(r.read())
        except urllib.error.HTTPError as e:
            return e.code, json.loads(e.read())

    def ok(self, method: str, path: str, body=None, ndjson=None):
        status, out = self.call(method, path, body, ndjson)
        check(status == 200, f"{method} {path}: HTTP {status}: {json.dumps(out)[:400]}")
        return out


def install_segment(svc, seg) -> None:
    """One prebuilt segment as shard 0's whole searchable state (bench.py's
    make_service): `_bulk` of 1M docs through host analysis is set-up,
    not the thing served."""
    eng = svc.shards[0]
    n = seg.num_docs
    eng.segments = [seg]
    eng.live_docs = [None]
    eng.seg_versions = [np.ones(n, np.int64)]
    eng.seg_seqnos = [np.arange(n, dtype=np.int64)]
    eng.seg_names = ["seg_0_0"]
    eng._next_seq = n
    eng.change_generation += 1


def small_docs(seed: int, vocab: int, dims: int):
    """SMALL_DOCS documents over the same Zipf vocabularies as the
    corpus, with its filter columns (`day` a few milliseconds past its
    day boundary, so odd-millisecond bounds split days)."""
    rng = np.random.default_rng(seed + 17)
    probs = 1.0 / np.arange(1, vocab + 1)
    probs /= probs.sum()
    tvocab = min(TITLE_VOCAB, vocab)
    tprobs = 1.0 / np.arange(1, tvocab + 1)
    tprobs /= tprobs.sum()
    out = []
    for i in range(SMALL_DOCS):
        words = rng.choice(vocab, size=int(rng.integers(15, 35)), p=probs)
        v = rng.standard_normal(dims).astype(np.float32)
        out.append((f"s{i}", {"body": " ".join(f"w{w:05d}" for w in words),
                              "vec": [round(float(x), 6) for x in v]}))
    for _, src in out:
        src["title"] = " ".join(f"w{w:05d}" for w in rng.choice(tvocab, size=int(rng.integers(*TITLE_LEN)), p=tprobs))
        src["popularity"] = int(rng.integers(0, 100))
        src["day"] = DAY0 + int(rng.integers(0, 30)) * DAY_MS + int(rng.integers(0, 4))
        src["cat"] = f"cat{int(rng.integers(0, 16)):02d}"
    return out


def small_text_hybrid_bodies(docs: list, dims: int, seed: int) -> dict:
    """The shapes of text_hybrid_bodies over the small index's own words."""
    rng = np.random.default_rng(seed + 31)
    bw = [w for _, src in docs[:200] for w in src["body"].split()]
    tw = [w for _, src in docs[:200] for w in src["title"].split()]
    out = {"bool": [], "multi_match": [], "filtered_bool": [], "hybrid_rrf": []}
    for i in range(4):
        b, t = rng.choice(bw, 4), rng.choice(tw, 2)
        out["bool"].append({"query": {"bool": {
            "must": [{"term": {"body": b[0]}}],
            "should": [{"match": {"body": f"{b[1]} {b[2]}"}}, {"match": {"title": t[0]}}]}}, "size": K})
        out["multi_match"].append({"query": {"multi_match": {
            "query": f"{t[0]} {t[1]} {b[3]}", "fields": ["title^2", "body"], "tie_breaker": 0.3}}, "size": K})
        d = DAY0 + (2 + 5 * i) * DAY_MS
        filters = [{"range": {"popularity": {"gte": 20}}}, {"range": {"day": {"gte": d + 1 + i % 2}}}]
        scoring = ({"must": [{"match": {"body": f"{b[1]} {b[3]}"}}]} if i % 2 == 0 else
                   {"must": [{"term": {"body": b[0]}}], "should": [{"match": {"body": b[2]}}]})
        out["filtered_bool"].append({"query": {"bool": {**scoring, "filter": filters}}, "size": K})
        mm = {"multi_match": {"query": f"{t[0]} {b[1]}", "fields": ["title", "body"]}}
        v = rng.standard_normal(dims)
        knn = {"field": "vec", "query_vector": [float(x) for x in v / np.linalg.norm(v)],
               "k": 20, "num_candidates": 100}
        out["hybrid_rrf"].append(
            {"query": mm, "knn": knn, "rank": {"rrf": {"rank_constant": RRF_RANK_CONSTANT}}, "size": K}
            if i % 2 else
            {"retriever": {"rrf": {"retrievers": [{"standard": {"query": mm}}, {"knn": knn}],
                                   "rank_constant": RRF_RANK_CONSTANT}}, "size": K})
    return out


def hits_of(resp: dict):
    return [(h["_id"], h["_score"]) for h in resp["hits"]["hits"]]


def same_served(ref: dict, got: dict, what: str) -> None:
    """Served responses agree: same total, same ids, scores within RTOL."""
    check(ref["hits"]["total"] == got["hits"]["total"],
          f"{what}: total {got['hits']['total']} != oracle {ref['hits']['total']}")
    rh, gh = hits_of(ref), hits_of(got)
    check(len(rh) == len(gh), f"{what}: {len(gh)} hits != oracle {len(rh)}")
    for (_, rs), (_, gs) in zip(rh, gh):
        check(np.isclose(gs, rs, rtol=RTOL, atol=1e-6), f"{what}: score {gs} != oracle {rs}")
    same_ids([i for i, _ in rh], [s for _, s in rh], [i for i, _ in gh], what)


def tie_runs(scores) -> list:
    """[(i, j)]: the runs of `scores` tied within RTOL."""
    runs, i = [], 0
    while i < len(scores):
        j = i + 1
        while j < len(scores) and np.isclose(scores[j], scores[j - 1], rtol=RTOL, atol=0):
            j += 1
        runs.append((i, j))
        i = j
    return runs


def same_fused(legs: list, got: dict, window: int, what: str, by_global_doc: bool) -> str:
    """A served hybrid page against RRF over the oracle's legs (their
    responses, already held to the served legs). `by_global_doc`: the
    card's fuse (float32 sums, ties on ascending global doc = int(_id),
    the port's rrf_fuse_host); else the host fuse (ties on the _id
    string). Where no oracle leg holds scores tied within RTOL, ids go
    position by position (a tie run of fused scores as a set, the run
    that reaches the page end as a subset of the oracle's run); where
    one does, ranks inside that run may permute, so each served score
    must lie between the least and the most RRF the leg ranks allow.
    Returns the mode used."""
    from elasticsearch_tpu_torch.ops.fusion import rrf_fuse_host

    leg_hits = [hits_of(r) for r in legs]
    gh = hits_of(got)
    union = {i for hits in leg_hits for i, _ in hits}
    check(got["hits"]["total"]["value"] == min(window, len(union)),
          f"{what}: total {got['hits']['total']} for {len(union)} candidates in a window of {window}")
    check(len(gh) == min(len(union), K), f"{what}: {len(gh)} hits for {len(union)} candidates")
    check(all(gh[i][1] >= gh[i + 1][1] for i in range(len(gh) - 1)), f"{what}: scores not descending")
    c = RRF_RANK_CONSTANT
    if all(j - i == 1 for hits in leg_hits for i, j in tie_runs([s for _, s in hits])):
        if by_global_doc:
            es, ed = rrf_fuse_host([np.asarray([[int(i) for i, _ in hits]], np.int64) for hits in leg_hits],
                                   len(union), c)
            exp = [(str(int(d)), float(s)) for s, d in zip(es[0], ed[0]) if d >= 0]
        else:
            acc: dict = {}
            for hits in leg_hits:
                for r, (i, _) in enumerate(hits, 1):
                    acc[i] = acc.get(i, 0.0) + 1.0 / (c + r)
            exp = sorted(acc.items(), key=lambda kv: (-kv[1], kv[0]))
        for (_, es_), (_, gs) in zip(exp, gh):
            check(np.isclose(gs, es_, rtol=RTOL, atol=0), f"{what}: fused score {gs} != {es_}")
        for i, j in tie_runs([s for _, s in exp]):
            if i >= len(gh):
                break
            want = {d for d, _ in exp[i:j]}
            have = {d for d, _ in gh[i:min(j, len(gh))]}
            ok = have == want if j <= len(gh) else have <= want
            check(ok, f"{what}: fused ids {have} at ranks {i}-{j - 1} != oracle {want}")
        return "exact"
    lo = {i: 0.0 for i in union}
    hi = {i: 0.0 for i in union}
    for hits in leg_hits:
        for a, b in tie_runs([s for _, s in hits]):
            for i, _ in hits[a:b]:
                lo[i] += 1.0 / (c + b)
                hi[i] += 1.0 / (c + a + 1)
    for i, s in gh:
        check(i in union and lo[i] * (1 - RTOL) <= s <= hi[i] * (1 + RTOL),
              f"{what}: fused score {s} of {i} outside [{lo.get(i)}, {hi.get(i)}]")
    if len(gh) == K:
        # a candidate whose least RRF beats the page's last score belongs
        # on the page
        floor = gh[-1][1] * (1 + RTOL)
        missing = [i for i in union - {i for i, _ in gh} if lo[i] > floor]
        check(not missing, f"{what}: {missing} must be on the page (least RRF above {floor})")
    return "interval"


def drive(http: Http, path: str, bodies: list, clients: int):
    """Sends every body once from `clients` threads; returns (responses
    in body order, per-request latencies in ms, wall seconds)."""
    out = [None] * len(bodies)
    lat = [0.0] * len(bodies)
    nxt = iter(range(len(bodies)))
    lock = threading.Lock()
    errors = []

    def worker():
        while True:
            with lock:
                i = next(nxt, None)
            if i is None:
                return
            t = time.perf_counter()
            try:
                out[i] = http.ok("POST", path, bodies[i])
            except BaseException as e:  # surfaced after the join
                errors.append(e)
                return
            lat[i] = (time.perf_counter() - t) * 1e3

    threads = [threading.Thread(target=worker) for _ in range(clients)]
    t = time.perf_counter()
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=600)
    wall = time.perf_counter() - t
    check(not any(th.is_alive() for th in threads), f"{path}: a client thread hung")
    if errors:
        raise errors[0]
    return out, lat, wall


def _client_loop(port: int, conn) -> None:
    """The load generator's process: runs `drive` for each (path,
    bodies, clients) it receives, until it receives None."""
    http = Http(port)
    while True:
        msg = conn.recv()
        if msg is None:
            break
        try:
            conn.send(("ok", drive(http, *msg)))
        except BaseException as e:  # reported to the parent
            conn.send(("err", repr(e)))
    conn.close()


class ClientProcess:
    """HTTP clients in a process of their own, so the load they generate
    does not compete with the server for its interpreter lock (what the
    server's users feel). Started with `spawn`; closed by `close()`."""

    def __init__(self, port: int):
        ctx = multiprocessing.get_context("spawn")
        self.conn, child = ctx.Pipe()
        self.proc = ctx.Process(target=_client_loop, args=(port, child), daemon=True)
        self.proc.start()
        child.close()

    def drive(self, path: str, bodies: list, clients: int):
        self.conn.send((path, bodies, clients))
        tag, out = self.conn.recv()
        check(tag == "ok", f"client process: {out}")
        return out

    def close(self) -> None:
        try:
            self.conn.send(None)
        except OSError:
            pass
        self.proc.join(timeout=30)
        if self.proc.is_alive():
            self.proc.terminate()
            self.proc.join(timeout=10)


def latency_row(lat: list, wall: float) -> dict:
    a = np.asarray(lat)
    return {"requests": len(lat), "qps": len(lat) / wall, "p50_ms": float(np.percentile(a, 50)),
            "p99_ms": float(np.percentile(a, 99)), "mean_ms": float(a.mean())}


def drive_measured(clients_proc: ClientProcess, path: str, bodies: list, clients: int):
    """`drive` in the client process; the latency row also carries this
    (the server's) process's CPU time over the drive: its share of the
    wall (1.0 = one core busy throughout) and its time per request."""
    cpu = time.process_time()
    out, lat, wall = clients_proc.drive(path, bodies, clients)
    cpu = time.process_time() - cpu
    row = latency_row(lat, wall)
    row["server_cpu_share"] = cpu / wall
    row["server_cpu_ms_per_request"] = cpu * 1e3 / len(lat)
    return out, row


# innermost frames of a thread that is blocked, not running Python
WAIT_FRAMES = {
    ("threading.py", "wait"), ("queue.py", "get"), ("socket.py", "readinto"),
    ("socket.py", "accept"), ("selectors.py", "select"), ("threading.py", "_wait_for_tstate_lock"),
    ("thread.py", "_worker"),  # an idle ThreadPoolExecutor thread
}


def thread_role(name: str):
    if name.startswith("query-batcher"):
        return "batcher"
    if name.startswith("search-fanout"):
        return "fanout"
    if "process_request_thread" in name:
        return "http"
    return None


class HostSampler:
    """Samples the Python stack of every HTTP, fan-out and batcher thread
    of this process every `period` seconds, from a thread of its own
    (what a sampling profiler does; none is installed). Per role it
    counts the share of samples blocked in a wait (WAIT_FRAMES) and, of
    the others, the innermost frames (file:function). The sampler's own wake-up delay past
    `period` is how long a runnable thread waited for the interpreter
    lock at that moment."""

    def __init__(self, period: float = 0.001):
        self.period = period
        self.counts: dict = {}
        self.lags: list = []
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, name="host-sampler", daemon=True)

    def __enter__(self):
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join(timeout=10)

    def _run(self) -> None:
        from collections import Counter

        while not self._stop.is_set():
            t = time.perf_counter()
            time.sleep(self.period)
            self.lags.append(time.perf_counter() - t - self.period)
            names = {th.ident: th.name for th in threading.enumerate()}
            for ident, frame in sys._current_frames().items():
                role = thread_role(names.get(ident, ""))
                if role is None:
                    continue
                code = frame.f_code
                where = (Path(code.co_filename).name, code.co_name)
                self.counts.setdefault(role, Counter())[where] += 1

    def summary(self, top: int = 8) -> dict:
        lags = np.asarray(self.lags) * 1e3
        out = {"samples": len(lags), "period_ms": self.period * 1e3,
               "lock_wait_ms_mean": float(lags.mean()) if len(lags) else None,
               "lock_wait_ms_p50": float(np.percentile(lags, 50)) if len(lags) else None,
               "lock_wait_ms_p99": float(np.percentile(lags, 99)) if len(lags) else None}
        for role, c in sorted(self.counts.items()):
            n = sum(c.values())
            running = [(w, v) for w, v in c.most_common() if w not in WAIT_FRAMES]
            n_run = sum(v for _, v in running)
            out[role] = {
                "thread_samples": n,
                "blocked_share": 1.0 - n_run / n,
                "top_running": [[f"{f}:{fn}", v / n_run] for (f, fn), v in running[:top]],
            }
        return out


def count_syncs(fn) -> dict:
    """Host-device synchronisations made by one call of `fn` on this
    thread (`torch.cuda.set_sync_debug_mode`, which warns at every
    synchronising call), with the source lines that made them."""
    import warnings
    from collections import Counter

    import torch

    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            fn()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    where = Counter(f"{Path(w.filename).name}:{w.lineno}" for w in caught
                    if "synchroniz" in str(w.message))
    return {"syncs": sum(where.values()), "where": where.most_common(6)}


# the 8-client /bench drive again under each variant: (name, batcher
# workers, the interpreter's thread switch interval in s, host sampler)
DIAG_VARIANTS = (
    ("workers6_switch5ms", 6, 0.005, False),
    ("workers1_switch5ms", 1, 0.005, False),
    ("workers2_switch5ms", 2, 0.005, False),
    ("workers6_switch0.5ms", 6, 0.0005, False),
    ("workers1_switch0.5ms", 1, 0.0005, False),
    ("workers6_switch5ms_sampled", 6, 0.005, True),
)


def diagnose_concurrency(srv, http: Http, clients_proc: ClientProcess,
                         match_bodies: list, knn_bodies: list) -> dict:
    """Why 8 clients form few groups and serve fewer QPS than 1: each
    variant gets a fresh `/bench` batcher (one warm request per route
    first), then the 8-client drive of both routes; its QPS, latency,
    the server's CPU share, launches by bucket and, where sampled, where
    the server's threads were."""
    from elasticsearch_tpu_torch.search.batcher import QueryBatcher

    bench = srv.cluster.get_index("bench")
    switch0 = sys.getswitchinterval()
    out = {}
    try:
        for name, workers, switch, sampled in DIAG_VARIANTS:
            old, bench._batcher = bench._batcher, QueryBatcher(workers=workers)
            old.close()
            sys.setswitchinterval(switch)
            for bodies in (match_bodies, knn_bodies):
                http.ok("POST", "/bench/_search", bodies[0])
            bench._batcher.wait_warm_idle()
            b = bench._batcher
            base = b.batching_stats()
            launches0, jobs0 = b.stats["launches"], b.stats["jobs"]
            res = {}
            sampler = HostSampler() if sampled else contextlib.nullcontext()
            with sampler:
                for route, bodies in (("match", match_bodies), ("knn", knn_bodies)):
                    _, res[route] = drive_measured(clients_proc, "/bench/_search", bodies, CLIENTS)
            bs = b.batching_stats()
            res["launches"] = b.stats["launches"] - launches0
            res["jobs"] = b.stats["jobs"] - jobs0
            res["launches_by_bucket"] = {
                k: n - base["launches_by_bucket"].get(k, 0) for k, n in bs["launches_by_bucket"].items()
            }
            res["express_lane_hits"] = bs["express_lane_hits"] - base["express_lane_hits"]
            if sampled:
                res["host_samples"] = sampler.summary()
            log(f"diagnosis {name}: match {res['match']} knn {res['knn']} "
                f"launches {res['launches']} for {res['jobs']} jobs, by bucket {res['launches_by_bucket']}")
            out[name] = res
    finally:
        sys.setswitchinterval(switch0)
    return out


def node_stats(http: Http) -> dict:
    node = http.ok("GET", "/_nodes/stats")["nodes"]["node-0"]
    return {"search": node["thread_pool"]["search"], "batching": node["pipeline"]["batching"],
            "pipeline": {k: v for k, v in node["pipeline"].items() if k != "batching"}}


def phase_serve(reader, dims: int, seed: int, device, card: str) -> dict:
    import torch

    from elasticsearch_tpu_torch.rest.server import ElasticsearchTpuServer
    from elasticsearch_tpu_torch.search import dsl
    from elasticsearch_tpu_torch.search.admission import admission
    from elasticsearch_tpu_torch.search.batcher import QueryBatcher, extract_knn_plan, extract_match_plan
    from elasticsearch_tpu_torch.search.executor_torch import TorchExecutor

    # a closed-loop measurement of the serving path, as bench.py's
    # closed-loop sections run it: the admission layer's queueing and
    # brownout tiers stay out of it
    admission.configure(enabled=False)
    check(torch.get_float32_matmul_precision() == "highest",
          f"float32 matmul precision is {torch.get_float32_matmul_precision()!r}, not 'highest'")
    seg = reader.segments[0]
    pf = seg.postings["body"]
    vocab = len(pf.terms)
    mapping = corpus_mapping(dims)
    times = {}
    t = time.perf_counter()
    srv = ElasticsearchTpuServer(port=0, device=device)
    srv.start_background()
    clients_proc = None
    try:
        http = Http(srv.port)
        clients_proc = ClientProcess(srv.port)
        for name, backend, shards in (("bench", "torch", 1), ("bench_oracle", "numpy", 1),
                                      ("small", "torch", 2), ("small_oracle", "numpy", 2)):
            # refresh_interval -1: segments come from the explicit
            # refreshes below only, not from the background refresher
            http.ok("PUT", f"/{name}", {"settings": {"number_of_shards": shards,
                                                     "search.backend": backend,
                                                     "refresh_interval": "-1"},
                                        "mappings": mapping})
        for name in ("bench", "bench_oracle"):
            install_segment(srv.cluster.get_index(name), seg)
        docs = small_docs(seed, vocab, dims)
        half = len(docs) // 2
        for name in ("small", "small_oracle"):
            for part in (docs[:half], docs[half:]):
                lines = []
                for doc_id, src in part:
                    lines += [{"index": {"_id": doc_id}}, src]
                out = http.ok("POST", f"/{name}/_bulk?refresh=true", ndjson=lines)
                check(not out["errors"], f"/{name}/_bulk reported errors")
            for i in range(SMALL_DELETES):
                http.ok("DELETE", f"/{name}/_doc/s{i * 37}")
            http.ok("POST", f"/{name}/_refresh")
            check(all(len(e.segments) == 2 for e in srv.cluster.get_index(name).shards),
                  f"/{name}: expected two segments per shard")
        times["setup_s"] = time.perf_counter() - t

        texts = match_texts(pf.term_df, MATCH_QUERIES, seed)
        rng = np.random.default_rng(seed + 19)
        match_bodies = [{"query": {"match": {"body": s}}, "size": K} for s in texts]
        knn_bodies = [
            {"knn": {"field": "vec", "query_vector": [float(x) for x in v], "k": K,
                     "num_candidates": 100}, "size": K}
            for v in rng.standard_normal((KNN_QUERIES, dims)).astype(np.float32)
        ]
        # one of each first: the executor's uploads and dense rows are
        # set-up, not serving
        t = time.perf_counter()
        http.ok("POST", "/bench/_search", match_bodies[0])
        http.ok("POST", "/bench/_search", knn_bodies[0])
        times["first_requests_s"] = time.perf_counter() - t
        stats0 = node_stats(http)

        # ---- the served path: 8 clients, then 1 (client process) ----
        served = {}
        rows = {}
        for clients in (CLIENTS, 1):
            for route, bodies in (("match", match_bodies), ("knn", knn_bodies)):
                out, rows[f"{route}_{clients}_clients"] = drive_measured(
                    clients_proc, "/bench/_search", bodies, clients)
                served[(route, clients)] = out
                log(f"/bench {route} x{len(bodies)} from {clients} clients: "
                    f"{rows[f'{route}_{clients}_clients']}")
        stats_bench = node_stats(http)
        bench_search = {k: stats_bench["search"][k] - stats0["search"][k]
                        for k in ("launches", "fused_jobs", "chunked_jobs", "completed")}
        by_bucket = {
            b: n - stats0["batching"]["launches_by_bucket"].get(b, 0)
            for b, n in stats_bench["batching"]["launches_by_bucket"].items()
        }
        log(f"/bench batcher: {bench_search}, launches by bucket {by_bucket}")
        check(bench_search["launches"] > 0, "/bench: the batcher launched nothing")
        check(bench_search["fused_jobs"] > 0, "/bench: no job went through a batched launch")
        check(any(int(b) > 1 and n > 0 for b, n in by_bucket.items()),
              f"/bench: no launch wider than one query row ({by_bucket})")

        # ---- held to the numpy oracle ----
        t = time.perf_counter()
        for route, bodies in (("match", match_bodies), ("knn", knn_bodies)):
            for i in range(ORACLE_QUERIES):
                ref = http.ok("POST", "/bench_oracle/_search", bodies[i])
                for clients in (CLIENTS, 1):
                    same_served(ref, served[(route, clients)][i],
                                f"/bench {route} body {i} ({clients} clients)")
        times["bench_oracle_s"] = time.perf_counter() - t

        # ---- the small index: chunked path, 2 shards, deletes ----
        t = time.perf_counter()
        rng = np.random.default_rng(seed + 23)
        words = [w for _, src in docs[:200] for w in src["body"].split()]
        small_bodies = []
        for i in range(SMALL_QUERIES):
            q = " ".join(rng.choice(words, size=int(rng.integers(2, 5))))
            if i % 4 == 3:
                small_bodies.append({"query": {"match": {"body": {"query": q, "operator": "and"}}}})
            else:
                small_bodies.append({"query": {"match": {"body": q}}, "size": K})
        for v in rng.standard_normal((SMALL_QUERIES // 2, dims)).astype(np.float32):
            small_bodies.append({"knn": {"field": "vec", "query_vector": [float(x) for x in v],
                                         "k": K, "num_candidates": 50}})
        out, rows["small_mixed_8_clients"] = drive_measured(
            clients_proc, "/small/_search", small_bodies, CLIENTS)
        for i, body in enumerate(small_bodies):
            same_served(http.ok("POST", "/small_oracle/_search", body), out[i], f"/small body {i}")
        stats_small = node_stats(http)
        chunked = stats_small["search"]["chunked_jobs"] - stats_bench["search"]["chunked_jobs"]
        log(f"/small: {chunked} (job, segment) pairs through the chunked path")
        check(chunked > 0, "/small: the chunked path was not taken")
        times["small_s"] = time.perf_counter() - t
        ex = srv.cluster.get_index("small")._executor(srv.cluster.get_index("small").shards[0])
        check(isinstance(ex, TorchExecutor) and ex.device.type == device.type,
              "/small is not served by a TorchExecutor on the card")

        # ---- bool, multi_match, filtered bool and hybrid RRF ----
        t = time.perf_counter()
        text_hybrid = serve_text_hybrid(srv, http, clients_proc, seg, docs, dims, seed, device, rows)
        times["text_hybrid_s"] = time.perf_counter() - t

        # ---- profiles: 8 requests served over HTTP per route (the
        # card's activity; the server's threads are not traced on the
        # host side), then one batcher group of 8 per route run on this
        # thread, whose host ranges (topk_desc's share) are traced ----
        profile, syncs = {}, {}
        if device.type == "cuda":
            def group(bodies):
                return lambda: clients_proc.drive("/bench/_search", bodies[:CLIENTS], CLIENTS)

            bench = srv.cluster.get_index("bench")
            bex = bench._executor(bench.shards[0])
            gb = QueryBatcher(workers=1)
            gb._ensure_thread = lambda: None  # groups run on this thread
            mplans = [extract_match_plan(dsl.parse_query(b["query"]), bench.mappings,
                                         bench.analysis) for b in match_bodies[:CLIENTS]]
            kplans = [extract_knn_plan([dsl.parse_knn(b["knn"])], bench.mappings)
                      for b in knn_bodies[:CLIENTS]]

            def batcher_match():
                jobs = [gb.submit_nowait(bex, p, K) for p in mplans]
                gb._run_group(jobs, "body", 16, rows=CLIENTS)

            def batcher_knn():
                jobs = [gb.submit_nowait(bex, p, K, kind="knn") for p in kplans]
                gb._collect_knn_group(jobs, gb._dispatch_knn_group(jobs, rows=CLIENTS))

            profile = profile_routes({"served_match_http_8": group(match_bodies),
                                      "served_knn_http_8": group(knn_bodies),
                                      "batcher_match_group_8": batcher_match,
                                      "batcher_knn_group_8": batcher_knn}, device)
            syncs = {"batcher_match_group_8": count_syncs(batcher_match),
                     "batcher_knn_group_8": count_syncs(batcher_knn)}
            log(f"synchronising calls per batcher group: {syncs}")
            gb.close()

        # ---- why 8 clients form few groups (measured, not checked) ----
        t = time.perf_counter()
        diagnosis = diagnose_concurrency(srv, http, clients_proc, match_bodies, knn_bodies)
        times["diagnosis_s"] = time.perf_counter() - t
        return {"card": card, "latency": rows, "times": times, "bench_batcher": bench_search, "text_hybrid": text_hybrid,
                "bench_launches_by_bucket": by_bucket, "small_chunked_jobs": chunked,
                "pipeline": stats_small["pipeline"], "profile": profile,
                "syncs_per_group": syncs, "concurrency_diagnosis": diagnosis,
                "float32_matmul_precision": torch.get_float32_matmul_precision()}
    finally:
        if clients_proc is not None:
            clients_proc.close()
        srv.close()


TEXT_HYBRID_ROUTES = ("bool", "multi_match", "filtered_bool", "hybrid_rrf")


def serve_text_hybrid(srv, http: Http, clients_proc: ClientProcess, seg, docs, dims: int, seed: int,
                 device, rows: dict) -> dict:
    """`bool`, `multi_match`, filtered `bool` and hybrid RRF served on
    the card: `/bench` from 8 clients then 1 (latency rows go into
    `rows`), 8 bodies per route held to `/bench_oracle` (a hybrid leg by
    leg, then its fusion), the counters that show the batched route was
    taken, the same shapes on `/small`, and one profiled batcher group
    of 8 per route."""
    from elasticsearch_tpu_torch.search import dsl
    from elasticsearch_tpu_torch.search.batcher import (
        QueryBatcher, extract_knn_plan, extract_serve_plan, split_filtered_bool,
    )

    bench = srv.cluster.get_index("bench")
    b5 = text_hybrid_bodies(seg.postings["body"].term_df, seg.postings["title"].term_df, dims, seed)
    bodies = {r: b5[r] + (b5["day_ranges"] if r == "filtered_bool" else []) for r in TEXT_HYBRID_ROUTES}
    # one of each first: the title field's uploads and dense rows are
    # set-up, not serving
    for r in TEXT_HYBRID_ROUTES:
        http.ok("POST", "/bench/_search", bodies[r][0])
    with bench._rrf_lock:
        for key in bench.rrf_stats:
            bench.rrf_stats[key] = 0
    served, per_route = {}, {}
    for clients in (CLIENTS, 1):
        for r in TEXT_HYBRID_ROUTES:
            st0, qc0 = node_stats(http), node_query_cache(http)
            out, rows[f"{r}_{clients}_clients"] = drive_measured(clients_proc, "/bench/_search", bodies[r], clients)
            st1, qc1 = node_stats(http), node_query_cache(http)
            served[(r, clients)] = out
            d = {k: st1["search"][k] - st0["search"][k] for k in ("launches", "fused_jobs", "fused_overflow_jobs")}
            d["query_cache_hits"] = qc1["hit_count"] - qc0["hit_count"]
            d["query_cache_misses"] = qc1["miss_count"] - qc0["miss_count"]
            per_route[f"{r}_{clients}_clients"] = d
            log(f"/bench {r} x{len(bodies[r])} from {clients} clients: {rows[f'{r}_{clients}_clients']} {d}")
            if r in ("bool", "multi_match"):
                # every body rode the serve family's fused launch
                check(d["fused_jobs"] == len(bodies[r]) and d["fused_overflow_jobs"] == 0,
                      f"/bench {r}: {d} for {len(bodies[r])} bodies: not all on the serve family's fused route")
            if r == "filtered_bool":
                check(d["query_cache_hits"] > 0, f"/bench filtered_bool: no filter-cache hit ({d})")
    rrf = dict(bench.rrf_stats)
    n_hybrid = 2 * len(bodies["hybrid_rrf"])
    log(f"/bench rrf_stats: {rrf}")
    check(rrf["searches"] == n_hybrid and rrf["device_fused"] == n_hybrid and rrf["host_fused"] == 0,
          f"/bench: {n_hybrid} hybrid requests, rrf_stats {rrf}: not all fused on the card")
    check(rrf["batcher_legs"] == 2 * n_hybrid and rrf["pool_legs"] == 0 and rrf["inline_legs"] == 0,
          f"/bench: hybrid legs left the batcher: {rrf}")

    # ---- held to the numpy oracle ----
    t = time.perf_counter()
    checked = {"fused_check_modes": []}
    for r in ("bool", "multi_match", "filtered_bool"):
        picks = list(range(ORACLE_QUERIES))
        if r == "filtered_bool":
            picks += list(range(len(b5[r]), len(bodies[r])))  # the day ranges
        for i in picks:
            ref = http.ok("POST", "/bench_oracle/_search", bodies[r][i])
            for clients in (CLIENTS, 1):
                same_served(ref, served[(r, clients)][i], f"/bench {r} body {i} ({clients} clients)")
        checked[r] = len(picks)
    for i in range(ORACLE_QUERIES):
        body = bodies["hybrid_rrf"][i]
        bm25, knn, window = hybrid_legs(body)
        legs = []
        for leg in (bm25, knn):
            ref = http.ok("POST", "/bench_oracle/_search", leg)
            same_served(ref, http.ok("POST", "/bench/_search", leg), f"/bench hybrid {i} leg")
            legs.append(ref)
        for clients in (CLIENTS, 1):
            checked["fused_check_modes"].append(same_fused(
                legs, served[("hybrid_rrf", clients)][i], window,
                f"/bench hybrid {i} ({clients} clients)", by_global_doc=True))
    checked["hybrid_rrf"] = ORACLE_QUERIES
    checked["oracle_s"] = time.perf_counter() - t

    # ---- /small: the tree-walk fallback, the 2-shard host fuse ----
    sb = small_text_hybrid_bodies(docs, dims, seed)
    small = []
    for r in TEXT_HYBRID_ROUTES:
        small += [(r, b) for b in sb[r]]
    qc0 = node_query_cache(http)
    out, rows["small_text_hybrid_8_clients"] = drive_measured(clients_proc, "/small/_search", [b for _, b in small], CLIENTS)
    for i, (r, body) in enumerate(small):
        if r != "hybrid_rrf":
            same_served(http.ok("POST", "/small_oracle/_search", body), out[i], f"/small {r} body {i}")
            continue
        bm25, knn, window = hybrid_legs(body)
        legs = []
        for leg in (bm25, knn):
            ref = http.ok("POST", "/small_oracle/_search", leg)
            same_served(ref, http.ok("POST", "/small/_search", leg), f"/small hybrid {i} leg")
            legs.append(ref)
        checked["fused_check_modes"].append(
            same_fused(legs, out[i], window, f"/small hybrid {i}", by_global_doc=False))
    small_rrf = dict(srv.cluster.get_index("small").rrf_stats)
    check(small_rrf["host_fused"] == len(sb["hybrid_rrf"]) and small_rrf["pool_legs"] == 2 * len(sb["hybrid_rrf"]),
          f"/small: 2-shard hybrids must fuse on the host from pool legs: {small_rrf}")
    qc1 = node_query_cache(http)
    log(f"/small bool, multi_match, filtered bool, hybrid: {len(small)} bodies held to /small_oracle; rrf {small_rrf}; "
        f"query cache hits {qc1['hit_count'] - qc0['hit_count']}; fused checks {checked['fused_check_modes']}")

    # ---- one profiled batcher group of 8 per route (this thread) ----
    profile, syncs = {}, {}
    if device.type == "cuda":
        bex = bench._executor(bench.shards[0])
        gb = QueryBatcher(workers=1)
        gb._ensure_thread = lambda: None  # groups run on this thread

        def serve_jobs(route):
            qs = [dsl.parse_query(b["query"]) for b in bodies[route][:CLIENTS]]
            return [(extract_serve_plan(q, bench.mappings, bench.analysis), q) for q in qs]

        groups = {r: serve_jobs(r) for r in ("bool", "multi_match")}
        hyb = [hybrid_legs(b) for b in bodies["hybrid_rrf"][:CLIENTS]]
        hyb_serve = [(extract_serve_plan(q, bench.mappings, bench.analysis), q)
                     for q in (dsl.parse_query(h[0]["query"]) for h in hyb)]
        hyb_knn = [extract_knn_plan([dsl.parse_knn(h[1]["knn"])], bench.mappings) for h in hyb]
        fq = dsl.parse_query(bodies["filtered_bool"][0]["query"])
        stripped, fclauses = split_filtered_bool(fq)

        def serve_group(route):
            def run():
                jobs = [gb.submit_nowait(bex, p, K, kind="serve", query=q) for p, q in groups[route]]
                gb._collect_serve_group(jobs, 16, gb._dispatch_serve_group(jobs, 16, rows=CLIENTS))
            return run

        def filtered_one():
            bex.search_plan_filtered(stripped, fclauses, K, 10_000, bench.mappings, bench.analysis)

        def hybrid_group():
            sj = [gb.submit_nowait(bex, p, K, kind="serve", query=q) for p, q in hyb_serve]
            kj = [gb.submit_nowait(bex, p, K, kind="knn") for p in hyb_knn]
            sp = gb._dispatch_serve_group(sj, 16, rows=CLIENTS)
            kp = gb._dispatch_knn_group(kj, rows=CLIENTS)
            gb._collect_serve_group(sj, 16, sp)
            gb._collect_knn_group(kj, kp)
            for a, b in zip(sj, kj):
                bench._fuse_legs_device([{"td": a.result, "ex": bex}, {"td": b.result, "ex": bex}],
                                        hyb[0][2], RRF_RANK_CONSTANT)

        fns = {"batcher_bool_group_8": serve_group("bool"),
               "batcher_multi_match_group_8": serve_group("multi_match"),
               "filtered_bool_one_request": filtered_one,
               "batcher_hybrid_legs_and_fuse_8": hybrid_group}
        profile = profile_routes(fns, device)
        syncs = {name: count_syncs(fn) for name, fn in fns.items()}
        log(f"synchronising calls, serve, filtered and hybrid groups: {syncs}")
        gb.close()
    return {"served_routes": {r: len(bodies[r]) for r in TEXT_HYBRID_ROUTES}, "counters": per_route,
            "rrf_stats_bench": rrf, "rrf_stats_small": small_rrf, "checked": checked,
            "small_bodies": len(small), "profile": profile, "syncs_per_group": syncs}


def node_query_cache(http: Http) -> dict:
    return http.ok("GET", "/_nodes/stats")["nodes"]["node-0"]["indices"]["query_cache"]


def gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def run(device, seed: int, n_docs: int, vocab: int, dims: int, card: str) -> dict:
    import torch

    from elasticsearch_tpu_torch.ops.int8_knn import QuantizedVectors
    from elasticsearch_tpu_torch.search.executor import NumpyExecutor

    phases = {}
    t = time.perf_counter()
    build_s = phase_build() if device.type == "cuda" else {}
    phases["1_build_s"] = time.perf_counter() - t

    t = time.perf_counter()
    reader, vecs = build_corpus(seed, n_docs, vocab, dims)
    oracle = NumpyExecutor(reader)
    qv = QuantizedVectors(vecs, similarity="cosine", device=device)
    phases["corpus_s"] = time.perf_counter() - t
    log(f"corpus: {n_docs} docs, {reader.segments[0].postings['body'].n_tiles} tiles, "
        f"{dims}-d vectors, int8 twin {tuple(qv.qvecs.shape)} in {phases['corpus_s']:.1f}s")

    t = time.perf_counter()
    rng = np.random.default_rng(seed + 13)
    kernels = phase_kernels(qv, rng.standard_normal((BATCH, dims)).astype(np.float32), device)
    phases["2_kernels_s"] = time.perf_counter() - t

    t = time.perf_counter()
    main = phase_main(reader, oracle, vecs, qv, seed, device)
    phases["3_main_path_s"] = time.perf_counter() - t
    for k in kernels:
        k["launches"] = main["launches"][k["name"]]
    del oracle, qv

    # the peak so far (phases 1-3), then phase 4's own from a reset
    peaks = {"phases_1_3": torch.cuda.max_memory_allocated(device) if device.type == "cuda" else None}
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    t = time.perf_counter()
    serve = phase_serve(reader, vecs.shape[1], seed, device, card)
    phases["4_serve_s"] = time.perf_counter() - t
    peaks["phase_4"] = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else None
    peak = max(peaks.values()) if device.type == "cuda" else None
    log(f"peak device bytes {peaks}")
    return {
        "card": card,
        "build_s": build_s,
        "phases": phases,
        "main_path": main,
        "serve": serve,
        "peak_device_bytes": peak,
        "peak_device_bytes_by_phase": peaks,
        "kernels": kernels,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--docs", type=int, default=1_000_000)
    ap.add_argument("--vocab", type=int, default=50_000)
    ap.add_argument("--dims", type=int, default=768)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the card", file=sys.stderr)
        return 2
    # the port itself lives beside this script
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    import elasticsearch_tpu_torch  # noqa: F401  (fails outside the repository)

    device = torch.device("cuda", 0)
    card = gpu_line()
    print(card, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}", flush=True)
    result = run(device, args.seed, args.docs, args.vocab, args.dims, card)
    print(json.dumps({"card": card, "phases": result["phases"], "build_s": result["build_s"],
                      "main_path": result["main_path"], "peak_device_bytes": result["peak_device_bytes"],
                      "peak_device_bytes_by_phase": result["peak_device_bytes_by_phase"]}))
    print(card, flush=True)
    print(json.dumps({"card": card, "serve": result["serve"]}), flush=True)
    print(card, flush=True)
    print(json.dumps({"kernels": result["kernels"]}), flush=True)
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }), flush=True)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        sys.exit(1)
