"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--seed 42] [--docs 1000000] [--vocab 50000] [--dims 768]

Drives the port's shard query phase (`elasticsearch_tpu_torch`) at the
scale of BASELINE configs 1 (BM25 `match`), 2 (`bool`), 3
(`multi_match`), 4 (768-d cosine kNN) and 5 (hybrid BM25 + kNN +
sparse_vector with RRF) and bench.py's `sparse_retrieval`,
`repeated_agg`, `cold_agg`, `ann_knn` and `rag_rerank`: one segment of
1,000,000 documents with a `body` text field over a 50,000-term Zipf
vocabulary (15-34 tokens each, with positions: a token's index in its
doc), a `title` text field over a 20,000-term Zipf vocabulary (3-8
tokens), a 768-d unit-vector `vec` field, bench.py's filter columns
(`popularity` integer 0-99, `day` date over 30 days, `cat` keyword with
16 values) and its learned-sparse `ml` column (3-9 terms per doc over a
300-token Zipf-0.7 vocabulary, weights in [0.05, 3.05), impact-ordered
int8 and fp32 planes), all made from `--seed`. Phases, each of which stops the run with a non-zero exit on
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
     (a2) 32 `match` queries past the fused slot budget (every fourth
         with operator "and") as one batcher group, scored on the
         chunked block-max route by the BM25 tile add, held to the
         oracle on 8 (totals, or a lower bound where pruned; hits;
         scores within rtol 1e-5) and run twice to the same bits; the
         tile add on its largest pass held bit for bit to its plain
         version and timed beside its byte bound, as again on the
         largest pass that phase 4's `/small` drive sent over HTTP,
         whose tile-add launches must be more than 0,
     (c) 32 exact kNN sections (k=10, num_candidates=100),
     (d) QuantizedVectors.search over the same vectors, B=32, k=10,
     (e) 32 `multi_match` (title^2, body, tie_breaker 0.3) as one group
         through fused_plan_field → MultiFusedScorer.search_async →
         merge_segment_topk;
     (f) 32 `sparse_vector` queries as one batcher sparse group, int8
         then fp32 (phase A, one theta download, the kept tiles, one
         merge; each pass one impact tile add), held to the oracle:
         fp32 pages by ids, int8 by recall@10 >= 0.95; the impact tile
         add on each group's largest pass, and on one pass at the ELSER
         cell's shape (about 68,352 tiles over 8,841,823 docs, f32 and
         int8), held bit for bit to its plain version and the replaced
         512-tile loop and timed beside them and its byte bound;
     (g) one `cold_agg` body and one dashboard body with metric subs and
         percentiles through DeviceAggPlan dispatch + collect, equal to
         the host AggCollector; each plain PyTorch op these routes run
         (`sorted_bucket_counts`/`_metrics`,
         `masked_sorted`, ...) timed alone beside its byte bound, and
         `topk_desc` beside its earlier two-scan version on the same
         input;
     (i) 32 `match` bodies sorted by `popularity` desc and by `day` asc,
         each with a second page through search_after, through
         execute_sorted_device, equal to the oracle's execute_sorted
         (ids, sort values, totals); a multi-key body must take the
         oracle's route;
     (h) bench.py's `ann_knn` corpus (1M x 768 unit cosine rows around
         512 Gaussian centers, noise 0.5, stored f16; nlist 2000): the
         IVF index built on the card from one seed (phase 4's
         `/ann_int8` builds it again, bit for bit), one Lloyd step timed alone,
         one batcher `knn` group of 32 at nprobe 8 in f16 and in int8
         with recall@10 >= 0.95 against the exact group on the same
         rows, 8 exact pages held to the oracle, 0 pageable uploads in
         the profiled groups, and the plain probe timed beside its byte
         bound;
     (a)-(c) and (e) are held to the port's NumPy oracle on 8 queries
     each (same totals and hits, scores within rtol 1e-5), (d) to
     recall@10 >= 0.9 against exact f32 cosine; every kernel must have
     launched; the profiles of routes (c) and (d) must show no pageable
     host→device copy; then the build parity phase: one segment of
     20,000 docs with every column family (two text fields with
     positions, a multi-valued keyword, an integer, a date, a 768-d
     cosine and a 768-d l2_norm dense_vector, 4 x 64 rank_vectors,
     bench.py's `ml` sparse_vector) built on the card through
     ops/index_build.py and on the host by SegmentBuilder from the same
     builder, equal bit for bit; route (g)'s 1M `cat` bucket ids through
     agg_perm_tables_device equal to a stable host argsort; each build
     op timed alone (CUDA events over 20 calls, one profiled call)
     beside its byte bound;
  4. serving on the card over HTTP: the port's ElasticsearchTpuServer
     (REST → ClusterService → IndexService → QueryBatcher →
     TorchExecutor) with `/bench` (torch) and `/bench_oracle` (numpy)
     over the same 1M-doc segment, and `/small` / `/small_oracle` (2
     shards, built by two `_bulk?refresh=true` calls and a few deletes,
     so every shard has two small segments and the chunked path runs).
     64 `match`, 32 `knn`, 32 `bool`, 32 `multi_match`, 36 filtered
     `bool` (8 rotating filter terms, 4 `day` ranges at odd-millisecond
     boundaries), 32 hybrid RRF bodies (bench.py's 3-leg retriever:
     `multi_match` + `knn` + `sparse_vector`), 32 `sparse_retrieval`
     (int8, then `"exact": true`), 64 `repeated_agg` and 32 `cold_agg`
     bodies go to `/bench` from 8 client threads, then from 1, in a
     client process of their own; `/small` gets the text and 2-leg
     hybrid shapes and one host-routed agg tree. Served hits are held to
     the numpy indices (same totals and ids, scores within rtol 1e-5; a
     hybrid leg by leg — its int8 sparse leg by recall — then its fusion
     against RRF over the legs; `sparse_retrieval` by recall@10 >= 0.95
     in int8 and by ids with `exact`; aggregations equal, `avg` within
     1e-12); `/ann` and `/ann_int8` (IVF over route (h)'s corpus, f16
     and int8) serve 32 `ann_knn` bodies at nprobe 4, 8, 16 and 32 and
     with `"exact": true` from 8 clients then 1 (recall@10 per nprobe
     against the exact bodies, >= 0.95 at nprobe 8; `knn.ann` shows
     builds, probes and 0 exact fallbacks), and route (i)'s sort bodies
     go to `/bench` and an `_id` sort to `/small`, held to the oracle
     indices; route (j), bench.py's `rag_rerank` (200,000 docs, a
     20,000-term body, 8 `cat` values, 64-d vectors, a `toks`
     rank_vectors column of 4 x 64 rows per doc): 32 filtered 2-leg
     `retriever.rrf` bodies with a `rescore` of window 100 on `/rerank`
     (f32 rows), `/rerank_int8` and without the rescore, from 8 clients
     then 1, f32 pages held to the host oracle's rescore (the
     `/rerank_oracle` page, or the host blend over the card's own first
     stage), int8 by recall@10 >= 0.9, NDCG@10 of both stages, every
     rescore on the card (`device_rescores`, no fallback or skip), one
     profiled `rerank` group of 8 (0 pageable uploads, one download) and
     the maxsim op timed alone at the route's shape and at ColBERT's
     widths; route (k): 32 `match_phrase`, 32 `prefix`, 16 `fuzzy`, 16
     `wildcard` and 16 phrase-filtered `bool` bodies on `/bench` held to
     `/bench_oracle`, every phrase through the device conjunction and
     the host position verify (counted), the conjunction timed alone;
     route (l), bench.py's `indexing` scenario in process: 100,000 base
     docs (8-15 words over a 4,000-word Zipf-1.1 vocabulary, an integer)
     on one torch shard with refresh_interval 200ms and the background
     refresher, a 1 s write warmup, 512 two-term `match` bodies, the
     read-only closed-loop peak at 64 threads, 15 s open-loop reads at
     0.4 x that peak, then 15 s at that rate while 4 writers offer 1,500
     docs/s: docs/s, refresh lag, read-only and mixed p50/p99, builds by
     route, build op walls and launches, prewarm ms and one swap's
     uploaded and adopted bytes; every segment built on the card, every
     prewarm building the text serving caches, every streamed doc
     searchable, 32 bodies held to a numpy index fed the same sources,
     the base batch bit-identical card against host, and a swap after a
     small refresh adopting every old segment's uploads; route (m), a
     durable node on the card: the 1M-doc segment installed into
     `/durable` (`best_compression`) of an in-process node with a data
     path and flushed (wall, bytes per file, postings raw against
     delta+varint, the native codec built), the node closed and opened
     again (every saved array reloaded bit for bit; the time to recover
     split into the cluster-state read, `Segment.load` with its native
     decode, the first executor and each family's first search with the
     bytes they upload, and the steady p50), 32 `match`, 32 `knn` and 8
     hybrid bodies held to `/bench_oracle` and to the pages `/bench`
     served before; `python -m elasticsearch_tpu_torch serve
     --data-path` spawned, phase 4's /small docs by `_bulk` into a
     2-shard `request`-durability index, a `_flush`, 200 more acknowledged
     and unflushed, SIGKILL and a new process (every acknowledged doc
     searchable, the replay built on the card, 24 bodies equal to a
     numpy index fed the same docs, the wall from spawn to the first
     answered search), an fs snapshot, delete, restore and a restore
     under a rename serving the pages from before on the card, a second
     snapshot adding no blobs; the crash matrix of index/crashpoints.py
     (11 sites x request/async) on the card, each recovered reader
     against the numpy oracle; and `python -m elasticsearch_tpu_torch
     check`; route (n), a multi-node cluster on the card: (n1) three
     in-process `TpuNode`s over localhost TCP with REST in node mode in
     front of each, `/dist` (8 shards, 0 replicas) spread over them, the
     1M-doc corpus split into 8 per-shard segments by the router's
     murmur3 `shard_id` of each `_id` and each installed on its owning
     node; 32 `match`, 32 exact `knn` and 8 3-leg hybrids through
     node-0 held to `/local8` (the same 8 segments on one node: ids,
     scores within rtol 1e-5, hybrids by RRF over `/local8`'s legs) and
     `match`/`knn` to a numpy 8-shard index, a GET by `_id` through each
     node, p50/p99/QPS at 8 clients and 1 beside `/local8`, shard
     requests and bytes on the transport per request, the card's busy
     time per request; (n2) at /small scale: `/rep` (2 shards, 1
     replica) fed by `_bulk` through node-1 and searched from node-2,
     every acknowledged doc on every in-sync copy, a primary's node
     crashed without a flush and its replica promoted, the node
     restarted and its copies peer-recovered (files shipped, every
     build on the card), a `_cluster/reroute` move, a distributed
     snapshot and restore, the pages unchanged throughout; (n3) two
     `python -m elasticsearch_tpu_torch serve --node-name ... --seeds
     ...` processes sharing the card, the one holding a primary
     SIGKILLed, every acknowledged doc answered by the other, the node
     restarted as an in-sync replica; route (o), the serving mesh on
     one slot (`ES_TPU_MESH=force`) over (n1)'s one-node 8-shard index:
     `match`, `knn`, `bool`, `multi_match`, int8 `sparse_vector` and
     `cold_agg` bodies, every request mesh-routed, pages held to the
     fan-out's of the same run and to the numpy index; route (p), the
     same bodies on a grid of several slots (every card when there are
     two or more, else 4 slots on the one card), held to route (o)'s
     pages, the fan-out's and the oracle's aggregations, with a line
     naming the grid's slots and distinct devices; (o2) and (p2), a
     4-shard index's mesh rescore and IVF probe (f32 and int8) on one
     slot and on a 2 x 2 (data x shards) grid, held to the fan-out;
     route (q), the JAX package's own test suites replayed against the
     port on the card (scripts/torch_reference_suites.py --device cuda
     in a process of its own, `elasticsearch_tpu.*` resolved to the
     port's module objects): the REST-, service- and node-level suites
     and the op-level ones, the device build on; any failure, a guard
     hit (a module of the JAX package or `jax` loaded) or a nonzero
     exit fails the smoke;
     `_nodes/stats` must show batched launches, a bucket wider
     than 1, the chunked path, serve launches, filter cache hits, every
     sparse body on the batcher's sparse family, every `cold_agg` body
     on the device plan, request-cache hits on repeated aggs; every
     `/bench` hybrid must be fused on the card with its 3 legs on the
     batcher; matmuls must run at float32 precision "highest". QPS, p50/p99 per route and client count, one profiled
     batcher group per route (with the host-device synchronisations
     each makes) are printed, and the
     8-client drive is repeated with 1, 2 and 6 batcher workers, at two
     interpreter switch intervals, and once under a host stack sampler
     (measured, not checked);
  5. a `durable` JSON line (route (m)), a `cluster` JSON line (route
     (n)), a `replay` JSON line (route (q)), a `kernels` JSON line and
     per-phase wall times.

The last line is {"ok": true, "device": {...}}. Without a CUDA device,
or without the rest of the repository beside it, the script exits
non-zero and prints no result.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import multiprocessing
import os
import shutil
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
PEAK_F32_FLOPS = 67e12  # float32 outside the tensor cores

MATCH_QUERIES = 64
BATCH = 32
KNN_QUERIES = 32
SERVE_QUERIES = 32  # bool, multi_match, filtered bool, hybrid bodies per route
ORACLE_QUERIES = 8
K = 10
TITLE_VOCAB = 20_000  # bench.py's title field
TITLE_LEN = (3, 9)
SPARSE_VOCAB = 300  # bench.py's `ml` sparse_vector column: Zipf 0.7 popularity
SPARSE_TERMS_PER_DOC = (3, 10)  # 3-9 terms per doc
DAY0 = 1_700_000_000_000  # epoch ms of bench.py's 30-day `day` column
DAY_MS = 86_400_000
RRF_RANK_CONSTANT = 60
CLIENTS = 8  # concurrent HTTP clients in phase 4
SMALL_DOCS = 2000  # docs of the small 2-shard index, in 2 _bulk calls
SMALL_DELETES = 5
SMALL_QUERIES = 16
PHRASE_DF = (2_000, 20_000)  # df of each term of a route (k) phrase
RTOL = 1e-5
KERNEL_RTOL = 1e-5  # of max|dots|: f32 sums in another order
# bench.py's ann_knn config: a clustered corpus of unit cosine rows
ANN_CENTERS = 512
ANN_NOISE = 0.5
ANN_QUERY_NOISE = 0.05
ANN_CHUNK = 65536  # rows drawn per float32 chunk
ANN_CANDIDATES = 100
ANN_NPROBES = (4, 8, 16, 32)
ANN_GATE_NPROBE = 8  # recall@10 >= 0.95 here, f16 and int8

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


def draw_terms(rng, vocab: int, lengths: np.ndarray) -> np.ndarray:
    """The token stream of a Zipf text field: `lengths[d]` term ids for
    doc d, docs in order."""
    probs = 1.0 / np.arange(1, vocab + 1)
    probs /= probs.sum()
    return rng.choice(vocab, size=int(lengths.sum()), p=probs).astype(np.int64)


def build_postings(rng, vocab: int, lengths: np.ndarray):
    return postings_from_stream(draw_terms(rng, vocab, lengths), vocab, lengths)


def postings_from_stream(term_stream: np.ndarray, vocab: int, lengths: np.ndarray,
                         positions: bool = False, names=None):
    """The port's PostingsField over a token stream (`names`: the term
    dictionary, sorted; "w00000"... by default). With `positions`, each
    posting's sorted positions (a token's index in its doc) go into the
    columnar position index, so phrases verify on it."""
    from elasticsearch_tpu_torch.index.segment import (
        INVALID_DOC, TILE, FieldStats, PostingsField,
    )
    from elasticsearch_tpu_torch.utils.smallfloat import encode_norms

    n_docs = len(lengths)
    doc_of = np.repeat(np.arange(n_docs, dtype=np.int64), lengths)
    key = term_stream * n_docs + doc_of
    pos_fields = {}
    if positions:
        # postings run term-major, doc-ascending (the order of `key`); a
        # stable sort keeps each (term, doc)'s positions ascending
        pos = np.arange(len(term_stream), dtype=np.int64) - np.repeat(
            np.cumsum(lengths) - lengths, lengths)
        pos_fields["pos_data"] = pos[np.argsort(key, kind="stable")].astype(np.int32)
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
    if positions:
        pos_fields["term_pos_start"] = term_post_start
        pos_fields["pos_offsets"] = np.concatenate([[0], np.cumsum(tfs_flat, dtype=np.int64)])
    pf = PostingsField(
        # sorted lexicographically
        terms=list(names) if names is not None else [f"w{i:05d}" for i in range(vocab)],
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
        **pos_fields,
    )
    return pf


def build_corpus(seed: int, n_docs: int, vocab: int, dims: int):
    from elasticsearch_tpu_torch.analysis import AnalysisRegistry
    from elasticsearch_tpu_torch.index.mapping import Mappings
    from elasticsearch_tpu_torch.index.segment import NumericField, OrdinalField, Segment, VectorField
    from elasticsearch_tpu_torch.search.executor import ShardReader

    rng = np.random.default_rng(seed)
    lengths = rng.integers(15, 35, size=n_docs)
    stream = draw_terms(rng, vocab, lengths)
    body = postings_from_stream(stream, vocab, lengths, positions=True)
    pairs = adjacent_pairs(stream, lengths, body.term_df)
    vecs = rng.standard_normal((n_docs, dims), dtype=np.float32)
    vecs /= np.linalg.norm(vecs, axis=1, keepdims=True)
    # bench.py's other columns, drawn after the body and the vectors so
    # those stay as earlier runs had them
    title_vocab = min(TITLE_VOCAB, vocab)
    title_lengths = rng.integers(*TITLE_LEN, size=n_docs)
    title_stream = draw_terms(rng, title_vocab, title_lengths)
    title = postings_from_stream(title_stream, title_vocab, title_lengths)
    exists = np.ones(n_docs, bool)
    popularity = rng.integers(0, 100, size=n_docs).astype(np.float64)
    day = (DAY0 + rng.integers(0, 30, size=n_docs).astype(np.int64) * DAY_MS).astype(np.float64)
    cat_ords = rng.integers(0, 16, size=n_docs).astype(np.int32)
    # drawn last, so every earlier column stays as earlier runs had it
    ml_triples = sparse_triples(rng, n_docs)
    ml = sparse_column(ml_triples, n_docs)
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
        sparse={"ml": ml},
    )
    mappings = Mappings(corpus_mapping(dims))
    # the columns the segment was built from, for route (n)'s per-shard
    # segments (shard_segments)
    raw = {"stream": stream, "lengths": lengths, "vocab": vocab, "title_stream": title_stream,
           "title_lengths": title_lengths, "title_vocab": title_vocab, "vecs": vecs,
           "popularity": popularity, "day": day, "cat_ords": cat_ords, "ml": ml_triples}
    return ShardReader([seg], mappings, AnalysisRegistry()), vecs, pairs, raw


def adjacent_pairs(stream: np.ndarray, lengths: np.ndarray, term_df: np.ndarray,
                   lo: int = PHRASE_DF[0], hi: int = PHRASE_DF[1]) -> np.ndarray:
    """[(a, b)] term-id pairs that stand next to each other in a doc of
    the stream, both terms with a df in [lo, hi] (the phrases route (k)
    asks for), from the first 20,000 docs."""
    end = int(lengths[:20_000].sum())
    a, b = stream[: end - 1], stream[1:end]
    same_doc = np.repeat(np.arange(min(len(lengths), 20_000)), lengths[:20_000])
    ok = (same_doc[:-1] == same_doc[1:]) & (a != b)
    ok &= (term_df[a] >= lo) & (term_df[a] <= hi) & (term_df[b] >= lo) & (term_df[b] <= hi)
    return np.unique(np.stack([a[ok], b[ok]], axis=1), axis=0)


def sparse_popularity() -> np.ndarray:
    pop = 1.0 / np.arange(1, SPARSE_VOCAB + 1) ** 0.7
    return pop / pop.sum()


def sparse_triples(rng, n_docs: int):
    """bench.py's learned-sparse `ml` column (its build_sparse_column):
    3-9 terms per doc over a 300-token Zipf-0.7 vocabulary, weights in
    [0.05, 3.05); (term, doc, weight) sorted by term, a doc activating
    each term once."""
    nt = rng.integers(*SPARSE_TERMS_PER_DOC, size=n_docs)
    total = int(nt.sum())
    t_flat = rng.choice(SPARSE_VOCAB, size=total, p=sparse_popularity()).astype(np.int64)
    d_flat = np.repeat(np.arange(n_docs, dtype=np.int64), nt)
    w_flat = (rng.random(total) * 3 + 0.05).astype(np.float32)
    # a doc activates each expansion term once
    _, first = np.unique(t_flat * n_docs + d_flat, return_index=True)
    t_u, d_u, w_u = t_flat[first], d_flat[first], w_flat[first]
    order = np.argsort(t_u, kind="stable")
    return t_u[order], d_u[order], w_u[order]


def sparse_column(triples, n_docs: int):
    """The `ml` column of `triples` laid out by the port's own planner
    (index/segment.sparse_plan / sparse_from_plan, pruning_ratio 0)."""
    from elasticsearch_tpu_torch.index.segment import sparse_from_plan, sparse_plan

    t_u, d_u, w_u = triples
    bounds = np.searchsorted(t_u, np.arange(SPARSE_VOCAB + 1))
    inv = {}
    for tid in range(SPARSE_VOCAB):
        lo, hi = int(bounds[tid]), int(bounds[tid + 1])
        if hi > lo:
            inv[f"tok{tid:04d}"] = dict(zip(d_u[lo:hi].tolist(), w_u[lo:hi].tolist()))
    return sparse_from_plan(sparse_plan(inv, pruning_ratio=0.0), n_docs, np.ones(n_docs, bool))


def sparse_vectors(n: int, seed: int) -> list:
    """bench.py's make_sparse_vectors: 2-5 terms drawn by popularity,
    weights in [0.1, 2.1) rounded to 4 places."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        picked = rng.choice(SPARSE_VOCAB, size=int(rng.integers(2, 6)), replace=False, p=sparse_popularity())
        out.append({f"tok{int(t):04d}": float(np.round(rng.random() * 2 + 0.1, 4)) for t in picked})
    return out


def corpus_mapping(dims: int) -> dict:
    """bench.py's mapping, its `ml: sparse_vector` field included."""
    return {
        "properties": {
            "title": {"type": "text"},
            "body": {"type": "text"},
            "popularity": {"type": "integer"},
            "day": {"type": "date"},
            "cat": {"type": "keyword"},
            "vec": {"type": "dense_vector", "dims": dims, "similarity": "cosine"},
            "ml": {"type": "sparse_vector"},
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
    hybrid is bench.py's 3-leg retriever: multi_match + knn (k 20,
    num_candidates 100) + sparse_vector, rank_constant 60; filtered bool
    gets `day_ranges` besides: 4 bodies whose `day` range bounds sit at
    odd milliseconds next to a day boundary (exact only in float64)."""
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
    for t, v, sv in zip(t_texts, qv, sparse_vectors(SERVE_QUERIES, seed + 37)):
        out["hybrid_rrf"].append({"retriever": {"rrf": {
            "retrievers": [
                {"standard": {"query": {"multi_match": {"query": t, "fields": ["title", "body"]}}}},
                {"knn": {"field": "vec", "query_vector": [float(x) for x in v], "k": 20, "num_candidates": 100}},
                {"standard": {"query": {"sparse_vector": {"field": "ml", "query_vector": sv}}}},
            ],
            "rank_constant": RRF_RANK_CONSTANT}}, "size": K, "_source": False})
    return out


def sparse_agg_bodies(body_df: np.ndarray, seed: int) -> dict:
    """bench.py's `sparse_retrieval`, `repeated_agg` and `cold_agg`
    bodies (its configs 5b, 7 and 8), from `seed`: SERVE_QUERIES
    sparse_vector queries (and the same with `"exact": true`), 64
    size-0 `avg(popularity)` bodies under a `match`, and SERVE_QUERIES
    unique date_histogram + terms + stats bodies with the request cache
    opted out."""
    sv = sparse_vectors(SERVE_QUERIES, seed + 41)
    sparse = [{"query": {"sparse_vector": {"field": "ml", "query_vector": v}}, "size": K, "_source": False}
              for v in sv]
    return {
        "sparse_retrieval": sparse,
        "sparse_retrieval_exact": [{**b, "exact": True} for b in sparse],
        "repeated_agg": [{"size": 0, "query": {"match": {"body": t}},
                          "aggs": {"pop_avg": {"avg": {"field": "popularity"}}}}
                         for t in match_texts(body_df, 64, seed + 17)],
        "cold_agg": [{"size": 0, "request_cache": False, "query": {"match": {"body": t}},
                      "aggs": {"by_day": {"date_histogram": {"field": "day", "fixed_interval": "1d"}},
                               "cats": {"terms": {"field": "cat"}},
                               "pop": {"stats": {"field": "popularity"}}}}
                     for t in match_texts(body_df, SERVE_QUERIES, seed + 19)],
    }


def hybrid_legs(body: dict):
    """([leg body per retriever], rank_window_size) of one hybrid body,
    as IndexService._run_rrf sends its legs."""
    if "retriever" in body:
        rrf = body["retriever"]["rrf"]
        legs = [r["standard"] if "standard" in r else {"knn": r["knn"]} for r in rrf["retrievers"]]
    else:
        rrf = body["rank"]["rrf"]
        legs = [{"query": body["query"]}, {"knn": body["knn"]}]
    size = int(body.get("size", 10))
    window = int(rrf.get("rank_window_size", max(max(size, 10), size)))
    return [{**leg, "size": window, "_source": False} for leg in legs], window


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


def recall_at(ref: dict, got: dict, k: int = K) -> float:
    """recall@k of a served page against the oracle's page."""
    want = [h["_id"] for h in ref["hits"]["hits"][:k]]
    have = {h["_id"] for h in got["hits"]["hits"][:k]}
    return len(have & set(want)) / len(want) if want else 1.0


def same_page(ref: dict, got: dict, what: str) -> str:
    """A pruned page against the oracle's unpruned one, `ref` fetched
    deeper than the page: ids position by position (a tie run within
    RTOL as a set; the run the page end cuts as a subset of the oracle's
    whole run), scores within RTOL. The total is the oracle's, or a lower
    bound under relation "gte". Returns "tie at k" where the page end
    cut a tie run, else "exact"."""
    rt, gt = ref["hits"]["total"], got["hits"]["total"]
    check(gt == rt or (gt["relation"] == "gte" and gt["value"] <= rt["value"]),
          f"{what}: total {gt} against oracle {rt}")
    rh, gh = hits_of(ref), hits_of(got)
    check(len(gh) == min(K, len(rh)), f"{what}: {len(gh)} hits != oracle {min(K, len(rh))}")
    for (_, rs), (_, gs) in zip(rh, gh):
        check(np.isclose(gs, rs, rtol=RTOL, atol=1e-6), f"{what}: score {gs} != oracle {rs}")
    mode = "exact"
    for i, j in tie_runs([sc for _, sc in rh]):
        if i >= len(gh):
            break
        want = {d for d, _ in rh[i:j]}
        have = {d for d, _ in gh[i:min(j, len(gh))]}
        if j > len(gh):
            mode = "tie at k"
        check(have == want if j <= len(gh) else have <= want,
              f"{what}: ids {have} at ranks {i}-{j - 1} != oracle {want}")
    return mode


def sparse_job(query, mappings, quantized: bool):
    """(SparsePlan, query) of one parsed sparse_vector query, the storage
    column resolved as IndexService resolves it."""
    from elasticsearch_tpu_torch.search.batcher import extract_sparse_plan
    from elasticsearch_tpu_torch.search.sparse import SparseSpec

    query.sparse = SparseSpec(quantized=quantized)
    plan = extract_sparse_plan(query, mappings)
    check(plan is not None, "a sparse_vector query did not reduce to a SparsePlan")
    return plan, query


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------


def phase_build() -> dict:
    """Every kernel's `nvcc` and the host postings codec's `g++` (route
    (m), csrc/postings_codec.cpp), all started together; a failed build
    stops the run before any phase."""
    from concurrent.futures import ThreadPoolExecutor

    from elasticsearch_tpu_torch.native import codec
    from elasticsearch_tpu_torch.ops import int8_knn, ordered_scatter

    def timed(build):
        t = time.perf_counter()
        out = build()
        return out, time.perf_counter() - t

    builds = {"int8_knn": int8_knn.build, "ordered_scatter": ordered_scatter.build,
              "postings_codec": codec.build}
    with ThreadPoolExecutor(len(builds)) as pool:
        futures = {name: pool.submit(timed, build) for name, build in builds.items()}
        done = {name: f.result() for name, f in futures.items()}
    secs = {}
    for name in ("int8_knn", "ordered_scatter"):
        (lib, compiler_out), secs[name] = done[name]
        for line in compiler_out.splitlines():
            log(f"nvcc: {line}")
        log(f"built {lib.name} in {secs[name]:.2f}s")
    path, secs["postings_codec"] = done["postings_codec"]
    check(codec.native_available(), f"the postings codec {path} does not load")
    log(f"built {Path(path).name} in {secs['postings_codec']:.2f}s")
    return secs


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


def same_bits(a, b, what: str) -> None:
    """Two runs' results hold the same bits: arrays, or tuples and lists
    of them."""
    if isinstance(a, (tuple, list)):
        check(len(a) == len(b), f"{what}: {len(a)} parts against {len(b)}")
        for x, y in zip(a, b):
            same_bits(x, y, what)
        return
    a, b = np.asarray(a), np.asarray(b)
    check(a.shape == b.shape and a.tobytes() == b.tobytes(), f"{what}: the two runs differ")


def sparse_pages(res: list) -> list:
    """A sparse group's TopDocs as arrays: totals, ids, float32 scores."""
    return [(np.asarray([td.total]), np.asarray([h.doc_id for h in td.hits]),
             np.asarray([h.score for h in td.hits], np.float32)) for td in res]


def capture_scatter(fn):
    """Runs `fn` once with ops/ordered_scatter.ordered_scatter_add wrapped
    where the scorers call it; returns the inputs of its first call (acc
    and cnt as they were before it)."""
    from elasticsearch_tpu_torch.ops import impact, ordered_scatter, scoring

    real = ordered_scatter.ordered_scatter_add
    first = []

    def spy(acc, tgt, src, cnt=None, inc=None):
        if not first:
            first.append([None if x is None else x.clone() for x in (acc, tgt, src, cnt, inc)])
        return real(acc, tgt, src, cnt, inc)

    scoring.ordered_scatter_add = impact.ordered_scatter_add = spy
    try:
        fn()
    finally:
        scoring.ordered_scatter_add = impact.ordered_scatter_add = real
    check(bool(first), "the route made no ordered scatter-add")
    return first[0]


def scatter_kernel_row(args, device) -> dict:
    """csrc/ordered_scatter.cu on one call's inputs against its plain
    version on the CPU (`scatter_add_` in slot order), bit for bit; its
    time, the plain version's and one `scatter_add_`'s on the card (two
    with the int plane); its bound from the bytes these inputs need: the
    slots read once, each touched cell read and written once."""
    import torch

    from elasticsearch_tpu_torch.ops import ordered_scatter as osc

    acc, tgt, src, cnt, inc = args
    R, C = (1, acc.shape[0]) if acc.dim() == 1 else tuple(acc.shape)
    S = tgt.numel() // R
    want, want_cnt = osc.ordered_scatter_add_plain(
        *[None if x is None else x.to("cpu", copy=True) for x in args])
    a, c = acc.clone(), None if cnt is None else cnt.clone()
    osc.ordered_scatter_add(a, tgt, src, c, inc)
    sync(device)
    got = a.cpu()
    differ = int((got.view(torch.int32) != want.view(torch.int32)).sum())
    max_abs = float((got - want).abs().max())
    check(differ == 0, f"ordered_scatter_add [{R}, {C}] x {S}: {differ} cells differ from the plain "
                       f"version (max abs {max_abs:.3e})")
    check(cnt is None or bool(torch.equal(c.cpu(), want_cnt)), "ordered_scatter_add: counts differ")
    ms = device_ms(lambda: osc.ordered_scatter_add(a, tgt, src, c, inc), device)
    plain_ms = device_ms(lambda: osc.ordered_scatter_add_plain(a, tgt, src, c, inc), device)
    # yardstick only: PyTorch's own scatter on the same inputs
    idx, a2, s2 = tgt.reshape(R, S).long(), a.view(R, C), src.reshape(R, S)
    if cnt is None:
        library_ms = device_ms(lambda: a2.scatter_add_(1, idx, s2), device)
    else:
        c2, i2 = c.view(R, C), inc.reshape(R, S)
        library_ms = device_ms(lambda: (a2.scatter_add_(1, idx, s2), c2.scatter_add_(1, idx, i2)), device)
    valid = idx != C - 1
    rows = torch.arange(R, device=idx.device)[:, None] * C
    cells = int(torch.unique((rows + idx)[valid]).numel())
    planes = 1 if cnt is None else 2
    nbytes = (tgt.numel() + src.numel() + (0 if inc is None else inc.numel())) * 4 + cells * 8 * planes
    adds = int(valid.sum()) * planes
    bytes_ms = nbytes / PEAK_BYTES_PER_S * 1e3
    ops_ms = adds / PEAK_F32_FLOPS * 1e3
    bound_ms = max(bytes_ms, ops_ms)
    path = "row_kernel" if osc.layout(R, C, S, cnt is not None).chunks == 0 else "chunk_kernel + apply_kernel"
    row = {"launches": None, "shape": {"R": R, "C": C, "S": S, "cnt": cnt is not None}, "path": path,
           "max_abs_err": max_abs, "cells_differing": differ, "ms": ms, "plain_ms": plain_ms,
           "bound_ms": bound_ms, "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
           "bound_share": bound_ms / ms, "library_ms": library_ms,
           "library": "scatter_add_" if cnt is None else "scatter_add_ f32 + scatter_add_ int32",
           "bytes": nbytes, "valid_slots": int(valid.sum()), "touched_cells": cells}
    log(f"ordered_scatter_add [{R}, {C}] x {S} (cnt {cnt is not None}, {path}): 0 cells differ, {ms:.4f} ms, "
        f"plain {plain_ms:.4f}, library {library_ms:.4f}, bound {bound_ms:.4f} ({nbytes} B)")
    return row


def capture_tile_add(fn, impact: bool = False):
    """Runs `fn` once with ops/scoring.tile_pass, the pass body that
    ChunkedScorer and ImpactScorer call, wrapped from any thread (the
    server's workers too); returns the inputs of the BM25 (with `impact`,
    the impact) source's call with the most tiles, as the entry takes them
    (acc and cnt as they were before it)."""
    from elasticsearch_tpu_torch.ops import impact as impact_ops
    from elasticsearch_tpu_torch.ops import scoring

    want = impact_ops.IMPACT_TILES if impact else scoring.BM25_TILES
    real = scoring.tile_pass
    most = []
    lock = threading.Lock()

    def spy(source, acc, cnt, planes, tile_lists, weight_lists):
        tiles = sum(len(x) for x in tile_lists)
        with lock:
            if source is want and tiles and (not most or tiles > most[0]):
                most[:] = [tiles, (acc.clone(), None if cnt is None else cnt.clone(), *planes,
                                   [np.array(x) for x in tile_lists], [np.array(x) for x in weight_lists])]
        return real(source, acc, cnt, planes, tile_lists, weight_lists)

    scoring.tile_pass = spy
    try:
        fn()
    finally:
        scoring.tile_pass = real
    check(bool(most), f"the route made no {want.name}")
    return most[1]


def pass_cells(C: int, doc_ids, tile_lists) -> tuple:
    """(tiles, valid slots, touched cells, distinct valid docs) of one
    tile-add pass over [rows, C] accumulators."""
    import torch

    R = len(tile_lists)
    ids = torch.from_numpy(np.concatenate(tile_lists).astype(np.int64)).to(doc_ids.device)
    rows = torch.repeat_interleave(torch.arange(R, device=doc_ids.device),
                                   torch.tensor([len(x) for x in tile_lists], device=doc_ids.device))
    docs = doc_ids[ids]
    valid = docs >= 0
    cells = int(torch.unique((rows[:, None] * C + docs)[valid]).numel())
    return ids.numel(), int(valid.sum()), cells, int(torch.unique(docs[valid]).numel())


def tile_add_bytes(C: int, doc_ids, tile_lists, planes: int):
    """(bytes, valid slots, touched cells) of one BM25 tile add pass over
    [rows, C] accumulators: the pass's postings tiles (doc ids and tfs)
    and its packed plan read once, each valid doc's inv_norm read once,
    each touched cell of each plane read and written once."""
    T, valid, cells, inv_reads = pass_cells(C, doc_ids, tile_lists)
    R = len(tile_lists)
    nbytes = T * doc_ids.shape[1] * 8 + (2 * (R + 1) + 2 * T) * 4 + inv_reads * 4 + cells * 8 * planes
    return nbytes, valid, cells


def tile_add_kernel_row(args, device) -> dict:
    """csrc/ordered_scatter.cu's BM25 tile add on one pass's inputs
    against its plain version on the CPU (`_chunk_scores` and the ordered
    scatter-add's plain version over each row's whole list), bit for bit
    and count for count; its time (the wrapper's packing and upload
    included) and the plain version's on the card; its bound from the
    bytes the pass needs (`tile_add_bytes`)."""
    import torch

    from elasticsearch_tpu_torch.ops import ordered_scatter as osc
    from elasticsearch_tpu_torch.ops import scoring

    acc, cnt, doc_ids, tfs, inv, tiles, weights = args
    R, C = acc.shape
    lay = osc.tile_layout(C, [len(x) for x in tiles] + [0] * (R - len(tiles)))
    want, want_cnt = scoring.bm25_tile_add_plain(
        *[None if x is None else x.to("cpu", copy=True) for x in (acc, cnt, doc_ids, tfs, inv)], tiles, weights)
    a, c = acc.clone(), None if cnt is None else cnt.clone()
    scoring.bm25_tile_add(a, c, doc_ids, tfs, inv, tiles, weights)
    sync(device)
    got = a.cpu()
    differ = int((got.view(torch.int32) != want.view(torch.int32)).sum())
    max_abs = float((got - want).abs().max())
    check(differ == 0, f"bm25_tile_add [{R}, {C}] x {lay.tiles} tiles: {differ} cells differ from the plain "
                       f"version (max abs {max_abs:.3e})")
    check(cnt is None or bool(torch.equal(c.cpu(), want_cnt)), "bm25_tile_add: counts differ")
    ms = device_ms(lambda: scoring.bm25_tile_add(a, c, doc_ids, tfs, inv, tiles, weights), device)
    plain_ms = device_ms(lambda: scoring.bm25_tile_add_plain(a, c, doc_ids, tfs, inv, tiles, weights), device,
                         iters=5)
    nbytes, valid, cells = tile_add_bytes(C, doc_ids, tiles, 1 if cnt is None else 2)
    bound_ms = nbytes / PEAK_BYTES_PER_S * 1e3
    path = "row_kernel" if lay.window == 0 else "chunk_kernel + apply_kernel"
    row = {"launches": None, "shape": {"R": R, "C": C, "tiles": lay.tiles, "cnt": cnt is not None}, "path": path,
           "windows": lay.windows, "max_abs_err": max_abs, "cells_differing": differ, "ms": ms, "plain_ms": plain_ms,
           "bound_ms": bound_ms, "bound_by": "bytes", "bound_share": bound_ms / ms, "library_ms": None,
           "library": "none: no library call gathers, scores and adds a pass in order",
           "bytes": nbytes, "valid_slots": valid, "touched_cells": cells,
           "scratch_bytes": lay.scratch_words * 4, "acc_bytes": R * C * 4}
    log(f"bm25_tile_add [{R}, {C}] x {lay.tiles} tiles (cnt {cnt is not None}, {path}, {lay.windows} windows): "
        f"0 cells differ, {ms:.4f} ms, plain {plain_ms:.4f}, bound {bound_ms:.4f} ({nbytes} B)")
    return row


def profiled_ms(fn, device, n: int = 10):
    """Device ms of one of `n` calls of fn: every kernel, copy and memset
    torch.profiler sees on the card (None off the card)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    if device.type != "cuda":
        return None
    fn()
    torch.cuda.synchronize(device)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize(device)
    us = sum(getattr(e, "self_device_time_total", 0) or getattr(e, "self_cuda_time_total", 0)
             for e in prof.key_averages() if e.device_type != DeviceType.CPU)
    return us / n / 1e3


ELSER_CONFIG = Path(__file__).resolve().parent / "benchmark" / "configs" / "msmarco-passage-elser.json"
ELSER_JOB_TILES = 68_352  # tiles a job in the ELSER cell (ledger, PR 23)


def impact_cell_pass(seed: int, device, quantized: bool, passages=None) -> tuple:
    """One learned-sparse pass at the ELSER cell's shape, drawn as
    `benchmark/kinds/sparse.py` draws its column: of 64 queries drawn as
    `bodies/sparse_vector.py` draws them (8 + Binomial(44, 0.5) tokens by
    document frequency, log-normal float32 weights), the one whose tiles
    come nearest ELSER_JOB_TILES; each token's df passages a uniform
    sample, its weights log-normal cut to 9 significant bits, laid out by
    weight desc then doc asc in 128-slot tiles padded with doc -1 (int8:
    the token's scale max/127 folded into the tile weight). Returns
    (acc, cnt, doc_ids, values, [tile list], [weights]) for one row on
    `device`, the accumulators zero."""
    import torch

    from benchmark.kinds.sparse import doc_freqs

    config = json.loads(ELSER_CONFIG.read_text())
    n = int(passages or config["passages"])
    df = doc_freqs({**config, "passages": n})
    tiles_of = -(-df // 128)
    p = df / df.sum()
    law = config["assumed"]["weight"]
    rng = np.random.default_rng(seed)
    best = None
    for _ in range(64):
        ids = rng.choice(len(p), size=8 + int(rng.binomial(44, 0.5)), replace=False, p=p)
        if best is None or abs(int(tiles_of[ids].sum()) - ELSER_JOB_TILES) < abs(int(tiles_of[best].sum())
                                                                                 - ELSER_JOB_TILES):
            best = ids
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    docs, vals, weights = [], [], []
    for t in best:
        d = int(df[t])
        doc = torch.randperm(n, generator=gen, device=device)[:d]
        z = torch.randn(d, generator=gen, device=device)
        w = torch.clamp(torch.exp(np.log(law["median"]) + law["sigma"] * z), max=float(law["max"]))
        w = (w.view(torch.int32) >> 15 << 15).view(torch.float32)
        order = torch.argsort(doc)  # doc asc, then a stable sort by weight desc
        doc, w = doc[order], w[order]
        order = torch.sort(w, descending=True, stable=True).indices
        doc, w = doc[order].int(), w[order]
        nt = int(tiles_of[t])
        dp = torch.full((nt * 128,), -1, dtype=torch.int32, device=device)
        wp = torch.zeros(nt * 128, device=device)
        dp[:d], wp[:d] = doc, w
        qw = np.float32(np.exp(np.log(law["median"]) + law["sigma"] * rng.standard_normal()))
        if quantized:
            scale = float(w[0]) / 127.0
            wp = torch.round(wp / scale).clamp(0, 127).to(torch.int8)
            qw = np.float32(qw * np.float32(scale))
        docs.append(dp.view(nt, 128))
        vals.append(wp.view(nt, 128))
        weights.append(np.full(nt, qw, np.float32))
    doc_ids, values = torch.cat(docs), torch.cat(vals)
    acc = torch.zeros(1, n + 1, device=device)
    cnt = torch.zeros(1, n + 1, dtype=torch.int32, device=device)
    return acc, cnt, doc_ids, values, [np.arange(len(doc_ids), dtype=np.int64)], [np.concatenate(weights)]


def impact_add_bytes(C: int, doc_ids, values, tile_lists, planes: int):
    """(bytes, valid slots, touched cells) of one impact tile add pass
    over [rows, C] accumulators: the pass's tiles (doc ids and stored
    impacts, 8 bytes a slot in f32, 5 in int8) and its packed plan read
    once, each touched cell of each plane read and written once."""
    T, valid, cells, _ = pass_cells(C, doc_ids, tile_lists)
    R = len(tile_lists)
    nbytes = (T * doc_ids.shape[1] * (4 + values.element_size()) + (2 * (R + 1) + 2 * T) * 4
              + cells * 8 * planes)
    return nbytes, valid, cells


def impact_add_kernel_row(args, device) -> dict:
    """csrc/ordered_scatter.cu's impact tile add on one pass's inputs
    against its plain version on the CPU (`_impact_chunk_add` over each
    row's whole list) and the replaced 512-tile loop on the card
    (`tests/scatter_cases.py:parent_impact_pass`), bit for bit and count
    for count; its time by events (the wrapper's packing and upload
    included) and by the profiler's device time; the plain version's time
    on the card (PyTorch's gathers and product over the whole list, then
    the ordered scatter-add) and the replaced loop's; its bound from the
    bytes the pass needs (`impact_add_bytes`). The launch counters are left
    as the main path made them."""
    import torch

    from elasticsearch_tpu_torch.ops import impact
    from elasticsearch_tpu_torch.ops import ordered_scatter as osc

    tests = str(Path(__file__).resolve().parent / "tests")
    if tests not in sys.path:
        sys.path.append(tests)
    from scatter_cases import parent_impact_pass

    acc, cnt, doc_ids, values, tiles, weights = args
    R, C = acc.shape
    lay = osc.tile_layout(C, [len(x) for x in tiles] + [0] * (R - len(tiles)))
    counts = (osc.launch_impact_add.launches, osc.ordered_scatter_add.launches)
    want, want_cnt = impact.impact_tile_add_plain(
        *[x.to("cpu", copy=True) for x in (acc, cnt, doc_ids, values)], tiles, weights)
    a, c = acc.clone(), cnt.clone()
    impact.impact_tile_add(a, c, doc_ids, values, tiles, weights)
    old, old_c = acc.clone(), cnt.clone()
    parent_impact_pass(old, old_c, doc_ids, values, tiles, weights)
    sync(device)
    got = a.cpu()
    differ = int((got.view(torch.int32) != want.view(torch.int32)).sum())
    differ_replaced = int((old.cpu().view(torch.int32) != got.view(torch.int32)).sum())
    max_abs = float((got - want).abs().max())
    what = f"impact_tile_add [{R}, {C}] x {lay.tiles} tiles, {values.dtype}"
    check(differ == 0 and differ_replaced == 0, f"{what}: {differ} cells differ from the plain version, "
                                                f"{differ_replaced} from the replaced loop (max abs {max_abs:.3e})")
    check(bool(torch.equal(c.cpu(), want_cnt)) and bool(torch.equal(old_c, c)), f"{what}: counts differ")
    ms = device_ms(lambda: impact.impact_tile_add(a, c, doc_ids, values, tiles, weights), device)
    dev_ms = profiled_ms(lambda: impact.impact_tile_add(a, c, doc_ids, values, tiles, weights), device)
    plain_ms = device_ms(lambda: impact.impact_tile_add_plain(a, c, doc_ids, values, tiles, weights), device,
                         iters=5)
    replaced_ms = device_ms(lambda: parent_impact_pass(a, c, doc_ids, values, tiles, weights), device, iters=5)
    osc.launch_impact_add.launches, osc.ordered_scatter_add.launches = counts
    nbytes, valid, cells = impact_add_bytes(C, doc_ids, values, tiles, 2)
    bound_ms = nbytes / PEAK_BYTES_PER_S * 1e3
    path = "row_kernel" if lay.window == 0 else "chunk_kernel + apply_kernel"
    row = {"launches": None, "shape": {"R": R, "C": C, "tiles": lay.tiles, "values": str(values.dtype)},
           "path": path, "windows": lay.windows, "max_abs_err": max_abs, "cells_differing": differ,
           "cells_differing_replaced": differ_replaced, "ms": ms, "device_ms": dev_ms, "plain_ms": plain_ms,
           "replaced_ms": replaced_ms, "bound_ms": bound_ms, "bound_by": "bytes",
           "bound_share": bound_ms / (dev_ms or ms), "library_ms": None,
           "library": "none: no library call gathers, multiplies and adds a pass in order",
           "bytes": nbytes, "valid_slots": valid, "touched_cells": cells,
           "scratch_bytes": lay.scratch_words * 4, "acc_bytes": 2 * R * C * 4}
    log(f"{what} ({path}, {lay.windows} windows): 0 cells differ, {ms:.4f} ms, device {dev_ms}, plain "
        f"{plain_ms:.4f}, replaced loop {replaced_ms:.4f}, bound {bound_ms:.4f} ({nbytes} B)")
    return row


def impact_cell_rows(seed: int, device) -> dict:
    """`impact_add_kernel_row` on a pass at the ELSER cell's shape
    (`impact_cell_pass`: one row, about 68,352 tiles, 8,841,823 docs on
    the card; 100,000 docs off it), f32 and int8."""
    passages = None if device.type == "cuda" else 100_000
    return {name: impact_add_kernel_row(impact_cell_pass(seed, device, quantized, passages), device)
            for name, quantized in (("fp32", False), ("int8", True))}


def chunked_texts(fs, pf, n: int, seed: int) -> list:
    """n `match` texts that overflow the fused scorer's rare-tile budget,
    so that the batcher scores them on the chunked route: from a
    rotating start among the body terms that have no dense row, most
    tiles first, terms until their tiles pass the budget, then one
    mid-frequency term."""
    order = [int(x) for x in np.argsort(-pf.term_tile_count, kind="stable") if int(x) not in fs.hot_rank]
    mids = match_texts(pf.term_df, n, seed + 29)
    out = []
    for i in range(n):
        picked, tiles, j = [], 0, i % 64
        while tiles <= fs.t_rare:
            picked.append(pf.terms[order[j]])
            tiles += int(pf.term_tile_count[order[j]])
            j += 1
        out.append(" ".join(picked + mids[i].split()[:1]))
    return out


def route_chunked(tex, fs, reader, oracle, seed: int, device) -> dict:
    """Route (a2): BATCH `match` queries that overflow the fused slot
    budget (every fourth with operator "and", so the count plane rides
    along) as one batcher group on this thread, which the chunked
    block-max route scores through the BM25 tile add (two passes: the
    essential terms, then the hot terms' surviving tiles), held to the
    oracle (totals, or a lower bound where tiles were pruned; hits; scores
    within RTOL), and run again to the same bits."""
    from elasticsearch_tpu_torch.search import dsl
    from elasticsearch_tpu_torch.search.batcher import QueryBatcher, extract_match_plan

    pf = reader.segments[0].postings["body"]
    texts = chunked_texts(fs, pf, BATCH, seed)
    queries = [dsl.parse_query({"match": {"body": {"query": s, "operator": "and" if i % 4 == 3 else "or"}}})
               for i, s in enumerate(texts)]
    plans = [extract_match_plan(q, reader.mappings, reader.analysis) for q in queries]
    check(all(tex.fused_plan(fs, 0, "body", p.terms, p.boost, p.msm) is None for p in plans),
          "(a2) a query fits the fused slot budget")
    gb = QueryBatcher(workers=1)
    gb._ensure_thread = lambda: None  # groups run on this thread

    def run():
        jobs = [gb.submit_nowait(tex, p, K) for p in plans]
        gb._run_group(jobs, "body", 16, rows=BATCH)
        return [gb.wait(j) for j in jobs]

    try:
        t = time.perf_counter()
        res = run()
        sync(device)
        wall = time.perf_counter() - t
        stats = dict(gb.stats)
        check(stats["chunked_jobs"] == BATCH and stats["fused_overflow_jobs"] == BATCH,
              f"(a2) the group did not take the chunked route: {stats}")
        for i in range(ORACLE_QUERIES):
            ref, got = oracle.search(queries[i], size=K), res[i]
            check(got.total == ref.total or (got.relation == "gte" and got.total <= ref.total),
                  f"(a2) total {got.total} ({got.relation}) against oracle {ref.total}")
            rs = np.array([h.score for h in ref.hits])
            gs = np.array([h.score for h in got.hits])
            check(len(gs) == len(rs) and np.allclose(gs, rs, rtol=RTOL, atol=1e-6),
                  f"(a2) scores {gs} != oracle {rs}")
            same_ids([h.doc_id for h in ref.hits], rs, [h.doc_id for h in got.hits], f"(a2) match [{texts[i]}]")
        again = []
        args = capture_tile_add(lambda: again.extend(run()))
        for a, b in zip(res, again):
            check([(h.doc_id, np.float32(h.score).tobytes()) for h in a.hits]
                  == [(h.doc_id, np.float32(h.score).tobytes()) for h in b.hits], "(a2) run twice: other bits")
    finally:
        gb.close()
    log(f"(a2) chunked group of {BATCH}: {wall * 1e3:.1f} ms, {stats['chunked_launches']} tile-add launches, "
        f"{sum(r.relation == 'gte' for r in res)} pruned; held to the oracle and run twice the same bits")
    return {"wall_s": wall, "chunked_launches": stats["chunked_launches"],
            "pruned_jobs": sum(r.relation == "gte" for r in res), "tile_add_args": args}


def phase_main(reader, oracle, vecs, qv, seed: int, device) -> dict:
    import torch

    from elasticsearch_tpu_torch.ops import int8_knn, ordered_scatter, scoring
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
    scatter = ordered_scatter.ordered_scatter_add
    scatter.launches = 0
    ordered_scatter.launch_tile_add.launches = 0
    ordered_scatter.launch_impact_add.launches = 0
    route_scatters = {}  # the ordered scatter-add's launches by route

    # (a) per-query match route
    t = time.perf_counter()
    res_a = [tex.search(dsl.parse_query({"match": {"body": s}}), size=K) for s in texts]
    sync(device)
    times["a_match_per_query_s"] = time.perf_counter() - t
    route_scatters["a"] = scatter.launches

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
    route_scatters["b"] = scatter.launches - sum(route_scatters.values())

    # (a2) match queries past the fused slot budget: the chunked route
    t = time.perf_counter()
    chunked = route_chunked(tex, fs, reader, oracle, seed, device)
    times["a2_match_chunked_group_s"] = time.perf_counter() - t
    route_scatters["a2"] = scatter.launches - sum(route_scatters.values())

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
    route_scatters["c_d_e"] = scatter.launches - sum(route_scatters.values())

    # (f) sparse_vector groups, (g) device aggregation plans
    t = time.perf_counter()
    fg = routes_sparse_aggs(tex, reader, oracle, seed, device)
    times["f_g_sparse_aggs_s"] = time.perf_counter() - t
    route_scatters["f_g"] = scatter.launches - sum(route_scatters.values())

    # (i) sorted collection on one numeric key
    t = time.perf_counter()
    sort_i = route_sort(tex, oracle, reader, seed, device)
    times["i_sorted_s"] = time.perf_counter() - t
    route_scatters["i"] = scatter.launches - sum(route_scatters.values())

    launches = {"int8_dot_scores": int8_knn.int8_dot_scores.launches,
                "ordered_scatter_add": scatter.launches,
                "bm25_tile_add": ordered_scatter.launch_tile_add.launches,
                "impact_tile_add": ordered_scatter.launch_impact_add.launches}
    log(f"main path done; launches {launches}; the ordered scatter-add's by route {route_scatters}")
    check(all(n > 0 for n in launches.values()), f"a kernel never launched on the main path: {launches}")

    # ---- the ordered scatter-add against its plain version at routes
    # (b) and (f)'s shapes, and routes (b), (e) and (f) run again: the
    # same score bits as the main path's run ----
    t = time.perf_counter()

    def route_b():
        return scoring.merge_segment_topk([(0, *fs.device_result(fs.search_async(plans_b0, K, False,
                                                                                   rows=BATCH)))], K)

    plans_b0 = [tex.fused_plan(fs, 0, "body", analyzer.terms(s), 1.0, 1) for s in texts[:BATCH]]
    f_runs = {name: fg["fns"][f"f_sparse_{name}_group32"] for name in ("int8", "fp32")}
    again = {"b": route_b(), "e": route_e(plans_e), **{f"f_{n}": fn() for n, fn in f_runs.items()}}
    same_bits(res_b[0], again["b"], "(b) run twice")
    same_bits(res_e, again["e"], "(e) run twice")
    for name, fn in f_runs.items():
        same_bits(sparse_pages(fg[f"f_{name}_res"]), sparse_pages(again[f"f_{name}"]), f"(f) {name} run twice")
    kernel_b = scatter_kernel_row(capture_scatter(route_b), device)
    q_a = dsl.parse_query({"match": {"body": texts[0]}})
    kernel_a = scatter_kernel_row(capture_scatter(lambda: tex.search(q_a, size=K)), device)
    kernel_a["launches"] = None  # the main path's count is the entry's
    scatter_row = {"name": "ordered_scatter_add", "route": "cuda",
                   "source": "elasticsearch_tpu_torch/csrc/ordered_scatter.cu",
                   "replaces": "none: the order of elasticsearch_tpu's `.at[].add` scatters "
                               "(elasticsearch_tpu/ops/scoring.py:549, ops/impact.py:94)",
                   **kernel_b, "at_route_a": kernel_a,
                   "launches_by_route": route_scatters}
    times["ordered_scatter_checks_s"] = time.perf_counter() - t
    log(f"ordered scatter-add: bit for bit at (a) and (b), (b)/(e)/(f) twice the same bits, "
        f"{times['ordered_scatter_checks_s']:.2f}s")
    # ---- the BM25 tile add against its plain version on (a2)'s largest
    # pass ----
    t = time.perf_counter()
    tile_row = {"name": "bm25_tile_add", "route": "cuda",
                "source": "elasticsearch_tpu_torch/csrc/ordered_scatter.cu",
                "replaces": "none: the loop of 512-tile chunks of elasticsearch_tpu's "
                            "ChunkedScorer.score_into (elasticsearch_tpu/ops/scoring.py:264)",
                **tile_add_kernel_row(chunked.pop("tile_add_args"), device)}
    times["tile_add_checks_s"] = time.perf_counter() - t
    # ---- the impact tile add against its plain version and the replaced
    # loop on (f)'s largest passes and at the ELSER cell's shape ----
    t = time.perf_counter()
    impact_row = {"name": "impact_tile_add", "route": "cuda",
                  "source": "elasticsearch_tpu_torch/csrc/ordered_scatter.cu",
                  "replaces": "none: the loop of 512-tile chunks of elasticsearch_tpu's "
                              "ImpactScorer.score_into (elasticsearch_tpu/ops/impact.py:133)",
                  **{f"at_route_f_{n}": impact_add_kernel_row(capture_tile_add(fn, impact=True), device)
                     for n, fn in f_runs.items()},
                  "at_elser_cell": impact_cell_rows(seed, device)}
    times["impact_add_checks_s"] = time.perf_counter() - t

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
        **fg["fns"],
    }, device) if device.type == "cuda" else {}
    fg["batcher"].close()
    if profile:
        # the query vector and the global cut's (doc, score) pairs go up
        # through pinned memory: a pageable copy would wait for the device
        pageable = profile["c_knn_one_query"]["pageable_htod"]
        log(f"(c) pageable host-to-device copies: {pageable}, device time "
            f"{profile['c_knn_one_query']['device_us']:.0f}us")
        check(pageable == 0, f"(c) made {pageable} pageable host-to-device copies")
        pageable = profile["d_knn_int8_batch32"]["pageable_htod"]
        log(f"(d) pageable host-to-device copies: {pageable}")
        check(pageable == 0, f"(d) made {pageable} pageable host-to-device copies")
    topk = topk_before_after(device, seed) if device.type == "cuda" else {}
    return {"times": times, "launches": launches, "int8_recall_at_10": recall, "ordered_scatter": scatter_row,
            "bm25_tile_add": tile_row, "impact_tile_add": impact_row, "chunked_a2": chunked,
            "sparse_f": fg["f"], "aggs_g": fg["g"], "sorted_i": sort_i,
            "plain_ops": fg["plain_ops"] + [sort_i["plain_op"]], "topk_desc_ms": topk,
            "totals_a": [r.total for r in res_a[:ORACLE_QUERIES]],
            "totals_e": [int(t.sum()) for t in res_e[3][:ORACLE_QUERIES]], "profile": profile}


def topk_desc_scans(x, k: int):
    """The earlier tie-exact `ops/scoring.topk_desc` (torch.topk for the
    k-th value, two int32 cumsum scans, a scatter and a stable sort),
    kept here only to time it beside the one-key version on the same
    input."""
    import torch

    n = x.shape[-1]
    rows = x.reshape(-1, n)
    kth = torch.topk(rows, k, dim=-1, sorted=True).values[:, -1:]
    above = rows > kth
    equal = rows == kth
    need = k - above.sum(dim=-1, keepdim=True, dtype=torch.int32)
    sel = above | (equal & (torch.cumsum(equal, dim=-1, dtype=torch.int32) <= need))
    slot = torch.where(sel, torch.cumsum(sel, dim=-1, dtype=torch.int32) - 1, k)
    idx = torch.zeros(rows.shape[0], k + 1, dtype=torch.int64, device=x.device)
    idx.scatter_(1, slot.long(), torch.arange(n, device=x.device).expand_as(rows))
    idx = idx[:, :k]
    vals = rows.gather(1, idx)
    vals, order = torch.sort(vals, dim=-1, descending=True, stable=True)
    return vals, idx.gather(1, order)


def topk_before_after(device, seed: int) -> dict:
    """topk_desc's two-scan and one-key versions on route (b)'s shape ([32, N]
    f32 scores, 0.9 of them -inf as a masked accumulator has) and a
    group of 8, in one process: the same docs, and the times."""
    import torch

    from elasticsearch_tpu_torch.ops import scoring

    out = {}
    g = torch.Generator(device="cpu").manual_seed(seed)
    for rows, n in ((BATCH, 1_000_000), (CLIENTS, 1_000_000)):
        x = torch.rand(rows, n, generator=g).to(device)
        x = torch.where(torch.rand(rows, n, generator=g).to(device) < 0.9, -torch.inf, x)
        new_v, new_i = scoring.topk_desc(x, K)
        old_v, old_i = topk_desc_scans(x, K)
        check(bool(torch.equal(new_i, old_i)) and bool(torch.equal(new_v, old_v)),
              "topk_desc: the one-key selection differs from the two-scan one on finite scores")
        ms = {"two_scans": [], "one_key": []}
        for name, fn in (("two_scans", topk_desc_scans), ("one_key", scoring.topk_desc),
                         ("one_key", scoring.topk_desc), ("two_scans", topk_desc_scans)):
            ms[name].append(device_ms(lambda: fn(x, K), device))
        out[f"{rows}x{n}"] = ms
        log(f"topk_desc [{rows}, {n}] k={K}: two scans {ms['two_scans']} ms, one key {ms['one_key']} ms")
    return out


class OpCounter:
    """Counts the calls of module-level functions while a route runs and
    keeps the first call's arguments (to time the op alone afterwards)."""

    def __init__(self, targets):
        self.targets = targets  # [(module, name)]
        self.calls = {}
        self.args = {}
        self._saved = []

    def __enter__(self):
        for mod, name in self.targets:
            fn = getattr(mod, name)
            self._saved.append((mod, name, fn))

            def wrapped(*a, _fn=fn, _name=name):
                self.calls[_name] = self.calls.get(_name, 0) + 1
                self.args.setdefault(_name, a)  # a route's calls of one op are alike
                return _fn(*a)

            setattr(mod, name, wrapped)
        return self

    def __exit__(self, *exc):
        for mod, name, fn in self._saved:
            setattr(mod, name, fn)


def op_bytes(name: str, a) -> int:
    """Bytes the op must move for these inputs (each input read once,
    each output written once)."""
    def nb(t):
        return t.numel() * t.element_size()

    if name == "sorted_bucket_counts":
        mask, mp, gate, bounds = a
        return nb(mask) + nb(mp) + nb(gate) + nb(bounds) + 4 * (bounds.numel() - 1)
    if name == "sorted_bucket_metrics":
        mask, mp, gate, v, iv, bounds = a
        return nb(mask) + nb(mp) + nb(gate) + nb(v) + nb(iv) + nb(bounds) + 16 * (bounds.numel() - 1)
    if name == "masked_sorted":
        sel, values = a
        return nb(sel) + nb(values) + 4 * values.numel() + 4
    if name == "masked_metric":
        sel, values, ivalues = a
        return nb(sel) + nb(values) + nb(ivalues) + 16
    sel, scores = a  # masked_total_and_max
    return nb(sel) + nb(scores) + 8


def plain_op_rows(counter: OpCounter, jobs: int, route: str, device) -> list:
    """One row per plain PyTorch op a route ran: calls per request, its
    time alone on the widest call's inputs, and its byte bound."""
    from elasticsearch_tpu_torch.ops import agg_kernels

    rows = []
    for name, calls in sorted(counter.calls.items()):
        a = counter.args[name]
        ms = device_ms(lambda: getattr(agg_kernels, name)(*a), device)
        nbytes = op_bytes(name, a)
        bound_ms = nbytes / PEAK_BYTES_PER_S * 1e3
        rows.append({"op": name, "route": route, "calls_per_request": calls / jobs, "ms": ms,
                     "bytes": nbytes, "bound_ms": bound_ms, "bound_by": "bytes",
                     "bound_share": bound_ms / ms if ms else None})
        log(f"plain op {name} ({route}): {calls / jobs:.3g} calls/request, {ms:.4f} ms, "
            f"bound {bound_ms:.4f} ms ({nbytes} B)")
    return rows


def routes_sparse_aggs(tex, reader, oracle, seed: int, device) -> dict:
    """Routes (f) and (g) of phase 3. (f): BATCH `sparse_vector` queries
    as one batcher sparse group, int8 then fp32 (`exact`), held to the
    oracle (fp32 pages by ids, int8 by recall@10 >= 0.95). (g): one
    `cold_agg` body, and one dashboard body with metric subs and
    percentiles, through DeviceAggPlan dispatch + collect, their reduced
    aggregations equal to AggCollector's over the oracle's masks."""
    import torch

    from elasticsearch_tpu_torch.ops import agg_kernels, ordered_scatter
    from elasticsearch_tpu_torch.search import aggs_device, dsl
    from elasticsearch_tpu_torch.search import sparse as sparse_mod
    from elasticsearch_tpu_torch.search.aggs import AggCollector, parse_aggs, reduce_aggs
    from elasticsearch_tpu_torch.search.batcher import QueryBatcher

    out = {"f": {}, "g": {}, "plain_ops": []}
    fns = {}
    gb = QueryBatcher(workers=1)
    gb._ensure_thread = lambda: None  # groups run on this thread
    qvs = sparse_vectors(BATCH, seed + 43)
    queries = [{"sparse_vector": {"field": "ml", "query_vector": v}} for v in qvs]
    for name, quantized in (("int8", True), ("fp32", False)):
        specs = [sparse_job(dsl.parse_query(q), reader.mappings, quantized) for q in queries]

        def run(specs=specs):
            jobs = [gb.submit_nowait(tex, p, K, kind="sparse", query=q) for p, q in specs]
            gb._collect_sparse_group(jobs, 16, gb._dispatch_sparse_group(jobs, 16, rows=BATCH))
            return [gb.wait(j) for j in jobs]

        run()  # the column's upload is set-up
        sync(device)
        st0 = dict(sparse_mod.SPARSE_STATS)
        launches = ordered_scatter.launch_impact_add.launches
        t = time.perf_counter()
        res = run()
        sync(device)
        wall = time.perf_counter() - t
        st1 = dict(sparse_mod.SPARSE_STATS)
        fns[f"f_sparse_{name}_group32"] = run
        out[f"f_{name}_res"] = res
        out["f"][name] = {"wall_s": wall, "tiles_scored": st1["tiles_scored"] - st0["tiles_scored"],
                          "tiles_pruned": st1["tiles_pruned"] - st0["tiles_pruned"],
                          "pruned_jobs": sum(r.relation == "gte" for r in res),
                          "launches": ordered_scatter.launch_impact_add.launches - launches}
        page = lambda td: {"hits": {"total": {"value": td.total, "relation": td.relation},
                                    "hits": [{"_id": h.doc_id, "_score": h.score} for h in td.hits]}}
        recalls, modes = [], []
        for i, q in enumerate(queries):
            if name == "fp32" and i >= ORACLE_QUERIES:
                break
            ref = page(oracle.search(dsl.parse_query(q), size=K + 20))
            if name == "int8":
                recalls.append(recall_at(ref, page(res[i])))
            else:
                modes.append(same_page(ref, page(res[i]), f"(f) fp32 sparse query {i}"))
        if recalls:
            out["f"][name]["recall_at_10"] = float(np.mean(recalls))
            check(np.mean(recalls) >= 0.95, f"(f) int8 recall@{K} {np.mean(recalls):.4f} < 0.95")
        else:
            out["f"][name]["page_checks"] = modes
        log(f"(f) sparse group of {BATCH}, {name}: {out['f'][name]}")

    bodies = sparse_agg_bodies(reader.segments[0].postings["body"].term_df, seed)
    dash = {"size": 0, "query": bodies["cold_agg"][1]["query"],
            "aggs": {"cats": {"terms": {"field": "cat"},
                              "aggs": {"pop": {"avg": {"field": "popularity"}}}},
                     "p": {"percentiles": {"field": "popularity", "percents": [50, 95]}}}}
    for name, body in (("cold_agg", bodies["cold_agg"][0]), ("dashboard_subs", dash)):
        nodes = parse_aggs(body["aggs"])
        q = dsl.parse_query(body["query"])
        plan = aggs_device.try_compile(tex, nodes, reader.mappings, "bench", 0, q, 0)
        check(plan is not None, f"(g) {name}: the device compiler did not take the body")

        def run(plan=plan):
            return plan.collect(plan.dispatch())

        run()  # the agg columns' upload is set-up
        sync(device)
        targets = [(agg_kernels, n) for n in ("sorted_bucket_counts", "sorted_bucket_metrics",
                                              "masked_sorted", "masked_metric", "masked_total_and_max")]
        with OpCounter(targets) as ops:
            t = time.perf_counter()
            td, parts = run()
            sync(device)
            wall = time.perf_counter() - t
        _, masks = oracle.execute(q, size=0)
        ref = AggCollector(oracle).collect(nodes, masks)
        # reduced as the coordinator reduces them (a percentiles partial
        # holds its values in collection order)
        check(reduce_aggs(nodes, [parts]) == reduce_aggs(nodes, [ref]),
              f"(g) {name}: aggregations differ from AggCollector's")
        check(td.total == int(sum(m.sum() for m in masks)), f"(g) {name}: total {td.total}")
        fns[f"g_{name}"] = run
        out["g"][name] = {"wall_s": wall, "total": td.total,
                          "syncs": count_syncs(run) if device.type == "cuda" else None}
        out["plain_ops"] += plain_op_rows(ops, 1, f"(g) {name}", device)
        log(f"(g) {name}: {out['g'][name]}")
    out["fns"] = fns
    out["batcher"] = gb  # closed by the caller once the routes are profiled
    return out


# ---------------------------------------------------------------------------
# routes (h) IVF ANN and (i) sorted collection
# ---------------------------------------------------------------------------


def ann_nlist(n: int) -> int:
    """bench.py's ann_knn nlist: max(64, 2·floor(sqrt N)), 2000 at 1M."""
    return max(64, int(np.sqrt(n)) * 2)


def build_ann_corpus(seed: int, n_docs: int, dims: int):
    """bench.py's ann_knn corpus (its build_ann_services): unit cosine
    rows around ANN_CENTERS Gaussian centers with noise 0.5, stored f16,
    as one segment; the queries are KNN_QUERIES corpus rows perturbed by
    0.05. Drawn in float32 chunks (bench.py's float64 draw would take
    6 GB of host memory at 1M x 768)."""
    from elasticsearch_tpu_torch.analysis import AnalysisRegistry
    from elasticsearch_tpu_torch.index.mapping import Mappings
    from elasticsearch_tpu_torch.index.segment import Segment, VectorField
    from elasticsearch_tpu_torch.search.executor import ShardReader

    rng = np.random.default_rng(seed + 31)
    centers = rng.standard_normal((ANN_CENTERS, dims), dtype=np.float32)
    vecs = np.empty((n_docs, dims), np.float16)
    for r0 in range(0, n_docs, ANN_CHUNK):
        m = min(ANN_CHUNK, n_docs - r0)
        v = centers[rng.integers(0, ANN_CENTERS, size=m)]
        v += ANN_NOISE * rng.standard_normal((m, dims), dtype=np.float32)
        v /= np.linalg.norm(v, axis=1, keepdims=True)
        vecs[r0:r0 + m] = v
    picks = rng.choice(n_docs, size=KNN_QUERIES, replace=False)
    q = vecs[picks].astype(np.float32)
    q += ANN_QUERY_NOISE * rng.standard_normal(q.shape, dtype=np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    seg = Segment(
        num_docs=n_docs, doc_ids=[str(i) for i in range(n_docs)], sources=[None] * n_docs,
        postings={}, numerics={}, ordinals={},
        vectors={"vec": VectorField(vectors=vecs, exists=np.ones(n_docs, bool), similarity="cosine",
                                    unit_vectors=vecs)},
    )
    return ShardReader([seg], Mappings(ann_mapping(dims)), AnalysisRegistry()), q


def ann_mapping(dims: int) -> dict:
    return {"properties": {"vec": {"type": "dense_vector", "dims": dims, "similarity": "cosine"}}}


def ann_body(v, nprobe=None, exact=False) -> dict:
    """bench.py's ann_knn body: k 10, num_candidates 100."""
    sec = {"field": "vec", "query_vector": [float(x) for x in v], "k": K, "num_candidates": ANN_CANDIDATES}
    if nprobe is not None:
        sec["nprobe"] = nprobe
    body = {"knn": sec, "size": K, "_source": False}
    if exact:
        body["exact"] = True
    return body


def probe_bytes(idx, B: int, nprobe: int, k: int, quantized: bool) -> int:
    """Bytes one probe must move: the queries and centroids, the probed
    slots' rows (int8 with their f32 scales, or the stored f16/f32), doc
    ids and candidate flags, and the [B, k'] scores and docs written."""
    P = min(nprobe, idx.nlist) * idx.cmax
    row = idx.dims * (1 if quantized else idx.vecs_flat.element_size()) + (4 if quantized else 0)
    return (B * idx.dims * 4 + idx.nlist * idx.dims * 4 + B * P * (row + 4 + 1)
            + B * min(k, P) * 8)


def ivf_digest(idx) -> dict:
    """sha256 of each array of an IVF index (`ops/ivf.py`), on the host."""
    import hashlib

    return {name: hashlib.sha256(getattr(idx, name).detach().cpu().contiguous().numpy().tobytes()).hexdigest()
            for name in ("centroids", "perm", "counts", "starts", "vecs_flat", "qvecs_flat", "scales_flat")}


def route_ivf(reader, queries: np.ndarray, device) -> dict:
    """Route (h): the IVF index of the ann_knn corpus built on the card
    from one seed (phase 4's `/ann_int8` builds it again from the same
    rows and seed, and the two must be bit-identical: their digests are
    compared there), one Lloyd step timed alone, one
    batcher `knn` group of 32 at nprobe ANN_GATE_NPROBE in f16 and in
    int8 held to the port's exact group on the same rows (recall@10),
    8 exact pages held to the numpy oracle, and the plain probe timed
    alone beside its byte bound."""
    import torch

    from elasticsearch_tpu_torch.ops import ivf, scoring
    from elasticsearch_tpu_torch.search import ann as ann_mod
    from elasticsearch_tpu_torch.search import dsl
    from elasticsearch_tpu_torch.search.batcher import QueryBatcher, extract_knn_plan
    from elasticsearch_tpu_torch.search.executor import NumpyExecutor
    from elasticsearch_tpu_torch.search.executor_torch import TorchExecutor

    out = {"plain_ops": []}
    seg = reader.segments[0]
    n, dims = seg.num_docs, seg.vectors["vec"].vectors.shape[1]
    nlist = ann_nlist(n)
    spec_i8 = ann_mod.AnnSpec(nlist=nlist, nprobe=ANN_GATE_NPROBE, quantized=True, min_docs=ann_mod.ann_min_docs())
    spec_f16 = ann_mod.AnnSpec(nlist=nlist, nprobe=ANN_GATE_NPROBE, quantized=False, min_docs=spec_i8.min_docs)

    # ---- the build from the executor's seed (built again in phase 4) ----
    tex = TorchExecutor(reader, device=device)
    t = time.perf_counter()
    idx = tex.ann_index(0, "vec", spec_i8)
    sync(device)
    build_s = [time.perf_counter() - t]
    check(idx is not None, "(h) the IVF index was not built")
    # the int8 build holds the f16 plane too: the f16 spec probes the same
    # layout (the ledger holds one charge)
    tex._ann_indexes[(0, "vec", nlist, False, spec_f16.min_docs)] = idx
    out["build"] = {"wall_s": build_s, "nlist_requested": nlist, "nlist": idx.nlist, "cmax": idx.cmax,
                    "nbytes": idx.nbytes, "build_ms_reported": idx.build_ms, "digest": ivf_digest(idx)}
    log(f"(h) IVF build of {n} x {dims} f16 rows, nlist {nlist} -> {idx.nlist}, cmax {idx.cmax}: "
        f"{build_s} s")

    # ---- one Lloyd step alone, at the build's shapes ----
    rng = np.random.default_rng(7)
    init = np.sort(rng.choice(n, size=nlist, replace=False))
    v32 = scoring.upload(np.asarray(seg.vectors["vec"].vectors, np.float32), device)
    c0 = v32[scoring.upload(init, device)]
    step_ms = device_ms(lambda: ivf._lloyd_step(v32, c0), device, iters=3, warmup=1)
    flops = 2 * n * nlist * dims
    bound = flops / PEAK_F32_FLOPS * 1e3
    del v32, c0
    out["plain_ops"].append({"op": "_lloyd_step", "route": "(h) k-means build, one step", "calls_per_request": None,
                             "ms": step_ms, "flops": flops, "bound_ms": bound, "bound_by": "operations",
                             "bound_share": bound / step_ms})
    log(f"(h) one Lloyd step [{n}, {dims}] x [{nlist}, {dims}]: {step_ms:.2f} ms, bound {bound:.2f} ms (f32 FLOP)")

    # ---- one batcher knn group of 32, IVF f16 / int8 / exact ----
    gb = QueryBatcher(workers=1)
    gb._ensure_thread = lambda: None  # groups run on this thread

    def group(spec):
        plans = []
        for v in queries:
            sec = dsl.parse_knn(ann_body(v)["knn"])
            sec.ann = spec
            plans.append(extract_knn_plan([sec], reader.mappings))

        def run():
            jobs = [gb.submit_nowait(tex, p, K, kind="knn") for p in plans]
            gb._collect_knn_group(jobs, gb._dispatch_knn_group(jobs, rows=BATCH))
            return [gb.wait(j) for j in jobs]
        return run

    fns = {"h_exact_group32": group(None), "h_ivf_f16_group32": group(spec_f16),
           "h_ivf_int8_group32": group(spec_i8)}
    res = {}
    for name, fn in fns.items():
        fn()  # warm
        sync(device)
        st0 = dict(ann_mod.ANN_STATS)
        t = time.perf_counter()
        res[name] = fn()
        sync(device)
        out[name] = {"wall_s": time.perf_counter() - t,
                     "ann_searches": ann_mod.ANN_STATS["ann_searches"] - st0["ann_searches"],
                     "exact_fallbacks": ann_mod.ANN_STATS["exact_fallbacks"] - st0["exact_fallbacks"]}
    check(out["h_ivf_f16_group32"]["ann_searches"] == BATCH and out["h_ivf_int8_group32"]["ann_searches"] == BATCH,
          f"(h) the IVF groups did not probe every job: {out}")
    check(out["h_exact_group32"]["ann_searches"] == 0, "(h) the exact group probed")
    exact = res["h_exact_group32"]
    for name in ("h_ivf_f16_group32", "h_ivf_int8_group32"):
        rec = float(np.mean([len({h.doc_id for h in g.hits} & {h.doc_id for h in e.hits}) / max(1, len(e.hits))
                             for g, e in zip(res[name], exact)]))
        out[name]["recall_at_10"] = rec
        check(out[name]["exact_fallbacks"] == 0, f"{name}: exact fallbacks")
        check(rec >= 0.95, f"(h) {name}: recall@{K} {rec:.4f} < 0.95 against the exact group")
        check(all(len(g.hits) == K and np.isfinite(g.hits[0].score) for g in res[name]), f"(h) {name}: short pages")
    oracle = NumpyExecutor(reader)
    for i in range(ORACLE_QUERIES):
        ref = oracle.search(None, knn=[dsl.parse_knn(ann_body(queries[i])["knn"])], size=K)
        same_hits(ref, exact[i], f"(h) exact knn page {i}")
    del oracle
    log(f"(h) groups of {BATCH}: " + ", ".join(f"{k} {v}" for k, v in out.items() if k.startswith("h_")))

    # ---- the plain probe alone, f16 and int8 ----
    qt = scoring.upload(queries, device)
    valid = torch.ones(BATCH, dtype=torch.bool, device=device)
    cand = tex.knn_candidates(0, "vec")
    kc = scoring.next_bucket(ANN_CANDIDATES, 16)
    for name, quant in (("f16", False), ("int8", True)):
        ms = device_ms(lambda: ivf.ann_topk_batch(idx, qt, valid, cand, ANN_GATE_NPROBE, kc, quantized=quant), device)
        nbytes = probe_bytes(idx, BATCH, ANN_GATE_NPROBE, kc, quant)
        flops = ivf.ann_flops(BATCH, idx.nlist, ANN_GATE_NPROBE, idx.cmax, dims)
        bytes_ms, ops_ms = nbytes / PEAK_BYTES_PER_S * 1e3, flops / PEAK_F32_FLOPS * 1e3
        bound = max(bytes_ms, ops_ms)
        out["plain_ops"].append({
            "op": "ann_topk_batch", "route": f"(h) IVF probe, B={BATCH}, nprobe {ANN_GATE_NPROBE}, {name}",
            "calls_per_request": 1 / BATCH, "ms": ms, "bytes": nbytes, "flops": flops, "bound_ms": bound,
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations", "bound_share": bound / ms})
        log(f"plain op ann_topk_batch ({name}, B={BATCH}, nprobe {ANN_GATE_NPROBE}, P="
            f"{ANN_GATE_NPROBE * idx.cmax}): {ms:.4f} ms, bound {bound:.4f} ms ({nbytes} B)")
    out["fns"] = fns
    out["batcher"], out["executor"] = gb, tex  # closed by the caller once profiled
    return out


def sort_bodies(body_df: np.ndarray, seed: int) -> dict:
    """Route (i)'s bodies: BATCH `match` bodies sorted by `popularity`
    desc (ties by doc) and by `day` asc, K each."""
    texts = match_texts(body_df, BATCH, seed + 47)
    return {
        "popularity_desc": [{"query": {"match": {"body": t}}, "sort": [{"popularity": {"order": "desc"}}], "size": K}
                            for t in texts],
        "day_asc": [{"query": {"match": {"body": t}}, "sort": [{"day": "asc"}], "size": K} for t in texts],
    }


def route_sort(tex, oracle, reader, seed: int, device) -> dict:
    """Route (i): each sort body and its second page (search_after the
    first page's last value) through execute_sorted_device, held to the
    oracle's execute_sorted: the same ids in the same order, the same
    sort values, the same totals; a multi-key body must take the
    oracle's route (None from the device path)."""
    import torch

    from elasticsearch_tpu_torch.search import dsl
    from elasticsearch_tpu_torch.search.executor import parse_sort

    out = {}
    bodies = sort_bodies(reader.segments[0].postings["body"].term_df, seed)
    for name, bl in bodies.items():
        specs = parse_sort(bl[0]["sort"])
        tex.execute_sorted_device(dsl.parse_query(bl[0]["query"]), specs, size=K)  # the rank column is set-up
        sync(device)
        walls, pages = [], 0
        for body in bl:
            q = dsl.parse_query(body["query"])
            after = None
            for _ in range(2):
                t = time.perf_counter()
                got = tex.execute_sorted_device(q, specs, size=K, search_after=after)
                walls.append(time.perf_counter() - t)
                check(got is not None, f"(i) {name}: the device route refused a single numeric key")
                td, svals = got
                ref, _, rvals = oracle.execute_sorted(q, specs, size=K, search_after=after)
                check(td.total == ref.total, f"(i) {name}: total {td.total} != oracle {ref.total}")
                check([h.doc_id for h in td.hits] == [h.doc_id for h in ref.hits] and svals == rvals,
                      f"(i) {name}: page {[h.doc_id for h in td.hits]} {svals} != oracle "
                      f"{[h.doc_id for h in ref.hits]} {rvals}")
                pages += 1
                if not svals:
                    break
                after = svals[-1]
        out[name] = {"pages": pages, "wall_ms_p50": float(np.median(walls) * 1e3),
                     "wall_ms_max": float(np.max(walls) * 1e3)}
    multi = parse_sort([{"popularity": "desc"}, {"day": "asc"}])
    check(tex.execute_sorted_device(dsl.parse_query(bodies["day_asc"][0]["query"]), multi, size=K) is None,
          "(i) a multi-key sort did not take the oracle route")
    # the rank top-k alone: one [N] int32 top-k, as each segment runs it
    ranks = tex._sort_ranks(0, "popularity", True)[0]
    neg = torch.where(ranks % 3 == 0, -ranks, -(2**31 - 1))
    ms = device_ms(lambda: torch.topk(neg, K), device)
    nbytes = neg.numel() * 4 + K * 12
    out["plain_op"] = {"op": "torch.topk (sort ranks)", "route": "(i) sorted collection, one segment",
                       "calls_per_request": 1, "ms": ms, "bytes": nbytes,
                       "bound_ms": nbytes / PEAK_BYTES_PER_S * 1e3, "bound_by": "bytes",
                       "bound_share": nbytes / PEAK_BYTES_PER_S * 1e3 / ms}
    log(f"(i) sorted collection: {out}")
    return out


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

    from elasticsearch_tpu_torch.ops import int8_knn, ivf, rerank, scoring

    plain = scoring.topk_desc

    def named(x, k):
        with torch.profiler.record_function("topk_desc"):
            return plain(x, k)

    scoring.topk_desc = int8_knn.topk_desc = ivf.topk_desc = rerank.topk_desc = named
    try:
        yield
    finally:
        scoring.topk_desc = int8_knn.topk_desc = ivf.topk_desc = rerank.topk_desc = plain


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
        dtoh = sum(e.count for e in dev if "DtoH" in e.key)
        out[name] = {
            "wall_us": wall_us,
            "device_us": busy,
            "device_idle_share": max(0.0, 1.0 - busy / wall_us) if wall_us else None,
            "topk_desc_device_us": topk,
            "topk_desc_share_of_device": topk / busy if busy else None,
            "pageable_htod": pageable,
            "dtoh": dtoh,
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


def install_segment(eng, seg) -> None:
    """One prebuilt segment as a shard engine's whole searchable state
    (bench.py's make_service): `_bulk` of 1M docs through host analysis
    is set-up, not the thing served."""
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


def phase_serve(reader, dims: int, seed: int, device, card: str, ann_reader, ann_q, ann_digest: dict,
                rc: dict, phrase_pairs) -> dict:
    import torch

    from elasticsearch_tpu_torch.ops import ordered_scatter
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
            install_segment(srv.cluster.get_index(name).shards[0], seg)
        # bench.py's ann_knn indexes over route (h)'s corpus
        ivf = {"knn.type": "ivf", "knn.nlist": ann_nlist(ann_reader.segments[0].num_docs),
               "knn.nprobe": ANN_GATE_NPROBE}
        for name, extra in (("ann", {}), ("ann_int8", {"knn.quantization": "int8"})):
            http.ok("PUT", f"/{name}", {"settings": {"number_of_shards": 1, "refresh_interval": "-1", **ivf, **extra},
                                        "mappings": ann_mapping(dims)})
            install_segment(srv.cluster.get_index(name).shards[0], ann_reader.segments[0])
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
        served_small = []
        tile_launches = ordered_scatter.launch_tile_add.launches
        small_pass = capture_tile_add(lambda: served_small.append(drive_measured(
            clients_proc, "/small/_search", small_bodies, CLIENTS)))
        tile_launches = ordered_scatter.launch_tile_add.launches - tile_launches
        out, rows["small_mixed_8_clients"] = served_small[0]
        for i, body in enumerate(small_bodies):
            same_served(http.ok("POST", "/small_oracle/_search", body), out[i], f"/small body {i}")
        stats_small = node_stats(http)
        chunked = stats_small["search"]["chunked_jobs"] - stats_bench["search"]["chunked_jobs"]
        small_launches = stats_small["search"]["chunked_launches"] - stats_bench["search"]["chunked_launches"]
        log(f"/small: {chunked} (job, segment) pairs through the chunked path, {tile_launches} BM25 tile-add "
            f"launches ({small_launches} in the batcher's count)")
        check(chunked > 0, "/small: the chunked path was not taken")
        check(tile_launches > 0, "/small: the chunked path launched no BM25 tile add")
        tile_add_small = {**tile_add_kernel_row(small_pass, device), "launches": tile_launches,
                          "batcher_chunked_launches": small_launches}
        times["small_s"] = time.perf_counter() - t
        ex = srv.cluster.get_index("small")._executor(srv.cluster.get_index("small").shards[0])
        check(isinstance(ex, TorchExecutor) and ex.device.type == device.type,
              "/small is not served by a TorchExecutor on the card")

        # ---- bool, multi_match, filtered bool and hybrid RRF ----
        t = time.perf_counter()
        text_hybrid = serve_text_hybrid(srv, http, clients_proc, seg, docs, dims, seed, device, rows)
        times["text_hybrid_s"] = time.perf_counter() - t
        durable_pages = {"match_bodies": match_bodies[:DURABLE_MATCH],
                         "match_served": served[("match", 1)][:DURABLE_MATCH],
                         "knn_bodies": knn_bodies[:DURABLE_KNN], "knn_served": served[("knn", 1)][:DURABLE_KNN],
                         **text_hybrid.pop("pages")}

        # ---- sparse_vector and aggregations ----
        t = time.perf_counter()
        sparse_aggs = serve_sparse_aggs(srv, http, clients_proc, seg, docs, seed, rows)
        times["sparse_aggs_s"] = time.perf_counter() - t

        # ---- IVF ann_knn and sorted collection ----
        t = time.perf_counter()
        ann_sort = serve_ann_sort(srv, http, clients_proc, ann_q, ann_digest, seg, docs, seed, rows)
        times["ann_sort_s"] = time.perf_counter() - t

        # ---- route (j): rag_rerank; route (k): the remaining nodes ----
        t = time.perf_counter()
        rerank = serve_rerank(srv, http, clients_proc, rc, rows)
        times["rerank_s"] = time.perf_counter() - t
        t = time.perf_counter()
        nodes = serve_nodes(http, clients_proc, phrase_pairs, pf.term_df, seed, rows)
        times["nodes_s"] = time.perf_counter() - t
        t = time.perf_counter()
        rr_fns, rr_launch, rr_batcher = rerank_group_fns(srv, rc, device)
        plain_ops = [phrase_conjunction_row(srv, phrase_pairs, pf.term_df, seed, device)]
        if device.type == "cuda":
            plain_ops += rerank_op_rows(rr_launch, device)
            rr_profile = profile_routes(rr_fns, device)
            rr_syncs = {name: count_syncs(fn) for name, fn in rr_fns.items()}
            for name, pr in rr_profile.items():
                check(pr["pageable_htod"] == 0 and pr["dtoh"] == 1,
                      f"{name}: {pr['pageable_htod']} pageable uploads, {pr['dtoh']} downloads (want 0 and 1)")
            rerank.update(profile=rr_profile, syncs_per_group=rr_syncs)
            log(f"rerank groups: {rr_syncs}")
        else:
            for fn in rr_fns.values():
                fn()
        rr_batcher.close()
        times["rerank_nodes_ops_s"] = time.perf_counter() - t

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

        # ---- route (m): a durable node on the card, held to
        # /bench_oracle and to the pages /bench served above ----
        t = time.perf_counter()
        durable = route_durable(seg, dims, vocab, seed, device, http, durable_pages)
        times["durable_s"] = time.perf_counter() - t
        return {"durable": durable, "card": card, "latency": rows, "times": times, "bench_batcher": bench_search, "text_hybrid": text_hybrid,
                "sparse_aggs": sparse_aggs, "ann_sort": ann_sort, "rerank": rerank, "nodes": nodes,
                "plain_ops": plain_ops,
                "bench_launches_by_bucket": by_bucket, "small_chunked_jobs": chunked,
                "tile_add_small": tile_add_small,
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
    # bench.py's 3 legs (multi_match, knn, sparse_vector), all on the batcher
    check(rrf["batcher_legs"] == 3 * n_hybrid and rrf["pool_legs"] == 0 and rrf["inline_legs"] == 0,
          f"/bench: hybrid legs left the batcher: {rrf}")

    # ---- held to the numpy oracle ----
    t = time.perf_counter()
    checked = {"fused_check_modes": [], "sparse_leg_recall": []}
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
        leg_bodies, window = hybrid_legs(body)
        legs = []
        for leg in leg_bodies:
            ref = http.ok("POST", "/bench_oracle/_search", leg)
            got = http.ok("POST", "/bench/_search", leg)
            if "sparse_vector" in leg.get("query", {}):
                # the leg serves the index's int8 column: held to the
                # oracle's f32 page by recall, and the fusion to the
                # served leg
                checked["sparse_leg_recall"].append(recall_at(ref, got))
                legs.append(got)
                continue
            same_served(ref, got, f"/bench hybrid {i} leg")
            legs.append(ref)
        for clients in (CLIENTS, 1):
            checked["fused_check_modes"].append(same_fused(
                legs, served[("hybrid_rrf", clients)][i], window,
                f"/bench hybrid {i} ({clients} clients)", by_global_doc=True))
    checked["hybrid_rrf"] = ORACLE_QUERIES
    rec = float(np.mean(checked["sparse_leg_recall"]))
    log(f"/bench hybrid sparse legs (int8): recall@{K} {rec:.4f} against the oracle's f32 pages")
    check(rec >= 0.95, f"/bench hybrid sparse legs: recall@{K} {rec:.4f} < 0.95")
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
        leg_bodies, window = hybrid_legs(body)
        legs = []
        for leg in leg_bodies:
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
                     for q in (dsl.parse_query(h[0][0]["query"]) for h in hyb)]
        hyb_knn = [extract_knn_plan([dsl.parse_knn(h[0][1]["knn"])], bench.mappings) for h in hyb]
        hyb_sparse = [sparse_job(dsl.parse_query(h[0][2]["query"]), bench.mappings, True) for h in hyb]
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
            vj = [gb.submit_nowait(bex, p, K, kind="sparse", query=q) for p, q in hyb_sparse]
            sp = gb._dispatch_serve_group(sj, 16, rows=CLIENTS)
            kp = gb._dispatch_knn_group(kj, rows=CLIENTS)
            vp = gb._dispatch_sparse_group(vj, 16, rows=CLIENTS)
            gb._collect_serve_group(sj, 16, sp)
            gb._collect_knn_group(kj, kp)
            gb._collect_sparse_group(vj, 16, vp)
            for a, b, c in zip(sj, kj, vj):
                bench._fuse_legs_device([{"td": j.result, "ex": bex} for j in (a, b, c)],
                                        hyb[0][1], RRF_RANK_CONSTANT)

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
            "small_bodies": len(small), "profile": profile, "syncs_per_group": syncs,
            # for route (m), not printed
            "pages": {"hybrid_bodies": bodies["hybrid_rrf"][:DURABLE_HYBRID],
                      "hybrid_served": served[("hybrid_rrf", 1)][:DURABLE_HYBRID]}}


SPARSE_AGG_ROUTES = ("sparse_retrieval", "sparse_retrieval_exact", "repeated_agg", "cold_agg")


def node_blocks(http: Http) -> dict:
    node = http.ok("GET", "/_nodes/stats")["nodes"]["node-0"]
    return {"sparse": node["sparse"], "aggs": node["aggs"],
            "request_cache": node["indices"]["request_cache"]}


def serve_sparse_aggs(srv, http: Http, clients_proc: ClientProcess, seg, docs, seed: int, rows: dict) -> dict:
    """bench.py's `sparse_retrieval` (int8, and `"exact": true`),
    `repeated_agg` and `cold_agg` served on the card: `/bench` from 8
    clients then 1 (latency rows go into `rows`), held to `/bench_oracle`
    (int8 by recall@10 >= 0.95 against the oracle's f32 pages, exact by
    ids, `avg` within 1e-12 relative, cold aggregations equal), the
    counters that show the batcher's sparse family and the device agg
    plans served them; then a host-routed tree on `/small`."""
    b = sparse_agg_bodies(seg.postings["body"].term_df, seed)
    # one of each first: the sparse column's and agg columns' uploads
    # are set-up, not serving
    for r in SPARSE_AGG_ROUTES:
        http.ok("POST", "/bench/_search", b[r][0])
    served, counters = {}, {}
    for clients in (CLIENTS, 1):
        for r in SPARSE_AGG_ROUTES:
            st0 = node_blocks(http)
            out, rows[f"{r}_{clients}_clients"] = drive_measured(clients_proc, "/bench/_search", b[r], clients)
            st1 = node_blocks(http)
            served[(r, clients)] = out
            d = {f"sparse_{k}": st1["sparse"][k] - st0["sparse"][k]
                 for k in ("batched_jobs", "tiles_scored", "tiles_pruned", "pruned_searches", "fallbacks")}
            d.update({f"aggs_{k}": st1["aggs"][k] - st0["aggs"][k]
                      for k in ("device_routed", "host_routed", "fallbacks", "batched_jobs")})
            d["request_cache_hits"] = st1["request_cache"]["hit_count"] - st0["request_cache"]["hit_count"]
            counters[f"{r}_{clients}_clients"] = d
            log(f"/bench {r} x{len(b[r])} from {clients} clients: {rows[f'{r}_{clients}_clients']} {d}")
            if r.startswith("sparse"):
                check(d["sparse_batched_jobs"] == len(b[r]) and d["sparse_fallbacks"] == 0,
                      f"/bench {r}: {d}: not every body rode the batcher's sparse family")
            if r == "cold_agg":
                check(d["aggs_device_routed"] == len(b[r]) and d["aggs_host_routed"] == 0,
                      f"/bench cold_agg: {d} for {len(b[r])} bodies: not all on the device plan")
            if r == "repeated_agg" and clients == 1:
                check(d["request_cache_hits"] > 0, f"/bench repeated_agg: no request-cache hit on the second pass ({d})")

    # ---- held to the numpy oracle ----
    t = time.perf_counter()
    checked = {"sparse_exact_modes": []}
    recalls = []
    for i, body in enumerate(b["sparse_retrieval"]):
        ref = http.ok("POST", "/bench_oracle/_search", {**body, "size": K + 20})
        for clients in (CLIENTS, 1):
            recalls.append(recall_at(ref, served[("sparse_retrieval", clients)][i]))
            checked["sparse_exact_modes"].append(same_page(
                ref, served[("sparse_retrieval_exact", clients)][i], f"/bench sparse exact {i} ({clients} clients)"))
    checked["sparse_int8_recall_at_10"] = float(np.mean(recalls))
    check(np.mean(recalls) >= 0.95, f"/bench sparse_retrieval int8: recall@{K} {np.mean(recalls):.4f} < 0.95")
    worst = 0.0
    for i, body in enumerate(b["repeated_agg"]):
        want = http.ok("POST", "/bench_oracle/_search", body)["aggregations"]["pop_avg"]["value"]
        for clients in (CLIENTS, 1):
            got = served[("repeated_agg", clients)][i]["aggregations"]["pop_avg"]["value"]
            if want is None:
                check(got is None, f"/bench repeated_agg {i}: avg {got} != oracle None")
                continue
            rel = abs(got - want) / abs(want) if want else abs(got)
            worst = max(worst, rel)
            check(rel <= 1e-12, f"/bench repeated_agg {i}: avg {got} != oracle {want}")
    checked["repeated_agg_max_rel_err"] = worst
    for i, body in enumerate(b["cold_agg"]):
        ref = http.ok("POST", "/bench_oracle/_search", body)
        for clients in (CLIENTS, 1):
            got = served[("cold_agg", clients)][i]
            check(got["aggregations"] == ref["aggregations"], f"/bench cold_agg {i} ({clients} clients): "
                  f"aggregations differ from the oracle's")
            check(got["hits"]["total"] == ref["hits"]["total"], f"/bench cold_agg {i}: total differs")
    checked["oracle_s"] = time.perf_counter() - t
    log(f"/bench sparse + aggs held to the oracle: {checked}")

    # ---- /small: a tree the device compiler does not take ----
    small_body = {"size": 3, "request_cache": False, "query": {"match": {"body": docs[0][1]["body"].split()[0]}},
                  "aggs": {"cats": {"terms": {"field": "cat"},
                                    "aggs": {"p": {"percentiles": {"field": "popularity", "percents": [50, 90]}}}}}}
    st0 = node_blocks(http)
    got = http.ok("POST", "/small/_search", small_body)
    st1 = node_blocks(http)
    ref = http.ok("POST", "/small_oracle/_search", small_body)
    check(got["aggregations"] == ref["aggregations"], "/small: host-routed aggregations differ from the oracle's")
    same_served(ref, got, "/small host-routed agg body")
    host = st1["aggs"]["host_routed"] - st0["aggs"]["host_routed"]
    check(host == 2, f"/small: {host} host-routed shard collections for 2 shards")
    return {"served_routes": {r: len(b[r]) for r in SPARSE_AGG_ROUTES}, "counters": counters,
            "checked": checked, "small_host_routed": host}


def node_ann(http: Http) -> dict:
    return http.ok("GET", "/_nodes/stats")["nodes"]["node-0"]["knn"]["ann"]


def sorted_page(resp: dict):
    return [(h["_id"], h.get("sort")) for h in resp["hits"]["hits"]], resp["hits"]["total"]


def serve_ann_sort(srv, http: Http, clients_proc: ClientProcess, ann_q: np.ndarray, ann_digest: dict, seg,
                   docs, seed: int, rows: dict) -> dict:
    """bench.py's `ann_knn` served on the card: `/ann` (IVF over the f16
    rows) and `/ann_int8` (its int8 twin, whose build must be bit for bit
    route (h)'s build of the same rows and seed), 32 bodies at each nprobe of
    ANN_NPROBES and with `"exact": true`, from 8 clients then 1 (latency
    rows go into `rows`), recall@10 of each nprobe against the exact
    bodies (>= 0.95 at ANN_GATE_NPROBE), the `knn.ann` counters; then
    route (i)'s sort bodies on `/bench` held to `/bench_oracle` (ids,
    sort values, totals; a second page through search_after) and an
    `_id`-sorted body on `/small` held to `/small_oracle`."""
    out = {}
    bodies = {f"nprobe_{p}": [ann_body(v, p) for v in ann_q] for p in ANN_NPROBES}
    bodies["exact"] = [ann_body(v, exact=True) for v in ann_q]
    for name in ("ann", "ann_int8"):
        path = f"/{name}/_search"
        b0 = node_ann(http)["builds"]
        t = time.perf_counter()
        # the generation's executor builds the IVF index: set-up, not serving
        http.ok("POST", path, bodies["nprobe_8"][0])
        first_s = time.perf_counter() - t
        for bl in bodies.values():
            http.ok("POST", path, bl[0])
        st0 = node_ann(http)
        check(st0["builds"] > b0, f"{path}: no IVF build")
        if name == "ann_int8":
            idx = srv.cluster.get_index(name)
            built = [i for i in idx._executor(idx.shards[0])._ann_indexes.values() if i is not None]
            check(len(built) == 1 and ivf_digest(built[0]) == ann_digest,
                  f"{path}: its IVF build differs from route (h)'s build of the same rows and seed")
        served, res = {}, {"first_request_s": first_s}
        for clients in (CLIENTS, 1):
            for r, bl in bodies.items():
                served[(r, clients)], rows[f"{name}_{r}_{clients}_clients"] = drive_measured(
                    clients_proc, path, bl, clients)
            for r in bodies:
                if r == "exact":
                    continue
                rec = float(np.mean([recall_at(e, g) for e, g in zip(served[("exact", clients)],
                                                                      served[(r, clients)])]))
                res[f"recall_at_10_{r}_{clients}_clients"] = rec
            log(f"{path} from {clients} clients: " + ", ".join(
                f"{r} {rows[f'{name}_{r}_{clients}_clients']}" for r in bodies))
        st1 = node_ann(http)
        res["counters"] = {k: st1[k] - st0[k] for k in ("ann_searches", "exact_searches", "exact_fallbacks",
                                                        "builds", "probes", "clusters_scanned")}
        log(f"{path}: {res}")
        check(res["counters"]["ann_searches"] > 0 and res["counters"]["exact_fallbacks"] == 0,
              f"{path}: knn.ann counters {res['counters']}")
        for clients in (CLIENTS, 1):
            rec = res[f"recall_at_10_nprobe_{ANN_GATE_NPROBE}_{clients}_clients"]
            check(rec >= 0.95, f"{path}: recall@{K} {rec:.4f} < 0.95 at nprobe {ANN_GATE_NPROBE}")
        out[name] = res
    blk = node_ann(http)
    charge = 0
    for name in ("ann", "ann_int8"):
        idx = srv.cluster.get_index(name)
        ex = idx._executor(idx.shards[0])
        charge += sum(i.nbytes for i in ex._ann_indexes.values() if i is not None)
    out["knn_ann"] = blk
    out["ann_charge_bytes"] = charge
    check(blk["builds"] >= 1 and blk["ann_searches"] > 0 and blk["exact_fallbacks"] == 0,
          f"_nodes/stats knn.ann: {blk}")
    check(0 < blk["ledger_bytes"] <= charge, f"knn.ann ledger_bytes {blk['ledger_bytes']} against the charge {charge}")

    # ---- route (i)'s sort bodies on /bench, held to /bench_oracle ----
    sb = sort_bodies(seg.postings["body"].term_df, seed)
    checked = 0
    for r, bl in sb.items():
        http.ok("POST", "/bench/_search", bl[0])  # the rank column is set-up
        res_s, rows[f"sort_{r}_{CLIENTS}_clients"] = drive_measured(clients_proc, "/bench/_search", bl, CLIENTS)
        _, rows[f"sort_{r}_1_clients"] = drive_measured(clients_proc, "/bench/_search", bl, 1)
        for i, body in enumerate(bl):
            ref = http.ok("POST", "/bench_oracle/_search", body)
            check(sorted_page(res_s[i]) == sorted_page(ref), f"/bench sort {r} body {i}: page differs from the oracle")
            checked += 1
            if i < ORACLE_QUERIES and ref["hits"]["hits"]:
                nxt = {**body, "search_after": ref["hits"]["hits"][-1]["sort"]}
                check(sorted_page(http.ok("POST", "/bench/_search", nxt))
                      == sorted_page(http.ok("POST", "/bench_oracle/_search", nxt)),
                      f"/bench sort {r} body {i}: the search_after page differs from the oracle")
                checked += 1
        log(f"/bench sort {r}: {rows[f'sort_{r}_{CLIENTS}_clients']} / {rows[f'sort_{r}_1_clients']}")
    word = docs[0][1]["body"].split()[0]
    id_body = {"query": {"match": {"body": word}}, "sort": [{"_id": "asc"}], "size": K}
    check(sorted_page(http.ok("POST", "/small/_search", id_body))
          == sorted_page(http.ok("POST", "/small_oracle/_search", id_body)),
          "/small _id sort differs from the oracle")
    out["sort_pages_checked"] = checked + 1
    return out


# ---------------------------------------------------------------------------
# route (j): bench.py's rag_rerank (filtered hybrid → rescore → fetch)
# ---------------------------------------------------------------------------

RR_DOCS = 200_000  # bench.py's RR_DOCS
RR_VOCAB = 20_000
RR_DIMS = 64
RR_TOKENS = 4  # token rows per doc
RR_QTOKENS = 3  # query token rows
RR_CATS = 8
RR_TOPICS = 64
RR_BODIES = 32
RR_EVAL = 24  # bodies whose NDCG@10 is computed (bench.py's RR_EVAL)
RR_WINDOW = 100  # rank_window_size and the rescore window_size
RR_INT8_RECALL = 0.9
# ColBERT's published widths (Khattab & Zaharia 2020): 128-d token rows,
# query_maxlen 32, doc_maxlen 180; a synthetic column of COLBERT_DOCS docs
COLBERT_DIMS, COLBERT_QLEN, COLBERT_DLEN, COLBERT_DOCS = 128, 32, 180, 10_000


def build_rerank_corpus(seed: int, n_docs: int = RR_DOCS) -> dict:
    """bench.py's rag_rerank corpus (its build_rerank_services) on the
    port's classes: a 20,000-term Zipf `body` (15-34 tokens), 8 `cat`
    values (keyword postings and ordinals), 64-d unit `vec` rows around
    64 topic centers (noise 0.6) and a `toks` rank_vectors column of 4
    token rows per doc around the doc's center (noise 0.8); queries:
    2-4 mid-frequency terms, 3 token rows around a topic center (noise
    0.6) and a query vector near it (noise 0.4). From `seed`."""
    from elasticsearch_tpu_torch.index.segment import MultiVectorField, OrdinalField, Segment, VectorField

    rng = np.random.default_rng(seed + 57)
    lengths = rng.integers(15, 35, size=n_docs)
    body = build_postings(rng, RR_VOCAB, lengths)
    centers = rng.normal(size=(RR_TOPICS, RR_DIMS)).astype(np.float32)
    topic = rng.integers(0, RR_TOPICS, size=n_docs)
    vecs = centers[topic] + 0.6 * rng.normal(size=(n_docs, RR_DIMS)).astype(np.float32)
    vecs /= np.linalg.norm(vecs, axis=1, keepdims=True)
    toks = centers[topic][:, None, :] + 0.8 * rng.normal(size=(n_docs, RR_TOKENS, RR_DIMS)).astype(np.float32)
    toks = toks.astype(np.float32)
    cat_ords = rng.integers(0, RR_CATS, size=n_docs).astype(np.int32)
    names = [f"cat{j}" for j in range(RR_CATS)]
    exists = np.ones(n_docs, bool)
    seg = Segment(
        num_docs=n_docs,
        doc_ids=[str(i) for i in range(n_docs)],
        sources=[{"cat": names[c]} for c in cat_ords],
        postings={"body": body,
                  "cat": postings_from_stream(cat_ords.astype(np.int64), RR_CATS,
                                              np.ones(n_docs, np.int64), names=names)},
        numerics={},
        ordinals={"cat": OrdinalField(ord_terms=names, ords=cat_ords, mv_ords=cat_ords.copy(),
                                      mv_offsets=np.arange(n_docs + 1, dtype=np.int32))},
        vectors={"vec": VectorField(vectors=vecs, exists=exists, similarity="cosine", unit_vectors=vecs)},
        multi_vectors={"toks": MultiVectorField(
            tok_vectors=toks.reshape(-1, RR_DIMS),
            tok_offsets=(np.arange(n_docs + 1, dtype=np.int64) * RR_TOKENS).astype(np.int32),
            exists=exists.copy(), similarity="dot_product")},
    )
    qtopic = rng.integers(0, RR_TOPICS, size=RR_BODIES)
    qtoks = (centers[qtopic][:, None, :]
             + 0.6 * rng.normal(size=(RR_BODIES, RR_QTOKENS, RR_DIMS)).astype(np.float32)).astype(np.float32)
    qvec = centers[qtopic] + 0.4 * rng.normal(size=(RR_BODIES, RR_DIMS)).astype(np.float32)
    qvec /= np.linalg.norm(qvec, axis=1, keepdims=True)
    return {"seg": seg, "texts": match_texts(body.term_df, RR_BODIES, seed + 23, hi=6000),
            "qtoks": qtoks, "qvec": qvec, "toks": toks, "cat_ords": cat_ords}


def rerank_mapping() -> dict:
    return {"properties": {
        "body": {"type": "text"},
        "cat": {"type": "keyword"},
        "vec": {"type": "dense_vector", "dims": RR_DIMS, "similarity": "cosine"},
        "toks": {"type": "rank_vectors", "dims": RR_DIMS, "similarity": "dot_product"},
    }}


def rerank_body(rc: dict, i: int, rescore: bool = True, size: int = K) -> dict:
    """bench.py's rag_rerank body: a 2-leg `retriever.rrf` (a `match`
    and a kNN, both under the body's `cat` filter) and a `rescore` of
    window 100 with weights 1.0/1.0 over the `toks` column."""
    flt = {"term": {"cat": f"cat{i % RR_CATS}"}}
    b = {"retriever": {"rrf": {"rank_window_size": RR_WINDOW, "retrievers": [
        {"standard": {"query": {"match": {"body": rc["texts"][i]}}, "filter": flt}},
        {"knn": {"field": "vec", "query_vector": [float(x) for x in rc["qvec"][i]], "k": 50,
                 "num_candidates": 200, "filter": flt}},
    ]}}, "size": size, "_source": False}
    if rescore:
        b["rescore"] = {"window_size": RR_WINDOW, "query": {
            "rescore_query": {"rank_vectors": {"field": "toks", "query_vectors": rc["qtoks"][i].tolist()}},
            "query_weight": 1.0, "rescore_query_weight": 1.0}}
    return b


def ndcg_at_10(ranked_ids: list, grades: dict) -> float:
    """bench.py's _ndcg_at_10."""
    dcg = sum((2 ** grades.get(d, 0) - 1) / np.log2(i + 2) for i, d in enumerate(ranked_ids[:10]))
    ideal = sorted(grades.values(), reverse=True)[:10]
    idcg = sum((2 ** g - 1) / np.log2(i + 2) for i, g in enumerate(ideal))
    return dcg / idcg if idcg > 0 else 0.0


def true_maxsim(rc: dict, i: int) -> np.ndarray:
    """Σ_q max_t q·d_t of body i's query tokens against every doc (host
    float32), -inf outside the body's `cat` slice."""
    toks = rc["toks"]
    dots = (toks.reshape(-1, RR_DIMS) @ rc["qtoks"][i].T).reshape(len(toks), RR_TOKENS, RR_QTOKENS)
    sims = dots.max(axis=1).sum(axis=1)
    return np.where(rc["cat_ords"] == i % RR_CATS, sims, -np.inf)


def host_rescored_page(rc: dict, i: int, first: dict) -> list:
    """The page the rescore must give over a first-stage response of
    RR_WINDOW hits: blended = 1.0·first + 1.0·maxsim in float32 (the
    host oracle's models/rerank.host_maxsim), sorted desc with the
    first-stage rank breaking ties."""
    from elasticsearch_tpu_torch.models.rerank import host_maxsim

    ranked = hits_of(first)[:RR_WINDOW]
    q = rc["qtoks"][i]
    blended = [float(np.float32(1.0) * np.float32(s)
                     + np.float32(1.0) * np.float32(host_maxsim(q, rc["toks"][int(d)])))
               for d, s in ranked]
    order = sorted(range(len(ranked)), key=lambda j: (-blended[j], j))
    return [(ranked[j][0], blended[j]) for j in order][:K]


def same_rescored(want: list, got: dict) -> bool:
    """A served page against an expected [(id, score)]: scores within
    RTOL, ids position by position, a run tied within RTOL as a set."""
    gh = hits_of(got)
    if len(gh) != len(want):
        return False
    if not all(np.isclose(g, w, rtol=RTOL, atol=1e-6) for (_, g), (_, w) in zip(gh, want)):
        return False
    return all({d for d, _ in gh[i:j]} == {d for d, _ in want[i:j]}
               for i, j in tie_runs([s for _, s in want]))


def node_rescore(http: Http) -> dict:
    return http.ok("GET", "/_nodes/stats")["nodes"]["node-0"]["rescore"]


def serve_rerank(srv, http: Http, clients_proc: ClientProcess, rc: dict, rows: dict) -> dict:
    """Route (j), bench.py's `rag_rerank` served on the card: `/rerank`
    (f32 token rows), `/rerank_int8` (`rerank.quantization: int8`) and
    `/rerank_oracle` (numpy) over one 200,000-doc segment; RR_BODIES
    bodies from 8 clients then 1, and the same bodies without `rescore`
    (the first stage) on `/rerank`. f32 pages are held to the host
    oracle's rescore of a first stage (the card's own, or the oracle
    index's), int8 pages by recall@10 against the f32 ones; NDCG@10 of
    the first stage and of the rescored pages against the true maxsim
    ordering (bench.py's grades); the `rescore` block's counters."""
    out = {}
    for name, extra in (("rerank", {"search.backend": "torch"}),
                        ("rerank_int8", {"search.backend": "torch", "rerank.quantization": "int8"}),
                        ("rerank_oracle", {"search.backend": "numpy"})):
        http.ok("PUT", f"/{name}", {"settings": {"number_of_shards": 1, "refresh_interval": "-1", **extra},
                                    "mappings": rerank_mapping()})
        install_segment(srv.cluster.get_index(name).shards[0], rc["seg"])
    bodies = [rerank_body(rc, i) for i in range(RR_BODIES)]
    firsts = [rerank_body(rc, i, rescore=False) for i in range(RR_BODIES)]
    # the first request of each index uploads its columns: set-up
    t = time.perf_counter()
    for path in ("/rerank", "/rerank_int8"):
        http.ok("POST", f"{path}/_search", bodies[0])
        http.ok("POST", f"{path}/_search", firsts[0])
    out["first_requests_s"] = time.perf_counter() - t
    served, counters = {}, {}
    for clients in (CLIENTS, 1):
        for route, path, bl in (("rag_rerank", "/rerank", bodies), ("rag_rerank_int8", "/rerank_int8", bodies),
                                ("rag_first_stage", "/rerank", firsts)):
            st0 = node_rescore(http)
            served[(route, clients)], rows[f"{route}_{clients}_clients"] = drive_measured(
                clients_proc, f"{path}/_search", bl, clients)
            st1 = node_rescore(http)
            d = {k: st1[k] - st0[k] for k in ("device_rescores", "host_rescores", "skipped", "fallbacks",
                                               "batched_jobs")}
            d["kernel_ms_per_rescore"] = ((st1["kernel_ms"] - st0["kernel_ms"]) / d["device_rescores"]
                                          if d["device_rescores"] else None)
            counters[f"{route}_{clients}_clients"] = d
            log(f"{path} {route} x{len(bl)} from {clients} clients: {rows[f'{route}_{clients}_clients']} {d}")
            if route != "rag_first_stage":
                check(d["device_rescores"] == len(bl) and d["fallbacks"] == 0 and d["skipped"] == 0
                      and d["batched_jobs"] == len(bl),
                      f"{path}: rescore counters {d} for {len(bl)} bodies: not all reranked on the card")
    out["counters"] = counters
    # ---- f32 pages against the host oracle; int8 by recall ----
    t = time.perf_counter()
    modes = {"oracle_page": 0, "card_first_stage": 0}
    recalls = []
    for i in range(RR_BODIES):
        deep = rerank_body(rc, i, rescore=False, size=RR_WINDOW)
        oracle_page = http.ok("POST", "/rerank_oracle/_search", bodies[i])
        for clients in (CLIENTS, 1):
            got = served[("rag_rerank", clients)][i]
            if same_rescored(hits_of(oracle_page), got):
                modes["oracle_page"] += 1
            else:
                # the card's first stage may order BM25 scores tied within
                # rtol otherwise (float atomics, ROADMAP queue 3), and so
                # bring another candidate set: hold the rescore to the
                # host oracle's blend over the card's own candidates
                want = host_rescored_page(rc, i, http.ok("POST", "/rerank/_search", deep))
                check(same_rescored(want, got),
                      f"/rerank body {i} ({clients} clients): page {hits_of(got)} != host rescore {want}")
                modes["card_first_stage"] += 1
            recalls.append(recall_at(got, served[("rag_rerank_int8", clients)][i]))
    out["f32_checks"] = modes
    out["int8_recall_at_10"] = float(np.mean(recalls))
    log(f"/rerank f32 pages: {modes}; /rerank_int8 recall@{K} {out['int8_recall_at_10']:.4f}")
    check(out["int8_recall_at_10"] >= RR_INT8_RECALL,
          f"/rerank_int8: recall@{K} {out['int8_recall_at_10']:.4f} < {RR_INT8_RECALL}")
    # ---- NDCG@10 against the true maxsim order (bench.py's grades) ----
    nd_first, nd_rerank, nd_int8 = [], [], []
    for i in range(min(RR_EVAL, RR_BODIES)):
        order = np.argsort(-true_maxsim(rc, i))[:200]
        grades = {str(int(d)): (3 if r < 10 else 2 if r < 50 else 1) for r, d in enumerate(order)}
        nd_first.append(ndcg_at_10([d for d, _ in hits_of(served[("rag_first_stage", 1)][i])], grades))
        nd_rerank.append(ndcg_at_10([d for d, _ in hits_of(served[("rag_rerank", 1)][i])], grades))
        nd_int8.append(ndcg_at_10([d for d, _ in hits_of(served[("rag_rerank_int8", 1)][i])], grades))
    out["ndcg_at_10"] = {"first_stage": float(np.mean(nd_first)), "rescored_f32": float(np.mean(nd_rerank)),
                         "rescored_int8": float(np.mean(nd_int8))}
    out["check_s"] = time.perf_counter() - t
    out["rescore_block"] = node_rescore(http)
    cols = {}
    for name in ("rerank", "rerank_int8"):
        idx = srv.cluster.get_index(name)
        cols[name] = sum(c["toks"].numel() * c["toks"].element_size()
                         + (0 if c["scales"] is None else c["scales"].numel() * 4)
                         for c in idx._executor(idx.shards[0])._rerank_columns.values() if c is not None)
    out["token_row_bytes"] = cols
    log(f"route (j): NDCG@10 {out['ndcg_at_10']}; token rows {cols} B; rescore block {out['rescore_block']}")
    return out


def rerank_group_fns(srv, rc: dict, device) -> tuple:
    """(one batcher `rerank` group of CLIENTS jobs over `/rerank` and
    `/rerank_int8`'s first-stage candidates, as callables; the group's
    launch inputs, for the op timings)."""
    from elasticsearch_tpu_torch.cluster.indices import _reader_locations
    from elasticsearch_tpu_torch.models import rerank as rerank_model
    from elasticsearch_tpu_torch.search import rescorer
    from elasticsearch_tpu_torch.search.batcher import QueryBatcher

    gb = QueryBatcher(workers=1)
    gb._ensure_thread = lambda: None  # groups run on this thread
    fns, launch = {}, {}
    for name in ("rerank", "rerank_int8"):
        idx = srv.cluster.get_index(name)
        ex = idx._executor(idx.shards[0])
        locs = _reader_locations(ex)
        model = rerank_model.resolve_model(idx.mappings, idx.settings, "toks")
        plans = []
        for i in range(CLIENTS):
            body = rerank_body(rc, i)
            ranked = idx._run_retriever(body["retriever"], K, K, None, None)
            cands = [(float(s), *locs[d]) for d, s in ranked]
            plans.append(rescorer.build_plan(ex.reader, model, rescorer.parse_rescore(body), cands))

        def group(ex=ex, plans=plans):
            jobs = [gb.submit_nowait(ex, p, len(p.first), kind="rerank") for p in plans]
            gb._collect_rerank_group(jobs, gb._dispatch_rerank_group(jobs, rows=CLIENTS))
            check(all(j.result[0] == "ok" for j in jobs), "a rerank group did not run on the card")

        fns[f"batcher_{name}_group_8"] = group
        launch[name] = (ex, plans)
    return fns, launch, gb


def maxsim_inputs(ex, plans: list, rows: int):
    """The device tensors one rerank group of `plans` launches with (the
    batcher's staging, uploaded), and the column."""
    from elasticsearch_tpu_torch.ops.scoring import upload

    col = ex.rerank_column(plans[0].model)
    p0 = plans[0]
    dev = col["starts"].device
    qtoks = np.zeros((rows, p0.qb, col["dims"]), np.float32)
    qvalid = np.zeros((rows, p0.qb), bool)
    docs = np.zeros((rows, p0.wb), np.int32)
    first = np.full((rows, p0.wb), -np.inf, np.float32)
    valid = np.zeros((rows, p0.wb), bool)
    for r, p in enumerate(plans):
        qtoks[r, : len(p.qtoks)] = p.qtoks
        qvalid[r, : len(p.qtoks)] = True
        docs[r, : len(p.first)] = p.gdocs
        first[r, : len(p.first)] = p.first
        valid[r, : len(p.first)] = True
    return col, [upload(a, dev) for a in (qtoks, qvalid, docs, first, valid)]


def maxsim_row(name: str, col: dict, t: list, window: int, real: dict, device) -> dict:
    """`maxsim_candidates` + `blend_and_sort` timed alone (CUDA events)
    on one group's device inputs, beside its bound: the bytes the real
    candidates need (their token rows — and int8 scales — read once, the
    query rows, each candidate's bounds and first-stage score, the packed
    result written once) over the memory rate, and their FLOP
    (2·Qt·T·d per candidate and query token) over the float32 rate."""
    import torch

    from elasticsearch_tpu_torch.ops import rerank as rerank_ops

    qtoks, qvalid, docs, first, valid = t
    weights = torch.tensor([1.0, 1.0], dtype=torch.float32, device=docs.device)

    def op():
        msim = rerank_ops.maxsim_candidates(qtoks, qvalid, col["starts"], col["counts"], col["toks"],
                                            col["scales"], docs, col["tmax"])
        return rerank_ops.blend_and_sort(msim, first, valid, weights, window)

    ms = device_ms(op, device)
    dev_ms = op_device_ms(op, device)
    nbytes = (real["tokens"] * (col["dims"] * col["toks"].element_size() + (4 if col["scales"] is not None else 0))
              + real["qrows"] * col["dims"] * 4 + real["cands"] * (4 + 4 + 4 + 4 + 1)
              + real["cands"] * 8)
    flops = 2 * real["qtok_dots"] * col["dims"]
    byte_ms = nbytes / PEAK_BYTES_PER_S * 1e3
    flop_ms = flops / PEAK_F32_FLOPS * 1e3
    bound_ms = max(byte_ms, flop_ms)
    row = {"op": "ops/rerank.py maxsim_candidates + blend_and_sort", "shape": name, "ms": ms,
           "device_ms": dev_ms, "bytes": int(nbytes), "flops": int(flops), "bound_ms": bound_ms,
           "bound_by": "bytes" if byte_ms >= flop_ms else "operations", "bound_share": bound_ms / ms,
           "device_bound_share": bound_ms / dev_ms if dev_ms else None,
           "gathered_f32_bytes": int(docs.numel() * col["tmax"] * col["dims"] * 4)}
    log(f"plain op maxsim ({name}): {ms:.4f} ms (kernels {dev_ms}), bound {bound_ms:.4f} ms "
        f"({row['bound_by']}; {nbytes} B, {flops} FLOP), share {row['bound_share']:.3f}")
    return row


def op_device_ms(fn, device):
    """The device time of one call of `fn`: its kernels and copies summed
    from a profile (CUDA-event times of a launch-bound op are host
    time); None off the card."""
    if device.type != "cuda":
        return None
    return profile_routes({"op": fn}, device)["op"]["device_us"] / 1e3


def rerank_op_rows(launch: dict, device) -> list:
    """The maxsim op at route (j)'s shape (f32 and int8, one group of
    CLIENTS jobs) and at ColBERT's published widths (B 8, W 128, a
    10,000-doc synthetic f32 column, every doc 180 token rows, 32 query
    token rows)."""
    import torch

    rows = []
    for name, (ex, plans) in launch.items():
        col, t = maxsim_inputs(ex, plans, len(plans))
        cands = sum(len(p.first) for p in plans)
        real = {"cands": cands, "tokens": cands * RR_TOKENS, "qrows": sum(len(p.qtoks) for p in plans),
                "qtok_dots": sum(len(p.first) * len(p.qtoks) * RR_TOKENS for p in plans)}
        rows.append(maxsim_row(f"route (j) {name}: B {len(plans)}, W {plans[0].wb}, Qt {RR_QTOKENS}, "
                               f"T {RR_TOKENS}, d {RR_DIMS}", col, t, plans[0].win_static, real, device))
    g = torch.Generator(device=device)
    g.manual_seed(7)
    rng = np.random.default_rng(7)
    b, w = CLIENTS, 128
    n_tok = COLBERT_DOCS * COLBERT_DLEN
    col = {"starts": torch.arange(0, n_tok, COLBERT_DLEN, dtype=torch.int32, device=device),
           "counts": torch.full((COLBERT_DOCS,), COLBERT_DLEN, dtype=torch.int32, device=device),
           "toks": torch.randn(n_tok + COLBERT_DLEN, COLBERT_DIMS, generator=g, device=device),
           "scales": None, "tmax": COLBERT_DLEN, "dims": COLBERT_DIMS}
    docs = np.stack([rng.choice(COLBERT_DOCS, size=w, replace=False) for _ in range(b)]).astype(np.int32)
    first = -np.sort(-rng.normal(size=(b, w)).astype(np.float32), axis=1)
    t = [torch.randn(b, COLBERT_QLEN, COLBERT_DIMS, generator=g, device=device),
         torch.ones(b, COLBERT_QLEN, dtype=torch.bool, device=device),
         torch.from_numpy(docs).to(device), torch.from_numpy(first).to(device),
         torch.ones(b, w, dtype=torch.bool, device=device)]
    real = {"cands": b * w, "tokens": b * w * COLBERT_DLEN, "qrows": b * COLBERT_QLEN,
            "qtok_dots": b * w * COLBERT_QLEN * COLBERT_DLEN}
    rows.append(maxsim_row(f"ColBERT widths: B {b}, W {w}, Qt {COLBERT_QLEN}, T {COLBERT_DLEN}, "
                           f"d {COLBERT_DIMS}, {COLBERT_DOCS} docs, f32", col, t, w, real, device))
    del col, t
    torch.cuda.empty_cache()
    return rows


# ---------------------------------------------------------------------------
# route (k): the remaining query nodes on /bench
# ---------------------------------------------------------------------------

NODE_COUNTS = {"match_phrase": 32, "prefix": 32, "fuzzy": 16, "wildcard": 16, "bool_phrase_filter": 16}


def node_bodies(phrase_pairs: np.ndarray, term_df: np.ndarray, seed: int) -> dict:
    """Route (k)'s bodies: `match_phrase` over adjacent term pairs of real
    docs (each term's df in PHRASE_DF), `prefix` (5 characters: 10
    terms), `fuzzy` (a term with its last digit changed, 1 edit, prefix
    length 3), `wildcard` (one `?`: 10 terms) and a `bool` whose filter
    is a phrase and whose `must` matches the phrase's first term."""
    rng = np.random.default_rng(seed + 29)
    check(len(phrase_pairs) >= NODE_COUNTS["match_phrase"],
          f"only {len(phrase_pairs)} adjacent pairs with df in {PHRASE_DF}")
    picks = phrase_pairs[rng.choice(len(phrase_pairs), size=NODE_COUNTS["match_phrase"], replace=False)]
    phrases = [f"w{a:05d} w{b:05d}" for a, b in picks]
    mid = np.argsort(-term_df)[100:5000]
    terms = [f"w{int(t):05d}" for t in rng.choice(mid, size=64, replace=False)]
    out = {
        "match_phrase": [{"query": {"match_phrase": {"body": p}}, "size": K} for p in phrases],
        "prefix": [{"query": {"prefix": {"body": t[:5]}}, "size": K} for t in terms[:32]],
        "fuzzy": [{"query": {"fuzzy": {"body": {"value": t[:-1] + str((int(t[-1]) + 1) % 10), "fuzziness": 1,
                                                "prefix_length": 3}}}, "size": K} for t in terms[32:48]],
        "wildcard": [{"query": {"wildcard": {"body": t[:4] + "?" + t[5]}}, "size": K} for t in terms[48:64]],
        "bool_phrase_filter": [{"query": {"bool": {"must": [{"match": {"body": p.split()[0]}}],
                                                   "filter": [{"match_phrase": {"body": p}}]}}, "size": K}
                               for p in phrases[:16]],
    }
    return out


def serve_nodes(http: Http, clients_proc: ClientProcess, phrase_pairs, term_df, seed: int, rows: dict) -> dict:
    """Route (k) on `/bench` (1M docs, `body` with positions): each
    family of node_bodies from 8 clients then 1, held to `/bench_oracle`;
    the phrase routes the executor took (the device conjunction and the
    host position verify, or the oracle's route for a segment without
    positions), the conjunction's candidates and the verify's wall."""
    from elasticsearch_tpu_torch.search import executor_torch

    bodies = node_bodies(phrase_pairs, term_df, seed)
    out, phrase = {}, {}
    for fam, bl in bodies.items():
        served = {}
        for clients in (CLIENTS, 1):
            p0 = dict(executor_torch.PHRASE_STATS)
            served[clients], rows[f"{fam}_{clients}_clients"] = drive_measured(
                clients_proc, "/bench/_search", bl, clients)
            p1 = dict(executor_torch.PHRASE_STATS)
            d = {k: p1[k] - p0[k] for k in p1}
            if d["conjunction"]:
                d["candidates_per_phrase"] = d["candidates"] / d["conjunction"]
                d["verify_ms_per_phrase"] = d["verify_s"] * 1e3 / d["conjunction"]
            phrase[f"{fam}_{clients}_clients"] = d
            log(f"/bench {fam} x{len(bl)} from {clients} clients: {rows[f'{fam}_{clients}_clients']} phrase {d}")
            # a phrase filter is computed once, then the filter-bitset
            # cache answers it: only its first drive runs the phrases
            if fam == "match_phrase" or (fam == "bool_phrase_filter" and clients == CLIENTS):
                check(d["conjunction"] >= len(bl) and d["oracle"] == 0,
                      f"/bench {fam}: phrase routes {d}: not every phrase took the device conjunction")
        hits = 0
        for i, body in enumerate(bl):
            ref = http.ok("POST", "/bench_oracle/_search", body)
            hits += len(ref["hits"]["hits"])
            for clients in (CLIENTS, 1):
                same_served(ref, served[clients][i], f"/bench {fam} body {i} ({clients} clients)")
        check(hits > 0, f"/bench {fam}: no body matched anything")
        out[fam] = {"bodies": len(bl), "oracle_hits": hits}
    out["phrase"] = phrase
    return out


def phrase_conjunction_row(srv, phrase_pairs, term_df, seed: int, device) -> dict:
    """`_exec_phrase`'s device conjunction (`_exec_match`, operator and)
    for one route (k) phrase on the 1M-doc segment, timed alone, beside
    its byte bound: the two terms' tiles (doc ids and tfs) and each
    posting's norm read once, the [n] mask and scores written once."""
    from elasticsearch_tpu_torch.search.dsl import MatchQuery

    bench = srv.cluster.get_index("bench")
    ex = bench._executor(bench.shards[0])
    text = node_bodies(phrase_pairs, term_df, seed)["match_phrase"][0]["query"]["match_phrase"]["body"]
    q = MatchQuery(field="body", query=text, operator="and")
    ms = device_ms(lambda: ex._exec_match(q, 0), device)
    dev_ms = op_device_ms(lambda: ex._exec_match(q, 0), device)
    pf = ex.reader.segments[0].postings["body"]
    n = ex.reader.segments[0].num_docs
    tids = [pf.term_id(t) for t in text.split()]
    tiles = sum(int(pf.term_tile_count[t]) for t in tids)
    slots = sum(int(pf.term_df[t]) for t in tids)
    nbytes = tiles * 128 * 8 + slots * 4 + n * 5
    bound_ms = nbytes / PEAK_BYTES_PER_S * 1e3
    row = {"op": "executor_torch._exec_phrase conjunction (_exec_match, operator and)",
           "shape": f"1 phrase, 2 terms, {tiles} tiles, {n} docs", "ms": ms, "device_ms": dev_ms,
           "bytes": nbytes, "bound_ms": bound_ms, "bound_by": "bytes", "bound_share": bound_ms / ms,
           "device_bound_share": bound_ms / dev_ms if dev_ms else None}
    log(f"plain op phrase conjunction: {ms:.4f} ms (kernels {dev_ms}), bound {bound_ms:.4f} ms ({nbytes} B)")
    return row


def node_query_cache(http: Http) -> dict:
    return http.ok("GET", "/_nodes/stats")["nodes"]["node-0"]["indices"]["query_cache"]


# ---------------------------------------------------------------------------
# segment builds on the card: the column-family parity phase and route (l)
# ---------------------------------------------------------------------------

PARITY_DOCS = 20_000
PARITY_VOCAB = 5_000  # body and title words, Zipf 1.1
PARITY_CATS = 16
BUILD_OPS = ("postings_tiles_device", "text_impacts_device", "ordinals_device", "scatter_rows_device",
             "csr_offsets_device", "sparse_planes_device")
FAMILY_ATTRS = {
    "postings": ("terms", "term_df", "term_total_tf", "term_tile_start", "term_tile_count", "doc_ids", "tfs",
                 "tile_max_tf", "tile_min_norm", "norms", "term_pos_start", "pos_offsets", "pos_data",
                 "impacts", "impact_scales"),
    "ordinals": ("ord_terms", "ords", "mv_ords", "mv_offsets"),
    "numerics": ("values", "exists"),
    "vectors": ("vectors", "exists", "unit_vectors"),
    "multi_vectors": ("tok_vectors", "tok_offsets", "exists"),
    "sparse": ("terms", "term_df", "term_tile_start", "term_tile_count", "doc_ids", "weights", "qweights",
               "scales", "tile_max", "tile_qmax", "exists", "pruned"),
}


def _same_column(a, b) -> bool:
    if a is None or b is None:
        return a is None and b is None
    if isinstance(a, (list, int)) or isinstance(b, (list, int)):
        return a == b
    a, b = np.asarray(a), np.asarray(b)
    return a.dtype == b.dtype and a.shape == b.shape and bool(np.array_equal(a, b))


def segment_diff(host, dev, skip=()) -> tuple:
    """(columns compared, the names of those that differ) between a host
    and a device build (or a saved segment and its reload): dtype, shape
    and every bit of every column of every family, but the attributes
    named in `skip`."""
    bad, n = [], 1
    if host.num_docs != dev.num_docs or host.doc_ids != dev.doc_ids:
        bad.append("doc_ids")
    for fam, attrs in FAMILY_ATTRS.items():
        h, d = getattr(host, fam), getattr(dev, fam)
        if sorted(h) != sorted(d):
            bad.append(fam)
            continue
        for f in h:
            for attr in attrs:
                if attr in skip:
                    continue
                n += 1
                if not _same_column(getattr(h[f], attr, None), getattr(d[f], attr, None)):
                    bad.append(f"{fam}.{f}.{attr}")
            if fam == "postings" and vars(h[f].stats) != vars(d[f].stats):
                bad.append(f"postings.{f}.stats")
    return n, bad


def parity_mapping(dims: int) -> dict:
    """Every column family at the repo's own widths: two text fields with
    positions, a multi-valued keyword, an integer and a date, a 768-d
    cosine and a 768-d l2_norm dense_vector, route (j)'s rank_vectors
    (4 x 64) and bench.py's `ml` sparse_vector."""
    return {"properties": {
        "body": {"type": "text"}, "title": {"type": "text"}, "tag": {"type": "keyword"},
        "popularity": {"type": "integer"}, "day": {"type": "date"},
        "vec": {"type": "dense_vector", "dims": dims, "similarity": "cosine"},
        "vec_l2": {"type": "dense_vector", "dims": dims, "similarity": "l2_norm"},
        "toks": {"type": "rank_vectors", "dims": RR_DIMS, "similarity": "cosine"},
        "ml": {"type": "sparse_vector"},
    }}


def parity_sources(seed: int, n: int, dims: int) -> list:
    rng = np.random.default_rng(seed + 61)
    words = np.array([f"p{i}" for i in range(PARITY_VOCAB)])
    zipf = 1.0 / np.arange(1, PARITY_VOCAB + 1) ** 1.1
    zipf /= zipf.sum()
    cats = [f"c{i}" for i in range(PARITY_CATS)]
    pop = sparse_popularity()
    out = []
    for i in range(n):
        src = {
            "body": " ".join(rng.choice(words, size=int(rng.integers(15, 35)), p=zipf)),
            "title": " ".join(rng.choice(words, size=int(rng.integers(3, 9)), p=zipf)),
            "tag": [cats[j] for j in rng.integers(0, PARITY_CATS, size=int(rng.integers(1, 4)))],
            "popularity": int(rng.integers(0, 100)),
            "day": int(1_700_000_000_000 + rng.integers(0, 30 * DAY_MS)),
            "toks": rng.standard_normal((RR_TOKENS, RR_DIMS), dtype=np.float32).tolist(),
            "ml": {f"tok{int(t):04d}": float(rng.random() * 3 + 0.05)
                   for t in rng.choice(SPARSE_VOCAB, size=int(rng.integers(*SPARSE_TERMS_PER_DOC)), p=pop)},
        }
        if i % 10:  # a tenth of the docs lack the vectors
            src["vec"] = rng.standard_normal(dims, dtype=np.float32).tolist()
            src["vec_l2"] = rng.standard_normal(dims, dtype=np.float32).tolist()
        out.append((f"p{i}", src))
    return out


def _nbytes(x) -> int:
    if isinstance(x, np.ndarray):
        return int(x.nbytes)
    if isinstance(x, dict):
        return sum(_nbytes(v) for v in x.values())
    if isinstance(x, (tuple, list)):
        return sum(_nbytes(v) for v in x)
    return 0


def build_op_row(name: str, fn, args: tuple, shape: str, device) -> dict:
    """One build op alone on the inputs the build gave it: CUDA-event ms
    over 20 calls, the device time of one profiled call, and its byte
    bound (each numpy input read once, each output written once)."""
    out = fn(*args)
    nbytes = sum(_nbytes(a) for a in args) + _nbytes(out)
    ms = device_ms(lambda: fn(*args), device)
    dev_ms = op_device_ms(lambda: fn(*args), device)
    bound_ms = nbytes / PEAK_BYTES_PER_S * 1e3
    row = {"op": f"ops/index_build.py {name}", "route": shape, "calls_per_request": None, "ms": ms,
           "device_ms": dev_ms, "bytes": nbytes, "bound_ms": bound_ms, "bound_by": "bytes",
           "bound_share": bound_ms / ms if ms else None,
           "device_bound_share": bound_ms / dev_ms if dev_ms else None}
    log(f"build op {name} ({shape}): {ms:.4f} ms (device {dev_ms}), bound {bound_ms:.5f} ms ({nbytes} B)")
    return row


def phase_build_parity(seed: int, dims: int, cat_ids: np.ndarray, n_cats: int, device) -> dict:
    """One segment of PARITY_DOCS docs with every column family, built on
    the card by index/segment_build._device_build and on the host by
    SegmentBuilder from the same builder, compared bit for bit; route
    (g)'s 1M-doc bucket ids through agg_perm_tables_device against a
    stable host argsort; each build op timed alone beside its bound."""
    from elasticsearch_tpu_torch.analysis import AnalysisRegistry
    from elasticsearch_tpu_torch.index import segment_build
    from elasticsearch_tpu_torch.index.mapping import DocumentParser, Mappings
    from elasticsearch_tpu_torch.index.segment import SegmentBuilder
    from elasticsearch_tpu_torch.ops import index_build as ib

    out = {"plain_ops": []}
    t = time.perf_counter()
    maps = Mappings(parity_mapping(dims))
    parser = DocumentParser(maps, AnalysisRegistry())
    builder = SegmentBuilder(maps)
    for doc_id, src in parity_sources(seed, PARITY_DOCS, dims):
        builder.add(parser.parse(doc_id, src))
    out["parse_s"] = time.perf_counter() - t
    ib.reset_kernel_stats()
    with OpCounter([(ib, name) for name in BUILD_OPS]) as ops:
        t = time.perf_counter()
        dev = segment_build._device_build(builder, device)
        out["device_build_s"] = time.perf_counter() - t
    out["build_kernels"] = ib.kernel_stats_snapshot()
    t = time.perf_counter()
    host = builder.build()
    out["host_build_s"] = time.perf_counter() - t
    n_cols, bad = segment_diff(host, dev)
    out["columns_compared"], out["columns_differing"] = n_cols, bad
    check(not bad, f"build parity: {len(bad)} of {n_cols} columns differ between the card and the host: {bad[:8]}")
    check(set(ops.calls) == set(BUILD_OPS), f"build parity: ops not run on the card: {set(BUILD_OPS) - set(ops.calls)}")
    log(f"build parity: {PARITY_DOCS} docs, {n_cols} columns bit-identical (device {out['device_build_s']:.1f}s, "
        f"host {out['host_build_s']:.1f}s)")

    t = time.perf_counter()
    got = ib.agg_perm_tables_device(cat_ids, n_cats, device)
    hperm = np.argsort(cat_ids, kind="stable").astype(np.int32)
    hbounds = np.searchsorted(cat_ids[hperm], np.arange(n_cats + 1)).astype(np.int32)
    check(got is not None and _same_column(got[0], hperm) and _same_column(got[1], hbounds),
          "agg_perm_tables_device differs from the stable host argsort on route (g)'s bucket ids")
    out["agg_tables_s"] = time.perf_counter() - t

    shape = f"parity segment: {PARITY_DOCS} docs"
    for name in BUILD_OPS:
        out["plain_ops"].append(build_op_row(name, getattr(ib, name), ops.args[name], shape, device))
    vec_rows = host.vectors["vec"].vectors[host.vectors["vec"].exists]
    out["plain_ops"].append(build_op_row("quantize_int8_device", ib.quantize_int8_device, (vec_rows, device),
                                         f"{len(vec_rows)} x {dims} vec rows", device))
    out["plain_ops"].append(build_op_row("agg_perm_tables_device", ib.agg_perm_tables_device,
                                         (cat_ids, n_cats, device), f"route (g): {len(cat_ids)} cat ids", device))
    return out


INGEST_BASE = 100_000  # bench.py's INGEST_BASE at BENCH_N_DOCS 1M
INGEST_SECONDS = 15.0
INGEST_WRITERS = 4
INGEST_REFRESH = "200ms"
INGEST_RATE = 1500.0  # offered docs/s across the writers
INGEST_VOCAB = 4000
INGEST_QUERIES = 512
INGEST_THREADS = 64
INGEST_CHECKS = 32  # bodies held to the numpy index after the final refresh
INGEST_DIAG_SECONDS = 5.0  # the read-only open loop of the one-worker diagnosis
INGEST_MAPPING = {"properties": {"body": {"type": "text"}, "popularity": {"type": "integer"}}}


def run_load(svc, bodies, threads: int):
    """bench.py's run_load: closed-loop, `threads` workers over `bodies`;
    (qps, p50_ms, p99_ms, wall_s)."""
    lat, lock, nxt = [], threading.Lock(), [0]

    def worker():
        local = []
        while True:
            with lock:
                i = nxt[0]
                if i >= len(bodies):
                    break
                nxt[0] += 1
            t0 = time.perf_counter()
            r = svc.search(bodies[i])
            local.append(time.perf_counter() - t0)
            check("hits" in r, "route (l): a closed-loop search gave no hits block")
        with lock:
            lat.extend(local)

    ts = [threading.Thread(target=worker) for _ in range(threads)]
    t0 = time.perf_counter()
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    wall = time.perf_counter() - t0
    lat_ms = np.asarray(lat) * 1e3
    return len(bodies) / wall, float(np.percentile(lat_ms, 50)), float(np.percentile(lat_ms, 99)), wall


def run_open_loop(svc, bodies, rate_qps: float, duration_s: float, slo_ms: float, seed: int,
                  window_end=None) -> dict:
    """bench.py's run_open_loop: Poisson arrivals at `rate_qps` for
    `duration_s` on a pool of 256 threads; accepted-request latency.
    `window_end` is called when the arrivals stop, before the backlog
    drains."""
    from concurrent.futures import ThreadPoolExecutor

    from elasticsearch_tpu_torch.common.memory import CircuitBreakingException
    from elasticsearch_tpu_torch.search.admission import EsOverloadedError
    from elasticsearch_tpu_torch.search.batcher import EsRejectedExecutionError

    rng = np.random.default_rng(seed)
    results, lock = [], threading.Lock()

    def one(body):
        t0 = time.perf_counter()
        try:
            ok, shed = "hits" in svc.search(body), False
        except (EsOverloadedError, EsRejectedExecutionError, CircuitBreakingException):
            ok, shed = False, True
        with lock:
            results.append((ok, shed, (time.perf_counter() - t0) * 1e3))

    pool = ThreadPoolExecutor(max_workers=256, thread_name_prefix="open-loop")
    prev = sys.getswitchinterval()
    sys.setswitchinterval(0.001)
    offered, t_start, next_t = 0, time.perf_counter(), 0.0
    try:
        while True:
            now = time.perf_counter() - t_start
            if now >= duration_s:
                break
            if now < next_t:
                time.sleep(min(next_t - now, 0.01))
                continue
            pool.submit(one, bodies[offered % len(bodies)])
            offered += 1
            next_t += float(rng.exponential(1.0 / rate_qps))
    finally:
        sys.setswitchinterval(prev)
        if window_end is not None:
            window_end()
    pool.shutdown(wait=True)
    wall = time.perf_counter() - t_start
    ok_lat = np.asarray([dt for ok, _, dt in results if ok])
    shed = sum(1 for _, s, _ in results if s)
    return {"offered": offered, "offered_qps": offered / wall, "completed": int(len(ok_lat)),
            "shed_429": shed, "errors": len(results) - len(ok_lat) - shed,
            "within_slo": int((ok_lat <= slo_ms).sum()) if len(ok_lat) else 0, "slo_ms": slo_ms,
            "p50_ms": float(np.percentile(ok_lat, 50)) if len(ok_lat) else None,
            "p99_ms": float(np.percentile(ok_lat, 99)) if len(ok_lat) else None, "wall_s": wall}


def same_page_any_tie_cut(oracle, body: dict, got: dict, what: str) -> None:
    """same_served against an index whose segments lie in another order:
    exact ties rank the lower global doc first on both, so the page's
    last run of tied scores may be cut at other docs. Every earlier run
    must hold the same ids; the last run's ids must be docs the oracle
    scores the same (read from its page deep enough to hold the run)."""
    ref = oracle.search(body)
    check(ref["hits"]["total"] == got["hits"]["total"],
          f"{what}: total {got['hits']['total']} != oracle {ref['hits']['total']}")
    rh, gh = hits_of(ref), hits_of(got)
    check(len(rh) == len(gh), f"{what}: {len(gh)} hits != oracle {len(rh)}")
    if not rh:
        return
    for (_, rs), (_, gs) in zip(rh, gh):
        check(np.isclose(gs, rs, rtol=RTOL, atol=1e-6), f"{what}: score {gs} != oracle {rs}")
    i, j = tie_runs([sc for _, sc in rh])[-1]
    same_ids([d for d, _ in rh[:i]], [sc for _, sc in rh[:i]], [d for d, _ in gh[:i]], what)
    last = rh[i][1]
    deep = oracle.search({**body, "size": min(ref["hits"]["total"]["value"], 10_000)})
    pool = {d for d, sc in hits_of(deep) if np.isclose(sc, last, rtol=RTOL, atol=1e-6)}
    check({d for d, _ in gh[i:j]} <= pool, f"{what}: ids {gh[i:j]} of the last tied run are not the oracle's")


def route_ingest(seed: int, device, seconds: float = INGEST_SECONDS, base: int = INGEST_BASE) -> dict:
    """Route (l), bench.py's `indexing` scenario (`bench.py:1475-1681`)
    on the port: one shard, `search.backend: torch`, refresh_interval
    200ms with the background refresher, admission off; `base` seeded
    docs of 8-15 words over a 4,000-word Zipf-1.1 vocabulary plus an
    integer; a 1-second write warmup; 512 two-term `match` bodies; the
    read-only closed-loop peak at 64 threads; `seconds` of open-loop
    reads at 0.4 x that peak; then `seconds` at the same rate while 4
    writers offer 1,500 docs/s. Every refresh and merge segment must be
    built on the card, every prewarm must build the text serving caches,
    every streamed doc must be searchable after the final refresh and 32
    bodies must equal a numpy-backend index fed the same sources; the
    base batch built on the card and on the host from one builder must
    be bit-identical, and a swap after a small refresh must adopt every
    old segment's uploads. Then, as a diagnosis, the closed loop and
    INGEST_DIAG_SECONDS of the read-only open loop again on a batcher of
    one worker (the served path's default is six)."""
    from elasticsearch_tpu_torch.cluster.indices import IndexService
    from elasticsearch_tpu_torch.index import segment_build
    from elasticsearch_tpu_torch.index.mapping import DocumentParser
    from elasticsearch_tpu_torch.index.segment import SegmentBuilder
    from elasticsearch_tpu_torch.search.admission import admission
    from elasticsearch_tpu_torch.search.executor_torch import TorchExecutor

    admission.configure(enabled=False)
    prev_bg = os.environ.get("ES_TPU_BG_REFRESH")
    os.environ["ES_TPU_BG_REFRESH"] = "auto"
    rng = np.random.default_rng(seed + 7)
    vocab = np.array([f"w{i}" for i in range(INGEST_VOCAB)])
    zipf = 1.0 / np.arange(1, INGEST_VOCAB + 1) ** 1.1
    zipf /= zipf.sum()

    def make_source(r):
        return {"body": " ".join(r.choice(vocab, size=int(r.integers(8, 16)), p=zipf)),
                "popularity": int(r.integers(0, 1000))}

    # every prewarm a refresh tick runs must build the text serving
    # caches: the tick swallows a prewarm error, this record does not
    prewarms = {"calls": 0, "failures": [], "missing": []}
    real_prewarm = TorchExecutor.prewarm

    def checked_prewarm(self, settings=None):
        try:
            real_prewarm(self, settings)
        except BaseException as e:
            prewarms["failures"].append(repr(e))
            raise
        prewarms["calls"] += 1
        for si, seg in enumerate(self.reader.segments):
            if seg.num_docs and "body" in seg.postings and (
                    self._block_indexes.get((si, "body")) is None
                    or self._chunked_scorers.get((si, "body")) is None):
                prewarms["missing"].append(si)

    TorchExecutor.prewarm = checked_prewarm
    segment_build.reset_stats()
    svc = IndexService("ingest-bench", settings={"number_of_shards": 1, "search.backend": "torch",
                                                 "refresh_interval": INGEST_REFRESH},
                       mappings_json=INGEST_MAPPING, device=device)
    out = {"base_docs": base, "refresh_interval": INGEST_REFRESH, "writers": INGEST_WRITERS,
           "offered_docs_per_s": INGEST_RATE, "seconds": seconds}
    fed = []  # (id, source) in write order, for the numpy index
    try:
        t = time.perf_counter()
        base_src = [(f"b{i}", make_source(rng)) for i in range(base)]
        for doc_id, src in base_src:
            svc.index_doc(doc_id, src)
        svc.refresh()
        out["seed_s"] = time.perf_counter() - t
        fed += base_src
        # the 1-second write warmup through the NRT loop
        r0 = np.random.default_rng(seed + 3)
        warm_n = max(int(INGEST_RATE * 1.0), 64)
        for i in range(warm_n):
            src = make_source(r0)
            svc.index_doc(f"warm{i}", src)
            fed.append((f"warm{i}", src))
            if i % max(warm_n // 4, 1) == 0:
                svc.wait_for_refresh(timeout=30)
        svc.wait_for_refresh(timeout=30)
        mids = vocab[40:400]
        bodies = [{"query": {"match": {"body": " ".join(rng.choice(mids, size=2))}}, "size": K}
                  for _ in range(INGEST_QUERIES)]
        for b in bodies[:6]:
            svc.search(b)
        ro_qps, ro_p50, ro_p99, _ = run_load(svc, bodies, INGEST_THREADS)
        rate = max(0.4 * ro_qps, 4.0)
        slo_ms = max(8.0 * ro_p50, 250.0)
        out["readonly_closed_loop"] = {"qps": ro_qps, "p50_ms": ro_p50, "p99_ms": ro_p99}
        log(f"(l) read-only closed loop at {INGEST_THREADS} threads: {ro_qps:.1f} QPS; open loop at {rate:.1f}/s")
        out["readonly"] = run_open_loop(svc, bodies, rate, seconds, slo_ms, seed + 101)

        def mixed(duration: float, tag: str, wseed: int, qseed: int):
            """The open loop at `rate` while INGEST_WRITERS paced writers
            (generators seeded by their index) offer INGEST_RATE docs/s
            until the arrivals stop (bench.py stops them only once the
            query backlog has drained, which lets a saturated run write
            on for minutes); (open-loop result, docs written, the
            writers' wall s)."""
            stop = threading.Event()
            written = [[] for _ in range(INGEST_WRITERS)]
            per_writer_dt = INGEST_WRITERS / INGEST_RATE

            def writer(tid):
                r = np.random.default_rng(wseed + tid)
                t_start, next_t = time.perf_counter(), 0.0
                while not stop.is_set():
                    now = time.perf_counter() - t_start
                    if now < next_t:
                        time.sleep(min(next_t - now, 0.02))
                        continue
                    doc_id, src = f"{tag}{tid}-{len(written[tid])}", make_source(r)
                    svc.index_doc(doc_id, src)
                    written[tid].append((doc_id, src))
                    next_t += per_writer_dt

            threads = [threading.Thread(target=writer, args=(i,), daemon=True) for i in range(INGEST_WRITERS)]
            t_mix = time.perf_counter()
            walls = []

            def window_end():
                stop.set()
                walls.append(time.perf_counter() - t_mix)

            for th in threads:
                th.start()
            res = run_open_loop(svc, bodies, rate, duration, slo_ms, qseed, window_end)
            for th in threads:
                th.join(timeout=30)
            check(not any(th.is_alive() for th in threads), "route (l): a writer did not stop")
            for w in written:
                fed.extend(w)
            return res, sum(len(w) for w in written), walls[0]

        # ---- mixed: the same open-loop rate while the writers stream ----
        out["mixed"], n_written, mix_wall = mixed(seconds, "s", seed + 100, seed + 11)
        ing = segment_build.stats_snapshot()
        svc.refresh()
        total = svc.search({"size": 0, "track_total_hits": True})["hits"]["total"]["value"]
        out.update({
            "docs_per_s": n_written / mix_wall, "docs_written": n_written, "seed_docs_per_s": base / out["seed_s"],
            "refresh_lag": ing["refresh_lag"], "refreshes": ing["refreshes"],
            "concurrent_refreshes": ing["concurrent_refreshes"], "concurrent_merges": ing["concurrent_merges"],
            "device_builds": ing["device_builds"], "host_builds": ing["host_builds"],
            "fallbacks": ing["fallbacks"], "degraded": ing["degraded"],
            "generations_discarded": ing["generations_discarded"], "build_kernels": ing["build_kernels"],
            "overlap_ms": ing["overlap_ms"], "prewarm_ms": ing["prewarm_ms"],
            "p99_ratio_vs_readonly": (out["mixed"]["p99_ms"] / out["readonly"]["p99_ms"]
                                      if out["mixed"]["p99_ms"] and out["readonly"]["p99_ms"] else None),
            "total_docs_after": total, "prewarms": dict(prewarms),
        })
        log(f"(l) {out['docs_per_s']:.1f} docs/s, refresh lag {ing['refresh_lag']}, read-only p50/p99 "
            f"{out['readonly']['p50_ms']}/{out['readonly']['p99_ms']} ms, mixed {out['mixed']['p50_ms']}/"
            f"{out['mixed']['p99_ms']} ms; builds {ing['device_builds']} device / {ing['host_builds']} host, "
            f"fallbacks {ing['fallbacks']}, degraded {ing['degraded']}; kernels {ing['build_kernels']}")
        check(out["readonly"]["errors"] == 0 and out["mixed"]["errors"] == 0, "route (l): searches failed")
        check(ing["device_builds"] > 0 and ing["host_builds"] == 0 and ing["fallbacks"] == 0,
              f"route (l): not every segment was built on the card: {ing}")
        check(total == len(fed), f"route (l): {total} docs searchable after the final refresh, {len(fed)} written")
        check(prewarms["calls"] > 0 and not prewarms["failures"] and not prewarms["missing"],
              f"route (l): a refresh's prewarm failed or left the text caches unbuilt: {prewarms}")

        # ---- a swap after a small refresh adopts every old upload ----
        shard = svc.local_shard(0)
        for attempt in range(3):
            old = svc._executor(shard)
            old.prewarm(svc.settings)
            old_cols = {(id(ds.seg), c): dict(getattr(ds, c)._cache)
                        for ds in old.device_segments for c in ("postings", "numerics", "vectors", "ordinals")}
            r1 = np.random.default_rng(seed + 5 + attempt)
            for i in range(64):
                src = make_source(r1)
                svc.index_doc(f"swap{attempt}-{i}", src)
                fed.append((f"swap{attempt}-{i}", src))
            svc.wait_for_refresh(timeout=30)
            new = svc._executor(shard)
            kept = [ds for ds in new.device_segments if (id(ds.seg), "postings") in old_cols]
            if kept:
                break
        check(bool(kept), "route (l): every swap merged away the old segments")
        missing = [(id(ds.seg), c, k) for ds in kept for c in ("postings", "numerics", "vectors", "ordinals")
                   for k, v in old_cols[(id(ds.seg), c)].items() if getattr(ds, c)._cache.get(k) is not v]
        check(not missing, f"route (l): the swap re-uploaded {len(missing)} columns of unchanged segments")
        adopted = sum(ds.adopted_bytes for ds in new.device_segments)
        charged = sum(nb for _, nb in new._charges)
        out["swap"] = {"segments": len(new.device_segments), "unchanged_segments": len(kept),
                       "adopted_bytes": adopted, "uploaded_bytes": charged - adopted}
        log(f"(l) swap: {out['swap']}")

        # ---- diagnosis: the same loads on a batcher of one worker ----
        from elasticsearch_tpu_torch.search.batcher import QueryBatcher

        old_batcher, svc._batcher = svc._batcher, QueryBatcher(workers=1)
        old_batcher.close()
        d_qps, d_p50, d_p99, _ = run_load(svc, bodies, INGEST_THREADS)
        diag = {"readonly_closed_loop": {"qps": d_qps, "p50_ms": d_p50, "p99_ms": d_p99},
                "readonly": run_open_loop(svc, bodies, rate, INGEST_DIAG_SECONDS, slo_ms, seed + 17)}
        out["diagnosis_workers1"] = diag
        log(f"(l) one batcher worker: closed loop {d_qps:.1f} QPS; read-only p50/p99 "
            f"{diag['readonly']['p50_ms']}/{diag['readonly']['p99_ms']} ms")
        end = segment_build.stats_snapshot()
        check(end["host_builds"] == 0 and end["fallbacks"] == 0,
              f"route (l): a later refresh was built on the host: {end}")

        # ---- 32 bodies held to a numpy-backend index fed the same sources ----
        t = time.perf_counter()
        oracle = IndexService("ingest-oracle", settings={"number_of_shards": 1, "search.backend": "numpy",
                                                         "refresh_interval": "-1"},
                              mappings_json=INGEST_MAPPING, device=device)
        try:
            for doc_id, src in fed:
                oracle.index_doc(doc_id, src)
            oracle.refresh()
            svc.refresh()
            for i, b in enumerate(bodies[:INGEST_CHECKS]):
                same_page_any_tie_cut(oracle, b, svc.search(b), f"(l) body {i} against the numpy index")
        finally:
            oracle.close()
        out["oracle_s"] = time.perf_counter() - t

        # ---- the base batch, card and host, from one builder ----
        t = time.perf_counter()
        parser = DocumentParser(svc.mappings, svc.analysis)
        builder = SegmentBuilder(svc.mappings)
        for doc_id, src in base_src:
            builder.add(parser.parse(doc_id, src))
        n_cols, bad = segment_diff(builder.build(), segment_build._device_build(builder, device))
        check(not bad, f"route (l): the base batch's columns differ between the card and the host: {bad}")
        out["base_parity"] = {"columns_compared": n_cols, "s": time.perf_counter() - t}
        return out
    finally:
        TorchExecutor.prewarm = real_prewarm
        svc.close()
        if prev_bg is None:
            os.environ.pop("ES_TPU_BG_REFRESH", None)
        else:
            os.environ["ES_TPU_BG_REFRESH"] = prev_bg


DURABLE_MATCH = 32  # route (m): match bodies held before and after the restart
DURABLE_KNN = 32
DURABLE_HYBRID = 8
DURABLE_MORE = 200  # acknowledged, unflushed docs the spawned node must replay
PCIE_BYTES_PER_S = 64e9  # PCIe Gen5 x16, one direction, nominal
SPAWN_TIMEOUT_S = 300.0


@contextlib.contextmanager
def timed_loads(acc: dict):
    """Adds the walls of `Segment.load` and of the native codec's decodes
    (which run inside it) to `acc` while open."""
    from elasticsearch_tpu_torch import native
    from elasticsearch_tpu_torch.index.segment import Segment

    real_load = Segment.__dict__["load"]
    real = {name: getattr(native, name) for name in ("tiles_decode", "vb_decode")}

    def wrap(fn, key):
        def run(*a, **k):
            t = time.perf_counter()
            try:
                return fn(*a, **k)
            finally:
                acc[key] = acc.get(key, 0.0) + time.perf_counter() - t
        return run

    Segment.load = classmethod(wrap(real_load.__func__, "segment_load_s"))
    for name, fn in real.items():
        setattr(native, name, wrap(fn, "native_decode_s"))
    try:
        yield acc
    finally:
        Segment.load = real_load
        for name, fn in real.items():
            setattr(native, name, fn)


def disk_bytes(root: str) -> dict:
    """Bytes of every file under `root`, by path relative to it."""
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            full = os.path.join(d, f)
            out[os.path.relpath(full, root)] = os.path.getsize(full)
    return out


def npz_bytes(path: str) -> dict:
    """Bytes of each array in an .npz (uncompressed: the stored size)."""
    import zipfile

    with zipfile.ZipFile(path) as z:
        return {i.filename[:-4]: i.file_size for i in z.infolist()}


def durable_reopen(seg, dims: int, device, http: Http, pages: dict, root: str) -> dict:
    """Route (m) steps 1-2: the 1M-doc segment flushed into `/durable`
    (best_compression) by an in-process node with a data path, the node
    closed and opened again, every saved array held bit for bit, the
    time to recover split, and the reopened index's pages held to
    `/bench_oracle` and to the pages `/bench` served before."""
    import gc

    import torch

    from elasticsearch_tpu_torch.cluster.service import ClusterService
    from elasticsearch_tpu_torch.common.memory import hbm_ledger
    from elasticsearch_tpu_torch.native import native_available

    out = {}
    path = os.path.join(root, "node")
    check(native_available(), "(m) the native postings codec did not build (g++): the NumPy codec would run")
    c = ClusterService(data_path=path, device=device)
    try:
        c.create_index("durable", {"settings": {"number_of_shards": 1, "search.backend": "torch",
                                                "codec": "best_compression", "refresh_interval": "-1"},
                                   "mappings": corpus_mapping(dims)})
        idx = c.get_index("durable")
        install_segment(idx.shards[0], seg)
        t = time.perf_counter()
        idx.flush()
        out["flush_s"] = time.perf_counter() - t
    finally:
        c.close()
    shard = os.path.join(path, "indices", "durable", "0")
    files = disk_bytes(shard)
    seg_dir = next(os.path.dirname(f) for f in files if f.endswith("segment.json"))
    arrays = npz_bytes(os.path.join(shard, seg_dir, "arrays.npz"))
    out["disk_bytes"] = files
    out["disk_bytes_total"] = sum(files.values())
    out["postings"] = {
        f: {"raw_bytes": int(seg.postings[f].doc_ids.nbytes + seg.postings[f].tfs.nbytes),
            "delta_varint_bytes": arrays[f"{f}.doc_ids_vb"] + arrays[f"{f}.tfs_vb"]}
        for f in ("body", "title")
    }
    log(f"(m) flush of {seg.num_docs} docs: {out['flush_s']:.2f}s, {out['disk_bytes_total']} bytes on disk; "
        f"postings raw vs delta+varint {out['postings']}")

    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    split = {}
    t = time.perf_counter()
    with open(os.path.join(path, "cluster_state.json"), encoding="utf-8") as f:
        json.load(f)
    split["cluster_state_read_s"] = time.perf_counter() - t
    t = time.perf_counter()
    with timed_loads(split):
        c = ClusterService(data_path=path, device=device)
    split["node_open_s"] = time.perf_counter() - t
    try:
        idx = c.get_index("durable")
        eng = idx.shards[0]
        loaded = eng.segments[0]
        n_cols, bad = segment_diff(seg, loaded, skip=("unit_vectors",))
        check(not bad and loaded.sources == seg.sources and loaded.generation == seg.generation,
              f"(m) reloaded columns differ from the saved ones: {bad}")
        unit_err = float(np.abs(loaded.vectors["vec"].unit_vectors - seg.vectors["vec"].unit_vectors).max())
        out["columns_bit_identical"] = n_cols
        out["unit_vectors_max_abs_diff"] = unit_err
        check(eng.committed_seq_no == seg.num_docs - 1 and eng.max_seq_no == seg.num_docs - 1,
              f"(m) reopened shard at seq {eng.committed_seq_no}/{eng.max_seq_no}, want {seg.num_docs - 1}")
        used = hbm_ledger.used
        t = time.perf_counter()
        ex = idx._executor(eng)
        sync(device)
        split["first_executor_s"] = time.perf_counter() - t
        split["uploaded_bytes"] = hbm_ledger.used - used
        split["uploaded_pcie_bound_s"] = split["uploaded_bytes"] / PCIE_BYTES_PER_S
        check(ex.device.type == device.type, f"(m) /durable serves on {ex.device}, not the card")
        # the executor uploads a column when a query first needs it: the
        # first body of each family pays for its columns
        for route in ("match", "knn", "hybrid"):
            before = hbm_ledger.used
            t = time.perf_counter()
            c.search("durable", pages[f"{route}_bodies"][0])
            sync(device)
            split[f"first_{route}_search_s"] = time.perf_counter() - t
            split[f"first_{route}_uploaded_bytes"] = hbm_ledger.used - before
        split["uploaded_bytes_total"] = hbm_ledger.used - used
        split["uploaded_total_pcie_bound_s"] = split["uploaded_bytes_total"] / PCIE_BYTES_PER_S
        lat = []
        got = {}
        for route in ("match", "knn"):
            got[route] = []
            for body in pages[f"{route}_bodies"]:
                t = time.perf_counter()
                got[route].append(c.search("durable", body))
                lat.append(time.perf_counter() - t)
        split["steady_p50_ms"] = float(np.percentile(np.asarray(lat[:len(pages["match_bodies"])]) * 1e3, 50))
        split["steady_knn_p50_ms"] = float(np.percentile(np.asarray(lat[len(pages["match_bodies"]):]) * 1e3, 50))
        split["engine_rest_s"] = split["node_open_s"] - split["segment_load_s"]
        out["recover"] = split
        log(f"(m) time to recover: {split}")

        for route in ("match", "knn"):
            for i, body in enumerate(pages[f"{route}_bodies"]):
                ref = http.ok("POST", "/bench_oracle/_search", body)
                same_served(ref, got[route][i], f"(m) /durable {route} body {i} against the oracle")
                same_served(pages[f"{route}_served"][i], got[route][i],
                            f"(m) /durable {route} body {i} against /bench before the restart")
        modes = []
        with idx._rrf_lock:
            for key in idx.rrf_stats:
                idx.rrf_stats[key] = 0
        for i, body in enumerate(pages["hybrid_bodies"]):
            page = c.search("durable", body)
            leg_bodies, window = hybrid_legs(body)
            legs = []
            for leg in leg_bodies:
                mine = c.search("durable", leg)
                if "sparse_vector" in leg.get("query", {}):
                    # the int8 column: held to the leg /bench serves from
                    # the segment before the restart; the fusion to the
                    # served leg
                    same_served(http.ok("POST", "/bench/_search", leg), mine, f"(m) /durable hybrid {i} sparse leg")
                    legs.append(mine)
                    continue
                ref = http.ok("POST", "/bench_oracle/_search", leg)
                same_served(ref, mine, f"(m) /durable hybrid {i} leg")
                legs.append(ref)
            mode = same_fused(legs, page, window, f"(m) /durable hybrid {i}", by_global_doc=True)
            # the page /bench served before the restart is a fusion of the
            # same legs (exact, or within the RRF intervals their ties allow)
            same_fused(legs, pages["hybrid_served"][i], window, f"(m) /bench hybrid {i} before the restart",
                       by_global_doc=True)
            if mode == "exact":
                # no tied leg scores: the fused page is determined, so both
                # pages agree
                same_served(pages["hybrid_served"][i], page, f"(m) /durable hybrid {i} against /bench before")
            modes.append(mode)
        rrf = dict(idx.rrf_stats)
        check(rrf["device_fused"] == len(pages["hybrid_bodies"]) and rrf["host_fused"] == 0,
              f"(m) /durable hybrids not fused on the card: {rrf}")
        out["checked"] = {"match": len(pages["match_bodies"]), "knn": len(pages["knn_bodies"]),
                          "hybrid": len(pages["hybrid_bodies"]), "fused_check_modes": modes}
        del loaded, eng, ex
    finally:
        c.close()
    shutil.rmtree(path, ignore_errors=True)
    return out


def repo_env(repo: str) -> dict:
    """This environment with the checkout first on the import path."""
    path = os.environ.get("PYTHONPATH")
    return dict(os.environ, PYTHONPATH=repo + (os.pathsep + path if path else ""))


class SpawnedNode:
    """`python -m elasticsearch_tpu_torch serve --data-path D --port 0
    [args]` in a process of its own (output to a log file under D's
    parent); `port` is read from the HTTP address of its startup line
    (a single node's "listening on http://...", or a cluster node's
    "transport ... http://...")."""

    def __init__(self, data_path: str, log_path: str, args=(), what: str = "(m) the spawned node"):
        repo = str(Path(__file__).resolve().parent)
        env = repo_env(repo)
        self.t0 = time.perf_counter()
        self.log_path = log_path
        self.what = what
        self.log = open(log_path, "wb")
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "elasticsearch_tpu_torch", "serve", "--data-path", data_path, "--port", "0",
             *args],
            stdout=self.log, stderr=subprocess.STDOUT, cwd=repo, env=env,
        )
        try:
            self.port = self._wait_listening()
        except BaseException:
            self.kill()
            raise

    def _tail(self) -> str:
        with open(self.log_path, "rb") as f:
            return f.read()[-2000:].decode(errors="replace")

    def _wait_listening(self) -> int:
        import re

        deadline = time.perf_counter() + SPAWN_TIMEOUT_S
        while time.perf_counter() < deadline:
            with open(self.log_path, "rb") as f:
                m = re.search(rb"http://[^:\s/]+:(\d+)", f.read())
            if m:
                return int(m.group(1))
            check(self.proc.poll() is None, f"{self.what} exited ({self.proc.returncode}): {self._tail()}")
            time.sleep(0.05)
        raise SmokeFailure(f"{self.what} did not listen in {SPAWN_TIMEOUT_S}s: {self._tail()}")

    def kill(self) -> None:
        if self.proc.poll() is None:
            self.proc.kill()  # SIGKILL: no flush, no close
        self.proc.wait(timeout=60)
        self.log.close()


def durable_small_bodies(docs: list, dims: int, seed: int) -> list:
    """Phase 4's `/small` shapes over the small docs: `match` (some with
    operator and), `knn`, `bool`, `multi_match` and filtered `bool`."""
    rng = np.random.default_rng(seed + 41)
    words = [w for _, src in docs[:200] for w in src["body"].split()]
    out = []
    for i in range(8):
        q = " ".join(rng.choice(words, size=int(rng.integers(2, 5))))
        out.append({"query": {"match": {"body": {"query": q, "operator": "and"} if i % 4 == 3 else q}}, "size": K})
    for v in rng.standard_normal((4, dims)).astype(np.float32):
        out.append({"knn": {"field": "vec", "query_vector": [float(x) for x in v], "k": K,
                            "num_candidates": 50}})
    sb = small_text_hybrid_bodies(docs, dims, seed)
    for r in ("bool", "multi_match", "filtered_bool"):
        out += sb[r]
    return out


def durable_node(seed: int, vocab: int, dims: int, device, root: str) -> dict:
    """Route (m) steps 3-4 through the real entry point: phase 4's /small
    docs by `_bulk` into `/small_durable` (2 shards, request durability),
    `_flush`, 200 more acknowledged and unflushed, SIGKILL, a new
    process; every acknowledged doc searchable, the replay built on the
    card, pages equal to a numpy index fed the same docs; then an fs
    snapshot, a delete, a restore and a restore under a rename, both
    serving the pages from before on the card, and a second snapshot
    that adds no blobs."""
    from elasticsearch_tpu_torch.cluster.indices import IndexService

    out = {}
    data = os.path.join(root, "node2")
    docs = small_docs(seed, vocab, dims)
    more = [(f"m{i}", src) for i, (_, src) in enumerate(small_docs(seed + 1, vocab, dims)[:DURABLE_MORE])]
    batches = (docs[:len(docs) // 2], docs[len(docs) // 2:], more)
    mapping = corpus_mapping(dims)
    node = SpawnedNode(data, os.path.join(root, "node2.log"))
    try:
        out["first_spawn_listening_s"] = time.perf_counter() - node.t0
        http = Http(node.port)
        http.ok("PUT", "/small_durable", {"settings": {"number_of_shards": 2, "search.backend": "torch",
                                                       "translog.durability": "request",
                                                       "refresh_interval": "-1"},
                                          "mappings": mapping})
        for bi, part in enumerate(batches):
            lines = []
            for doc_id, src in part:
                lines += [{"index": {"_id": doc_id}}, src]
            # the last batch is acknowledged but neither refreshed nor flushed
            res = http.ok("POST", "/small_durable/_bulk" + ("?refresh=true" if bi < 2 else ""), ndjson=lines)
            check(not res["errors"], "(m) /small_durable/_bulk reported errors")
            if bi == 1:
                http.ok("POST", "/small_durable/_flush")
    finally:
        node.kill()

    t = time.perf_counter()
    node = SpawnedNode(data, os.path.join(root, "node2-restart.log"))
    try:
        http = Http(node.port)
        out["restart_listening_s"] = time.perf_counter() - node.t0
        http.ok("POST", "/small_durable/_search", {"query": {"match_all": {}}, "size": 1})
        out["restart_to_first_search_s"] = time.perf_counter() - t
        n_acked = len(docs) + len(more)
        count = http.ok("POST", "/small_durable/_count", {"query": {"match_all": {}}})["count"]
        check(count == n_acked, f"(m) {count} docs after the restart, {n_acked} acknowledged")
        ids = [d for d, _ in more]
        res = http.ok("POST", "/small_durable/_search", {"query": {"ids": {"values": ids}}, "size": len(ids)})
        check(sorted(h["_id"] for h in res["hits"]["hits"]) == sorted(ids),
              "(m) an acknowledged, unflushed doc is missing after the restart")
        ingest = http.ok("GET", "/_nodes/stats")["nodes"]["node-0"]["ingest"]
        out["replay_builds"] = {k: ingest[k] for k in ("device_builds", "host_builds", "fallbacks", "degraded")}
        check(ingest["device_builds"] >= 2 and ingest["host_builds"] == 0 and ingest["fallbacks"] == 0,
              f"(m) the replay was not built on the card: {out['replay_builds']}")

        oracle = IndexService("small_durable_oracle", settings={"number_of_shards": 2, "search.backend": "numpy",
                                                                "refresh_interval": "-1"},
                              mappings_json=mapping, device=device)
        bodies = durable_small_bodies(docs, dims, seed)
        try:
            for part in batches:
                for doc_id, src in part:
                    oracle.index_doc(doc_id, src)
                oracle.refresh()
            before = []
            for i, body in enumerate(bodies):
                page = http.ok("POST", "/small_durable/_search", body)
                same_served(oracle.search(body), page, f"(m) /small_durable body {i} after the restart")
                before.append(page)
        finally:
            oracle.close()
        out["bodies_held"] = len(bodies)

        t = time.perf_counter()
        blobs = os.path.join(root, "repo", "blobs")
        http.ok("PUT", "/_snapshot/fs", {"type": "fs", "settings": {"location": os.path.join(root, "repo")}})
        snap = http.ok("PUT", "/_snapshot/fs/s1?wait_for_completion=true", {"indices": "small_durable"})
        check(snap["snapshot"]["state"] == "SUCCESS", f"(m) snapshot: {snap}")
        n_blobs = len(os.listdir(blobs))
        http.ok("DELETE", "/small_durable")
        http.ok("POST", "/_snapshot/fs/s1/_restore", {})
        http.ok("POST", "/_snapshot/fs/s1/_restore", {"indices": "small_durable", "rename_pattern": "small_",
                                                      "rename_replacement": "restored_"})
        launches = http.ok("GET", "/_nodes/stats")["nodes"]["node-0"]["thread_pool"]["search"]["launches"]
        for name in ("small_durable", "restored_durable"):
            for i, body in enumerate(bodies):
                same_served(before[i], http.ok("POST", f"/{name}/_search", body),
                            f"(m) restored /{name} body {i} against the page before the snapshot")
        launched = http.ok("GET", "/_nodes/stats")["nodes"]["node-0"]["thread_pool"]["search"]["launches"] - launches
        check(launched > 0, "(m) the restored indexes made no batched launch on the card")
        http.ok("PUT", "/_snapshot/fs/s2?wait_for_completion=true", {"indices": "small_durable"})
        added = len(os.listdir(blobs)) - n_blobs
        check(added == 0, f"(m) a second snapshot of unchanged segments added {added} blobs")
        out["snapshot"] = {"blobs": n_blobs, "second_snapshot_new_blobs": added, "restored_launches": launched,
                           "s": time.perf_counter() - t}
        log(f"(m) spawned node: {out}")
    finally:
        node.kill()
    return out


def durable_crash_matrix(device, root: str) -> dict:
    """Route (m) step 5: crashpoints' ENGINE_CRASH_SITES x {request,
    async} with engines on the card and device builds: each recovered
    engine meets the durability contract and its reader gives the numpy
    oracle's pages on the card's executor."""
    from elasticsearch_tpu_torch.index import segment_build
    from elasticsearch_tpu_torch.index.crashpoints import ENGINE_CRASH_SITES, run_engine_crash_case
    from elasticsearch_tpu_torch.search import dsl
    from elasticsearch_tpu_torch.search.executor import NumpyExecutor
    from elasticsearch_tpu_torch.search.executor_torch import TorchExecutor

    t = time.perf_counter()
    before = dict(segment_build.INGEST_STATS)
    cells = 0
    for label, rule in ENGINE_CRASH_SITES:
        for durability in ("request", "async"):
            path = os.path.join(root, "crash", f"{cells}")
            eng, _, report = run_engine_crash_case(path, rule, durability, sync_interval=3600.0, device=device)
            try:
                what = f"(m) crash cell {label} [{durability}]"
                check(report["crashed"], f"{what}: the crash never fired")
                if durability == "request":
                    check(report["lost_acks_beyond_bound"] == 0 and report["durable_bound"] == report["max_acked_seq"],
                          f"{what}: {report}")
                reader = eng.reader()
                tex = TorchExecutor(reader, device=device)
                nex = NumpyExecutor(reader)
                try:
                    for body in ({"match": {"body": "shared"}}, {"match": {"body": "alpha"}}):
                        q = dsl.parse_query(body)
                        same_hits(nex.search(q, size=50), tex.search(q, size=50), f"{what} {body}")
                finally:
                    tex.close()
            finally:
                eng.close()
            cells += 1
    after = segment_build.INGEST_STATS
    builds = {k: after[k] - before[k] for k in ("device_builds", "host_builds", "fallbacks", "degraded")}
    check(builds["device_builds"] > 0 and builds["host_builds"] == 0,
          f"(m) the crash matrix's builds did not all run on the card: {builds}")
    out = {"cells": cells, "builds": builds, "wall_s": time.perf_counter() - t}
    log(f"(m) crash matrix: {out}")
    return out


def cli_check() -> dict:
    """`python -m elasticsearch_tpu_torch check` exits 0 on the card."""
    repo = str(Path(__file__).resolve().parent)
    t = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "elasticsearch_tpu_torch", "check"], capture_output=True,
                          text=True, timeout=300, cwd=repo, env=repo_env(repo))
    check(proc.returncode == 0, f"(m) check exited {proc.returncode}: {proc.stdout} {proc.stderr}")
    out = json.loads(proc.stdout)
    check(out["checks_passed"] is True, f"(m) check: {out}")
    out["wall_s"] = time.perf_counter() - t
    return out


def route_durable(seg, dims: int, vocab: int, seed: int, device, http: Http, pages: dict) -> dict:
    """Route (m), a durable node on the card (steps in the docstring of
    each part): the 1M segment flushed and reopened in process, the real
    entry point killed and restarted, snapshots and restores on it, the
    crash matrix on the card and `check`. Its files live under a
    temporary directory that is removed at the end."""
    import tempfile

    root = tempfile.mkdtemp(prefix="es-torch-durable-")
    try:
        out = {}
        t = time.perf_counter()
        out["reopen"] = durable_reopen(seg, dims, device, http, pages, root)
        out["reopen"]["s"] = time.perf_counter() - t
        t = time.perf_counter()
        out["node"] = durable_node(seed, vocab, dims, device, root)
        out["node"]["s"] = time.perf_counter() - t
        out["crash_matrix"] = durable_crash_matrix(device, root)
        out["check"] = cli_check()
        return out
    finally:
        shutil.rmtree(root, ignore_errors=True)


# ---------------------------------------------------------------------------
# route (n): a multi-node cluster on the card
# ---------------------------------------------------------------------------

CLUSTER_NODES = 3
CLUSTER_SHARDS = 8  # BASELINE config 5's shard count
CLUSTER_MATCH = 32
CLUSTER_KNN = 32
CLUSTER_HYBRID = 8
CLUSTER_GETS = 16
CLUSTER_FD = {"fd_interval": 0.2, "fd_retries": 2}
CLUSTER_WAIT_S = 120.0


def _sub_postings(stream: np.ndarray, lengths: np.ndarray, vocab: int, positions: bool = False):
    """postings_from_stream over one shard's token stream, its term
    dictionary cut to the terms the shard holds (as a segment built from
    documents has no term of df 0)."""
    present = np.zeros(vocab, bool)
    present[stream] = True
    ids = np.flatnonzero(present)
    remap = np.full(vocab, -1, np.int64)
    remap[ids] = np.arange(len(ids))
    return postings_from_stream(remap[stream], len(ids), lengths, positions=positions,
                                names=[f"w{i:05d}" for i in ids])


def shard_segments(raw: dict, n_shards: int) -> tuple:
    """The corpus split by the router: doc `str(i)` belongs to
    utils/murmur3.shard_id(str(i), n_shards), and each shard's docs (in
    ascending order) make one segment with every column of the 1M-doc
    segment. Returns (segments, shard of each doc)."""
    from elasticsearch_tpu_torch.index.segment import NumericField, OrdinalField, Segment, VectorField
    from elasticsearch_tpu_torch.utils.murmur3 import shard_id

    n = len(raw["lengths"])
    owner = np.fromiter((shard_id(str(i), n_shards) for i in range(n)), np.int64, count=n)
    body_owner = np.repeat(owner, raw["lengths"])
    title_owner = np.repeat(owner, raw["title_lengths"])
    t_u, d_u, w_u = raw["ml"]
    ml_owner = owner[d_u]
    segs = []
    for s in range(n_shards):
        docs = np.flatnonzero(owner == s)
        m = len(docs)
        local = np.full(n, -1, np.int64)
        local[docs] = np.arange(m)
        keep = ml_owner == s
        exists = np.ones(m, bool)
        vecs = np.ascontiguousarray(raw["vecs"][docs])
        cat = raw["cat_ords"][docs]
        segs.append(Segment(
            num_docs=m,
            doc_ids=[str(int(g)) for g in docs],
            sources=[None] * m,
            postings={
                "body": _sub_postings(raw["stream"][body_owner == s], raw["lengths"][docs], raw["vocab"],
                                      positions=True),
                "title": _sub_postings(raw["title_stream"][title_owner == s], raw["title_lengths"][docs],
                                       raw["title_vocab"]),
            },
            numerics={
                "popularity": NumericField(values=raw["popularity"][docs], exists=exists.copy()),
                "day": NumericField(values=raw["day"][docs], exists=exists.copy()),
            },
            ordinals={"cat": OrdinalField(
                ord_terms=[f"cat{j:02d}" for j in range(16)], ords=cat, mv_ords=cat.copy(),
                mv_offsets=np.arange(m + 1, dtype=np.int32))},
            vectors={"vec": VectorField(vectors=vecs, exists=exists, similarity="cosine", unit_vectors=vecs)},
            sparse={"ml": sparse_column((t_u[keep], local[d_u[keep]], w_u[keep]), m)},
        ))
    return segs, owner


def install_shard(eng, seg) -> None:
    """install_segment, with the version map and doc locations filled as
    a reopened engine fills them, so a realtime GET by `_id` finds every
    doc."""
    from elasticsearch_tpu_torch.index.engine import _VersionEntry

    with eng._lock:
        eng._versions = {d: _VersionEntry(1, i, False) for i, d in enumerate(seg.doc_ids)}
        eng._locations = {d: (0, i) for i, d in enumerate(seg.doc_ids)}
        install_segment(eng, seg)


def start_cluster(n: int, device, root=None, **kw) -> list:
    """n in-process `TpuNode`s on `device` over localhost TCP; node-0
    (the lowest id) is the master. With `root`, each keeps its shards
    under root/node-i."""
    from elasticsearch_tpu_torch.cluster.node import TpuNode

    nodes = []
    try:
        for i in range(n):
            path = os.path.join(root, f"node-{i}") if root else None
            seeds = [nodes[0].address] if nodes else None
            nodes.append(TpuNode(f"node-{i}", seeds=seeds, data_path=path, device=device, **kw).start())
    except BaseException:
        close_cluster(nodes, [])
        raise
    return nodes


def stop_http(srv) -> None:
    """Stops a node-mode server's HTTP tier; the node closes its own
    cluster service."""
    srv.httpd.shutdown()
    srv.httpd.server_close()


def close_cluster(nodes: list, servers: list) -> None:
    for srv in servers:
        stop_http(srv)
    for node in nodes:
        node.close()


def node_servers(nodes: list) -> list:
    """One REST server in node mode per node (the HTTP tier fronting the
    node's DistributedClusterService, as `serve --node-name` runs it)."""
    from elasticsearch_tpu_torch.rest.server import ElasticsearchTpuServer

    out = []
    for node in nodes:
        srv = ElasticsearchTpuServer(port=0, cluster=node.cluster)
        srv.start_background()
        out.append(srv)
    return out


def wait_for(cond, what: str, timeout: float = CLUSTER_WAIT_S, interval: float = 0.1) -> float:
    t = time.perf_counter()
    while time.perf_counter() - t < timeout:
        if cond():
            return time.perf_counter() - t
        time.sleep(interval)
    raise SmokeFailure(f"timed out after {timeout}s waiting for {what}")


def shard_owner(node, index: str, sid: int) -> dict:
    from elasticsearch_tpu_torch.cluster.indices import norm_shard_routing

    return norm_shard_routing(node.state["indices"][index]["routing"][str(sid)])


def check_engines_on(nodes: list, index: str, device, what: str) -> int:
    """Every engine of `index` on every node serves on `device`; returns
    how many there are."""
    n = 0
    for node in nodes:
        idx = node.indices.get(index)
        if idx is None:
            continue
        check(idx.device.type == device.type, f"{what}: {node.name}'s /{index} is on {idx.device}")
        for sid, eng in idx.local_shards.items():
            check(eng.device.type == device.type, f"{what}: {node.name}'s [{index}][{sid}] engine is on {eng.device}")
            n += 1
    return n


class TransportMeter:
    """While on: every frame the port's transport writes (bytes on the
    wire, after DEFLATE) and every request a node sends over it, by
    action. In-process nodes share this process, so the counts are the
    whole cluster's; a coordinator's own shards run without a hop."""

    def __init__(self):
        self.frames = 0
        self.bytes = 0
        self.requests: dict = {}
        self._lock = threading.Lock()

    def __enter__(self):
        from elasticsearch_tpu_torch.transport import service

        frame, send = service._frame, service.TransportService.send
        meter = self

        def counted_frame(msg):
            out = frame(msg)
            with meter._lock:
                meter.frames += 1
                meter.bytes += len(out)
            return out

        def counted_send(transport, address, action, payload, timeout=30.0):
            with meter._lock:
                meter.requests[action] = meter.requests.get(action, 0) + 1
            return send(transport, address, action, payload, timeout)

        self._saved = (frame, send)
        service._frame = counted_frame
        service.TransportService.send = counted_send
        return self

    def __exit__(self, *exc):
        from elasticsearch_tpu_torch.transport import service

        service._frame, service.TransportService.send = self._saved
        return False

    def per_request(self, n: int) -> dict:
        return {"frames": self.frames / n, "bytes": self.bytes / n,
                "requests_by_action": {a: c / n for a, c in sorted(self.requests.items())}}


def cluster_full_width(segs: list, owner: np.ndarray, seg, dims: int, seed: int, device) -> dict:
    """Route (n1): three in-process nodes on the card over localhost
    TCP, REST in node mode in front of each; `/dist` (8 shards, 0
    replicas) spread over the three, each shard's segment of the 1M-doc
    corpus installed on its owning node; the same 8 segments in
    `/local8` (one node, torch) and `/local8_oracle` (numpy). 32 `match`,
    32 exact `knn` and 8 3-leg hybrids go to `/dist` through node-0;
    pages are held to `/local8` (ids position by position, scores within
    RTOL, tie runs as sets; hybrids by RRF over `/local8`'s legs) and
    `match`/`knn` to `/local8_oracle`; a GET by `_id` through each node
    finds its doc. Latency at 8 clients and 1, shard requests and bytes
    on the transport per request, the coordinator's wall against the
    card's busy time, peak device memory: printed, not checked."""
    import torch

    from elasticsearch_tpu_torch.rest.server import ElasticsearchTpuServer
    from elasticsearch_tpu_torch.search.admission import admission

    admission.configure(enabled=False)
    out = {"rows": {}}
    if device.type == "cuda":
        torch.cuda.synchronize(device)  # the context exists before the reset
        torch.cuda.reset_peak_memory_stats(device)
    mapping = corpus_mapping(dims)
    settings = {"number_of_shards": CLUSTER_SHARDS, "refresh_interval": "-1"}
    nodes, servers, procs, local = [], [], [], None
    t = time.perf_counter()
    try:
        nodes = start_cluster(CLUSTER_NODES, device)
        servers = node_servers(nodes)
        local = ElasticsearchTpuServer(port=0, device=device)
        local.start_background()
        http = [Http(srv.port) for srv in servers]
        h0, lh = http[0], Http(local.port)
        h0.ok("PUT", "/dist", {"settings": {**settings, "number_of_replicas": 0, "search.backend": "torch"},
                               "mappings": mapping})
        for name, backend in (("local8", "torch"), ("local8_oracle", "numpy")):
            lh.ok("PUT", f"/{name}", {"settings": {**settings, "search.backend": backend}, "mappings": mapping})
        by_name = {node.name: node for node in nodes}
        placement = {}
        for sid, sseg in enumerate(segs):
            primary = shard_owner(nodes[0], "dist", sid)["primary"]
            placement[sid] = primary
            install_shard(by_name[primary].indices["dist"].local_shards[sid], sseg)
            for name in ("local8", "local8_oracle"):
                install_shard(local.cluster.get_index(name).local_shards[sid], sseg)
        check(set(placement.values()) == set(by_name), f"(n1) /dist does not span the 3 nodes: {placement}")
        out["placement"] = {str(s): n for s, n in placement.items()}
        out["docs_per_shard"] = [sseg.num_docs for sseg in segs]
        out["setup_s"] = time.perf_counter() - t

        texts = match_texts(seg.postings["body"].term_df, CLUSTER_MATCH, seed + 101)
        rng = np.random.default_rng(seed + 103)
        match_bodies = [{"query": {"match": {"body": q}}, "size": K} for q in texts]
        knn_bodies = [{"knn": {"field": "vec", "query_vector": [float(x) for x in v], "k": K,
                               "num_candidates": 100}, "size": K}
                      for v in rng.standard_normal((CLUSTER_KNN, dims)).astype(np.float32)]
        hybrids = text_hybrid_bodies(seg.postings["body"].term_df, seg.postings["title"].term_df, dims,
                                     seed + 107)["hybrid_rrf"][:CLUSTER_HYBRID]

        # the first request of each family uploads its columns: set-up
        t = time.perf_counter()
        for h, path in ((h0, "/dist"), (lh, "/local8")):
            h.ok("POST", f"{path}/_search", match_bodies[0])
            h.ok("POST", f"{path}/_search", knn_bodies[0])
        out["first_requests_s"] = time.perf_counter() - t
        check_engines_on(nodes, "dist", device, "(n1)")

        procs = [ClientProcess(servers[0].port), ClientProcess(local.port)]
        served = {}
        for clients in (CLIENTS, 1):
            for route, bodies in (("match", match_bodies), ("knn", knn_bodies)):
                for path, proc in (("/dist", procs[0]), ("/local8", procs[1])):
                    with TransportMeter() as meter:
                        pages, row = drive_measured(proc, f"{path}/_search", bodies, clients)
                    if path == "/dist":
                        row["transport_per_request"] = meter.per_request(len(bodies))
                    served[(path, route, clients)] = pages
                    out["rows"][f"{path[1:]}_{route}_{clients}_clients"] = row
                    log(f"(n1) {path} {route} from {clients} clients: {row}")

        # ---- held to /local8 and to the numpy oracle ----
        t = time.perf_counter()
        for route, bodies in (("match", match_bodies), ("knn", knn_bodies)):
            for clients in (CLIENTS, 1):
                for i in range(len(bodies)):
                    same_served(served[("/local8", route, clients)][i], served[("/dist", route, clients)][i],
                                f"(n1) /dist {route} body {i} ({clients} clients) against /local8")
            for i in range(ORACLE_QUERIES):
                ref = lh.ok("POST", "/local8_oracle/_search", bodies[i])
                same_served(ref, served[("/dist", route, 1)][i], f"(n1) /dist {route} body {i} against the oracle")
        # a hybrid's legs as each index runs them: a distributed index
        # sends them through the shards' batchers (the sparse leg in
        # int8, as a bare sparse_vector body), while a one-node
        # multi-shard index pins its executors for the request and
        # scores the sparse leg on the unbatched path, the dense fp32
        # oracle (the reference's routing, ROADMAP queue 3), which a
        # bare body gets with "exact": true
        modes = []
        for i, body in enumerate(hybrids):
            legs, window = hybrid_legs(body)
            exact = [{**leg, "exact": True} if "sparse_vector" in leg.get("query", {}) else leg for leg in legs]
            for path, h, leg_bodies in (("/dist", h0, legs), ("/local8", lh, exact)):
                leg_pages = [lh.ok("POST", "/local8/_search", leg) for leg in leg_bodies]
                if path == "/dist":
                    for leg, ref in zip(leg_bodies, leg_pages):
                        same_served(ref, h0.ok("POST", "/dist/_search", leg), f"(n1) /dist hybrid {i} leg")
                modes.append(same_fused(leg_pages, h.ok("POST", f"{path}/_search", body), window,
                                        f"(n1) {path} hybrid {i}", by_global_doc=False))
        out["hybrid_check_modes"] = modes
        ids = [str(int(g)) for g in np.random.default_rng(seed + 109).choice(len(owner), CLUSTER_GETS, replace=False)]
        check(len({int(owner[int(d)]) for d in ids}) > 1, "(n1) the GET ids lie on one shard")
        for h, node in zip(http, nodes):
            for d in ids:
                got = h.ok("GET", f"/dist/_doc/{d}")
                check(got.get("found") is True and got["_id"] == d, f"(n1) GET /dist/_doc/{d} through {node.name}: {got}")
        out["gets"] = len(ids) * len(nodes)
        out["checks_s"] = time.perf_counter() - t

        if device.type == "cuda":
            def group(proc, path, bodies):
                return lambda: proc.drive(f"{path}/_search", bodies[:CLIENTS], 1)

            out["profile"] = profile_routes({
                "dist_match_1_client_8": group(procs[0], "/dist", match_bodies),
                "local8_match_1_client_8": group(procs[1], "/local8", match_bodies),
                "dist_knn_1_client_8": group(procs[0], "/dist", knn_bodies),
                "local8_knn_1_client_8": group(procs[1], "/local8", knn_bodies),
            }, device)
            out["peak_device_bytes"] = torch.cuda.max_memory_allocated(device)
        log(f"(n1) placement {out['placement']}, hybrids {modes}")
        # route (o): the forced mesh over /local8 before it closes
        t = time.perf_counter()
        out["o"] = route_mesh(local, lh, procs[1], match_bodies, knn_bodies, served, out["rows"], seg, dims,
                              seed, device)
        out["o"]["s"] = time.perf_counter() - t
        # route (p): the same forced mesh over a grid of several slots
        t = time.perf_counter()
        out["p"] = route_mesh_grid(local, lh, procs[1], match_bodies, knn_bodies, out["o"], device)
        out["p"]["s"] = time.perf_counter() - t
        for key in ("_fam", "_pages", "_fanout", "_oracle_aggs"):
            del out["o"][key]
        return out
    finally:
        for proc in procs:
            proc.close()
        close_cluster(nodes, servers)
        if local is not None:
            local.close()


MESH_AGG_BODIES = 8  # route (o)'s cold_agg bodies
MESH_SMALL_DOCS = 4000  # route (o2): docs of each 4-shard index


class MeshEnv:
    """ES_TPU_MESH set for one route and restored after it."""

    def __init__(self, mode: str):
        self.mode = mode

    def __enter__(self):
        self.old = os.environ.get("ES_TPU_MESH")
        os.environ["ES_TPU_MESH"] = self.mode
        return self

    def __exit__(self, *exc):
        if self.old is None:
            os.environ.pop("ES_TPU_MESH", None)
        else:
            os.environ["ES_TPU_MESH"] = self.old
        return False


def mesh_counts(mex) -> dict:
    return {k: mex.stats[k] for k in ("routed", "launches", "jobs", "fallbacks", "degraded")}


def route_mesh(local, lh: Http, proc: ClientProcess, match_bodies: list, knn_bodies: list, served: dict,
               n1_rows: dict, seg, dims: int, seed: int, device) -> dict:
    """Route (o), the forced serving mesh on one slot of the card over
    (n1)'s own `/local8` (8 shards of the 1M-doc corpus, 768-d vectors) and
    `/local8_oracle`: ES_TPU_MESH=force for this route only. (n1)'s 32
    `match` and 32 exact `knn` from 8 clients then 1, 32 `bool` and 32
    `multi_match` (text_hybrid_bodies), 32 int8 `sparse_vector` and 8
    `cold_agg` bodies with the request cache opted out. Checked: every
    request is mesh-routed (the `routed` delta is the requests sent), no
    fallback and no degrade, totals equal and pages equal `/local8`'s
    fan-out pages of the same run (ids position by position, tie runs
    as sets, scores within RTOL; where the fan-out's sparse family
    pruned and reports a lower bound, the mesh's exact total reaches
    it), 8 of each family held to the oracle
    (int8 sparse by recall@10 >= 0.95 as phase 4 does), aggregations
    equal the oracle's. Printed, not checked: latency and QPS beside
    (n1)'s `/local8` rows, the server's CPU per request, the card's busy
    time for a profiled 1-client group, launches and jobs per group, the
    snapshot's build wall and bytes, the route's peak device memory."""
    import torch

    idx = local.cluster.get_index("local8")
    mex = idx.mesh_executor()
    tb = text_hybrid_bodies(seg.postings["body"].term_df, seg.postings["title"].term_df, dims, seed + 107)
    sa = sparse_agg_bodies(seg.postings["body"].term_df, seed + 113)
    fam = {"bool": tb["bool"], "multi_match": tb["multi_match"],
           "sparse": sa["sparse_retrieval"], "cold_agg": sa["cold_agg"][:MESH_AGG_BODIES]}
    out = {"rows": {}}
    # the fan-out pages of the same run for the families (n1) did not drive
    t = time.perf_counter()
    fanout = {r: [lh.ok("POST", "/local8/_search", b) for b in bodies] for r, bodies in fam.items()}
    out["fanout_pages_s"] = time.perf_counter() - t
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
    # one slot on the index's card, however many cards the machine has
    with mesh_grid(mex, [device]), MeshEnv("force"):
        check(mex.available(), "(o) the forced mesh is not available on /local8")
        c0 = mesh_counts(mex)
        sent = 0
        # the snapshot and its stacked views are built before serving
        t = time.perf_counter()
        snap = mex.ensure_snapshot()
        out["snapshot_s"] = time.perf_counter() - t
        t = time.perf_counter()
        for f in ("body", "title"):
            mex._text_view(snap, f)
        mex._knn_view(snap, "vec")
        mex._sparse_view(snap, "ml", True)
        sync(device)
        out["views_s"] = time.perf_counter() - t
        out["stack_bytes"] = snap.nbytes
        out["entries"] = len(snap.entries)
        out["fold"] = snap.fold
        log(f"(o) snapshot of {len(snap.entries)} entries (fold {snap.fold}) in {out['snapshot_s']:.3f}s, "
            f"views in {out['views_s']:.2f}s, {snap.nbytes} bytes")
        # the first request of each family builds its steps: set-up
        t = time.perf_counter()
        for bodies in (match_bodies, knn_bodies, *fam.values()):
            lh.ok("POST", "/local8/_search", bodies[0])
            sent += 1
        out["first_requests_s"] = time.perf_counter() - t
        meshed = {}
        c1 = mesh_counts(mex)
        for clients in (CLIENTS, 1):
            for route, bodies in (("match", match_bodies), ("knn", knn_bodies)):
                pages, row = drive_measured(proc, "/local8/_search", bodies, clients)
                meshed[(route, clients)] = pages
                sent += len(bodies)
                # (n1)'s /local8 fan-out row of the same run, beside it
                row["fanout_local8"] = n1_rows.get(f"local8_{route}_{clients}_clients")
                out["rows"][f"mesh_{route}_{clients}_clients"] = row
                log(f"(o) mesh {route} from {clients} clients: {row}")
        c2 = mesh_counts(mex)
        out["per_group"] = {
            "launches": c2["launches"] - c1["launches"],
            "jobs": c2["jobs"] - c1["jobs"],
            "jobs_per_launch": (c2["jobs"] - c1["jobs"]) / max(1, c2["launches"] - c1["launches"]),
        }
        for route, bodies in fam.items():
            pages, row = drive_measured(proc, "/local8/_search", bodies, CLIENTS)
            meshed[(route, CLIENTS)] = pages
            sent += len(bodies)
            out["rows"][f"mesh_{route}_{CLIENTS}_clients"] = row
        if device.type == "cuda":
            out["profile"] = profile_routes({
                "o_mesh_match_1_client_8": lambda: proc.drive("/local8/_search", match_bodies[:CLIENTS], 1),
                "o_mesh_knn_1_client_8": lambda: proc.drive("/local8/_search", knn_bodies[:CLIENTS], 1),
            }, device)
            sent += 4 * CLIENTS  # two routes, each run twice (warm + traced)
            out["peak_device_bytes"] = torch.cuda.max_memory_allocated(device)
        c3 = mesh_counts(mex)
        out["counts"] = {k: c3[k] - c0[k] for k in c3}
        out["requests_sent"] = sent
        log(f"(o) counts {out['counts']} for {sent} requests")
        check(out["counts"]["routed"] == sent, f"(o) {out['counts']['routed']} of {sent} requests mesh-routed")
        check(out["counts"]["fallbacks"] == 0 and out["counts"]["degraded"] == 0,
              f"(o) the mesh fell back or degraded: {out['counts']}")
    # ---- held to the fan-out pages of the same run and to the oracle ----
    t = time.perf_counter()
    for (route, clients), pages in meshed.items():
        refs = served[("/local8", route, clients)] if route in ("match", "knn") else fanout[route]
        for i, got in enumerate(pages):
            if route == "cold_agg":
                check(got["aggregations"] == refs[i]["aggregations"], f"(o) cold_agg {i}: aggregations differ")
                check(got["hits"]["total"] == refs[i]["hits"]["total"], f"(o) cold_agg {i}: total differs")
            elif route == "sparse":
                # the fan-out's sparse family prunes impact tiles and
                # then reports a lower bound ("gte"); the mesh scores
                # every tile, so its exact total must reach that bound
                same_page(got, refs[i], f"(o) mesh sparse body {i} against /local8's pruned fan-out")
            else:
                same_served(refs[i], got, f"(o) mesh {route} body {i} ({clients} clients) against /local8")
    recalls = []
    oracle_aggs = []
    for route in ("match", "knn", *fam):
        for i in range(ORACLE_QUERIES):
            body = (match_bodies if route == "match" else knn_bodies if route == "knn" else fam[route])[i]
            got = meshed[(route, CLIENTS)][i]
            if route == "sparse":
                ref = lh.ok("POST", "/local8_oracle/_search", {**body, "size": K + 20})
                recalls.append(recall_at(ref, got))
                continue
            ref = lh.ok("POST", "/local8_oracle/_search", body)
            if route == "cold_agg":
                oracle_aggs.append(ref)
                check(got["aggregations"] == ref["aggregations"], f"(o) cold_agg {i}: differs from the oracle")
                check(got["hits"]["total"] == ref["hits"]["total"], f"(o) cold_agg {i}: oracle total differs")
            else:
                same_served(ref, got, f"(o) mesh {route} body {i} against the oracle")
    out["sparse_int8_recall_at_10"] = float(np.mean(recalls))
    check(np.mean(recalls) >= 0.95, f"(o) mesh sparse int8 recall@{K} {np.mean(recalls):.4f} < 0.95")
    out["checks_s"] = time.perf_counter() - t
    log(f"(o) held to /local8 and the oracle in {out['checks_s']:.1f}s")
    # for route (p), not printed: the families, route (o)'s pages, the
    # fan-out's pages of the same run and the oracle's cold_agg pages
    out["_fam"] = fam
    out["_pages"] = meshed
    out["_fanout"] = {
        (route, clients): served[("/local8", route, clients)] if route in ("match", "knn") else fanout[route]
        for route, clients in meshed
    }
    out["_oracle_aggs"] = oracle_aggs
    return out


def grid_cards(device) -> int:
    import torch

    return torch.cuda.device_count() if device.type == "cuda" else 1


def p_grid(device):
    """Route (p)'s slots: None (the executor's own list, every visible
    card) with 2+ cards, else 4 slots on the one card (fold 2 of 8)."""
    return None if grid_cards(device) >= 2 else [device] * 4


def p2_grid(device) -> list:
    """Route (p2)'s 4 slots of a 2 x 2 (data x shards) grid: the index's
    card first, then the other cards in turn, repeated to fill 4."""
    import torch

    n = min(grid_cards(device), 4)
    if n == 1:
        return [device] * 4
    cards = [device] + [torch.device("cuda", i) for i in range(grid_cards(device)) if i != device.index]
    return [cards[i % n] for i in range(4)]


@contextlib.contextmanager
def mesh_grid(mex, slots, n_data: int = 1):
    """The executor's mesh over `slots` (None: its own device list) with
    a data axis of `n_data`, for one route; the snapshot is dropped
    before and after, so the route's grid is built from nothing."""
    old_data = os.environ.get("ES_TPU_MESH_DATA")
    if slots is not None:
        mex._devices = lambda: list(slots)
    if n_data > 1:
        os.environ["ES_TPU_MESH_DATA"] = str(n_data)
    mex.close()
    try:
        yield
    finally:
        if slots is not None:
            del mex._devices
        if old_data is None:
            os.environ.pop("ES_TPU_MESH_DATA", None)
        else:
            os.environ["ES_TPU_MESH_DATA"] = old_data
        mex.close()


def grid_line(route: str, snap) -> dict:
    """The grid a route's snapshot spans, printed on a line of its own."""
    devs = [str(d) for d in snap.mesh.devices.ravel()]
    grid = {"shape": dict(snap.mesh.shape), "fold": snap.fold, "e_pad": snap.e_pad,
            "entries": len(snap.entries), "slots": len(devs), "distinct_devices": sorted(set(devs))}
    print(f"({route}) mesh grid {grid['shape']} (fold {snap.fold}, e_pad {snap.e_pad}): "
          f"{len(devs)} slots on {len(set(devs))} distinct device(s) {grid['distinct_devices']}", flush=True)
    return grid


def slot_bytes(snap) -> list:
    """Bytes each slot holds of the snapshot's stacked views."""
    from elasticsearch_tpu_torch.parallel.sharded import Stacked

    n_data, g = snap.mesh.devices.shape
    out = [0] * (n_data * g)
    stacks = [snap.live]
    for views in (snap.text, snap.knn, snap.aggs):
        for view in views.values():
            stacks.extend(v for v in view.values() if isinstance(v, Stacked))
    for st in stacks:
        for r in range(n_data):
            for c in range(g):
                p = st.at(r, c)
                out[r * g + c] += p.numel() * p.element_size()
    return out


def route_mesh_grid(local, lh: Http, proc: ClientProcess, match_bodies: list, knn_bodies: list, o: dict,
                    device) -> dict:
    """Route (p), the forced serving mesh over a grid of several slots on
    (n1)'s `/local8` (8 shards of the 1M-doc corpus, 768-d), right after
    route (o): every visible card when there are 2+ (`shards` = min(8,
    cards)), else 4 slots on the one card (fold 2). The same `match`,
    `knn` (8 clients, then 1), `bool`, `multi_match`, int8 `sparse` and
    `cold_agg` bodies as route (o). Checked: the grid's shape, every
    request mesh-routed with no fallback and no degrade, every page equal
    to route (o)'s one-slot mesh page and to `/local8`'s fan-out page of
    the same run under route (o)'s rules, the aggregations equal to the
    oracle's. Printed, not checked: latency and QPS beside route (o)'s,
    the card's busy time for a profiled 1-client group, stack bytes per
    slot and the build wall, the route's peak device memory, and the
    page bytes gathered from the other slots and copied between devices
    per request."""
    import torch

    from elasticsearch_tpu_torch.parallel import sharded

    mex = local.cluster.get_index("local8").mesh_executor()
    fam = o["_fam"]
    cards = grid_cards(device)
    want_shards = min(8, cards) if cards >= 2 else 4
    out = {"rows": {}, "cards": cards}
    with mesh_grid(mex, p_grid(device)), MeshEnv("force"):
        if device.type == "cuda":
            for i in range(cards):
                torch.cuda.synchronize(i)
                torch.cuda.reset_peak_memory_stats(i)
        check(mex.available(), "(p) the forced mesh is not available on /local8")
        c0 = mesh_counts(mex)
        g0 = sharded.gather_stats()
        sent = 0
        t = time.perf_counter()
        snap = mex.ensure_snapshot()
        out["snapshot_s"] = time.perf_counter() - t
        out["grid"] = grid_line("p", snap)
        check(out["grid"]["shape"] == {"data": 1, "shards": want_shards}
              and snap.fold == -(-len(snap.entries) // want_shards),
              f"(p) grid {out['grid']} on {cards} card(s)")
        t = time.perf_counter()
        for f in ("body", "title"):
            mex._text_view(snap, f)
        mex._knn_view(snap, "vec")
        mex._sparse_view(snap, "ml", True)
        sync(device)
        out["views_s"] = time.perf_counter() - t
        out["stack_bytes"] = snap.nbytes
        out["stack_bytes_per_slot"] = slot_bytes(snap)
        log(f"(p) views in {out['views_s']:.2f}s, {snap.nbytes} bytes, per slot {out['stack_bytes_per_slot']}")
        t = time.perf_counter()
        for bodies in (match_bodies, knn_bodies, *fam.values()):
            lh.ok("POST", "/local8/_search", bodies[0])
            sent += 1
        out["first_requests_s"] = time.perf_counter() - t
        meshed = {}
        for clients in (CLIENTS, 1):
            for route, bodies in (("match", match_bodies), ("knn", knn_bodies)):
                pages, row = drive_measured(proc, "/local8/_search", bodies, clients)
                meshed[(route, clients)] = pages
                sent += len(bodies)
                row["route_o"] = o["rows"].get(f"mesh_{route}_{clients}_clients")
                out["rows"][f"grid_{route}_{clients}_clients"] = row
                log(f"(p) grid {route} from {clients} clients: {row}")
        for route, bodies in fam.items():
            pages, row = drive_measured(proc, "/local8/_search", bodies, CLIENTS)
            meshed[(route, CLIENTS)] = pages
            sent += len(bodies)
            row["route_o"] = o["rows"].get(f"mesh_{route}_{CLIENTS}_clients")
            out["rows"][f"grid_{route}_{CLIENTS}_clients"] = row
        g1 = sharded.gather_stats()
        gathered = sent
        if device.type == "cuda":
            out["profile"] = profile_routes({
                "p_grid_match_1_client_8": lambda: proc.drive("/local8/_search", match_bodies[:CLIENTS], 1),
                "p_grid_knn_1_client_8": lambda: proc.drive("/local8/_search", knn_bodies[:CLIENTS], 1),
            }, device)
            sent += 4 * CLIENTS  # two routes, each run twice (warm + traced)
            out["peak_device_bytes"] = torch.cuda.max_memory_allocated(device)
            out["peak_device_bytes_by_card"] = [torch.cuda.max_memory_allocated(i) for i in range(cards)]
        c1 = mesh_counts(mex)
        out["counts"] = {k: c1[k] - c0[k] for k in c1}
        out["requests_sent"] = sent
        out["gather_per_request"] = {
            "pages": (g1["pages"] - g0["pages"]) / gathered,
            "slot_bytes": (g1["slot_bytes"] - g0["slot_bytes"]) / gathered,
            "peer_bytes": (g1["peer_bytes"] - g0["peer_bytes"]) / gathered,
        }
        log(f"(p) counts {out['counts']} for {sent} requests; gathered per request {out['gather_per_request']}")
        check(out["counts"]["routed"] == sent, f"(p) {out['counts']['routed']} of {sent} requests mesh-routed")
        check(out["counts"]["fallbacks"] == 0 and out["counts"]["degraded"] == 0,
              f"(p) the mesh fell back or degraded: {out['counts']}")
    # ---- held to route (o)'s pages, the fan-out's and the oracle's ----
    t = time.perf_counter()
    for key, pages in meshed.items():
        route, clients = key
        one_slot, fan = o["_pages"][key], o["_fanout"][key]
        for i, got in enumerate(pages):
            what = f"(p) grid {route} body {i} ({clients} clients)"
            if route == "cold_agg":
                for ref in (one_slot[i], fan[i]):
                    check(got["aggregations"] == ref["aggregations"], f"{what}: aggregations differ")
                    check(got["hits"]["total"] == ref["hits"]["total"], f"{what}: total differs")
                continue
            same_served(one_slot[i], got, f"{what} against route (o)")
            if route == "sparse":
                same_page(got, fan[i], f"{what} against /local8's pruned fan-out")
            else:
                same_served(fan[i], got, f"{what} against /local8")
    for i, ref in enumerate(o["_oracle_aggs"]):
        got = meshed[("cold_agg", CLIENTS)][i]
        check(got["aggregations"] == ref["aggregations"], f"(p) cold_agg {i}: differs from the oracle")
        check(got["hits"]["total"] == ref["hits"]["total"], f"(p) cold_agg {i}: oracle total differs")
    out["checks_s"] = time.perf_counter() - t
    log(f"(p) held to route (o), /local8 and the oracle in {out['checks_s']:.1f}s")
    return out


def route_mesh_small(seed: int, device) -> dict:
    """Route (o2), at small scale: a 4-shard torch index of
    MESH_SMALL_DOCS docs with a `rank_vectors` column and an IVF
    `dense_vector` (f32 rerank + f32 IVF, then int8 rerank + int8 IVF),
    one segment per shard (the mesh rescore's precondition). 8 `match`
    bodies with a rescore of window 20 and 8 IVF `knn` bodies go through
    the forced mesh on the card and are held to the same index with the
    mesh off (ids with tie runs as sets, scores within RTOL). Every
    request is mesh-routed, none falls back. Then route (p2): the same
    bodies on a 2 x 2 (data x shards) grid (`p2_grid`), held to the
    fan-out and to route (o2)'s pages by the same rule, under the same
    checks; its result is `out["p2"]`."""
    from elasticsearch_tpu_torch.cluster.indices import IndexService
    from elasticsearch_tpu_torch.search import ann as ann_mod

    rng = np.random.default_rng(seed + 127)
    words = ["ant", "bee", "cat", "dog", "eel", "fox"]
    centers = rng.normal(size=(24, 32))
    mapping = {"properties": {"body": {"type": "text"},
                              "vec": {"type": "dense_vector", "dims": 32, "similarity": "cosine"},
                              "toks": {"type": "rank_vectors", "dims": 16, "similarity": "dot_product"}}}
    docs = []
    for i in range(MESH_SMALL_DOCS):
        v = centers[i % 24] + 0.5 * rng.normal(size=32)
        docs.append((f"m{i}", {"body": " ".join(rng.choice(words, int(rng.integers(2, 8)))),
                               "vec": [float(x) for x in v / np.linalg.norm(v)],
                               "toks": rng.normal(size=(1 + i % 5, 16)).round(3).tolist()}))
    out = {}
    p2 = {}
    old_floor = os.environ.get(ann_mod.ANN_MIN_DOCS_ENV)
    os.environ[ann_mod.ANN_MIN_DOCS_ENV] = "64"
    try:
        for quant in ("none", "int8"):
            svc = IndexService(f"o2-{quant}", mappings_json=mapping, device=device, settings={
                "number_of_shards": 4, "refresh_interval": "-1", "knn.type": "ivf", "knn.nlist": 16,
                "knn.nprobe": 4, "knn.quantization": quant, "rerank.quantization": quant})
            try:
                for doc_id, src in docs:
                    svc.index_doc(doc_id, src)
                svc.refresh()
                bodies = []
                for i in range(8):
                    resc = {"window_size": 20, "query": {"rescore_query": {"rank_vectors": {
                        "field": "toks", "query_vectors": rng.normal(size=(3, 16)).round(3).tolist()}},
                        "query_weight": 0.5, "rescore_query_weight": 2.0}}
                    bodies.append({"query": {"match": {"body": words[i % 6]}}, "size": K, "rescore": resc})
                    q = docs[int(rng.integers(0, len(docs)))][1]["vec"]
                    bodies.append({"knn": {"field": "vec", "query_vector": q, "k": K, "num_candidates": 100},
                                   "size": K})
                mex = svc.mesh_executor()
                with MeshEnv("off"):
                    refs = [svc.search(json.loads(json.dumps(b))) for b in bodies]
                with mesh_grid(mex, [device]), MeshEnv("force"):
                    c0 = mesh_counts(mex)
                    t = time.perf_counter()
                    got = [svc.search(json.loads(json.dumps(b))) for b in bodies]
                    wall = time.perf_counter() - t
                    c1 = mesh_counts(mex)
                d = {k: c1[k] - c0[k] for k in c1}
                check(d["routed"] == len(bodies) and d["fallbacks"] == 0 and d["degraded"] == 0,
                      f"(o2) {quant}: {d} for {len(bodies)} bodies")
                for i, (ref, g) in enumerate(zip(refs, got)):
                    same_served(ref, g, f"(o2) {quant} body {i} ({'rescore' if i % 2 == 0 else 'ivf'})")
                out[quant] = {"counts": d, "bodies": len(bodies), "wall_s": wall}
                log(f"(o2) {quant}: {out[quant]}")
                # route (p2): the same index on a 2 x 2 (data x shards) grid
                with mesh_grid(mex, p2_grid(device), n_data=2), MeshEnv("force"):
                    t = time.perf_counter()
                    snap = mex.ensure_snapshot()
                    build_s = time.perf_counter() - t
                    grid = grid_line("p2", snap)
                    check(grid["shape"] == {"data": 2, "shards": 2} and snap.fold == 2,
                          f"(p2) {quant}: grid {grid}")
                    c0 = mesh_counts(mex)
                    t = time.perf_counter()
                    got2 = [svc.search(json.loads(json.dumps(b))) for b in bodies]
                    wall = time.perf_counter() - t
                    c1 = mesh_counts(mex)
                d = {k: c1[k] - c0[k] for k in c1}
                check(d["routed"] == len(bodies) and d["fallbacks"] == 0 and d["degraded"] == 0,
                      f"(p2) {quant}: {d} for {len(bodies)} bodies")
                for i, (ref, one, g) in enumerate(zip(refs, got, got2)):
                    what = f"(p2) {quant} body {i} ({'rescore' if i % 2 == 0 else 'ivf'})"
                    same_served(ref, g, f"{what} against the fan-out")
                    same_served(one, g, f"{what} against route (o2)")
                p2[quant] = {"counts": d, "bodies": len(bodies), "wall_s": wall, "snapshot_s": build_s,
                             "grid": grid}
                log(f"(p2) {quant}: {p2[quant]}")
            finally:
                svc.close()
    finally:
        if old_floor is None:
            os.environ.pop(ann_mod.ANN_MIN_DOCS_ENV, None)
        else:
            os.environ[ann_mod.ANN_MIN_DOCS_ENV] = old_floor
    out["p2"] = p2
    return out


def acked_ids(res: dict) -> list:
    return [item["index"]["_id"] for item in res["items"] if item["index"].get("status") in (200, 201)]


def check_copies_hold(nodes: list, index: str, acked: list, n_shards: int, what: str) -> int:
    """Every acknowledged doc is on every in-sync copy of its shard (each
    node's own engine, read in process). Returns the copies read."""
    from elasticsearch_tpu_torch.utils.murmur3 import shard_id

    want: dict = {}
    for d in acked:
        want.setdefault(shard_id(d, n_shards), []).append(d)
    copies = 0
    for node in nodes:
        idx = node.indices[index]
        for sid, eng in idx.local_shards.items():
            entry = idx._entry(sid)
            if node.name not in entry["in_sync"]:
                continue
            missing = [d for d in want.get(sid, []) if eng.get(d) is None]
            check(not missing, f"{what}: {node.name}'s copy of [{index}][{sid}] lacks {len(missing)} "
                  f"acknowledged docs, e.g. {missing[:3]}")
            copies += 1
    return copies


def cluster_replication(seed: int, vocab: int, dims: int, device, root: str) -> dict:
    """Route (n2) at phase 4's /small scale (a shard ships whole in one
    transport frame, whose limit is MAX_FRAME): three nodes with data
    paths; `/rep` (2 shards, 1 replica) created and fed by `_bulk`
    through node-1, searched from node-2 and held to a numpy index fed
    the same docs; every acknowledged doc on every in-sync copy; replica
    allocation held to primaries (ES's rolling-restart setting), then a
    node holding a primary crashes without a flush and its replica is
    promoted (pages unchanged, nothing lost); the node restarts, replica
    allocation is enabled again and its copies peer-recover onto it
    (files shipped, the ops refreshed by a build on the card); a
    `_cluster/reroute` move ends with the pages unchanged; a distributed
    fs snapshot, a delete and a restore serve the pages from before.
    Every build of the route on the card, every engine on the card."""
    from elasticsearch_tpu_torch.cluster.indices import IndexService
    from elasticsearch_tpu_torch.index import segment_build
    from elasticsearch_tpu_torch.index.translog import durability_stats_snapshot

    out = {}
    mapping = corpus_mapping(dims)
    docs = small_docs(seed, vocab, dims)
    bodies = durable_small_bodies(docs, dims, seed)
    # the oracle's refresh builds on the host, before the route's count
    oracle = IndexService("rep_oracle", settings={"number_of_shards": 2, "search.backend": "numpy",
                                                  "refresh_interval": "-1"},
                          mappings_json=mapping, device=device)
    nodes, servers = [], []
    t0 = time.perf_counter()
    try:
        for doc_id, src in docs:
            oracle.index_doc(doc_id, src)
        oracle.refresh()
        builds0 = dict(segment_build.INGEST_STATS)
        nodes = start_cluster(CLUSTER_NODES, device, root=os.path.join(root, "rep"), **CLUSTER_FD)
        servers = node_servers(nodes)
        http = [Http(srv.port) for srv in servers]
        h0, h1, h2 = http
        h1.ok("PUT", "/rep", {"settings": {"number_of_shards": 2, "number_of_replicas": 1, "search.backend": "torch",
                                           "refresh_interval": "-1"}, "mappings": mapping})
        wait_for(lambda: h0.ok("GET", "/_cluster/health")["status"] == "green", "(n2) /rep green")
        acked = []
        for part in (docs[:len(docs) // 2], docs[len(docs) // 2:]):
            lines = []
            for doc_id, src in part:
                lines += [{"index": {"_id": doc_id}}, src]
            res = h1.ok("POST", "/rep/_bulk?refresh=true", ndjson=lines)
            check(not res["errors"], "(n2) /rep/_bulk reported errors")
            acked += acked_ids(res)
        check(len(acked) == len(docs), f"(n2) {len(acked)} of {len(docs)} docs acknowledged")
        out["copies_read"] = check_copies_hold(nodes, "rep", acked, 2, "(n2) after _bulk")
        before = []
        for i, body in enumerate(bodies):
            page = h2.ok("POST", "/rep/_search", body)
            same_served(oracle.search(body), page, f"(n2) /rep body {i} from node-2")
            before.append(page)
        check_engines_on(nodes, "rep", device, "(n2)")
        out["setup_s"] = time.perf_counter() - t0

        # ---- a primary's node crashes; its replica is promoted ----
        t = time.perf_counter()
        h0.ok("PUT", "/_cluster/settings", {"transient": {"cluster.routing.allocation.enable": "primaries"}})
        primaries = {shard_owner(nodes[0], "rep", sid)["primary"] for sid in (0, 1)}
        victim_i = next(i for i in (2, 1) if f"node-{i}" in primaries)
        victim = nodes[victim_i]
        lost = [sid for sid in (0, 1) if shard_owner(nodes[0], "rep", sid)["primary"] == victim.name]
        stop_http(servers[victim_i])
        victim.crash()  # no flush, no close
        survivors = [n for n in nodes if n is not victim]
        wait_for(lambda: victim.name not in nodes[0].state["nodes"], "(n2) the crashed node to leave")
        wait_for(lambda: all(shard_owner(nodes[0], "rep", sid)["primary"] not in (None, victim.name)
                             for sid in (0, 1)), "(n2) the replica's promotion")
        out["promotion_s"] = time.perf_counter() - t
        hs = http[1 if victim_i == 2 else 2]
        hs.ok("POST", "/rep/_refresh")
        count = hs.ok("POST", "/rep/_count", {"query": {"match_all": {}}})["count"]
        check(count == len(acked), f"(n2) {count} docs after the promotion, {len(acked)} acknowledged")
        check_copies_hold(survivors, "rep", acked, 2, "(n2) after the promotion")
        for i, body in enumerate(bodies):
            same_served(before[i], hs.ok("POST", "/rep/_search", body), f"(n2) /rep body {i} after the promotion")
        out["victim"], out["promoted_shards"] = victim.name, lost
        check_engines_on(survivors, "rep", device, "(n2) after the promotion")

        # ---- the node restarts and peer-recovers its copies ----
        t = time.perf_counter()
        files0 = durability_stats_snapshot()["recovered_files"]
        from elasticsearch_tpu_torch.cluster.node import TpuNode

        victim = TpuNode(victim.name, seeds=[nodes[0].address], data_path=os.path.join(root, "rep", victim.name),
                         device=device, **CLUSTER_FD).start()
        nodes[victim_i] = victim
        servers[victim_i] = node_servers([victim])[0]
        http[victim_i] = Http(servers[victim_i].port)
        # the rolling restart's end: each replica the crash took goes
        # back onto the restarted node (an explicit operator command),
        # then replica allocation is enabled again
        commands = [{"allocate_replica": {"index": "rep", "shard": sid, "node": victim.name}}
                    for sid in (0, 1) if not shard_owner(nodes[0], "rep", sid)["replicas"]]
        check(commands, "(n2) no shard lost a replica in the crash")
        h0.ok("POST", "/_cluster/reroute", {"commands": commands})
        h0.ok("PUT", "/_cluster/settings", {"transient": {"cluster.routing.allocation.enable": "all"}})
        wait_for(lambda: h0.ok("GET", "/_cluster/health")["status"] == "green", "(n2) green after the restart")
        out["restart_to_green_s"] = time.perf_counter() - t
        out["recovered_files"] = durability_stats_snapshot()["recovered_files"] - files0
        check(out["recovered_files"] > 0, "(n2) the restarted node's peer recovery shipped no files")
        check(victim.indices["rep"].local_shards, "(n2) the restarted node holds no copy of /rep")
        check_copies_hold(nodes, "rep", acked, 2, "(n2) after the peer recovery")
        check_engines_on(nodes, "rep", device, "(n2) after the peer recovery")
        for i, body in enumerate(bodies):
            same_served(before[i], http[2].ok("POST", "/rep/_search", body),
                        f"(n2) /rep body {i} after the peer recovery")

        # ---- a reroute move ----
        t = time.perf_counter()
        entry = shard_owner(nodes[0], "rep", 0)
        src = entry["replicas"][0]
        dst = next(n.name for n in nodes if n.name not in [entry["primary"]] + entry["replicas"])
        h0.ok("POST", "/_cluster/reroute", {"commands": [{"move": {"index": "rep", "shard": 0, "from_node": src,
                                                                   "to_node": dst}}]})
        wait_for(lambda: not shard_owner(nodes[0], "rep", 0).get("relocating")
                 and h0.ok("GET", "/_cluster/health")["status"] == "green", "(n2) the relocation's end")
        moved = shard_owner(nodes[0], "rep", 0)
        check(dst in moved["replicas"] and src not in moved["replicas"], f"(n2) the move did not land: {moved}")
        rel = h0.ok("GET", "/_nodes/stats")["nodes"]["node-0"]["relocation"]
        check(rel["completed"] >= 1 and rel["failed"] == 0, f"(n2) relocation stats {rel}")
        out["move"] = {"from": src, "to": dst, "s": time.perf_counter() - t, "relocation": rel}
        for i, body in enumerate(bodies):
            same_served(before[i], http[2].ok("POST", "/rep/_search", body), f"(n2) /rep body {i} after the move")
        check_copies_hold(nodes, "rep", acked, 2, "(n2) after the move")
        # every build so far (the refreshes, the peer recoveries' and the
        # relocation's) ran on the index's device
        builds = {k: segment_build.INGEST_STATS[k] - builds0[k] for k in ("device_builds", "host_builds", "fallbacks")}
        out["builds"] = builds
        if device.type == "cuda":
            check(builds["device_builds"] > 0 and builds["host_builds"] == 0 and builds["fallbacks"] == 0,
                  f"(n2) a build of a refresh, replay or recovery ran on the host: {builds}")

        # ---- a distributed snapshot and a restore ----
        t = time.perf_counter()
        h0.ok("PUT", "/_snapshot/fs", {"type": "fs", "settings": {"location": os.path.join(root, "rep-repo")}})
        snap = h0.ok("PUT", "/_snapshot/fs/s1?wait_for_completion=true", {"indices": "rep"})
        check(snap["snapshot"]["state"] == "SUCCESS", f"(n2) snapshot: {snap}")
        h0.ok("DELETE", "/rep")
        h0.ok("POST", "/_snapshot/fs/s1/_restore", {})
        wait_for(lambda: h0.ok("GET", "/_cluster/health")["status"] == "green", "(n2) green after the restore")
        h0.ok("POST", "/rep/_refresh")
        for i, body in enumerate(bodies):
            same_served(before[i], http[2].ok("POST", "/rep/_search", body), f"(n2) restored /rep body {i}")
        out["snapshot_restore_s"] = time.perf_counter() - t
        check_engines_on(nodes, "rep", device, "(n2) after the restore")
        # the restore reads each shard's files through a scratch engine
        # on the host (cluster/service._docs_from_snapshot_files) and
        # replays the docs into the new index, whose builds are the card's
        out["restore_builds"] = {k: segment_build.INGEST_STATS[k] - builds0[k] - builds[k] for k in builds}
        out["bodies_held"] = len(bodies)
        log(f"(n2) {out}")
        return out
    finally:
        close_cluster(nodes, servers)
        oracle.close()


def free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def cat_shards(http: Http, index: str) -> list:
    status, rows = http.call("GET", "/_cat/shards?format=json")
    check(status == 200, f"_cat/shards: HTTP {status}")
    return [r for r in rows if r["index"] == index]


def cluster_processes(seed: int, vocab: int, dims: int, root: str) -> dict:
    """Route (n3), the real entry point: two `python -m
    elasticsearch_tpu_torch serve --node-name ... --seeds ...`
    processes sharing the card; phase 4's /small docs by `_bulk` into
    `/small_dist` (2 shards, 1 replica); the process holding a primary
    (the non-master) is SIGKILLed and the other answers every
    acknowledged doc; the killed node restarts on its data path and
    recovers as a replica."""
    out = {}
    mapping = corpus_mapping(dims)
    docs = small_docs(seed, vocab, dims)
    ports = [free_port(), free_port()]
    seeds = f"127.0.0.1:{ports[0]}"

    def spawn(i, tag):
        args = ["--node-name", f"node-{i}", "--transport-port", str(ports[i])]
        if i:
            args += ["--seeds", seeds]
        return SpawnedNode(os.path.join(root, f"proc-{i}"), os.path.join(root, f"proc-{i}-{tag}.log"), args,
                           what=f"(n3) node-{i}")

    procs = []
    try:
        t = time.perf_counter()
        procs.append(spawn(0, "first"))
        procs.append(spawn(1, "first"))
        out["spawn_to_listening_s"] = time.perf_counter() - t
        h0, h1 = Http(procs[0].port), Http(procs[1].port)
        wait_for(lambda: h0.ok("GET", "/_cluster/health")["number_of_nodes"] == 2, "(n3) node-1 to join")
        h1.ok("PUT", "/small_dist", {"settings": {"number_of_shards": 2, "number_of_replicas": 1,
                                                  "search.backend": "torch", "refresh_interval": "-1"},
                                     "mappings": mapping})
        wait_for(lambda: h0.ok("GET", "/_cluster/health")["status"] == "green", "(n3) green")
        acked = []
        for part in (docs[:len(docs) // 2], docs[len(docs) // 2:]):
            lines = []
            for doc_id, src in part:
                lines += [{"index": {"_id": doc_id}}, src]
            res = h0.ok("POST", "/small_dist/_bulk?refresh=true", ndjson=lines)
            check(not res["errors"], "(n3) /small_dist/_bulk reported errors")
            acked += acked_ids(res)
        check(len(acked) == len(docs), f"(n3) {len(acked)} of {len(docs)} docs acknowledged")
        rows = cat_shards(h0, "small_dist")
        check(any(r["prirep"] == "p" and r["node"] == "node-1" for r in rows),
              f"(n3) node-1 holds no primary: {rows}")
        out["shards_before"] = rows

        t = time.perf_counter()
        procs[1].kill()  # SIGKILL: no flush, no close
        wait_for(lambda: h0.ok("GET", "/_cluster/health")["number_of_nodes"] == 1, "(n3) node-1 to leave")
        out["kill_to_failover_s"] = time.perf_counter() - t
        h0.ok("POST", "/small_dist/_refresh")
        count = h0.ok("POST", "/small_dist/_count", {"query": {"match_all": {}}})["count"]
        check(count == len(acked), f"(n3) {count} docs after the kill, {len(acked)} acknowledged")
        res = h0.ok("POST", "/small_dist/_search", {"query": {"ids": {"values": acked}}, "size": len(acked),
                                                    "_source": False})
        check(sorted(h["_id"] for h in res["hits"]["hits"]) == sorted(acked),
              "(n3) an acknowledged doc is missing after the kill")

        t = time.perf_counter()
        procs[1] = spawn(1, "restart")
        wait_for(lambda: h0.ok("GET", "/_cluster/health")["status"] == "green", "(n3) green after the restart")
        out["restart_to_green_s"] = time.perf_counter() - t
        rows = cat_shards(h0, "small_dist")
        mine = [r for r in rows if r["node"] == "node-1"]
        check(mine and all(r["prirep"] == "r" and r["state"] == "STARTED" for r in mine),
              f"(n3) the restarted node is not an in-sync replica: {rows}")
        local = cat_shards(Http(procs[1].port), "small_dist")
        held = sum(int(r["docs"]) for r in local if r["node"] == "node-1" and r["docs"])
        check(held == len(acked), f"(n3) the restarted node's replicas hold {held} docs, {len(acked)} acknowledged")
        out["shards_after"] = rows
        log(f"(n3) {out}")
        return out
    finally:
        for proc in procs:
            proc.kill()


def route_cluster(raw: dict, seg, dims: int, vocab: int, seed: int, device) -> dict:
    """Route (n), a multi-node cluster on the card: (n1) at full width,
    (n2) replication at /small scale, (n3) the real entry point. Files
    of (n2) and (n3) live under a temporary directory removed at the
    end."""
    import tempfile

    out = {}
    t = time.perf_counter()
    segs, owner = shard_segments(raw, CLUSTER_SHARDS)
    out["split_s"] = time.perf_counter() - t
    log(f"(n) {CLUSTER_SHARDS} shard segments in {out['split_s']:.1f}s: {[s.num_docs for s in segs]}")
    t = time.perf_counter()
    # the fan-out wherever (n1) and route (o) read it: on 2+ cards
    # `auto` would take the mesh; routes (o) and (p) force it inside
    with MeshEnv("off"):
        out["n1"] = cluster_full_width(segs, owner, seg, dims, seed, device)
    out["n1"]["s"] = time.perf_counter() - t
    out["o"] = out["n1"].pop("o")
    out["p"] = out["n1"].pop("p")
    out["n1"]["s"] -= out["o"]["s"] + out["p"]["s"]
    t = time.perf_counter()
    out["o2"] = route_mesh_small(seed, device)
    out["o2"]["s"] = time.perf_counter() - t
    out["p2"] = out["o2"].pop("p2")
    del segs
    root = tempfile.mkdtemp(prefix="es-torch-cluster-")
    try:
        t = time.perf_counter()
        out["n2"] = cluster_replication(seed, vocab, dims, device, root)
        out["n2"]["s"] = time.perf_counter() - t
        t = time.perf_counter()
        out["n3"] = cluster_processes(seed, vocab, dims, root)
        out["n3"]["s"] = time.perf_counter() - t
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return out


REPLAY_WORKERS = 8  # pytest-xdist workers of route (q), where installed: one a core
REPLAY_TIMEOUT_S = 600


def route_replay(device) -> dict:
    """Route (q): the JAX package's own test suites replayed against the
    port on `device` by scripts/torch_reference_suites.py in a process of
    its own, with none of this process's `ES_TPU_*` settings. Every
    failure, a guard hit or a nonzero exit fails the smoke. Returns the
    runner's JSON line with the route's wall."""
    import importlib.util

    import torch

    root = Path(__file__).resolve().parent
    cmd = [sys.executable, str(root / "scripts" / "torch_reference_suites.py"), "--device", device.type]
    if importlib.util.find_spec("xdist") is not None:
        cmd += ["-n", str(REPLAY_WORKERS)]
    env = {k: v for k, v in os.environ.items() if not k.startswith("ES_TPU_")}
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t = time.perf_counter()
    proc = subprocess.run(cmd, cwd=root, env=env, capture_output=True, text=True, timeout=REPLAY_TIMEOUT_S)
    wall = time.perf_counter() - t
    lines = [ln for ln in proc.stdout.splitlines() if ln.startswith('{"replay"')]
    if proc.returncode != 0 or not lines:
        sys.stderr.write(proc.stdout[-20000:] + proc.stderr[-4000:])
    check(proc.returncode == 0 and bool(lines), f"(q) the replay exited {proc.returncode}")
    out = json.loads(lines[-1])
    check(out["failed"] == 0 and not out["guard"] and not out["stale_deselections"],
          f"(q) failed {out['failed']}, guard {out['guard']}, stale {out['stale_deselections']}")
    check(out["passed"] > 0 and out["replay"] == device.type, f"(q) {out['passed']} passed on {out['replay']}")
    out["wall_s"] = wall
    log(f"(q) replay on {device.type}: {out['suites']} suites, {out['passed']} passed of "
        f"{out['collected']}, deselected {out['deselected']}, {wall:.1f}s")
    return out


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
    reader, vecs, phrase_pairs, raw = build_corpus(seed, n_docs, vocab, dims)
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
    kernels.append(main.pop("ordered_scatter"))
    kernels.append(main.pop("bm25_tile_add"))
    for k in kernels:
        k["launches"] = main["launches"][k["name"]]
    del oracle, qv

    t = time.perf_counter()
    ann_reader, ann_q = build_ann_corpus(seed, n_docs, dims)
    phases["ann_corpus_s"] = time.perf_counter() - t
    t = time.perf_counter()
    ivf_h = route_ivf(ann_reader, ann_q, device)
    if device.type == "cuda":
        ivf_h["profile"] = profile_routes(ivf_h["fns"], device)
        for name in ("h_ivf_f16_group32", "h_ivf_int8_group32"):
            pageable = ivf_h["profile"][name]["pageable_htod"]
            check(pageable == 0, f"(h) {name} made {pageable} pageable host-to-device copies")
    ivf_h.pop("batcher").close()
    ivf_h.pop("executor").close()
    del ivf_h["fns"]
    main["ivf_h"] = ivf_h
    main["plain_ops"] += ivf_h["plain_ops"]
    phases["3h_ivf_s"] = time.perf_counter() - t

    t = time.perf_counter()
    cat = reader.segments[0].ordinals["cat"]
    parity = phase_build_parity(seed, dims, cat.mv_ords.astype(np.int64), len(cat.ord_terms), device)
    main["plain_ops"] += parity.pop("plain_ops")
    main["build_parity"] = parity
    phases["3l_build_parity_s"] = time.perf_counter() - t

    # the peak so far (phases 1-3), then phase 4's own from a reset
    peaks = {"phases_1_3": torch.cuda.max_memory_allocated(device) if device.type == "cuda" else None}
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    t = time.perf_counter()
    rc = build_rerank_corpus(seed, min(RR_DOCS, n_docs))
    phases["rerank_corpus_s"] = time.perf_counter() - t
    t = time.perf_counter()
    serve = phase_serve(reader, vecs.shape[1], seed, device, card, ann_reader, ann_q, ivf_h["build"]["digest"], rc,
                        phrase_pairs)
    phases["4_serve_s"] = time.perf_counter() - t
    durable = serve.pop("durable")
    next(k for k in kernels if k["name"] == "bm25_tile_add")["at_small_http"] = serve.pop("tile_add_small")
    phases["4m_durable_s"] = serve["times"]["durable_s"]
    peaks["phase_4"] = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else None
    t = time.perf_counter()
    ingest = route_ingest(seed, device)
    phases["4l_ingest_s"] = time.perf_counter() - t
    t = time.perf_counter()
    cluster = route_cluster(raw, reader.segments[0], dims, vocab, seed, device)
    phases["4n_cluster_s"] = time.perf_counter() - t
    peaks["route_n"] = cluster["n1"].get("peak_device_bytes")
    t = time.perf_counter()
    replay = route_replay(device)
    phases["4q_replay_s"] = time.perf_counter() - t
    peak = max(peaks.values()) if device.type == "cuda" else None
    log(f"peak device bytes {peaks}")
    return {
        "card": card,
        "build_s": build_s,
        "phases": phases,
        "main_path": main,
        "serve": serve,
        "ingest": ingest,
        "durable": durable,
        "cluster": cluster,
        "replay": replay,
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
    print(json.dumps({"card": card, "ingest": result["ingest"]}), flush=True)
    print(card, flush=True)
    print(json.dumps({"card": card, "durable": result["durable"]}), flush=True)
    print(card, flush=True)
    print(json.dumps({"card": card, "cluster": result["cluster"]}), flush=True)
    print(card, flush=True)
    print(json.dumps({"card": card, "serve": result["serve"]}), flush=True)
    print(card, flush=True)
    print(json.dumps({"card": card, "replay": result["replay"]}), flush=True)
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
