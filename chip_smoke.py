"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--seed 42] [--docs 1000000] [--vocab 50000] [--dims 768]

Drives the port's shard query phase (`elasticsearch_tpu_torch`) at the
scale of BASELINE configs 1 (BM25 `match`) and 4 (768-d cosine kNN): one
segment of 1,000,000 documents with a `body` text field over a
50,000-term Zipf vocabulary (15-34 tokens each) and a 768-d unit-vector
`vec` field, all made from `--seed`. Phases, each of which stops the run
with a non-zero exit on any failure:

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
     (d) QuantizedVectors.search over the same vectors, B=32, k=10;
     (a)-(c) are held to the port's NumPy oracle on 8 queries each
     (same totals and hits, scores within rtol 1e-5), (d) to recall@10
     >= 0.9 against exact f32 cosine; every kernel must have launched;
  4. a `kernels` JSON line and per-phase wall times.

The last line is {"ok": true, "device": {...}}. Without a CUDA device,
or without the rest of the repository beside it, the script exits
non-zero and prints no result.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

# published peaks of one H100 SXM (NVIDIA data sheet, dense, at 700 W)
PEAK_BYTES_PER_S = 3.35e12
PEAK_BF16_TENSOR_FLOPS = 989e12  # bf16 tensor cores, dense

MATCH_QUERIES = 64
BATCH = 32
KNN_QUERIES = 32
ORACLE_QUERIES = 8
K = 10
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
    from elasticsearch_tpu_torch.index.segment import Segment, VectorField
    from elasticsearch_tpu_torch.search.executor import ShardReader

    rng = np.random.default_rng(seed)
    lengths = rng.integers(15, 35, size=n_docs)
    body = build_postings(rng, vocab, lengths)
    vecs = rng.standard_normal((n_docs, dims), dtype=np.float32)
    vecs /= np.linalg.norm(vecs, axis=1, keepdims=True)
    seg = Segment(
        num_docs=n_docs,
        doc_ids=[str(i) for i in range(n_docs)],
        sources=[None] * n_docs,
        postings={"body": body},
        numerics={},
        ordinals={},
        vectors={
            "vec": VectorField(
                vectors=vecs, exists=np.ones(n_docs, bool), similarity="cosine",
                unit_vectors=vecs,
            )
        },
    )
    mappings = Mappings({
        "properties": {
            "body": {"type": "text"},
            "vec": {"type": "dense_vector", "dims": dims, "similarity": "cosine"},
        }
    })
    return ShardReader([seg], mappings, AnalysisRegistry()), vecs


def match_texts(term_df: np.ndarray, n: int, seed: int) -> list:
    """2-4 mid-frequency terms per query (bench.py's make_query_texts)."""
    rng = np.random.default_rng(seed + 7)
    cands = np.argsort(-term_df)[50:8000]
    out = []
    for _ in range(n):
        k = int(rng.integers(2, 5))
        picked = rng.choice(len(cands), size=k, replace=False)
        out.append(" ".join(f"w{cands[int(i)]:05d}" for i in picked))
    return out


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


def same_hits(ref, got, what: str) -> None:
    """Same totals, same hit count, scores within RTOL; docs equal except
    where scores tie within the tolerance."""
    check(ref.total == got.total, f"{what}: total {got.total} != oracle {ref.total}")
    check(len(ref.hits) == len(got.hits), f"{what}: {len(got.hits)} hits != oracle {len(ref.hits)}")
    rs = np.array([h.score for h in ref.hits])
    gs = np.array([h.score for h in got.hits])
    check(np.allclose(gs, rs, rtol=RTOL, atol=1e-6), f"{what}: scores {gs} != oracle {rs}")
    for hr, hg in zip(ref.hits, got.hits):
        check(
            hr.doc_id == hg.doc_id or np.isclose(hr.score, hg.score, rtol=RTOL),
            f"{what}: doc {hg.doc_id} != oracle {hr.doc_id} at unequal scores",
        )


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

    t = time.perf_counter()
    tex = TorchExecutor(reader, device=device)
    fs = tex.fused_scorer(0, "body")
    check(fs is not None, "fused scorer was not built for the segment")
    tex.search(dsl.parse_query({"match": {"body": texts[0]}}), size=K)
    tex.search(None, knn=[dsl.parse_knn({"field": "vec", "query_vector": knn_q[0].tolist(), "k": K})], size=K)
    sync(device)
    times["setup_uploads_s"] = time.perf_counter() - t
    log(f"executor set-up (uploads, dense rows: {fs.dense.shape[0] if fs.dense is not None else 0}) "
        f"{times['setup_uploads_s']:.2f}s")

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
        for (gs, gd), h in zip(got, ref.hits):
            check(np.isclose(gs, h.score, rtol=RTOL, atol=1e-6), f"(b) score {gs} != oracle {h.score}")
            check(gd == h.doc_id or np.isclose(gs, h.score, rtol=RTOL), f"(b) doc {gd} != oracle {h.doc_id}")
        ref = oracle.search(None, knn=[secs[i]], size=K)
        same_hits(ref, res_c[i], f"(c) knn query {i}")
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
    }, device) if device.type == "cuda" else {}
    return {"times": times, "launches": launches, "int8_recall_at_10": recall,
            "totals_a": [r.total for r in res_a[:ORACLE_QUERIES]], "profile": profile}


def _device_us(evt) -> float:
    for name in ("self_device_time_total", "self_cuda_time_total"):
        v = getattr(evt, name, None)
        if v is not None:
            return float(v)
    return 0.0


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
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t = time.perf_counter()
            fn()
            sync(device)
            wall_us = (time.perf_counter() - t) * 1e6
        # device activity only (kernels, copies, memsets): the aten ops
        # that launched them carry the same time again
        evts = [
            e for e in prof.key_averages()
            if e.device_type != DeviceType.CPU and _device_us(e) > 0
        ]
        busy = sum(_device_us(e) for e in evts)
        top = sorted(evts, key=_device_us, reverse=True)[:6]
        out[name] = {
            "wall_us": wall_us,
            "device_us": busy,
            "device_idle_share": max(0.0, 1.0 - busy / wall_us) if wall_us else None,
            "top_kernels_us": [[e.key[:80], _device_us(e), e.count] for e in top],
        }
        log(f"profile {name}: wall {wall_us:.0f}us device {busy:.0f}us")
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

    # full float32 products for the f32 paths (PyTorch's default, stated)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
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
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else None
    return {
        "card": card,
        "build_s": build_s,
        "phases": phases,
        "main_path": main,
        "peak_device_bytes": peak,
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
                      "main_path": result["main_path"], "peak_device_bytes": result["peak_device_bytes"]}))
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
