"""The port's serving path against the JAX package's, on the CPU.

The same documents (made with numpy from a seed) are indexed into the
JAX package's `IndexService` (`search.backend: jax`) and the port's
(`search.backend: torch`, `device="cpu"`), and the same requests go
through both: the block-max tiling and bounds (`ops/wand.py`), the
chunked scorer and the kNN merge (`ops/scoring.py`), `QueryBatcher` at
every bucket of the ladder and at pipeline depths 1 and 2, and
`IndexService.search`, for `match`, `knn`, `bool`, `multi_match`,
filtered `bool` (the cached-bitset route), `retriever.rrf` and
`rank: {rrf}`, and for the bodies that raised while their slice was cut
(phrase nodes, rescore). Hits must agree: the same totals and ids,
scores within rtol 1e-5 (float32 sums taken in another order; the
reference's own kNN scores move in the last ulp with the batch's row
count). The paths the port does not have yet must raise, naming their
slice.
"""

import copy
import dataclasses

import threading

import numpy as np
import pytest
import torch

from elasticsearch_tpu.cluster.indices import IndexService as JIndexService
from elasticsearch_tpu.ops import scoring as jscoring
from elasticsearch_tpu.ops import wand as jwand
from elasticsearch_tpu.search import dsl as jdsl
from elasticsearch_tpu.search import executor_jax
from elasticsearch_tpu.search.batcher import QueryBatcher as JBatcher
from elasticsearch_tpu.search.batcher import extract_knn_plan as j_knn_plan
from elasticsearch_tpu.search.batcher import extract_match_plan as j_match_plan
from elasticsearch_tpu.search.batcher import extract_serve_plan as j_serve_plan
from elasticsearch_tpu.search.batcher import split_filtered_bool as j_split

from elasticsearch_tpu_torch.cluster.indices import IndexService
from elasticsearch_tpu_torch.common.settings import batch_buckets
from elasticsearch_tpu_torch.ops import scoring, wand
from elasticsearch_tpu_torch.search import dsl, executor_torch
from elasticsearch_tpu_torch.search.batcher import (
    QueryBatcher,
    extract_knn_plan,
    extract_match_plan,
    extract_serve_plan,
    live_batchers,
    split_filtered_bool,
)
from elasticsearch_tpu_torch.search.executor_torch import TorchExecutor

torch.set_num_threads(1)

RTOL = 1e-5
WORDS = [
    "alpha", "bravo", "charlie", "delta", "echo", "foxtrot", "golf",
    "hotel", "india", "juliet", "kilo", "lima", "mike", "november",
]
DIMS = 8
MAPPING = {
    "properties": {
        "title": {"type": "text"},
        "body": {"type": "text"},
        "tag": {"type": "keyword"},
        "n": {"type": "integer"},
        "vec": {"type": "dense_vector", "dims": DIMS, "similarity": "cosine"},
    }
}


@pytest.fixture(autouse=True)
def _reset_port_singletons():
    """The port keeps its own process-wide admission controller and
    fault registry; tests/conftest.py resets only the JAX package's."""
    yield
    from elasticsearch_tpu_torch.common.faults import faults
    from elasticsearch_tpu_torch.search.admission import admission

    admission.reset()
    if faults.active:
        faults.clear()


@pytest.fixture(autouse=True, scope="module")
def _no_leaked_port_batcher_threads():
    """Every closed port QueryBatcher must have let its workers exit."""
    yield
    leaked = []
    for b in list(live_batchers):
        if not getattr(b, "_closed", False):
            continue
        for t in list(b._threads):
            t.join(timeout=10.0)
            if t.is_alive():
                leaked.append(t.name)
    assert not leaked, f"closed port QueryBatcher left live worker threads: {leaked}"


def _zipf(n):
    w = 1.0 / np.arange(1, n + 1)
    return w / w.sum()


def make_docs(n, seed):
    rng = np.random.default_rng(seed)
    docs = []
    for i in range(n):
        docs.append((
            f"d{i}",
            {
                "title": " ".join(rng.choice(WORDS, int(rng.integers(1, 4)), p=_zipf(len(WORDS)))),
                "body": " ".join(rng.choice(WORDS, int(rng.integers(3, 14)), p=_zipf(len(WORDS)))),
                "vec": [float(x) for x in rng.normal(size=DIMS)],
                # filter columns, drawn from the doc number (the random
                # stream of the text and vectors stays as it was)
                "tag": f"t{i % 4}",
                "n": (i * 37) % 100,
            },
        ))
    return docs


def build_pair(docs, shards=1, waves=3, deletes=(), name="sv"):
    """(JAX IndexService, port IndexService) over the same docs, indexed
    by index_doc and refreshed in `waves` (one segment per wave per
    shard), then the `deletes` removed and refreshed."""
    pair = (
        JIndexService(name, settings={"number_of_shards": shards, "search.backend": "jax"},
                      mappings_json=MAPPING),
        IndexService(name, settings={"number_of_shards": shards, "search.backend": "torch"},
                     mappings_json=MAPPING, device="cpu"),
    )
    per_wave = max(1, len(docs) // waves)
    for svc in pair:
        for i, (doc_id, src) in enumerate(docs):
            svc.index_doc(doc_id, src)
            if (i + 1) % per_wave == 0:
                svc.refresh()
        svc.refresh()
        for doc_id in deletes:
            svc.delete_doc(doc_id)
        svc.refresh()
    return pair


def close_pair(pair):
    for svc in pair:
        svc.close()


def same_ids(ref_ids, ref_scores, got_ids, what=""):
    """Ids agree position by position. Within a run of reference scores
    that tie within RTOL the run's ids must agree as a set: both sides
    order exact ties lowest index first, and only ulp-level differences
    in the sums may reorder a run."""
    ref_ids, got_ids = list(ref_ids), list(got_ids)
    assert len(got_ids) == len(ref_ids), (what, ref_ids, got_ids)
    i = 0
    while i < len(ref_ids):
        j = i + 1
        while j < len(ref_ids) and np.isclose(ref_scores[j], ref_scores[j - 1], rtol=RTOL, atol=0):
            j += 1
        assert set(got_ids[i:j]) == set(ref_ids[i:j]), (what, i, ref_ids, got_ids)
        i = j


def same_td(ref, got, what=""):
    """TopDocs agree: total, relation, ids, scores within RTOL."""
    assert got.total == ref.total, what
    assert got.relation == ref.relation, what
    assert len(got.hits) == len(ref.hits), what
    rs = np.array([h.score for h in ref.hits])
    gs = np.array([h.score for h in got.hits])
    np.testing.assert_allclose(gs, rs, rtol=RTOL, atol=1e-6, err_msg=what)
    same_ids([h.doc_id for h in ref.hits], rs, [h.doc_id for h in got.hits], what)


def same_response(ref, got, what=""):
    """Search responses agree: total, ids, scores within RTOL."""
    assert got["hits"]["total"] == ref["hits"]["total"], what
    rh, gh = ref["hits"]["hits"], got["hits"]["hits"]
    rs = np.array([h["_score"] for h in rh])
    assert len(gh) == len(rh), what
    np.testing.assert_allclose([h["_score"] for h in gh], rs, rtol=RTOL, atol=1e-6, err_msg=what)
    same_ids([h["_id"] for h in rh], rs, [h["_id"] for h in gh], what)


def match_body(i, msm=None):
    w = [WORDS[(i * 3 + j) % len(WORDS)] for j in range(3)]
    if msm is None:
        return {"match": {"body": " ".join(w[:2])}}
    return {"match": {"body": {"query": " ".join(w), "minimum_should_match": msm}}}


def knn_body(i, nc=30, k=6):
    rng = np.random.default_rng(100 + i)
    return {"field": "vec", "query_vector": [float(x) for x in rng.normal(size=DIMS)],
            "k": k, "num_candidates": nc}


def bool_body(i):
    """A bool over body and title (the ServePlan's fields in that
    order, combine "sum"): must term + should matches, or should-only
    with minimum_should_match 2."""
    w = [WORDS[(i * 5 + j) % len(WORDS)] for j in range(4)]
    if i % 2 == 0:
        return {"bool": {"must": [{"term": {"body": w[0]}}],
                         "should": [{"match": {"body": f"{w[1]} {w[2]}"}}, {"match": {"title": w[3]}}]}}
    return {"bool": {"should": [{"match": {"body": w[0]}}, {"match": {"title": w[1]}},
                                {"match": {"body": w[2]}}], "minimum_should_match": 2}}


def mm_body(i, **extra):
    """multi_match over title^2 and body, best_fields with tie 0.3."""
    w = [WORDS[(i * 3 + j) % len(WORDS)] for j in range(3)]
    return {"multi_match": {"query": " ".join(w[: 2 + i % 2]), "fields": ["title^2", "body"],
                            "tie_breaker": 0.3, **extra}}


# ---------------------------------------------------------------------
# ops/wand.py: block-aligned tiling and bounds
# ---------------------------------------------------------------------


@pytest.fixture(scope="module")
def segment_pair():
    """One (JAX segment, port segment) pair built by the two packages'
    own write paths from the same docs, with 30 deletes."""
    docs = make_docs(400, seed=5)
    pair = build_pair(docs, waves=1, deletes=[f"d{i}" for i in range(0, 300, 10)], name="seg")
    jr = pair[0].shards[0].reader()
    tr = pair[1].shards[0].reader()
    yield jr, tr
    close_pair(pair)


@pytest.mark.parametrize("block_size,hot_min", [(4096, 32), (64, 4), (16, 2)])
def test_block_max_index_matches_reference(segment_pair, block_size, hot_min):
    jr, tr = segment_pair
    jpf, tpf = jr.segments[0].postings["body"], tr.segments[0].postings["body"]
    n = jr.segments[0].num_docs
    jt = jwand.get_tiling(jpf, n, block_size, hot_min)
    tt = wand.get_tiling(tpf, n, block_size, hot_min, device="cpu")
    np.testing.assert_array_equal(np.asarray(jt.doc_ids), tt.doc_ids.numpy())
    np.testing.assert_array_equal(np.asarray(jt.tfs), tt.tfs.numpy())
    for f in ("tile_term", "tile_block", "tile_max_tf", "tile_min_norm",
              "term_tile_start", "term_tile_count", "term_hot"):
        np.testing.assert_array_equal(getattr(jt, f), getattr(tt, f), err_msg=f)
    assert tt.n_blocks == jt.n_blocks
    jx = executor_jax.JaxExecutor(jr)
    tx = TorchExecutor(tr, device="cpu")
    weights = jx._segment_weights(0, "body")
    np.testing.assert_array_equal(weights, tx._segment_weights(0, "body"))
    cache = jx._oracle._field_cache("body")
    jb = jwand.BlockMaxIndex(jt, weights, cache)
    tb = wand.BlockMaxIndex(tt, weights, cache)
    np.testing.assert_array_equal(jb.tile_bounds, tb.tile_bounds)
    np.testing.assert_array_equal(jb.term_block_bounds, tb.term_block_bounds)
    rng = np.random.default_rng(block_size)
    for boost in (1.0, 2.5):
        jp, tp = jb.plan(WORDS + ["zulu"], boost), tb.plan(WORDS + ["zulu"], boost)
        assert [vars(p) for p in jp] == [vars(p) for p in tp]
        for p in tp:
            if not p.hot:
                continue
            np.testing.assert_array_equal(jb.block_bounds(p), tb.block_bounds(p))
            potential = rng.uniform(0, 3, jt.n_blocks).astype(np.float32)
            theta = float(rng.uniform(0.5, 2.5))
            live = rng.random(jt.n_blocks) < 0.7
            np.testing.assert_array_equal(
                jb.surviving_tiles(p, potential, theta),
                tb.surviving_tiles(p, potential, theta),
            )
            np.testing.assert_array_equal(
                jb.surviving_tiles(p, potential, theta, block_live=live),
                tb.surviving_tiles(p, potential, theta, block_live=live),
            )


def test_tiling_cache_is_the_ports_own(segment_pair):
    """A field tiled by both packages keeps a jax tiling and a torch
    tiling side by side: neither hands the other its arrays."""
    jr, tr = segment_pair
    pf = jr.segments[0].postings["body"]
    n = jr.segments[0].num_docs
    jt = jwand.get_tiling(pf, n)
    tt = wand.get_tiling(pf, n, device="cpu")
    assert isinstance(tt.doc_ids, torch.Tensor)
    assert not isinstance(jt.doc_ids, torch.Tensor)
    assert jwand.get_tiling(pf, n) is jt
    assert wand.get_tiling(pf, n, device="cpu") is tt


# ---------------------------------------------------------------------
# ops/scoring.py: chunked scorer and the kNN merge
# ---------------------------------------------------------------------


@pytest.mark.parametrize("with_cnt", [False, True])
def test_chunked_scorer_matches_reference(segment_pair, with_cnt):
    jr, tr = segment_pair
    n = jr.segments[0].num_docs
    jt = jwand.get_tiling(jr.segments[0].postings["body"], n, 64, 4)
    tt = wand.get_tiling(tr.segments[0].postings["body"], n, 64, 4, device="cpu")
    inv = executor_jax.JaxExecutor(jr)._inv_norm(0, "body", n)
    live = jr.live_docs[0]
    assert live is not None and not live.all()
    js = jscoring.ChunkedScorer(jt.doc_ids, jt.tfs, inv, live, block_size=64)
    ts = scoring.ChunkedScorer(
        tt.doc_ids, tt.tfs, torch.from_numpy(np.array(inv)), torch.from_numpy(live),
        block_size=64,
    )
    rows = 4
    rng = np.random.default_rng(1)
    # rows of different lengths, one longer than a TCHUNK launch
    lengths = [3, 0, scoring.TCHUNK + 40, 17]
    n_tiles = tt.doc_ids.shape[0]
    tiles = [rng.integers(0, n_tiles, size=m).astype(np.int64) for m in lengths]
    weights = [rng.uniform(0.2, 2.0, size=m).astype(np.float32) for m in lengths]
    ja, jc = js.new_acc(with_cnt, rows=rows)
    ta, tc = ts.new_acc(with_cnt, rows=rows)
    ja, jc = js.score_into(ja, jc, tiles, weights)
    ta, tc = ts.score_into(ta, tc, tiles, weights)
    np.testing.assert_allclose(ta.numpy(), np.asarray(ja), rtol=RTOL, atol=1e-6)
    if with_cnt:
        np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    jth, jmax = js.threshold(ja, 16)
    tth, tmax = ts.threshold(ta, 16)
    np.testing.assert_allclose(tth, jth, rtol=RTOL)
    np.testing.assert_allclose(tmax, jmax, rtol=RTOL, atol=1e-6)
    msm = np.array([1, 1, 2, 3], np.int32)
    js_, jd, jtot = js.finalize(ja, jc, msm, 16)
    ts_, td, ttot = ts.finalize(ta, tc, msm, 16)
    np.testing.assert_array_equal(ttot, jtot)
    np.testing.assert_allclose(ts_, js_, rtol=RTOL, atol=1e-6)
    for r in range(rows):
        fin = np.isfinite(js_[r])
        np.testing.assert_array_equal(np.isfinite(ts_[r]), fin)
        same_ids(jd[r][fin], js_[r][fin], td[r][fin], f"row {r}")


def test_knn_merge_matches_reference_with_ties_and_cut():
    rng = np.random.default_rng(4)
    rows, k = 5, 7
    items_j, items_t = [], []
    for si, width in ((0, 16), (2, 16), (3, 32)):
        # few distinct values → many ties across and within segments
        s = np.sort(rng.choice([0.9, 0.7, 0.7, 0.5, 0.3], size=(rows, width)), axis=1)[:, ::-1]
        s = np.ascontiguousarray(s, dtype=np.float32)
        s[:, width - 3:] = -np.inf  # segments with fewer real candidates
        d = np.tile(np.arange(width, dtype=np.int32), (rows, 1))
        items_j.append((si, jscoring.jnp.asarray(s), jscoring.jnp.asarray(d)))
        items_t.append((si, torch.from_numpy(s), torch.from_numpy(d)))
    nc = rng.integers(0, 20, size=(rows, 3)).astype(np.int32)
    nc[0] = 100  # no cut
    nc[1, 1] = 0  # one segment cut out entirely
    ref = jscoring.knn_merge_segment_topk(items_j, nc, k)
    got = scoring.knn_merge_segment_topk(items_t, nc, k)
    for r, g in zip(ref, got):
        np.testing.assert_array_equal(g, r)


# ---------------------------------------------------------------------
# QueryBatcher: every bucket, both pipeline depths
# ---------------------------------------------------------------------


@pytest.fixture(scope="module")
def serving_pair():
    docs = make_docs(360, seed=2)
    pair = build_pair(docs, shards=1, waves=3, deletes=["d5", "d77", "d200"], name="bt")
    yield pair
    close_pair(pair)


def _plans(jsvc, tsvc, kind, n, tth=10_000):
    out = []
    for i in range(n):
        if kind in ("serve_bool", "serve_mm"):
            body = bool_body(i) if kind == "serve_bool" else mm_body(i)
            jq, tq = jdsl.parse_query(body), dsl.parse_query(body)
            jp = j_serve_plan(jq, jsvc.mappings, jsvc.analysis)
            tp = extract_serve_plan(tq, tsvc.mappings, tsvc.analysis)
            assert jp is not None and dataclasses.asdict(tp) == dataclasses.asdict(jp)
            out.append(((jp, jq), (tp, tq)))
        elif kind == "match":
            body = match_body(i, msm=2 if i % 3 == 2 and tth == 10_000 else None)
            jq, tq = jdsl.parse_query(body), dsl.parse_query(body)
            jp = j_match_plan(jq, jsvc.mappings, jsvc.analysis, tth)
            tp = extract_match_plan(tq, tsvc.mappings, tsvc.analysis, tth)
            assert vars(tp) == vars(jp)
            out.append(((jp, jq), (tp, tq)))
        else:
            body = knn_body(i)
            jp = j_knn_plan([jdsl.parse_knn(body)], jsvc.mappings)
            tp = extract_knn_plan([dsl.parse_knn(body)], tsvc.mappings)
            out.append(((jp, None), (tp, None)))
    return out


def _run_group(b, ex, plans, kind, rows):
    """One group of len(plans) jobs at launch width `rows` through the
    batcher's real group path (no worker threads)."""
    k = 6 if kind == "knn" else 10
    job_kind = "serve" if kind.startswith("serve") else kind
    jobs = [b.submit_nowait(ex, p, k, kind=job_kind, query=q) for p, q in plans]
    if kind == "match":
        b._run_group(jobs, plans[0][0].field, 16, rows=rows)
    elif job_kind == "serve":
        b._collect_serve_group(jobs, 16, b._dispatch_serve_group(jobs, 16, rows=rows))
    else:
        b._collect_knn_group(jobs, b._dispatch_knn_group(jobs, rows=rows))
    return [b.wait(j, timeout=30) for j in jobs]


def _workerless(cls, monkeypatch):
    b = cls(workers=1)
    monkeypatch.setattr(b, "_ensure_thread", lambda: None)
    return b


@pytest.mark.parametrize("kind", ["match", "knn", "serve_bool", "serve_mm"])
@pytest.mark.parametrize("rows", batch_buckets(scoring.BPAD))
def test_batcher_bucket_matches_reference(serving_pair, monkeypatch, kind, rows):
    jsvc, tsvc = serving_pair
    jex, tex = jsvc._executor(jsvc.shards[0]), tsvc._executor(tsvc.shards[0])
    assert isinstance(tex, TorchExecutor)
    jb, tb = _workerless(JBatcher, monkeypatch), _workerless(QueryBatcher, monkeypatch)
    try:
        for n in sorted({rows, rows // 2 + 1}):  # full and partial occupancy
            plans = _plans(jsvc, tsvc, kind, n)
            ref = _run_group(jb, jex, [p[0] for p in plans], kind, rows)
            got = _run_group(tb, tex, [p[1] for p in plans], kind, rows)
            for i, (r, g) in enumerate(zip(ref, got)):
                same_td(r, g, f"{kind} rows={rows} job {i}")
    finally:
        jb.close()
        tb.close()
    if kind == "match":
        assert tb.stats["chunked_jobs"] > 0
    if kind.startswith("serve"):
        # small segments: every (job, segment) takes segment_topk
        assert tb.stats["launches"] > 0 and tb.stats["fused_jobs"] == 0


@pytest.mark.parametrize("kind", ["serve_bool", "serve_mm"])
@pytest.mark.parametrize("rows", batch_buckets(scoring.BPAD))
def test_batcher_serve_fused_bucket_matches_reference(serving_pair, monkeypatch, kind, rows):
    """The serve family on the multi-field fused route (the fused size
    lowered so every segment takes it), deletes in the live operand."""
    jsvc, tsvc = serving_pair
    monkeypatch.setattr(executor_jax, "FUSED_MIN_DOCS", 10)
    jex = executor_jax.JaxExecutor(jsvc.shards[0].reader())
    tex = TorchExecutor(tsvc.shards[0].reader(), device="cpu", fused_min_docs=10)
    jb, tb = _workerless(JBatcher, monkeypatch), _workerless(QueryBatcher, monkeypatch)
    try:
        for n in sorted({rows, rows // 2 + 1}):
            plans = _plans(jsvc, tsvc, kind, n)
            ref = _run_group(jb, jex, [p[0] for p in plans], kind, rows)
            got = _run_group(tb, tex, [p[1] for p in plans], kind, rows)
            for i, (r, g) in enumerate(zip(ref, got)):
                same_td(r, g, f"{kind} fused rows={rows} job {i}")
    finally:
        jb.close()
        tb.close()
    assert tb.stats["fused_jobs"] > 0 and tb.stats["fused_jobs"] == jb.stats["fused_jobs"]


@pytest.mark.parametrize("rows", [1, 8])
def test_batcher_block_max_round_matches_reference(serving_pair, monkeypatch, rows):
    """With totals capped below the shard's doc freqs, hot terms defer
    to the threshold round (θ, block bounds, surviving tiles): hits and
    totals (relation included) still match the reference."""
    jsvc, tsvc = serving_pair
    jex, tex = jsvc._executor(jsvc.shards[0]), tsvc._executor(tsvc.shards[0])
    jb, tb = _workerless(JBatcher, monkeypatch), _workerless(QueryBatcher, monkeypatch)
    try:
        plans = _plans(jsvc, tsvc, "match", rows, tth=5)
        assert all(p[1][0].wand_ok for p in plans)
        ref = _run_group(jb, jex, [p[0] for p in plans], "match", rows)
        got = _run_group(tb, tex, [p[1] for p in plans], "match", rows)
        for i, (r, g) in enumerate(zip(ref, got)):
            same_td(r, g, f"pruned rows={rows} job {i}")
        assert tb.stats["pruned_jobs"] == jb.stats["pruned_jobs"]
    finally:
        jb.close()
        tb.close()


@pytest.mark.parametrize("depth", [1, 2])
def test_batcher_pipeline_depth_matches_reference(serving_pair, depth):
    """Concurrent mixed match + knn load through real workers at each
    pipeline depth gives the reference's hits."""
    jsvc, tsvc = serving_pair
    jex, tex = jsvc._executor(jsvc.shards[0]), tsvc._executor(tsvc.shards[0])
    plans = [("match", p) for p in _plans(jsvc, tsvc, "match", 24)]
    plans += [("knn", p) for p in _plans(jsvc, tsvc, "knn", 12)]
    plans += [("serve", p) for p in _plans(jsvc, tsvc, "serve_bool", 10)]
    plans += [("serve", p) for p in _plans(jsvc, tsvc, "serve_mm", 10)]
    jb = JBatcher(workers=1)
    ref = [jb.execute(jex, p[0][0], 10, kind=kind, query=p[0][1]) for kind, p in plans]
    jb.close()
    tb = QueryBatcher(workers=2, pipeline_depth=depth)
    got = [None] * len(plans)

    def client(lo):
        for i in range(lo, len(plans), 4):
            kind, p = plans[i]
            got[i] = tb.execute(tex, p[1][0], 10, kind=kind, query=p[1][1])

    threads = [threading.Thread(target=client, args=(lo,)) for lo in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    tb.close()
    for i, (r, g) in enumerate(zip(ref, got)):
        same_td(r, g, f"depth={depth} job {i} ({plans[i][0]})")
    assert tb.pipeline_depth == depth and tb.stats["jobs"] == len(plans)


def test_batcher_refuses_families_it_does_not_have(serving_pair):
    """The mesh families are the batcher's own since the serving mesh is
    ported; a kind no package has is still refused at submit."""
    from elasticsearch_tpu_torch.search import batcher as batcher_mod

    assert {"mesh_match", "mesh_serve", "mesh_knn", "mesh_sparse", "mesh_agg"} <= set(
        batcher_mod._JOB_KINDS
    )
    b = QueryBatcher(workers=1)
    try:
        for kind in ("mesh_hnsw", "phrase"):
            with pytest.raises(ValueError, match=kind):
                b.submit_nowait(None, None, 10, kind=kind)
    finally:
        b.close()


# the shapes of tests/test_serve_plans.py (plans and rejections)
SERVE_PLAN_QUERIES = [
    {"bool": {"must": [{"match": {"body": "alpha"}}, {"term": {"body": "bravo"}}],
              "should": [{"match": {"title": "charlie delta"}}]}},
    {"bool": {"should": [{"match": {"body": "alpha"}}, {"match": {"body": "bravo"}},
                         {"match": {"body": "charlie"}}], "minimum_should_match": 2}},
    {"bool": {"must_not": [{"match": {"body": "alpha"}}], "should": [{"match": {"body": "bravo"}}]}},
    {"bool": {"filter": [{"term": {"body": "alpha"}}], "must": [{"match": {"body": "bravo"}}]}},
    {"bool": {"must": [{"match": {"body": "alpha bravo"}}]}},
    {"multi_match": {"query": "alpha", "fields": ["title", "body"], "operator": "and"}},
    {"multi_match": {"query": "alpha", "fields": ["title", "body"], "type": "cross_fields"}},
    {"term": {"body": "alpha"}},
    {"term": {"tag": "t1"}},
    {"multi_match": {"query": "alpha bravo", "fields": ["title^2", "body"], "type": "best_fields",
                     "tie_breaker": 0.3}},
    {"multi_match": {"query": "alpha charlie", "fields": ["title", "body"]}},
    {"multi_match": {"query": "bravo echo", "fields": ["title", "body"], "type": "most_fields"}},
    {"bool": {"must": [{"term": {"body": "alpha"}}, {"term": {"body": "bravo"}}]}},
    {"bool": {"should": [{"match": {"body": "alpha"}}, {"match": {"body": "echo"}},
                         {"match": {"title": "charlie"}}], "minimum_should_match": 2}},
    {"bool": {"should": [{"match": {"body": "alpha bravo"}}], "minimum_should_match": 0}},
    {"bool": {"must": [{"match": {"body": "alpha"}}], "should": [{"match": {"body": "x"}}],
              "minimum_should_match": 1}},
    {"bool": {"must": [{"match": {"body": {"query": "alpha", "minimum_should_match": 1}}}]}},
    {"bool": {"should": [{"match": {"body": "alpha bravo"}}, {"match": {"title": "echo"}}],
              "minimum_should_match": 2}},
]


@pytest.mark.parametrize("qi", range(len(SERVE_PLAN_QUERIES)))
def test_extract_serve_plan_matches_reference(serving_pair, qi):
    jsvc, tsvc = serving_pair
    body = SERVE_PLAN_QUERIES[qi]
    jp = j_serve_plan(jdsl.parse_query(body), jsvc.mappings, jsvc.analysis)
    tp = extract_serve_plan(dsl.parse_query(body), tsvc.mappings, tsvc.analysis)
    if jp is None:
        assert tp is None
    else:
        assert dataclasses.asdict(tp) == dataclasses.asdict(jp)
        assert tp.fields == jp.fields
    js, ts = j_split(jdsl.parse_query(body)), split_filtered_bool(dsl.parse_query(body))
    assert (js is None) == (ts is None)
    if ts is not None:
        assert len(ts[1]) == len(js[1])
        assert dsl.canonical_key(ts[0]) == jdsl.canonical_key(js[0])


# ---------------------------------------------------------------------
# IndexService: multi-segment, deletes, 2 shards, fused-size segments
# ---------------------------------------------------------------------


# one body per served shape of bool, multi_match, the
# filtered-bool route, the tree walk, kNN with a filter, the rrf
# retriever with 2 and 3 legs, rank: {rrf})
SERVED = {
    "bool_must_should": {"query": bool_body(0), "size": 8},
    "bool_should_msm": {"query": bool_body(1)},
    "multi_match_best_fields": {"query": mm_body(0)},
    "multi_match_most_fields": {"query": mm_body(1, type="most_fields"), "size": 12},
    "filtered_bool_match": {"query": {"bool": {"must": [{"match": {"body": "alpha bravo"}}],
                                               "filter": [{"term": {"tag": "t1"}}]}}},
    "filtered_bool_serve": {"query": {"bool": {"must": [{"term": {"body": "charlie"}}],
                                               "should": [{"match": {"title": "alpha"}}],
                                               "filter": [{"range": {"n": {"gte": 30}}},
                                                          {"term": {"tag": "t2"}}]}}},
    "bool_tree_walk": {"query": {"bool": {"must": [{"match": {"body": "delta echo"}}],
                                          "must_not": [{"term": {"tag": "t0"}}],
                                          "filter": [{"range": {"n": {"lt": 70}}}]}}},
    "dis_max": {"query": {"dis_max": {"queries": [{"match": {"title": "alpha"}},
                                                  {"match": {"body": "alpha golf"}}],
                                      "tie_breaker": 0.2}}},
    "knn_filter": {"knn": {**knn_body(6, k=7), "filter": {"terms": {"tag": ["t1", "t3"]}}}},
    "retriever_rrf": {"retriever": {"rrf": {"retrievers": [
        {"standard": {"query": mm_body(2)}}, {"knn": knn_body(3, k=8, nc=40)}],
        "rank_constant": 60}}, "size": 7},
    "retriever_rrf_3_legs": {"retriever": {"rrf": {"retrievers": [
        {"standard": {"query": bool_body(2)}}, {"knn": knn_body(5)},
        {"standard": {"query": match_body(4)}}], "rank_window_size": 20}}, "size": 5},
    "rank_rrf": {"query": match_body(3), "knn": knn_body(4), "rank": {"rrf": {"rank_constant": 20}}},
}

BODIES = (
    [{"query": match_body(i), "size": 7} for i in range(5)]
    + [{"query": match_body(i, msm=2)} for i in range(3)]
    + [{"query": {"match": {"title": {"query": "alpha bravo", "operator": "and"}}}}]
    + [{"query": {"match": {"body": "echo"}}, "track_total_hits": True, "size": 30}]
    + [{"knn": knn_body(i), "size": 6} for i in range(4)]
    + [{"knn": knn_body(9, nc=6, k=6)}, {"query": {"match_all": {}}, "size": 3}]
    + list(SERVED.values())
)


@pytest.mark.parametrize("shards,fused", [(1, False), (2, False), (1, True), (2, True)])
def test_index_service_matches_reference(monkeypatch, shards, fused):
    if fused:
        # every segment takes the fused route, as large ones do
        monkeypatch.setattr(executor_jax, "FUSED_MIN_DOCS", 10)
        monkeypatch.setattr(executor_torch, "FUSED_MIN_DOCS", 10)
    docs = make_docs(300, seed=11 + shards)
    pair = build_pair(docs, shards=shards, waves=3,
                      deletes=["d1", "d42", "d150", "d299"], name=f"is{shards}")
    try:
        jsvc, tsvc = pair
        for i, body in enumerate(BODIES):
            same_response(jsvc.search(body), tsvc.search(body), f"body {i}: {body}")
        for body in ({"query": match_body(2)}, {}):
            assert tsvc.count(body)["count"] == jsvc.count(body)["count"]
        ex = tsvc._executor(tsvc.shards[0])
        assert isinstance(ex, TorchExecutor) and ex.device.type == "cpu"
        if fused:
            assert ex.fused_scorer(0, "body") is not None
            assert ex.fused_scorer_mf(0, ("title", "body")) is not None
        stats = tsvc._batcher.stats
        assert stats["launches"] > 0
        assert (stats["fused_jobs"] > 0) if fused else (stats["chunked_jobs"] > 0)
        # one shard: every rrf request fused on the device, every leg
        # rode the batcher; two shards: legs on the pool, host fuse
        rrf = tsvc.rrf_stats
        assert rrf["searches"] == jsvc.rrf_stats["searches"] == 3
        if shards == 1:
            assert rrf["device_fused"] == 3 and rrf["batcher_legs"] == 7 and rrf["pool_legs"] == 0
        else:
            assert rrf["host_fused"] == 3 and rrf["pool_legs"] == 7
    finally:
        close_pair(pair)


@pytest.fixture(scope="module")
def served_pairs():
    """{shards: (JAX IndexService, port IndexService)} over the same 240
    docs, three refreshes and two deletes, for 1 and 2 shards."""
    docs = make_docs(240, seed=29)
    pairs = {n: build_pair(docs, shards=n, waves=3, deletes=["d4", "d100"], name=f"sv{n}")
             for n in (1, 2)}
    yield pairs
    for pair in pairs.values():
        close_pair(pair)


@pytest.mark.parametrize("shards", [1, 2])
@pytest.mark.parametrize("name", sorted(SERVED))
def test_served_body_matches_reference(served_pairs, name, shards):
    """Each shape of the SERVED table, through IndexService.search on
    both packages: same totals, ids and scores."""
    jsvc, tsvc = served_pairs[shards]
    body = SERVED[name]
    same_response(jsvc.search(body), tsvc.search(body), f"{name} ({shards} shards)")


# ---------------------------------------------------------------------
# settings, the device default, and the cuts
# ---------------------------------------------------------------------


@pytest.mark.parametrize("backend", ["jax", "foo"])
def test_other_backends_are_refused(backend):
    from elasticsearch_tpu_torch.cluster import ClusterError, ClusterService

    cs = ClusterService(device="cpu")
    try:
        with pytest.raises(ClusterError) as e:
            cs.create_index("x", {"settings": {"search.backend": backend}})
        assert e.value.status == 400 and "search.backend" in e.value.reason
        cs.create_index("y", {"settings": {"search.backend": "numpy"}})
        assert cs.create_index("z")["acknowledged"]
        assert cs.get_index("z").settings["search.backend"] == "torch"
    finally:
        cs.close()


@pytest.mark.parametrize("entry", ["cluster", "index", "server"])
def test_default_device_is_cuda_without_fallback(entry):
    from elasticsearch_tpu_torch.cluster import ClusterService
    from elasticsearch_tpu_torch.rest.server import ElasticsearchTpuServer

    make = {
        "cluster": lambda: ClusterService(),
        "index": lambda: IndexService("x"),
        "server": lambda: ElasticsearchTpuServer(port=0),
    }[entry]
    if torch.cuda.is_available():
        obj = make()
        dev = obj.cluster.device if entry == "server" else obj.device
        assert dev.type == "cuda"
        obj.close()
    else:
        with pytest.raises(RuntimeError, match="cuda"):
            make()


# bodies that raised while their ROADMAP queue 1 item was cut: each now
# gets the JAX package's answer (served, or its 400: a `match_all`
# rescore_query is unsupported there too; a highlight's fragments too)
CUT_BODIES = {
    "sparse_vector_leg": ({"retriever": {"rrf": {"retrievers": [
        {"standard": {"query": {"match": {"body": "alpha"}}}},
        {"standard": {"query": {"bool": {
            "must": [{"sparse_vector": {"field": "ml", "query_vector": {"alpha": 1.0}}}],
            "filter": [{"match_phrase": {"body": "alpha bravo"}}]}}}}]}}},
        "item 16"),
    "rescore_in_retriever": ({"retriever": {"rrf": {"retrievers": [
        {"standard": {"query": {"match": {"body": "alpha"}}}}, {"knn": knn_body(0)}]}},
        "rescore": {"window_size": 5, "query": {"rescore_query": {"match_all": {}}}}}, "item 7"),
    "multi_match_phrase": ({"query": {"multi_match": {"query": "alpha bravo", "fields": ["title", "body"],
                                                      "type": "phrase"}}}, "item 16"),
    "rescore": ({"query": {"match": {"body": "alpha"}},
                 "rescore": {"window_size": 5, "query": {"rescore_query": {"match_all": {}}}}}, "item 7"),
    "aggs": ({"size": 0, "query": {"match_phrase": {"body": "alpha bravo"}},
              "aggs": {"n": {"value_count": {"field": "title"}}}}, "item 16"),
    "highlight": ({"query": {"match": {"body": "alpha"}}, "highlight": {"fields": {"body": {}}}}, "item 14"),
}
SMALL_MAPPING = {"properties": {**MAPPING["properties"], "ml": {"type": "sparse_vector"}}}


@pytest.fixture(scope="module")
def small_torch_index():
    docs = make_docs(60, seed=3)
    svc = IndexService("cuts", settings={"number_of_shards": 2}, mappings_json=SMALL_MAPPING, device="cpu")
    for doc_id, src in docs:
        svc.index_doc(doc_id, src)
    svc.refresh()
    yield svc
    svc.close()


@pytest.fixture(scope="module")
def small_jax_index():
    svc = JIndexService("cuts", settings={"number_of_shards": 2, "search.backend": "jax"},
                        mappings_json=SMALL_MAPPING)
    for doc_id, src in make_docs(60, seed=3):
        svc.index_doc(doc_id, src)
    svc.refresh()
    yield svc
    svc.close()


def _search_or_error(svc, body):
    try:
        return svc.search(copy.deepcopy(body)), None
    except (dsl.QueryParseError, jdsl.QueryParseError) as e:
        return None, str(e)


@pytest.mark.parametrize("name", sorted(CUT_BODIES))
def test_cut_request_raises_naming_its_slice(small_torch_index, small_jax_index, name):
    body, item = CUT_BODIES[name]
    ref, ref_err = _search_or_error(small_jax_index, body)
    got, got_err = _search_or_error(small_torch_index, body)
    assert got_err == ref_err, (name, ref_err, got_err)
    if ref is not None:
        assert ref["hits"]["total"]["value"] > 0, name
        same_response(ref, got, name)
        assert got.get("aggregations") == ref.get("aggregations"), name
        hl = {h["_id"]: h.get("highlight") for h in got["hits"]["hits"]}
        assert {h["_id"]: h.get("highlight") for h in ref["hits"]["hits"]} == hl, name


def test_ivf_index_serves_and_exact_escape_serves(small_torch_index, monkeypatch):
    """An IVF index is served by the probe (the batcher's kNN family, a
    filtered section through the executor), and `exact` still serves
    the brute-force path."""
    from elasticsearch_tpu_torch.search import ann as ann_mod

    monkeypatch.setenv(ann_mod.ANN_MIN_DOCS_ENV, "8")
    svc = IndexService("ivf", settings={"knn.type": "ivf", "knn.nlist": 4},
                       mappings_json=MAPPING, device="cpu")
    try:
        for doc_id, src in make_docs(40, seed=1):
            svc.index_doc(doc_id, src)
        svc.refresh()
        before = ann_mod.stats_snapshot()
        assert svc.search({"knn": knn_body(0)})["hits"]["hits"]
        filtered = {**knn_body(0), "filter": {"term": {"tag": "t0"}}}
        hits = svc.search({"knn": filtered})["hits"]["hits"]
        assert hits and all(int(h["_id"][1:]) % 4 == 0 for h in hits)
        after = ann_mod.stats_snapshot()
        assert after["ann_searches"] >= before["ann_searches"] + 2
        assert after["exact_fallbacks"] == before["exact_fallbacks"]
        assert svc.search({"knn": knn_body(0), "exact": True})["hits"]["hits"]
        assert ann_mod.stats_snapshot()["exact_searches"] == after["exact_searches"] + 1
    finally:
        svc.close()


def test_mesh_force_serves(small_torch_index, monkeypatch):
    """`ES_TPU_MESH=force` raised naming ROADMAP queue 1 item 12b while
    the serving mesh was cut; since it is ported the same body is
    mesh-routed and equals the per-shard fan-out bit for bit."""
    body = {"query": {"match": {"body": "alpha"}}}
    mex = small_torch_index.mesh_executor()
    monkeypatch.setenv("ES_TPU_MESH", "force")
    routed0 = mex.stats["routed"]
    got = small_torch_index.search(copy.deepcopy(body))
    assert mex.stats["routed"] == routed0 + 1
    monkeypatch.setenv("ES_TPU_MESH", "off")
    ref = small_torch_index.search(copy.deepcopy(body))
    assert got["hits"]["total"] == ref["hits"]["total"]
    assert [(h["_id"], h["_score"]) for h in got["hits"]["hits"]] == [
        (h["_id"], h["_score"]) for h in ref["hits"]["hits"]
    ]


def test_device_build_force_raises(monkeypatch):
    """`ES_TPU_DEVICE_BUILD=force` raised naming ROADMAP queue 1 item 11
    while it was cut; since it is ported the refresh builds through
    ops/index_build.py on the index's device and the doc is served."""
    from elasticsearch_tpu_torch.index import segment_build

    monkeypatch.setenv("ES_TPU_DEVICE_BUILD", "force")
    svc = IndexService("db", mappings_json=MAPPING, device="cpu")
    try:
        svc.index_doc("a", {"body": "alpha"})
        before = segment_build.INGEST_STATS["device_builds"]
        svc.refresh()
        assert segment_build.INGEST_STATS["device_builds"] == before + 1
        hits = svc.search({"query": {"match": {"body": "alpha"}}})["hits"]["hits"]
        assert [h["_id"] for h in hits] == ["a"]
    finally:
        monkeypatch.setenv("ES_TPU_DEVICE_BUILD", "off")
        svc.close()


def test_data_path_raises(tmp_path):
    """A data path raised naming ROADMAP queue 1 item 13 while on-disk
    shards were cut; since they are ported a node and an index open on
    disk, and a reopened index answers as before, as the JAX one does."""
    from elasticsearch_tpu_torch.cluster import ClusterService

    c = ClusterService(data_path=str(tmp_path / "node"), device="cpu")
    c.close()
    assert (tmp_path / "node").is_dir()
    pages = []
    for cls, kw in ((IndexService, {"device": "cpu"}), (JIndexService, {})):
        base = str(tmp_path / cls.__module__.split(".")[0])
        svc = cls("p", mappings_json=MAPPING, base_path=base,
                  settings={"search.backend": "numpy"}, **kw)
        svc.index_doc("a", {"body": "alpha bravo"})
        svc.index_doc("b", {"body": "alpha"})
        svc.flush()
        svc.close()
        svc = cls("p", mappings_json=MAPPING, base_path=base,
                  settings={"search.backend": "numpy"}, **kw)
        try:
            hits = svc.search({"query": {"match": {"body": "alpha"}}})["hits"]["hits"]
            pages.append([(h["_id"], h["_score"]) for h in hits])
        finally:
            svc.close()
    assert pages[0] == pages[1] and len(pages[0]) == 2
