"""The port's learned-sparse path against the JAX package's, on the CPU.

The same `sparse_vector` documents (made with numpy from a seed) go
through the JAX package and the port: the impact scorer (`score_into`,
`threshold`, `finalize`), the block-max plan (`SparseBlockMax`) and the
tile resolution (`impact_tile_lists`) on the same numpy planes; the
batcher's `sparse` family at every bucket of the ladder, pruned and
not; and `IndexService` for bare `sparse_vector` bodies (int8, fp32 and
`"exact": true`), the 3-leg RRF body, the injected `sparse.score` fault
and `_nodes/stats`. Tolerances: ids by position (a run of scores tied
within rtol 1e-5 as a set), scores within rtol 1e-5 / atol 1e-6 (float32
sums, one order per package), totals, relations, tile counts and every
integer exact. On the CPU the port's fp32 path also equals the numpy
oracle bit for bit, as the reference's does.
"""

import dataclasses
import json
import urllib.request

import numpy as np
import pytest
import torch

from elasticsearch_tpu.analysis import AnalysisRegistry as JAnalysis
from elasticsearch_tpu.cluster.indices import IndexService as JIndexService
from elasticsearch_tpu.common.faults import faults as jfaults
from elasticsearch_tpu.index.mapping import DocumentParser as JParser
from elasticsearch_tpu.index.mapping import Mappings as JMappings
from elasticsearch_tpu.index.segment import SegmentBuilder as JSegmentBuilder
from elasticsearch_tpu.ops import impact as jimpact
from elasticsearch_tpu.search import dsl as jdsl
from elasticsearch_tpu.search import sparse as jsparse
from elasticsearch_tpu.search.batcher import QueryBatcher as JBatcher
from elasticsearch_tpu.search.batcher import extract_sparse_plan as j_sparse_plan

from elasticsearch_tpu_torch.cluster.indices import IndexService
from elasticsearch_tpu_torch.cluster.service import ClusterError
from elasticsearch_tpu_torch.common.faults import faults
from elasticsearch_tpu_torch.common.settings import batch_buckets
from elasticsearch_tpu_torch.ops import impact, scoring
from elasticsearch_tpu_torch.search import dsl
from elasticsearch_tpu_torch.search import sparse as sparse_mod
from elasticsearch_tpu_torch.search.batcher import QueryBatcher, extract_sparse_plan, live_batchers
from elasticsearch_tpu_torch.search.executor_torch import TorchExecutor

torch.set_num_threads(1)

RTOL = 1e-5
VOCAB = [f"tok{i:02d}" for i in range(40)]
DIMS = 4
MAPPING = {
    "properties": {
        "ml": {"type": "sparse_vector"},
        "body": {"type": "text"},
        "vec": {"type": "dense_vector", "dims": DIMS, "similarity": "cosine"},
    }
}


@pytest.fixture(autouse=True)
def _reset_port_singletons():
    yield
    from elasticsearch_tpu_torch.search.admission import admission

    admission.reset()
    if faults.active:
        faults.clear()


@pytest.fixture(autouse=True, scope="module")
def _no_leaked_port_batcher_threads():
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


def sparse_docs(n=300, vocab=VOCAB, seed=3, lo=2, hi=9):
    """The reference's tests/test_sparse.py corpus: lo..hi-1 terms per
    doc, weights in [0.05, 3.05) rounded to 4 places."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        nt = int(rng.integers(lo, min(hi, len(vocab))))
        toks = [str(t) for t in rng.choice(vocab, size=nt, replace=False)]
        vec = {t: float(np.round(rng.random() * 3 + 0.05, 4)) for t in toks}
        out.append((str(i), {"ml": vec, "body": " ".join(toks),
                             "vec": [float(x) for x in rng.normal(size=DIMS)]}))
    return out


# a term-heavy corpus: every term spans several 128-posting tiles, so
# phase A's theta drops tails
PRUNE_DOCS = dict(vocab=VOCAB[:6], seed=21, lo=2, hi=5)


def qvec(seed, vocab=VOCAB):
    rng = np.random.default_rng(seed)
    toks = [str(t) for t in rng.choice(vocab, size=int(rng.integers(2, 6)), replace=False)]
    return {t: float(np.round(rng.random() * 2 + 0.1, 4)) for t in toks}


def qbody(seed, size=10, exact=False, vocab=VOCAB):
    b = {"query": {"sparse_vector": {"field": "ml", "query_vector": qvec(seed, vocab)}}, "size": size}
    if exact:
        b["exact"] = True
    return b


def make_service(cls, name, backend, quant="int8", shards=1, docs=None, **kw):
    svc = cls(name, settings={"number_of_shards": shards, "search.backend": backend,
                              "sparse.quantization": quant},
              mappings_json=MAPPING, **kw)
    for i, s in (docs if docs is not None else sparse_docs()):
        svc.index_doc(i, s)
    svc.refresh()
    return svc


def port_service(name, backend="torch", **kw):
    return make_service(IndexService, name, backend, device="cpu", **kw)


def jax_service(name, **kw):
    return make_service(JIndexService, name, "jax", **kw)


def same_ids(ref_ids, ref_scores, got_ids, what=""):
    ref_ids, got_ids = list(ref_ids), list(got_ids)
    assert len(got_ids) == len(ref_ids), (what, ref_ids, got_ids)
    i = 0
    while i < len(ref_ids):
        j = i + 1
        while j < len(ref_ids) and np.isclose(ref_scores[j], ref_scores[j - 1], rtol=RTOL, atol=0):
            j += 1
        assert set(got_ids[i:j]) == set(ref_ids[i:j]), (what, i, ref_ids, got_ids)
        i = j


def same_response(ref, got, what=""):
    assert got["hits"]["total"] == ref["hits"]["total"], what
    rh, gh = ref["hits"]["hits"], got["hits"]["hits"]
    rs = np.array([h["_score"] for h in rh])
    assert len(gh) == len(rh), what
    np.testing.assert_allclose([h["_score"] for h in gh], rs, rtol=RTOL, atol=1e-6, err_msg=what)
    same_ids([h["_id"] for h in rh], rs, [h["_id"] for h in gh], what)


def same_td(ref, got, what=""):
    assert got.total == ref.total and got.relation == ref.relation, what
    rs = np.array([h.score for h in ref.hits])
    assert len(got.hits) == len(ref.hits), what
    np.testing.assert_allclose([h.score for h in got.hits], rs, rtol=RTOL, atol=1e-6, err_msg=what)
    same_ids([h.doc_id for h in ref.hits], rs, [h.doc_id for h in got.hits], what)


def hits_of(resp):
    return [(h["_id"], h["_score"]) for h in resp["hits"]["hits"]]


# ---------------------------------------------------------------------------
# ops/impact.py on the same numpy planes
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def sparse_field():
    """A SparseField built by the JAX package's SegmentBuilder (numpy
    planes both packages take as they are)."""
    maps = JMappings({"properties": {"ml": {"type": "sparse_vector"}}})
    parser = JParser(maps, JAnalysis())
    b = JSegmentBuilder(maps)
    for i, s in sparse_docs(600, **PRUNE_DOCS):
        b.add(parser.parse(i, {"ml": s["ml"]}))
    seg = b.build()
    return seg, seg.sparse["ml"]


def tile_plan(vocab, seed):
    rng = np.random.default_rng(seed)
    toks = [str(t) for t in rng.choice(vocab, size=int(rng.integers(1, 4)), replace=False)]
    ws = [float(np.round(rng.random() * 2 + 0.1, 4)) for _ in toks]
    return toks, ws


@pytest.mark.parametrize("quantized", [False, True])
def test_impact_tile_lists_and_block_max_match_reference(sparse_field, quantized):
    _seg, sf = sparse_field
    bound = sf.tile_qmax if quantized else sf.tile_max
    for seed in range(8):
        toks, ws = tile_plan(VOCAB[:7], seed)  # tok06 is not in the dictionary
        ref = jimpact.impact_tile_lists(sf, toks, ws, quantized)
        got = impact.impact_tile_lists(sf, toks, ws, quantized)
        assert got[0] == ref[0]
        for a, b in zip(got[1:], ref[1:]):
            np.testing.assert_array_equal(a, b)
        tids, tws, bws = got[0], got[1], got[2]
        jb = jimpact.SparseBlockMax(sf.term_tile_start, sf.term_tile_count, bound, tids, tws, bws)
        tb = impact.SparseBlockMax(sf.term_tile_start, sf.term_tile_count, bound, tids, tws, bws)
        for a, b in zip(tb.phase_a(), jb.phase_a()):
            np.testing.assert_array_equal(a, b)
        assert tb.n_tail_tiles == jb.n_tail_tiles and tb.sum_bound == jb.sum_bound
        for theta in (-np.inf, 0.0, 0.5 * jb.sum_bound, 0.9 * jb.sum_bound, 2 * jb.sum_bound + 1):
            gt, gw, gd = tb.kept(theta)
            rt, rw, rd = jb.kept(theta)
            np.testing.assert_array_equal(gt, rt)
            np.testing.assert_array_equal(gw, rw)
            assert gd == rd
    assert impact.sparse_flops(17) == jimpact.sparse_flops(17)
    assert impact.TILE_WIDTH == jimpact.TILE_WIDTH


@pytest.mark.parametrize("quantized", [False, True])
@pytest.mark.parametrize("k", [5, 16, 40])
def test_impact_scorer_matches_reference(sparse_field, quantized, k):
    """score_into (two chunks of the same rows), threshold and finalize,
    with a live mask; totals and integers exact, scores rtol 1e-5."""
    seg, sf = sparse_field
    vals = sf.qweights if quantized else sf.weights
    live = np.random.default_rng(k).random(seg.num_docs) > 0.1
    js = jimpact.ImpactScorer(sf.doc_ids, vals, seg.num_docs, live)
    ts = impact.ImpactScorer(sf.doc_ids, vals, seg.num_docs, live, device="cpu")
    assert ts.values.dtype == (torch.int8 if quantized else torch.float32)
    tiles, weights = [], []
    for seed in range(6):
        toks, ws = tile_plan(VOCAB[:6], seed)
        tids, tws, _bws, starts, counts = impact.impact_tile_lists(sf, toks, ws, quantized)
        tiles.append(np.concatenate([np.arange(s, s + c) for s, c in zip(starts, counts)]))
        weights.append(np.concatenate([np.full(int(c), w, np.float32) for w, c in zip(tws, counts)]))
    ja, jc = js.new_acc(8)
    ta, tc = ts.new_acc(8)
    half = [t[: len(t) // 2] for t in tiles], [w[: len(w) // 2] for w in weights]
    rest = [t[len(t) // 2:] for t in tiles], [w[len(w) // 2:] for w in weights]
    for tl, wl in (half, rest):
        ja, jc = js.score_into(ja, jc, tl, wl)
        ta, tc = ts.score_into(ta, tc, tl, wl)
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_allclose(ta.numpy(), np.asarray(ja), rtol=RTOL, atol=1e-6)
    jth, jmax = js.threshold(ja, k)
    tth, tmax = ts.threshold(ta, k)
    np.testing.assert_allclose(tth, jth, rtol=RTOL, atol=1e-6)
    np.testing.assert_allclose(tmax, jmax, rtol=RTOL, atol=1e-6)
    jsc, jd, jt = js.finalize(ja, jc, k)
    tsc, td, tt = ts.finalize(ta, tc, k)
    np.testing.assert_array_equal(tt, jt)
    for r in range(8):
        fin = np.isfinite(jsc[r])
        np.testing.assert_array_equal(np.isfinite(tsc[r]), fin)
        np.testing.assert_allclose(tsc[r][fin], jsc[r][fin], rtol=RTOL, atol=1e-6)
        same_ids(jd[r][fin], jsc[r][fin], td[r][fin], f"row {r}")


# ---------------------------------------------------------------------------
# the batcher's sparse family
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def prune_pair():
    docs = sparse_docs(600, **PRUNE_DOCS)
    out = {}
    for quant in ("int8", "none"):
        out[quant] = (jax_service(f"bp-{quant}", quant=quant, docs=docs),
                      port_service(f"bp-{quant}", quant=quant, docs=docs))
    yield out
    for pair in out.values():
        for svc in pair:
            svc.close()


def _sparse_plans(jsvc, tsvc, n, quantized, size_seed=0):
    out = []
    for i in range(n):
        body = {"sparse_vector": {"field": "ml", "query_vector": qvec(100 + i + size_seed, VOCAB[:6])}}
        jq, tq = jdsl.parse_query(body), dsl.parse_query(body)
        jq.sparse = jsparse.SparseSpec(quantized=quantized)
        tq.sparse = sparse_mod.SparseSpec(quantized=quantized)
        jp, tp = j_sparse_plan(jq, jsvc.mappings), extract_sparse_plan(tq, tsvc.mappings)
        assert dataclasses.asdict(tp) == dataclasses.asdict(jp)
        out.append(((jp, jq), (tp, tq)))
    return out


def _run_sparse(b, ex, plans, k, rows):
    jobs = [b.submit_nowait(ex, p, k, kind="sparse", query=q) for p, q in plans]
    kb = 16 if k <= 16 else scoring.next_bucket(k, 16)
    b._collect_sparse_group(jobs, kb, b._dispatch_sparse_group(jobs, kb, rows=rows))
    return [b.wait(j, timeout=30) for j in jobs]


@pytest.mark.parametrize("quant", ["int8", "none"])
@pytest.mark.parametrize("rows", batch_buckets(scoring.BPAD))
def test_batcher_sparse_bucket_matches_reference(prune_pair, monkeypatch, quant, rows):
    """Every bucket, full and partial occupancy, k=5 (tails pruned for
    some jobs: relation "gte") and k=400 (nothing dropped: "eq")."""
    jsvc, tsvc = prune_pair[quant]
    jex, tex = jsvc._executor(jsvc.shards[0]), tsvc._executor(tsvc.shards[0])
    assert isinstance(tex, TorchExecutor)
    jb, tb = JBatcher(workers=1), QueryBatcher(workers=1)
    monkeypatch.setattr(jb, "_ensure_thread", lambda: None)
    monkeypatch.setattr(tb, "_ensure_thread", lambda: None)
    try:
        for n in sorted({rows, rows // 2 + 1}):
            plans = _sparse_plans(jsvc, tsvc, n, quant == "int8", size_seed=rows)
            for k in (5, 400):
                ref = _run_sparse(jb, jex, [p[0] for p in plans], k, rows)
                got = _run_sparse(tb, tex, [p[1] for p in plans], k, rows)
                for i, (r, g) in enumerate(zip(ref, got)):
                    same_td(r, g, f"{quant} rows={rows} k={k} job {i}")
                rel = {g.relation for g in got}
                assert "gte" in rel if k == 5 else rel == {"eq"}
    finally:
        jb.close()
        tb.close()
    for key in ("launches", "sparse_jobs", "pruned_jobs"):
        assert tb.stats[key] == jb.stats[key] > 0, key


# ---------------------------------------------------------------------------
# IndexService: bare sparse_vector bodies, exact, the 3-leg RRF body
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def services():
    out = {}
    for quant in ("int8", "none"):
        for shards in (1, 2):
            out[(quant, shards)] = (
                jax_service(f"s-{quant}-{shards}", quant=quant, shards=shards),
                port_service(f"s-{quant}-{shards}", quant=quant, shards=shards),
            )
    out["numpy"] = port_service("s-np", backend="numpy", quant="none")
    yield out
    for key, val in out.items():
        for svc in (val if isinstance(val, tuple) else (val,)):
            svc.close()


@pytest.mark.parametrize("quant", ["int8", "none"])
@pytest.mark.parametrize("shards", [1, 2])
@pytest.mark.parametrize("exact", [False, True])
def test_index_service_sparse_matches_reference(services, quant, shards, exact):
    jsvc, tsvc = services[(quant, shards)]
    before = sparse_mod.SPARSE_STATS["searches"]
    for s in range(10):
        for size in (5, 16):
            b = qbody(s, size=size, exact=exact)
            same_response(jsvc.search(dict(b)), tsvc.search(dict(b)), f"{quant} {shards} {exact} {s} {size}")
    assert sparse_mod.SPARSE_STATS["searches"] > before


def test_fp32_served_sparse_equals_numpy_oracle_bit_for_bit(services):
    """On the CPU `index_add_` adds in slot order: the fp32 column (and
    `exact: true` on the int8 index) equals the dense oracle exactly."""
    ref = services["numpy"]
    for svc, exact in ((services[("none", 1)][1], False), (services[("int8", 1)][1], True)):
        for s in range(12):
            b = qbody(s, size=16, exact=exact)
            assert hits_of(svc.search(dict(b))) == hits_of(ref.search(dict(b))), s


def test_int8_recall_at_10_against_oracle(services):
    """The reference's gate (tests/test_sparse.py): recall@10 >= 0.95."""
    tsvc, ref = services[("int8", 1)][1], services["numpy"]
    rec = []
    for s in range(40):
        b = qbody(s, size=10)
        got = {h["_id"] for h in tsvc.search(dict(b))["hits"]["hits"]}
        want = [h["_id"] for h in ref.search(dict(b))["hits"]["hits"]]
        if want:
            rec.append(len(got & set(want)) / len(want))
    assert np.mean(rec) >= 0.95, np.mean(rec)


def three_leg_body(qv, i=0):
    rng = np.random.default_rng(50 + i)
    return {"retriever": {"rrf": {
        "retrievers": [
            {"standard": {"query": {"match": {"body": "tok00 tok01"}}}},
            {"knn": {"field": "vec", "query_vector": [float(x) for x in rng.normal(size=DIMS)],
                     "k": 20, "num_candidates": 40}},
            {"standard": {"query": {"sparse_vector": {"field": "ml", "query_vector": qv}}}},
        ],
        "rank_constant": 60, "rank_window_size": 50}}, "size": 10}


@pytest.mark.parametrize("quant", ["int8", "none"])
@pytest.mark.parametrize("shards", [1, 2])
def test_three_leg_rrf_matches_reference(services, quant, shards):
    """bench.py's config-5 shape: BM25 + kNN + sparse_vector legs. One
    shard: every leg on the batcher, fused on the device, the sparse leg
    labelled `sparse`; two shards: pool legs, host fuse."""
    jsvc, tsvc = services[(quant, shards)]
    with tsvc._rrf_lock:
        for key in tsvc.rrf_stats:
            tsvc.rrf_stats[key] = 0
    for i in range(4):
        body = three_leg_body(qvec(i), i)
        same_response(jsvc.search(json.loads(json.dumps(body))), tsvc.search(body), f"rrf {i}")
    st = tsvc.rrf_stats
    assert st["searches"] == 4 and tsvc.rrf_leg_samples["sparse"]
    if shards == 1:
        assert st["batcher_legs"] == 12 and st["pool_legs"] == 0 and st["device_fused"] == 4
    else:
        assert st["pool_legs"] == 12 and st["host_fused"] == 4


# ---------------------------------------------------------------------------
# the host route: only an injected fault or the breaker takes it
# ---------------------------------------------------------------------------


def test_sparse_score_fault_routes_to_host_in_both_packages(services):
    """The injected `sparse.score` fault sends the segment to the dense
    oracle in both packages: same answer as the numpy backend, counted."""
    ref = services["numpy"]
    jsvc, tsvc = services[("none", 1)]
    b = qbody(2)
    want = hits_of(ref.search(dict(b)))
    rule = {"rules": [{"site": "sparse.score", "kind": "error"}]}
    jfaults.configure(rule)
    faults.configure(rule)
    try:
        jb0, tb0 = jsparse.SPARSE_STATS["fallbacks"], sparse_mod.SPARSE_STATS["fallbacks"]
        assert hits_of(jsvc.search(dict(b))) == want
        assert hits_of(tsvc.search(dict(b))) == want
        assert jsparse.SPARSE_STATS["fallbacks"] > jb0
        assert sparse_mod.SPARSE_STATS["fallbacks"] > tb0
    finally:
        jfaults.clear()
        faults.clear()


def test_budget_breach_routes_to_host(services):
    """A column that would not fit the device-memory budget is served by
    the oracle (impact_scorer caches None)."""
    from elasticsearch_tpu_torch.common.memory import hbm_ledger

    ref = services["numpy"]
    svc = port_service("s-budget", quant="none")
    try:
        b = qbody(3)
        want = hits_of(ref.search(dict(b)))
        old = hbm_ledger.budget
        svc._executors.clear()
        hbm_ledger.budget = hbm_ledger.used
        try:
            f0 = sparse_mod.SPARSE_STATS["fallbacks"]
            assert hits_of(svc.search(dict(b))) == want
            assert sparse_mod.SPARSE_STATS["fallbacks"] > f0
        finally:
            hbm_ledger.budget = old
    finally:
        svc.close()


def test_runtime_error_in_dispatch_reaches_the_caller(services, monkeypatch):
    """A failure that is not injected (a launch error on the card) must
    fail the request, bare or as an RRF leg — never a host answer."""
    _jsvc, tsvc = services[("none", 1)]
    tsvc.search(qbody(0))  # the executor exists before the patch

    def boom(self, si, field, quantized):
        raise RuntimeError("CUDA error: an illegal memory access was encountered")

    monkeypatch.setattr(TorchExecutor, "impact_scorer", boom)
    # the shard fails, so the request fails (all shards failed)
    with pytest.raises(ClusterError, match="runtime_error: CUDA error: an illegal memory access"):
        tsvc.search(qbody(1))
    with pytest.raises(RuntimeError, match="illegal memory access"):
        tsvc.search(three_leg_body(qvec(1)))


# ---------------------------------------------------------------------------
# _nodes/stats
# ---------------------------------------------------------------------------


def test_nodes_stats_sparse_block_matches_reference():
    from elasticsearch_tpu.rest.server import ElasticsearchTpuServer as JServer
    from elasticsearch_tpu_torch.rest.server import ElasticsearchTpuServer

    pair = (JServer(port=0), ElasticsearchTpuServer(port=0, device="cpu"))
    blocks = []
    try:
        for srv, backend in zip(pair, ("jax", "torch")):
            srv.start_background()
            srv.cluster.create_index("sp", {"settings": {"search.backend": backend,
                                                           "refresh_interval": "-1"},
                                            "mappings": MAPPING})
            idx = srv.cluster.get_index("sp")
            for i, s in sparse_docs(80, seed=4):
                idx.index_doc(i, s)
            idx.refresh()
            idx.search(qbody(1))
            with urllib.request.urlopen(f"http://127.0.0.1:{srv.port}/_nodes/stats", timeout=60) as r:
                node = json.loads(r.read())["nodes"]["node-0"]
            blocks.append(node)
    finally:
        for srv in pair:
            srv.close()
    (jnode, tnode) = blocks
    assert sorted(tnode["sparse"]) == sorted(jnode["sparse"])
    sp = tnode["sparse"]
    assert sp["searches"] > 0 and sp["quantized_searches"] > 0 and sp["batched_jobs"] > 0
    assert sp["impact_fp32_equivalent_bytes"] > sp["impact_bytes"] > 0
    assert sp["ledger_bytes"] > 0
    assert sorted(tnode["aggs"]) == sorted(jnode["aggs"])
