"""The `sparse` kind (`kinds/sparse.py`), the `sparse_vector` body, the
plain reference (`reference/sparse.py`) and the sparse family's metric
readers, on the CPU at a small size: the kind's `SparseField` is the
port's own build of the same triples, array for array; the port's
`_search` serves the reference's pages, pruned queries included; a
whole run is correct, and the control and planted faults are not."""

import json

import numpy as np
import pytest
import torch

from benchmark.control import control_readings
from benchmark.harness import check, corpus, spec, system
from benchmark.harness.traffic import QueryMaker, term_name
from benchmark.reference.sparse import SparseRef
from benchmark.tests.conftest import ROOT

WORKLOAD = "msmarco-passage-elser.sparse.c1"
BIG = 2**31 + 77
FIELD_ARRAYS = ("term_df", "term_tile_start", "term_tile_count", "doc_ids", "weights",
                "qweights", "scales", "tile_max", "tile_qmax", "exists")


def small(passages=3000, vocab=2048):
    """(configuration, mix) of the cell, cut to a test's size."""
    cell = spec.resolve(ROOT, WORKLOAD)
    a = cell.config["assumed"]
    return {**cell.config, "passages": passages, "assumed": {**a, "vocab": vocab}}, cell.traffic


def triples(c):
    df = c["df"].numpy()
    start = np.cumsum(df) - df
    return df, start, c["docs"].numpy(), c["weights"].numpy()


@pytest.mark.parametrize("seed", [5, BIG])
def test_corpus_is_a_function_of_the_seed_with_fixed_counts(seed):
    cfg, _ = small()
    a, b, other = (corpus.make(cfg, s, "cpu") for s in (seed, seed, seed + 1))
    for k in ("docs", "weights", "df"):
        assert torch.equal(a[k], b[k])
    assert torch.equal(a["df"], other["df"]) and not torch.equal(a["docs"], other["docs"])
    df, start, docs, w = triples(a)
    assert df.sum() == len(docs) == len(w) and 120 <= df.sum() / 3000 <= 136
    assert df[0] == 300 and (np.diff(df) <= 0).all() and df[-1] > 0
    for t in range(len(df)):
        d = docs[start[t]:start[t] + df[t]]
        assert (np.diff(d) > 0).all() and d.min() >= 0 and d.max() < 3000
    # positive, at most 4, 9 significant bits
    assert w.min() > 0 and w.max() <= 4.0 and not (w.view(np.int32) & 0x7FFF).any()
    assert 0.3 < float(np.median(w)) < 0.5


@pytest.mark.parametrize("seed", [5, BIG])
def test_the_kinds_field_is_the_ports_own_build(seed):
    """Array for array what `sparse_plan` + `sparse_from_plan` make of
    the same triples through the port's host build."""
    from elasticsearch_tpu_torch.index.segment import sparse_from_plan, sparse_plan

    cfg, _ = small()
    c = corpus.make(cfg, seed, "cpu")
    sf = system.segment(cfg, c).sparse[cfg["field"]]
    df, start, docs, w = triples(c)
    inv = {term_name(t): dict(zip(docs[start[t]:start[t] + df[t]].tolist(),
                                  w[start[t]:start[t] + df[t]].tolist()))
           for t in range(len(df))}
    exists = np.zeros(3000, bool)
    exists[docs] = True
    want = sparse_from_plan(sparse_plan(inv, 0.0), 3000, exists)
    assert sf.terms == want.terms and sf.pruned == 0
    for k in FIELD_ARRAYS:
        a, b = getattr(sf, k), getattr(want, k)
        assert a.dtype == b.dtype and a.shape == b.shape, k
        assert a.tobytes() == b.tobytes(), k


def test_the_reference_matches_a_brute_force_loop():
    cfg, _ = small(400, 300)
    c = corpus.make(cfg, 11, "cpu")
    df, start, docs, w = triples(c)
    ref = SparseRef(c["docs"], c["weights"], c["df"], 400)
    rng = np.random.default_rng(2)
    for n in (1, 3, 12):
        ids = rng.choice(300, n, replace=False).tolist()
        qw = rng.uniform(0.1, 2.0, n).astype(np.float32).tolist()
        scores, hit = np.zeros(400), np.zeros(400, bool)
        for t, q in zip(ids, qw):
            for d, x in zip(docs[start[t]:start[t] + df[t]], w[start[t]:start[t] + df[t]]):
                scores[d] += float(q) * float(x)
                hit[d] = True
        order = sorted(np.nonzero(hit)[0], key=lambda d: (-scores[d], d))
        got_docs, vals, count, s, h = ref.top((ids, qw), 10)
        assert count == int(hit.sum()) and got_docs.tolist() == order[:10]
        np.testing.assert_allclose(vals.numpy(), scores[order[:10]], rtol=1e-13)
        assert torch.equal(h, torch.from_numpy(hit))


def test_the_body_is_the_same_set_of_queries_for_every_seed():
    cfg, tr = small()
    a, b = QueryMaker(tr, cfg, {}, 5), QueryMaker(tr, cfg, {}, BIG)
    assert a.shapes == b.shapes and list(a.perm) != list(b.perm)
    for ids, ws in a.shapes:
        assert 8 <= len(ids) <= 52 and len(set(ids)) == len(ids)
        assert all(0 < x <= 4.0 and x == float(np.float32(x)) for x in ws)
    assert 25 <= np.mean([len(s[0]) for s in a.shapes]) <= 35
    body = a.body(0, 3)
    ids, ws = a.terms(0, 3)
    qv = body["query"]["sparse_vector"]["query_vector"]
    assert body["size"] == 10 and body["query"]["sparse_vector"]["field"] == cfg["field"]
    assert qv == {term_name(t): x for t, x in zip(ids, ws)}
    assert json.loads(json.dumps(body)) == body


@pytest.fixture(scope="module")
def served():
    """The port's server on the CPU holding the kind's segment of a
    small corpus, and the corpus."""
    from elasticsearch_tpu_torch.search import sparse as sparse_mod

    cfg, _ = small()
    c = corpus.make(cfg, BIG, "cpu")
    sut = system.System(cfg, system.segment(cfg, c), "cpu", spec.BENCH_DIR)
    sut.prewarm()
    yield sut, c, cfg, sparse_mod
    sut.close()


def _pages_equal(resp, ref, query, size=10):
    docs, vals, count, *_ = ref.top(query, size)
    hits = resp["hits"]["hits"]
    assert [h["_id"] for h in hits] == [str(d) for d in docs.tolist()]
    np.testing.assert_allclose([h["_score"] for h in hits], vals.numpy(), rtol=2e-6)
    return resp["hits"]["total"], count


def test_the_ports_search_is_the_reference(served):
    sut, c, cfg, sparse_mod = served
    ref = SparseRef(c["docs"], c["weights"], c["df"], 3000)
    maker = QueryMaker(small()[1], cfg, {}, BIG)
    before = dict(sparse_mod.SPARSE_STATS)
    for i in range(12):
        total, count = _pages_equal(sut.search(maker.body(0, i)), ref, maker.terms(0, i))
        assert total["value"] == min(count, 10000) if total["relation"] == "eq" \
            else total["value"] <= count
    after = sparse_mod.SPARSE_STATS
    assert after["searches"] - before["searches"] >= 12 and after["fallbacks"] == before["fallbacks"]


def test_a_pruned_query_is_exact_with_a_gte_total(served):
    """One token held by 300 docs (three tiles): its first tile sets
    theta, and tail tiles bounded below it are dropped."""
    sut, c, cfg, sparse_mod = served
    ref = SparseRef(c["docs"], c["weights"], c["df"], 3000)
    query = ([0], [1.25])
    body = {"query": {"sparse_vector": {"field": cfg["field"],
                                        "query_vector": {term_name(0): 1.25}}}, "size": 10}
    before = sparse_mod.SPARSE_STATS["tiles_pruned"]
    total, count = _pages_equal(sut.search(body), ref, query)
    assert sparse_mod.SPARSE_STATS["tiles_pruned"] > before
    assert total["relation"] == "gte" and total["value"] <= count == 300


def _cell():
    cell = spec.resolve(ROOT, WORKLOAD)
    cfg, _ = small(20000, 3000)
    cell.config = cfg
    cell.traffic = {**cell.traffic, "warmup_s": 0.5, "check_sample": 24}
    return cell


def _run():
    from benchmark import run

    run.set_env(run.ROOT)
    return run.run_cell(_cell(), BIG, 2.0, False, device="cpu", log=lambda *a, **k: None)


def test_a_sound_run_is_correct():
    out = _run()
    assert out["correct"], out["check"]
    assert out["failed"] == 0 and out["attempted"] > 0
    assert out["check"]["score_err"]["value"] < 1e-6 and out["check"]["hit_gap"]["value"] == 0


def _weight_changed(c):
    c = dict(c, weights=c["weights"].clone())
    # the first posting of every token: each query holds some
    start = torch.cumsum(c["df"], 0) - c["df"]
    c["weights"][start] *= 1.01
    return c


def _posting_dropped(c):
    """Each token's heaviest posting goes."""
    df, start, docs, w = triples(c)
    keep = np.ones(len(docs), bool)
    for t in range(len(df)):
        keep[start[t] + int(np.argmax(w[start[t]:start[t] + df[t]]))] = False
    return dict(c, docs=c["docs"][torch.from_numpy(keep)], weights=c["weights"][torch.from_numpy(keep)],
                df=c["df"] - 1)


def _untruncated(c):
    """The weights as drawn, before FeatureField's cut: every stored one
    gains low bits."""
    w = c["weights"].view(torch.int32) | 0x4000
    return dict(c, weights=w.view(torch.float32))


@pytest.mark.parametrize("fault", [_weight_changed, _posting_dropped, _untruncated],
                         ids=["weight", "posting", "untruncated"])
def test_a_fault_planted_in_the_served_index_is_caught(fault, monkeypatch):
    real = system.segment
    monkeypatch.setattr(system, "segment", lambda cfg, corp, bench=spec.BENCH_DIR:
                        real(cfg, fault(corp), bench))
    out = _run()
    assert not out["correct"], out["check"]


def test_the_control_fails_the_check():
    cfg, tr = small(20000, 3000)
    got = control_readings(cfg, tr, BIG, 24, "cpu")
    correct, compared = check.verdict(got, cfg["limits"])
    assert not correct, compared
    assert got["score_err"] > 1e-3


def _stats(searches, tiles, fallbacks, launches=None):
    node = {"sparse": {"searches": searches, "tiles_scored": tiles, "fallbacks": fallbacks},
            "thread_pool": {"search": {"completed": searches}}}
    if launches is not None:
        node["thread_pool"]["search"]["sparse_launches"] = launches
    return node


def reader(name):
    return spec.load_reader(ROOT / "benchmark", name)


def test_the_counter_readers():
    ctx = {"stats": (_stats(10, 1000, 0, 50), _stats(30, 141000, 0, 2850))}
    assert reader("sparse_launches_per_job")(ctx) == pytest.approx(140.0)
    assert reader("sparse_tiles_per_job")(ctx) == pytest.approx(7000.0)
    assert reader("sparse_fallback_share")(ctx) == 0.0
    fell = {"stats": (_stats(10, 0, 2), _stats(16, 0, 4))}
    assert reader("sparse_fallback_share")(fell) == pytest.approx(2 / 8)
    # a program without the launch counter, or a window with no scoring
    assert reader("sparse_launches_per_job")(fell) is None
    idle = {"stats": (_stats(10, 0, 0, 5), _stats(10, 0, 0, 5))}
    for name in ("sparse_launches_per_job", "sparse_tiles_per_job", "sparse_fallback_share"):
        assert reader(name)(idle) is None
        assert reader(name)({}) is None
        assert reader(name)({"stats": ({}, {})}) is None


def span(id, parent, name, ms):
    return {"id": id, "parent_id": parent, "name": name, "start_ns": 0,
            "duration_ns": int(ms * 1e6), "tags": {}}


def test_the_span_reader():
    sparse = {"spans": [span(1, None, "http", 60.0), span(2, 1, "batcher.dispatch", 55.0),
                        span(3, 2, "sparse.plan", 1.0), span(4, 2, "sparse.score", 0.5),
                        span(5, 2, "device.wait", 2.0), span(6, 2, "sparse.survive", 1.5),
                        span(7, 2, "sparse.score", 40.0)]}
    chunked = {"spans": [span(1, None, "http", 9.0), span(2, 1, "chunked.plan", 1.0)]}
    read = reader("sparse_host_ms_per_job")
    assert read({"traces": [sparse, chunked, sparse]}) == pytest.approx(43.0)
    assert read({"traces": [chunked]}) is None and read({}) is None


def test_the_scatter_reader():
    events = [("chunk_kernel", "kernel", 0.0, 400.0), ("apply_kernel", "kernel", 500.0, 1100.0),
              ("gemv2T_kernel_val", "kernel", 0.0, 50.0), ("Memcpy HtoD", "memcpy", 0.0, 9.0)]
    sl = {"events": events, "lo": 100.0, "hi": 1000.0, "requests": 2}
    read = reader("sparse_scatter_ms_per_req")
    assert read({"slice": sl}) == pytest.approx((300 + 500) * 1e-3 / 2)
    assert read({"slice": dict(sl, requests=0)}) is None
    assert read({"slice": dict(sl, events=events[2:])}) is None and read({}) is None
