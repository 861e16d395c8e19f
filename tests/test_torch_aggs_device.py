"""The port's device aggregations against the JAX package's, on the CPU.

`ops/agg_kernels.py` against the reference's on the same seeded numpy
inputs (integers exact, float32 extrema exact, percentile operands
exact); `aggs_device.try_compile`'s device-or-host decision over a table
of bodies; `DeviceAggPlan`, `execute_with_terms_aggs` and the routing in
`IndexService` (device plan → terms pass → host `AggCollector`) against
the JAX `IndexService` and the numpy backend, for the reference's parity
bodies and bench.py's `repeated_agg` and `cold_agg` shapes. The device
route is exact by construction (int32 counts and sums inside the
`ColProfile` window, f32 extrema at rank positions), so aggregation
results are compared for equality; `avg` values within 1e-12 relative.
Only an injected `aggs.collect` fault or the breaker takes the host
route after a plan compiled; any other error fails the request.
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from elasticsearch_tpu.cluster.indices import IndexService as JIndexService
from elasticsearch_tpu.ops import agg_kernels as jk
from elasticsearch_tpu.search import aggs_device as jaggs
from elasticsearch_tpu.search.aggs import parse_aggs as j_parse_aggs

from elasticsearch_tpu_torch.cluster.indices import IndexService
from elasticsearch_tpu_torch.cluster.service import ClusterError
from elasticsearch_tpu_torch.common.faults import faults
from elasticsearch_tpu_torch.ops import agg_kernels as tk
from elasticsearch_tpu_torch.search import aggs_device
from elasticsearch_tpu_torch.search import dsl
from elasticsearch_tpu_torch.search.aggs import parse_aggs
from elasticsearch_tpu_torch.search.batcher import live_batchers
from elasticsearch_tpu_torch.search.executor_torch import TorchExecutor

torch.set_num_threads(1)

WORDS = ["alpha", "beta", "gamma", "delta", "epsilon"]
CATS = ["red", "green", "blue", "black"]
DAY0 = 1_700_000_000_000
MAPPING = {
    "properties": {
        "body": {"type": "text"},
        "cat": {"type": "keyword"},
        "tags": {"type": "keyword"},
        "price": {"type": "double"},
        "qty": {"type": "integer"},
        "popularity": {"type": "integer"},
        "flag": {"type": "boolean"},
        "day": {"type": "date"},
        "huge": {"type": "double"},
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


def t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


# ---------------------------------------------------------------------------
# ops/agg_kernels.py
# ---------------------------------------------------------------------------


def layout(rng, n_docs, n_slots, nb, with_map=True):
    """A bucket-major slot permutation over `n_slots` slots (slot → doc
    map for multi-valued columns), its gate and boundaries, and a metric
    column sorted within each bucket."""
    ids = rng.integers(0, nb + 1, size=n_slots)  # nb = the missing bucket
    docs = rng.integers(0, n_docs, size=n_slots) if with_map else np.arange(n_slots)
    vals = rng.integers(-50, 50, size=n_slots).astype(np.float64)
    perm = np.lexsort((vals, ids))
    bounds = np.searchsorted(ids[perm], np.arange(nb + 1)).astype(np.int32)
    gate = (rng.random(n_slots) > 0.1)[perm]
    return (docs[perm].astype(np.int32), gate, bounds, vals[perm].astype(np.float32),
            np.where(gate, vals[perm], 0).astype(np.int32))


@pytest.mark.parametrize("seed", range(4))
def test_sorted_bucket_kernels_match_reference(seed):
    rng = np.random.default_rng(seed)
    n_docs = 500
    mask = rng.random(n_docs) > 0.4
    for n_slots, nb in ((n_docs, 7), (900, 13)):
        mp, gate, bounds, v, iv = layout(rng, n_docs, n_slots, nb, with_map=n_slots != n_docs)
        ref = jk.sorted_bucket_counts(jnp.asarray(mask), jnp.asarray(mp), jnp.asarray(gate),
                                      jnp.asarray(bounds))
        got = tk.sorted_bucket_counts(t(mask), t(mp), t(gate), t(bounds))
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
        ref = jk.sorted_bucket_metrics(jnp.asarray(mask), jnp.asarray(mp), jnp.asarray(gate),
                                       jnp.asarray(v), jnp.asarray(iv), jnp.asarray(bounds))
        got = tk.sorted_bucket_metrics(t(mask), t(mp), t(gate), t(v), t(iv), t(bounds))
        assert got[0].dtype == got[1].dtype == torch.int32
        for g, r in zip(got, ref):
            np.testing.assert_array_equal(g.numpy(), np.asarray(r))
    # a keyword column no doc of the segment holds: no slot at all
    empty = [t(np.zeros(0, dt)) for dt in (np.int32, bool, np.float32, np.int32)]
    bounds = t(np.zeros(4, np.int32))
    cnt, sm, mn, mx = tk.sorted_bucket_metrics(t(mask), *empty, bounds)
    assert cnt.tolist() == sm.tolist() == [0, 0, 0]
    assert mn.tolist() == [np.inf] * 3 and mx.tolist() == [-np.inf] * 3
    assert tk.sorted_bucket_counts(t(mask), empty[0], empty[1], bounds).tolist() == [0, 0, 0]


@pytest.mark.parametrize("seed", range(3))
def test_masked_kernels_match_reference(seed):
    rng = np.random.default_rng(seed)
    n = 400
    sel = rng.random(n) > 0.5
    vals = rng.integers(-1000, 1000, size=n).astype(np.float64)
    ivals = vals.astype(np.int32)
    scores = rng.random(n).astype(np.float32)
    for g, r in zip(tk.masked_metric(t(sel), t(vals), t(ivals)),
                    jk.masked_metric(jnp.asarray(sel), jnp.asarray(vals.astype(np.float32)),
                                     jnp.asarray(ivals))):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))
    for g, r in zip(tk.masked_sorted(t(sel), t(vals)),
                    jk.masked_sorted(jnp.asarray(sel), jnp.asarray(vals.astype(np.float32)))):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))
    for g, r in zip(tk.masked_total_and_max(t(sel), t(scores)),
                    jk.masked_total_and_max(jnp.asarray(sel), jnp.asarray(scores))):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))
    # two-word range membership over date millis (beyond float32 and int32)
    delta = rng.integers(0, 90 * 86_400_000, size=n)
    hi_w, lo_w = (delta >> 24).astype(np.int32), (delta & ((1 << 24) - 1)).astype(np.int32)
    exists = rng.random(n) > 0.1
    for lo_b, hi_b in ((0, 86_400_001), (12_345_677, 40 * 86_400_000 + 1), (-1, 90 * 86_400_000 + 2)):
        words = (*divmod(lo_b, 1 << 24), *divmod(hi_b, 1 << 24))
        ref = jk.wide_range_mask(jnp.asarray(hi_w), jnp.asarray(lo_w), jnp.asarray(exists),
                                 *(np.int32(w) for w in words))
        got = tk.wide_range_mask(t(hi_w), t(lo_w), t(exists), *(np.int32(w) for w in words))
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
        np.testing.assert_array_equal(got.numpy(), exists & (delta >= lo_b) & (delta < hi_b))
    assert tk.agg_flops(1000, 3) == jk.agg_flops(1000, 3)


# ---------------------------------------------------------------------------
# services: JAX (jax backend), port (torch, CPU), port numpy oracle
# ---------------------------------------------------------------------------


def _index_docs(svc, rng, n, start):
    for i in range(start, start + n):
        doc = {
            "body": " ".join(rng.choice(WORDS, size=int(rng.integers(1, 4)))),
            "cat": str(rng.choice(CATS)),
            "tags": [str(x) for x in rng.choice(CATS, size=int(rng.integers(0, 3)), replace=False)],
            "qty": int(rng.integers(0, 50)),
            "popularity": int(rng.integers(0, 100)),
            "flag": bool(rng.integers(0, 2)),
        }
        if rng.random() > 0.15:
            doc["price"] = int(rng.integers(1, 500))
        if rng.random() > 0.15:
            # ~90 days of millis: beyond float32 and one int32 offset
            doc["day"] = int(DAY0 + int(rng.integers(0, 90)) * 86_400_000)
        if rng.random() > 0.5:
            # outside the float32-exact window: sums/extrema go to the host
            doc["huge"] = float(rng.random() * 1e17 + 0.123456789)
        svc.index_doc(str(i), doc)


def make_services(n_docs=240, n_shards=2, seed=3, name="da"):
    out = {}
    for key, cls, backend, kw in (("jax", JIndexService, "jax", {}),
                                  ("torch", IndexService, "torch", {"device": "cpu"}),
                                  ("numpy", IndexService, "numpy", {"device": "cpu"})):
        rng = np.random.default_rng(seed)
        svc = cls(f"{name}-{key}-{n_shards}",
                  settings={"number_of_shards": n_shards, "search.backend": backend},
                  mappings_json=MAPPING, **kw)
        _index_docs(svc, rng, n_docs // 2, 0)
        svc.refresh()
        _index_docs(svc, rng, n_docs - n_docs // 2, n_docs // 2)
        svc.refresh()
        svc.delete_doc("7")
        svc.refresh()
        out[key] = svc
    return out


def close_all(svcs):
    for svc in svcs.values():
        svc.close()


@pytest.fixture(scope="module")
def trio():
    svcs = make_services()
    yield svcs
    close_all(svcs)


def rt(body):
    return json.loads(json.dumps(body))


def same_aggs(ref, got, what=""):
    """Aggregations equal; hits agree (totals, ids, scores rtol 1e-5)."""
    assert got["aggregations"] == ref["aggregations"], what
    assert got["hits"]["total"] == ref["hits"]["total"], what
    rh, gh = ref["hits"]["hits"], got["hits"]["hits"]
    assert [h["_id"] for h in gh] == [h["_id"] for h in rh], what
    np.testing.assert_allclose([h["_score"] for h in gh], [h["_score"] for h in rh], rtol=1e-5)


def check_parity(svcs, body, expect_device=True):
    before = aggs_device.stats_snapshot()
    got = svcs["torch"].search(rt(body))
    same_aggs(svcs["numpy"].search(rt(body)), got, f"numpy {body}")
    same_aggs(svcs["jax"].search(rt(body)), got, f"jax {body}")
    after = aggs_device.stats_snapshot()
    assert (after["device_routed"] > before["device_routed"]) == expect_device, body
    return got


# the reference's tests/test_aggs_device.py parity bodies
PARITY_BODIES = [
    {"size": 0, "aggs": {
        "s": {"stats": {"field": "price"}},
        "a": {"avg": {"field": "qty"}},
        "mn": {"min": {"field": "price"}},
        "mx": {"max": {"field": "price"}},
        "vc": {"value_count": {"field": "qty"}},
        "p": {"percentiles": {"field": "price", "percents": [5, 50, 95]}},
    }},
    {"size": 0, "query": {"match": {"body": "alpha"}},
     "aggs": {"cats": {"terms": {"field": "cat"},
                       "aggs": {"q": {"avg": {"field": "qty"}}, "st": {"stats": {"field": "price"}}}}}},
    {"size": 0, "aggs": {"tags": {"terms": {"field": "tags", "size": 2}}}},
    {"size": 0, "aggs": {"ka": {"terms": {"field": "cat", "order": {"_key": "asc"}}}}},
    {"size": 0, "aggs": {"nt": {"terms": {"field": "qty", "size": 5},
                                "aggs": {"m": {"max": {"field": "price"}}}}}},
    {"size": 0, "aggs": {"bt": {"terms": {"field": "flag"}}}},
    {"size": 0, "aggs": {"qh": {"histogram": {"field": "qty", "interval": 10},
                                "aggs": {"m": {"sum": {"field": "qty"}}}}}},
    {"size": 0, "aggs": {"dh": {"date_histogram": {"field": "day", "fixed_interval": "7d"}}}},
    {"size": 0, "aggs": {"pr": {"range": {
        "field": "price", "ranges": [{"to": 100}, {"from": 100, "to": 300}, {"from": 300}]},
        "aggs": {"q": {"sum": {"field": "qty"}}}}}},
    {"size": 0, "aggs": {"dr": {"date_range": {
        "field": "day", "ranges": [{"to": "2023-12-15"}, {"from": "2023-12-15"}]}}}},
    {"size": 0, "aggs": {"f": {"filter": {"term": {"cat": "red"}},
                               "aggs": {"q": {"avg": {"field": "qty"}}}}}},
    {"size": 0, "aggs": {"fs": {"filters": {"filters": {
        "r": {"term": {"cat": "red"}}, "hi": {"range": {"qty": {"gte": 25}}}}}}}},
    {"size": 0, "query": {"bool": {"must": [{"match": {"body": "beta"}}],
                                   "filter": [{"range": {"qty": {"gte": 10}}}]}},
     "aggs": {"s": {"sum": {"field": "qty"}}, "cats": {"terms": {"field": "cat"}}}},
    {"size": 4, "query": {"match": {"body": "gamma delta"}},
     "aggs": {"cats": {"terms": {"field": "cat"}}}},
    {"size": 0, "aggs": {"s": {"stats": {"field": "qty"}}}},
    # a pipeline agg beside a device bucket node (reduced on the host)
    {"size": 0, "aggs": {"qh": {"histogram": {"field": "qty", "interval": 10},
                                "aggs": {"m": {"sum": {"field": "qty"}}}},
                         "best": {"max_bucket": {"buckets_path": "qh>m"}}}},
]


@pytest.mark.parametrize("i", range(len(PARITY_BODIES)))
def test_device_agg_plan_matches_reference_and_host(trio, i):
    check_parity(trio, PARITY_BODIES[i])


# try_compile's decision: device (True) or host (False), as the reference
DECISION_BODIES = {
    "terms": ({"t": {"terms": {"field": "cat"}}}, True),
    "terms_numeric": ({"t": {"terms": {"field": "qty"}}}, True),
    "terms_unmapped": ({"t": {"terms": {"field": "nope"}}}, False),
    "terms_count_asc": ({"t": {"terms": {"field": "cat", "order": {"_count": "asc"}}}}, True),
    "histogram": ({"h": {"histogram": {"field": "qty", "interval": 5}}}, True),
    "histogram_fraction": ({"h": {"histogram": {"field": "qty", "interval": 2.5}}}, False),
    "date_histogram": ({"d": {"date_histogram": {"field": "day", "fixed_interval": "1d"}}}, True),
    "date_histogram_calendar": ({"d": {"date_histogram": {"field": "day", "calendar_interval": "month"}}}, False),
    "range": ({"r": {"range": {"field": "qty", "ranges": [{"to": 10}, {"from": 10}]}}}, True),
    "date_range": ({"r": {"date_range": {"field": "day", "ranges": [{"from": "2023-11-20"}]}}}, True),
    "stats": ({"s": {"stats": {"field": "qty"}}}, True),
    "avg": ({"a": {"avg": {"field": "price"}}}, True),
    "min": ({"m": {"min": {"field": "price"}}}, True),
    "max": ({"m": {"max": {"field": "price"}}}, True),
    "max_date_millis": ({"m": {"max": {"field": "day"}}}, False),
    "sum_huge": ({"s": {"sum": {"field": "huge"}}}, False),
    "percentiles": ({"p": {"percentiles": {"field": "qty"}}}, True),
    "percentiles_under_terms": ({"t": {"terms": {"field": "cat"},
                                       "aggs": {"p": {"percentiles": {"field": "qty"}}}}}, False),
    "filter": ({"f": {"filter": {"range": {"qty": {"lt": 20}}}}}, True),
    "filters": ({"f": {"filters": {"filters": [{"term": {"cat": "red"}}, {"term": {"cat": "blue"}}]}}}, True),
    "sub_aggs": ({"t": {"terms": {"field": "cat"}, "aggs": {"a": {"avg": {"field": "qty"}},
                                                            "m": {"min": {"field": "price"}}}}}, True),
    "deep_nesting": ({"t": {"terms": {"field": "cat"}, "aggs": {"i": {"terms": {"field": "tags"}}}}}, False),
    "cardinality": ({"c": {"cardinality": {"field": "cat"}}}, False),
    "keyword_metric": ({"m": {"value_count": {"field": "cat"}}}, False),
    "pipeline": ({"h": {"histogram": {"field": "qty", "interval": 10},
                        "aggs": {"d": {"cumulative_sum": {"buckets_path": "_count"}}}}}, True),
}


@pytest.mark.parametrize("name", sorted(DECISION_BODIES))
def test_try_compile_decision_matches_reference(trio, name):
    aggs_json, device = DECISION_BODIES[name]
    jsvc, tsvc = trio["jax"], trio["torch"]
    q = {"match": {"body": "alpha"}}
    for sid in range(2):
        jex = jsvc._executor(jsvc.shards[sid])
        tex = tsvc._executor(tsvc.shards[sid])
        assert isinstance(tex, TorchExecutor)
        from elasticsearch_tpu.search import dsl as jdsl

        jplan = jaggs.try_compile(jex, j_parse_aggs(rt(aggs_json)), jsvc.mappings, jsvc.name, sid,
                                  jdsl.parse_query(q), 10)
        tplan = aggs_device.try_compile(tex, parse_aggs(rt(aggs_json)), tsvc.mappings, tsvc.name, sid,
                                        dsl.parse_query(q), 10)
        assert (tplan is not None) == (jplan is not None) == device, name
        if tplan is not None:
            assert tplan.sig == jplan.sig
    check_parity(trio, {"size": 0, "query": q, "aggs": aggs_json}, expect_device=device)


def test_plan_dispatch_collect_matches_reference_partials(trio):
    """DeviceAggPlan.dispatch/collect on one shard: the partials equal
    the reference plan's and the host AggCollector's over the oracle's
    masks; the top hits agree."""
    from elasticsearch_tpu.search import dsl as jdsl
    from elasticsearch_tpu_torch.search.aggs import AggCollector

    jsvc, tsvc = trio["jax"], trio["torch"]
    body = PARITY_BODIES[1]["aggs"] | PARITY_BODIES[8]["aggs"] | PARITY_BODIES[7]["aggs"]
    q = {"match": {"body": "beta gamma"}}
    for sid in range(2):
        jex, tex = jsvc._executor(jsvc.shards[sid]), tsvc._executor(tsvc.shards[sid])
        jplan = jaggs.try_compile(jex, j_parse_aggs(rt(body)), jsvc.mappings, "x", sid, jdsl.parse_query(q), 5)
        tplan = aggs_device.try_compile(tex, parse_aggs(rt(body)), tsvc.mappings, "x", sid, dsl.parse_query(q), 5)
        jtd, jparts = jplan.collect(jplan.dispatch())
        ttd, tparts = tplan.collect(tplan.dispatch())
        assert tparts == jparts
        _td, masks = tex._oracle.execute(dsl.parse_query(q), size=5)
        assert AggCollector(tex._oracle).collect(parse_aggs(rt(body)), masks) == tparts
        assert ttd.total == jtd.total and ttd.relation == jtd.relation == "eq"
        assert [h.doc_id for h in ttd.hits] == [h.doc_id for h in jtd.hits]
        np.testing.assert_allclose([h.score for h in ttd.hits], [h.score for h in jtd.hits], rtol=1e-5)


def test_execute_with_terms_aggs_matches_reference(trio):
    from elasticsearch_tpu.search import dsl as jdsl

    jsvc, tsvc = trio["jax"], trio["torch"]
    body = {"c": {"terms": {"field": "cat"}}, "t": {"terms": {"field": "tags", "size": 2}}}
    for q in ({"match": {"body": "alpha beta"}}, None):
        for sid in range(2):
            jex, tex = jsvc._executor(jsvc.shards[sid]), tsvc._executor(tsvc.shards[sid])
            jtd, jparts = jex.execute_with_terms_aggs(
                jdsl.parse_query(q) if q else None, j_parse_aggs(rt(body)), 6, 10_000)
            ttd, tparts = tex.execute_with_terms_aggs(
                dsl.parse_query(q) if q else None, parse_aggs(rt(body)), 6, 10_000)
            assert tparts == jparts
            assert ttd.total == jtd.total
            assert [h.doc_id for h in ttd.hits] == [h.doc_id for h in jtd.hits]
            np.testing.assert_allclose([h.score for h in ttd.hits], [h.score for h in jtd.hits],
                                       rtol=1e-5)
    tex = tsvc._executor(tsvc.shards[0])
    assert tex.execute_with_terms_aggs(None, parse_aggs({"s": {"sum": {"field": "qty"}}}), 5, 10) is None


def test_terms_pass_serves_when_device_compiler_is_off(trio, monkeypatch):
    """ES_TPU_DEVICE_AGGS=off: keyword terms still bucket on the device
    in the query pass (execute_with_terms_aggs); anything else is host."""
    monkeypatch.setenv("ES_TPU_DEVICE_AGGS", "off")
    calls = []
    real = TorchExecutor.execute_with_terms_aggs

    def spy(self, *a):
        got = real(self, *a)
        calls.append(got is not None)
        return got

    monkeypatch.setattr(TorchExecutor, "execute_with_terms_aggs", spy)
    for body, host in (({"size": 3, "request_cache": False, "query": {"match": {"body": "delta"}},
                         "aggs": {"c": {"terms": {"field": "cat"}}}}, 0),
                       ({"size": 0, "request_cache": False,
                         "aggs": {"s": {"stats": {"field": "qty"}}}}, 2)):
        before = aggs_device.stats_snapshot()
        got = trio["torch"].search(rt(body))
        after = aggs_device.stats_snapshot()
        assert after["host_routed"] == before["host_routed"] + host  # one per shard
        assert after["device_routed"] == before["device_routed"]
        same_aggs(trio["numpy"].search(rt(body)), got)
    assert calls == [True, True, False, False]  # two shards per body


def test_force_mode_raises_the_routing_reason(trio, monkeypatch):
    monkeypatch.setenv("ES_TPU_DEVICE_AGGS", "force")
    check_parity(trio, {"size": 0, "request_cache": False, "aggs": {"s": {"stats": {"field": "qty"}}}})
    with pytest.raises(ClusterError, match="float32"):
        trio["torch"].search({"size": 0, "request_cache": False,
                              "aggs": {"s": {"sum": {"field": "huge"}}}})


def bench_agg_bodies():
    """bench.py's `repeated_agg` and `cold_agg` shapes (its config 7 and
    8) over this corpus's words."""
    repeated = [{"size": 0, "query": {"match": {"body": w}},
                 "aggs": {"pop_avg": {"avg": {"field": "popularity"}}}} for w in WORDS]
    cold = [{"size": 0, "request_cache": False, "query": {"match": {"body": f"{a} {b}"}},
             "aggs": {"by_day": {"date_histogram": {"field": "day", "fixed_interval": "1d"}},
                      "cats": {"terms": {"field": "cat"}},
                      "pop": {"stats": {"field": "popularity"}}}}
            for a, b in zip(WORDS, WORDS[1:])]
    return repeated, cold


def test_bench_repeated_and_cold_agg_shapes(trio):
    repeated, cold = bench_agg_bodies()
    for body in cold:
        check_parity(trio, body)
    from elasticsearch_tpu_torch.search.query_cache import request_cache

    tsvc, ref = trio["torch"], trio["numpy"]
    hits0 = request_cache.node_stats()["hit_count"]
    for _round in range(2):  # the second round is answered by the request cache
        for body in repeated:
            got = tsvc.search(rt(body))
            want = ref.search(rt(body))
            g, w = got["aggregations"]["pop_avg"]["value"], want["aggregations"]["pop_avg"]["value"]
            assert abs(g - w) <= 1e-12 * abs(w), (g, w)
            assert got["hits"]["total"] == want["hits"]["total"]
    assert request_cache.node_stats()["hit_count"] >= hits0 + 2 * len(repeated)


# ---------------------------------------------------------------------------
# the host route after a compiled plan: injected fault and breaker only
# ---------------------------------------------------------------------------


def test_injected_fault_takes_the_host_route(trio):
    body = {"size": 0, "request_cache": False, "aggs": {"s": {"stats": {"field": "qty"}}}}
    want = trio["numpy"].search(rt(body))["aggregations"]
    faults.configure({"rules": [{"site": "aggs.collect", "kind": "error"}]})
    try:
        before = aggs_device.stats_snapshot()
        assert trio["torch"].search(rt(body))["aggregations"] == want
        after = aggs_device.stats_snapshot()
    finally:
        faults.clear()
    assert after["fallbacks"] == before["fallbacks"] + 2  # one per shard
    assert after["host_routed"] == before["host_routed"] + 2
    assert after["device_routed"] == before["device_routed"]


def test_runtime_error_in_dispatch_fails_the_request(trio, monkeypatch):
    def boom(self):
        raise RuntimeError("CUDA error: unspecified launch failure")

    monkeypatch.setattr(aggs_device.DeviceAggPlan, "dispatch", boom)
    before = aggs_device.stats_snapshot()
    with pytest.raises(ClusterError, match="unspecified launch failure"):
        trio["torch"].search({"size": 0, "request_cache": False,
                              "aggs": {"s": {"stats": {"field": "qty"}}}})
    after = aggs_device.stats_snapshot()
    assert after["host_routed"] == before["host_routed"]
    assert after["fallbacks"] == before["fallbacks"]


def test_cut_query_node_raises_through_the_agg_plan(trio):
    """The plan runs the body's query through the port's `_exec`: a node
    the port still cuts raises naming its item there."""
    with pytest.raises(NotImplementedError, match="ROADMAP queue 1 item 16"):
        trio["torch"].search({"size": 0, "request_cache": False,
                              "query": {"match_phrase": {"body": "alpha beta"}},
                              "aggs": {"s": {"stats": {"field": "qty"}}}})


def test_host_routed_percentiles_under_terms(trio):
    """A tree the device compiler does not take goes to AggCollector
    over the query's masks (note_host_routed), and equals the oracle."""
    body = {"size": 2, "query": {"match": {"body": "epsilon"}},
            "aggs": {"c": {"terms": {"field": "cat"},
                           "aggs": {"p": {"percentiles": {"field": "qty", "percents": [25, 75]}}}}}}
    before = aggs_device.stats_snapshot()
    check_parity(trio, body, expect_device=False)
    assert aggs_device.stats_snapshot()["host_routed"] > before["host_routed"]


def test_single_shard_and_budget_breach(monkeypatch):
    """One shard, three segments: parity; a budget that holds no agg
    column sends the tree to the host when its dispatch meets it."""
    from elasticsearch_tpu_torch.common.memory import hbm_ledger

    svcs = make_services(n_docs=120, n_shards=1, seed=11, name="ds")
    try:
        for body in PARITY_BODIES[:8]:
            check_parity(svcs, body)
        body = {"size": 0, "request_cache": False,
                "aggs": {"dh": {"date_histogram": {"field": "day", "fixed_interval": "30d"}}}}
        svcs["torch"].index_doc("extra", {"day": DAY0, "qty": 1})
        svcs["torch"].refresh()
        svcs["numpy"].index_doc("extra", {"day": DAY0, "qty": 1})
        svcs["numpy"].refresh()
        monkeypatch.setattr(hbm_ledger, "budget", 0)
        before = aggs_device.stats_snapshot()
        got = svcs["torch"].search(rt(body))
        assert got["aggregations"] == svcs["numpy"].search(rt(body))["aggregations"]
        after = aggs_device.stats_snapshot()
        assert after["device_routed"] == before["device_routed"]
        assert after["fallbacks"] == before["fallbacks"] + 1
    finally:
        close_all(svcs)


def test_nodes_stats_aggs_block(trio):
    snap = aggs_device.stats_snapshot()
    assert sorted(snap) == sorted(jaggs.stats_snapshot())
    assert trio["torch"]._batcher.stats["agg_jobs"] > 0
