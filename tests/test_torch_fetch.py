"""The port's fetch extras and scripts against the JAX package, on the CPU.

Two REST servers on `port=0`: the JAX package's with a `numpy`-backend
index (the reference's host oracle) and the port's with a
`torch`-backend index (`device="cpu"`), fed the same documents. Both
must give the same answers for `highlight` (plain, with tags, several
fields), `script_fields`, the `script`, `script_score` and
`function_score` script query nodes, an update script, `_reindex`,
`_update_by_query` and `_delete_by_query`: the same totals and ids,
scores within rtol 1e-5 (a run of near-ties as a set), equal highlight
fragments, script fields and sources.

The port's own copies of `script/`, `search/highlight.py` and
`reindex.py` also repair four imports of its verbatim copies: an ingest
`if` condition and `script` processor (ingest/service.py), a
`bucket_script`/`bucket_selector` aggregation (search/aggs.py) and a
plugin's script bindings (plugins.py). Each is held to the JAX package
here.
"""

import json
import urllib.error
import urllib.request

import numpy as np
import pytest

from elasticsearch_tpu.plugins import Plugin as JPlugin
from elasticsearch_tpu.plugins import PluginsService as JPluginsService
from elasticsearch_tpu.rest.server import ElasticsearchTpuServer as JServer
from elasticsearch_tpu.script import service as jscript

from elasticsearch_tpu_torch.plugins import Plugin, PluginsService
from elasticsearch_tpu_torch.rest.server import ElasticsearchTpuServer
from elasticsearch_tpu_torch.script import service as tscript
from elasticsearch_tpu_torch.search.batcher import live_batchers

RTOL = 1e-5
WORDS = ["quick", "brown", "fox", "lazy", "dog", "jumps", "over", "river", "stone"]
MAPPING = {
    "properties": {
        "body": {"type": "text"},
        "title": {"type": "text"},
        "tag": {"type": "keyword"},
        "rank": {"type": "integer"},
        "month": {"type": "integer"},
        "price": {"type": "double"},
    }
}


@pytest.fixture(autouse=True)
def _reset_port_singletons():
    yield
    from elasticsearch_tpu_torch.common.faults import faults
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


def call(port, method, path, body=None, ndjson=None):
    data, headers = None, {}
    if ndjson is not None:
        data = "".join(json.dumps(x) + "\n" for x in ndjson).encode()
        headers["Content-Type"] = "application/x-ndjson"
    elif body is not None:
        data = json.dumps(body).encode()
        headers["Content-Type"] = "application/json"
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=data, method=method, headers=headers
    )
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def make_docs(n, seed):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        src = {
            "body": " ".join(rng.choice(WORDS, int(rng.integers(3, 12)))),
            "tag": str(rng.choice(["a", "b", "c"])),
            "rank": int(rng.integers(0, 20)),
            "month": int(rng.integers(1, 5)),
            "price": float(rng.integers(1, 40) * 10),
        }
        if i % 3 == 0:
            src["title"] = " ".join(rng.choice(WORDS, 3))
        out.append((f"d{i}", src))
    return out


def create(port, index, backend, docs):
    status, out = call(port, "PUT", f"/{index}", {
        "settings": {"number_of_shards": 2, "search.backend": backend},
        "mappings": MAPPING,
    })
    assert status == 200, out
    lines = []
    for doc_id, src in docs:
        lines += [{"index": {"_id": doc_id}}, src]
    status, out = call(port, "POST", f"/{index}/_bulk?refresh=true", ndjson=lines)
    assert status == 200 and not out["errors"], out


@pytest.fixture(scope="module")
def servers():
    """(JAX server on numpy, port server on torch), each with index `f`
    of 2 shards holding the same 120 docs."""
    pair = (JServer(port=0), ElasticsearchTpuServer(port=0, device="cpu"))
    docs = make_docs(120, seed=5)
    for srv, backend in zip(pair, ("numpy", "torch")):
        srv.start_background()
        create(srv.port, "f", backend, docs)
    yield pair
    for srv in pair:
        srv.close()


def both(servers, method, path, body=None):
    (jsrv, tsrv) = servers
    s1, ref = call(jsrv.port, method, path, body)
    s2, got = call(tsrv.port, method, path, body)
    assert s1 == s2, (path, ref, got)
    return ref, got


def same_hits(ref, got):
    """Same totals and ids (a run of scores tied within RTOL as a set),
    scores within RTOL, and the same fetch extras hit by hit."""
    rh, gh = ref["hits"]["hits"], got["hits"]["hits"]
    assert ref["hits"]["total"] == got["hits"]["total"]
    assert len(rh) == len(gh)
    assert rh, "a check needs hits"
    i = 0
    while i < len(rh):
        j = i + 1
        s = rh[i]["_score"]
        while s is not None and j < len(rh) and np.isclose(rh[j]["_score"], s, rtol=RTOL):
            j += 1
        assert {h["_id"] for h in rh[i:j]} == {h["_id"] for h in gh[i:j]}
        i = j
    by_id = {h["_id"]: h for h in gh}
    for h in rh:
        g = by_id[h["_id"]]
        if h["_score"] is None:
            assert g["_score"] is None
        else:
            np.testing.assert_allclose(g["_score"], h["_score"], rtol=RTOL)
        for key in ("highlight", "fields", "_source"):
            assert g.get(key) == h.get(key), (h["_id"], key)


HIGHLIGHTS = {
    "plain": {"query": {"match": {"body": "fox"}},
              "highlight": {"fields": {"body": {}}}},
    "tags": {"query": {"match": {"body": "lazy dog"}},
             "highlight": {"pre_tags": ["<b>"], "post_tags": ["</b>"],
                           "fields": {"body": {"fragment_size": 20, "number_of_fragments": 2}}}},
    "several_fields": {"query": {"multi_match": {"query": "river stone", "fields": ["body", "title"]}},
                       "highlight": {"fields": {"body": {}, "title": {}}}},
}


@pytest.mark.parametrize("name", sorted(HIGHLIGHTS))
def test_highlight_matches_reference(servers, name):
    ref, got = both(servers, "POST", "/f/_search", {**HIGHLIGHTS[name], "size": 20})
    assert any("highlight" in h for h in ref["hits"]["hits"])
    same_hits(ref, got)


def test_script_fields_match_reference(servers):
    ref, got = both(servers, "POST", "/f/_search", {
        "query": {"match": {"body": "quick"}}, "size": 15,
        "script_fields": {
            "double_rank": {"script": {"source": "doc['rank'].value * 2"}},
            "label": {"script": "'rank ' + str(doc['rank'].value)"},
        },
    })
    assert all("fields" in h for h in ref["hits"]["hits"])
    same_hits(ref, got)


SCRIPT_NODES = {
    "script": {"bool": {"must": [{"match": {"body": "dog"}}],
                        "filter": [{"script": {"script": {"source": "doc['rank'].value > 5"}}}]}},
    "script_score": {"script_score": {"query": {"match": {"body": "fox"}},
                                      "script": {"source": "_score * 2 + doc['rank'].value",
                                                 "params": {}}}},
    "function_score": {"function_score": {"query": {"match": {"body": "brown"}},
                                          "functions": [{"script_score": {"script": {
                                              "source": "doc['rank'].value * params.f",
                                              "params": {"f": 0.5}}}}],
                                          "boost_mode": "sum"}},
}


@pytest.mark.parametrize("name", sorted(SCRIPT_NODES))
def test_script_query_nodes_match_reference(servers, name):
    ref, got = both(servers, "POST", "/f/_search", {"query": SCRIPT_NODES[name], "size": 20})
    same_hits(ref, got)


def test_script_query_inside_device_agg_plan_matches_reference(servers):
    """A size-0 terms aggregation whose query is a script node: the
    port's device agg plan takes the node through its host oracle, as
    the reference's does."""
    body = {"size": 0, "request_cache": False,
            "query": {"script": {"script": {"source": "doc['rank'].value >= 10"}}},
            "aggs": {"t": {"terms": {"field": "tag"}, "aggs": {"p": {"sum": {"field": "price"}}}}}}
    (_, tsrv) = servers
    _, before = call(tsrv.port, "GET", "/_nodes/stats")
    ref, got = both(servers, "POST", "/f/_search", body)
    _, after = call(tsrv.port, "GET", "/_nodes/stats")
    assert ref["hits"]["total"] == got["hits"]["total"]
    assert ref["aggregations"] == got["aggregations"]
    routed = [s["nodes"]["node-0"]["aggs"]["device_routed"] for s in (before, after)]
    assert routed[1] > routed[0]


def _docs_equal(servers, index, ids):
    for doc_id in ids:
        ref, got = both(servers, "GET", f"/{index}/_doc/{doc_id}")
        assert ref.get("found") == got.get("found"), doc_id
        assert ref.get("_source") == got.get("_source"), doc_id


def test_update_script_matches_reference(servers):
    for op in ({"script": {"source": "ctx['_source']['rank'] = ctx['_source']['rank'] + params.n",
                           "params": {"n": 7}}},
               {"script": {"source": "ctx['op'] = 'noop'"}},
               {"script": {"source": "ctx['_source']['tag'] = 'z'"}}):
        ref, got = both(servers, "POST", "/f/_update/d4?refresh=true", op)
        assert ref["result"] == got["result"]
        assert ref["_version"] == got["_version"]
    _docs_equal(servers, "f", ["d4"])


def test_reindex_matches_reference(servers):
    ref, got = both(servers, "POST", "/_reindex?refresh=true", {
        "source": {"index": "f", "query": {"match": {"body": "river"}}},
        "dest": {"index": "f_copy"},
        "script": {"source": "ctx['_source']['rank'] = ctx['_source']['rank'] * 10"},
    })
    for key in ("total", "created", "updated", "noops", "failures"):
        assert ref[key] == got[key], key
    assert ref["created"] > 0
    ref, got = both(servers, "POST", "/f_copy/_search", {"query": {"match_all": {}}, "size": 200})
    same_hits(ref, got)


def test_update_by_query_matches_reference(servers):
    ref, got = both(servers, "POST", "/f/_update_by_query?refresh=true", {
        "query": {"term": {"tag": "b"}},
        "script": {"source": "ctx['_source']['month'] = 9"},
    })
    for key in ("total", "updated", "noops", "failures"):
        assert ref[key] == got[key], key
    assert ref["updated"] > 0
    ref, got = both(servers, "POST", "/f/_search", {"query": {"term": {"month": 9}}, "size": 200})
    same_hits(ref, got)


def test_delete_by_query_matches_reference(servers):
    (jsrv, tsrv) = servers
    docs = make_docs(40, seed=9)
    create(jsrv.port, "g", "numpy", docs)
    create(tsrv.port, "g", "torch", docs)
    ref, got = both(servers, "POST", "/g/_delete_by_query?refresh=true", {
        "query": {"match": {"body": "stone"}},
    })
    assert ref["deleted"] == got["deleted"] > 0
    ref, got = both(servers, "POST", "/g/_search", {"query": {"match": {"body": "dog"}}, "size": 50})
    same_hits(ref, got)


# ---- the four repaired import sites ----


@pytest.mark.parametrize("site,processors,doc", [
    ("if_condition", [{"drop": {"if": "ctx['status'] == 'spam'"}},
                      {"set": {"field": "kept", "value": True, "if": "ctx['n'] > 2"}}],
     [{"status": "spam", "n": 5}, {"status": "ham", "n": 5}, {"status": "ham", "n": 1}]),
    ("script_processor", [{"script": {"source": "ctx['total'] = ctx['a'] + ctx['b'] * params.m",
                                      "params": {"m": 10}}}],
     [{"a": 1, "b": 2}, {"a": -4, "b": 0.5}]),
])
def test_ingest_script_sites_match_reference(servers, site, processors, doc):
    both(servers, "PUT", f"/_ingest/pipeline/{site}", {"processors": processors})
    for i, src in enumerate(doc):
        ref, got = both(servers, "PUT", f"/ing/_doc/{site}{i}?pipeline={site}&refresh=true", src)
        assert ref.get("result") == got.get("result")
    _docs_equal(servers, "ing", [f"{site}{i}" for i in range(len(doc))])


def test_bucket_script_and_selector_match_reference(servers):
    ref, got = both(servers, "POST", "/f/_search", {
        "size": 0, "request_cache": False,
        "aggs": {"months": {
            "histogram": {"field": "month", "interval": 1},
            "aggs": {
                "sales": {"sum": {"field": "price"}},
                "per_doc": {"bucket_script": {"buckets_path": {"s": "sales", "n": "_count"},
                                              "script": "s / n"}},
                "big_only": {"bucket_selector": {"buckets_path": {"s": "sales"},
                                                 "script": "s > 1000"}},
            },
        }},
    })
    assert ref["aggregations"]["months"]["buckets"]
    assert got["aggregations"] == ref["aggregations"]


def test_plugin_script_bindings_match_reference():
    """A plugin's script bindings land in the port's own script service
    (plugins.py), and a script calling one answers as the reference."""
    added = []
    for plugin_cls, service_cls, mod in ((JPlugin, JPluginsService, jscript),
                                         (Plugin, PluginsService, tscript)):
        class Triple(plugin_cls):
            name = "triple"

            def get_script_contexts(self):
                return {"triple": lambda x: 3 * x}

        service_cls().install(Triple())
        added.append(mod)
    try:
        src = {"source": "triple(doc['rank'].value) + params.k", "params": {"k": 1}}
        lookup = {"rank": [4]}.get
        assert tscript.script_service.run_field(src, lookup) == jscript.script_service.run_field(src, lookup) == 13
    finally:
        for mod in added:
            mod._SAFE_BUILTINS.pop("triple", None)
