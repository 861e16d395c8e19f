"""The port's REST server against the JAX package's, over HTTP on the
CPU: both serve on `port=0` on the loopback, take the same `PUT`,
`_bulk?refresh=true`, deletes and searches, and must answer with the
same JSON hits (same totals and ids, scores within rtol 1e-5). The
port's server runs with `device="cpu"`, as tests must."""

import json
import urllib.error
import urllib.request

import numpy as np
import pytest

from elasticsearch_tpu.rest.server import ElasticsearchTpuServer as JServer

from elasticsearch_tpu_torch.rest.server import ElasticsearchTpuServer
from elasticsearch_tpu_torch.search.batcher import live_batchers
from elasticsearch_tpu_torch.search.executor_torch import TorchExecutor

RTOL = 1e-5
DIMS = 8
WORDS = ["red", "green", "blue", "cyan", "magenta", "yellow", "black", "white", "grey"]
MAPPING = {
    "properties": {
        "body": {"type": "text"},
        "vec": {"type": "dense_vector", "dims": DIMS, "similarity": "cosine"},
    }
}


@pytest.fixture(autouse=True)
def _reset_port_singletons():
    """The port's own admission controller and fault registry (the
    conftest resets only the JAX package's)."""
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


def bulk_lines(docs):
    out = []
    for doc_id, src in docs:
        out += [{"index": {"_id": doc_id}}, src]
    return out


def make_docs(n, seed):
    rng = np.random.default_rng(seed)
    w = 1.0 / np.arange(1, len(WORDS) + 1)
    w /= w.sum()
    return [
        (f"r{i}", {"body": " ".join(rng.choice(WORDS, int(rng.integers(2, 12)), p=w)),
                   "vec": [float(x) for x in rng.normal(size=DIMS)]})
        for i in range(n)
    ]


@pytest.fixture(scope="module")
def servers():
    """(JAX server, port server), each with index `r` (2 shards) built by
    two `_bulk?refresh=true` calls and two deletes."""
    pair = (JServer(port=0), ElasticsearchTpuServer(port=0, device="cpu"))
    docs = make_docs(240, seed=8)
    for srv, backend in zip(pair, ("jax", "torch")):
        srv.start_background()
        status, out = call(srv.port, "PUT", "/r", {
            "settings": {"number_of_shards": 2, "search.backend": backend},
            "mappings": MAPPING,
        })
        assert status == 200, out
        for part in (docs[:120], docs[120:]):
            status, out = call(srv.port, "POST", "/r/_bulk?refresh=true", ndjson=bulk_lines(part))
            assert status == 200 and not out["errors"], out
        for doc_id in ("r3", "r130"):
            status, _ = call(srv.port, "DELETE", f"/r/_doc/{doc_id}?refresh=true")
            assert status == 200
    yield pair
    for srv in pair:
        srv.close()


def knn(i, k=5, nc=20):
    rng = np.random.default_rng(40 + i)
    return {"field": "vec", "query_vector": [float(x) for x in rng.normal(size=DIMS)],
            "k": k, "num_candidates": nc}


SEARCHES = [
    {"query": {"match": {"body": "red green"}}},
    {"query": {"match": {"body": {"query": "blue cyan black", "operator": "and"}}}, "size": 20},
    {"query": {"match": {"body": "white"}}, "size": 3, "from": 2},
    {"query": {"match": {"body": "grey magenta"}}, "track_total_hits": True, "_source": False},
    {"knn": knn(0)},
    {"knn": knn(1, k=8, nc=8), "size": 4},
]


@pytest.mark.parametrize("i", range(len(SEARCHES)))
def test_search_matches_reference_server(servers, i):
    jsrv, tsrv = servers
    s1, ref = call(jsrv.port, "POST", "/r/_search", SEARCHES[i])
    s2, got = call(tsrv.port, "POST", "/r/_search", SEARCHES[i])
    assert s1 == s2 == 200, got
    assert got["hits"]["total"] == ref["hits"]["total"]
    assert got["_shards"] == ref["_shards"]
    rh, gh = ref["hits"]["hits"], got["hits"]["hits"]
    assert len(gh) == len(rh)
    rs = np.array([h["_score"] for h in rh])
    np.testing.assert_allclose([h["_score"] for h in gh], rs, rtol=RTOL, atol=1e-6)
    # ids position by position; a run of scores tied within RTOL as a set
    i = 0
    while i < len(rh):
        j = i + 1
        while j < len(rh) and np.isclose(rs[j], rs[j - 1], rtol=RTOL, atol=0):
            j += 1
        assert {h["_id"] for h in gh[i:j]} == {h["_id"] for h in rh[i:j]}, (rh, gh)
        i = j
    by_id = {h["_id"]: h for h in rh}
    for g in gh:
        assert g.get("_source") == by_id[g["_id"]].get("_source")


@pytest.mark.parametrize("body", [None, {"query": {"match": {"body": "red"}}}])
def test_count_matches_reference_server(servers, body):
    jsrv, tsrv = servers
    _, ref = call(jsrv.port, "POST", "/r/_count", body)
    status, got = call(tsrv.port, "POST", "/r/_count", body)
    assert status == 200 and got["count"] == ref["count"]


def test_served_by_the_ports_executor_and_batcher(servers):
    _, tsrv = servers
    idx = tsrv.cluster.get_index("r")
    assert all(isinstance(idx._executor(e), TorchExecutor) for e in idx.shards)
    for body in SEARCHES[:2]:
        assert call(tsrv.port, "POST", "/r/_search", body)[0] == 200
    status, stats = call(tsrv.port, "GET", "/_nodes/stats")
    assert status == 200
    search = stats["nodes"]["node-0"]["thread_pool"]["search"]
    assert search["launches"] > 0 and search["chunked_jobs"] > 0
    assert "batching" in stats["nodes"]["node-0"]["pipeline"]


@pytest.mark.parametrize("backend", ["jax", "foo"])
def test_unknown_backend_is_a_400(servers, backend):
    _, tsrv = servers
    status, out = call(tsrv.port, "PUT", f"/b_{backend}",
                       {"settings": {"search.backend": backend}})
    assert status == 400 and "search.backend" in json.dumps(out)


@pytest.mark.parametrize("body,item", [
    ({"query": {"bool": {"should": [{"match": {"body": "red"}}]}}}, "item 4"),
    ({"query": {"match": {"body": "red"}}, "knn": knn(0), "rank": {"rrf": {}}}, "item 5"),
])
def test_cut_is_a_501_naming_its_slice(servers, body, item):
    _, tsrv = servers
    status, out = call(tsrv.port, "POST", "/r/_search", body)
    assert status == 501, out
    assert f"ROADMAP queue 1 {item}" in out["error"]["reason"]
