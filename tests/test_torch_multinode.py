"""Multi-node clusters of the port against the JAX package's, on the CPU.

Each test runs the same steps twice: on a cluster of the JAX package's
`TpuNode`s as tests/test_multinode.py, test_distributed_search.py and
test_quorum.py build them (the numpy backend), and on a cluster of the
port's `TpuNode(device="cpu")` (the torch backend on CPU tensors), both
over real localhost TCP in this process. Each run asserts the
reference test's own invariants, and the port's run is held to the JAX
package's: the same pages (ids position by position, scores within
rtol 1e-5, runs of tied scores as sets), routing tables, `_shards`
accounting, aggregations and counters.

This file also holds the harness the other multi-node files import
(`Pkg`, `twin`, `make_cluster`, the per-test time limit and the
batcher check): every node a test starts is closed when the test ends,
whatever happened, every port `QueryBatcher` the test made must be
closed with its worker threads gone, and a test that runs past its
limit fails with `TimeLimitExceeded` instead of stalling the run.
"""

from __future__ import annotations

import json
import signal
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from elasticsearch_tpu.cluster import allocation as j_allocation
from elasticsearch_tpu.cluster import node as j_node
from elasticsearch_tpu.cluster.indices import IndexService as JIndexService
from elasticsearch_tpu.cluster.service import ClusterError as JClusterError
from elasticsearch_tpu.cluster.service import ClusterService as JClusterService
from elasticsearch_tpu.common.faults import faults as j_faults
from elasticsearch_tpu.index import crashpoints as j_crashpoints
from elasticsearch_tpu.index import translog as j_translog
from elasticsearch_tpu.rest.server import ElasticsearchTpuServer as JServer
from elasticsearch_tpu.transport import service as j_transport

from elasticsearch_tpu_torch.cluster import allocation as p_allocation
from elasticsearch_tpu_torch.cluster import node as p_node
from elasticsearch_tpu_torch.cluster.indices import IndexService as PIndexService
from elasticsearch_tpu_torch.cluster.service import ClusterError as PClusterError
from elasticsearch_tpu_torch.cluster.service import ClusterService as PClusterService
from elasticsearch_tpu_torch.common.faults import faults as p_faults
from elasticsearch_tpu_torch.index import crashpoints as p_crashpoints
from elasticsearch_tpu_torch.index import translog as p_translog
from elasticsearch_tpu_torch.rest.server import ElasticsearchTpuServer as PServer
from elasticsearch_tpu_torch.search.batcher import live_batchers
from elasticsearch_tpu_torch.transport import service as p_transport

torch.set_num_threads(1)

RTOL = 1e-5
CPU = "cpu"

# ---------------------------------------------------------------------------
# harness (imported by the other multi-node files)
# ---------------------------------------------------------------------------


class TimeLimitExceeded(Exception):
    """Raised in the main thread when a test runs past its limit."""


DEFAULT_LIMIT_S = 120


def time_limit(seconds: int):
    """Gives one test a limit of its own (the harness's default is
    `DEFAULT_LIMIT_S`)."""

    def mark(fn):
        fn.time_limit_s = seconds
        return fn

    return mark


class _Alarm:
    """SIGALRM in the main thread: the blocked call (a join, a lock, a
    socket read) raises `TimeLimitExceeded`, so the test fails and its
    `finally` closes its nodes."""

    def __init__(self, seconds: int, what: str):
        self.seconds, self.what = int(seconds), what

    def __enter__(self):
        def fire(signum, frame):
            raise TimeLimitExceeded(f"{self.what} ran past {self.seconds} s")

        self._old = signal.signal(signal.SIGALRM, fire)
        signal.alarm(self.seconds)
        return self

    def __exit__(self, *exc):
        signal.alarm(0)
        signal.signal(signal.SIGALRM, self._old)
        return False


_OPEN_NODES: list = []
_OPEN_SERVERS: list = []


class Pkg:
    """One package's side of a twin test: its node class (the port's on
    the CPU) and the process-wide state the test resets."""

    def __init__(self, name, node_mod, allocation, faults, crashpoints,
                 translog, transport, cluster_error, cluster_service,
                 index_service, server, **node_kw):
        self.name = name
        self.node_mod = node_mod
        self.allocation = allocation
        self.faults = faults
        self.crashpoints = crashpoints
        self.translog = translog
        self.transport = transport
        self.ClusterError = cluster_error
        self.NodeError = node_mod.NodeError
        self.NotMasterError = node_mod.NotMasterError
        self._cluster_service = cluster_service
        self._index_service = index_service
        self._server = server
        self.node_kw = node_kw

    def __repr__(self):
        return self.name

    def node(self, name, **kw):
        """A started node, closed by the harness when the test ends."""
        n = self.node_mod.TpuNode(name, **{**self.node_kw, **kw}).start()
        _OPEN_NODES.append(n)
        return n

    def unstarted_node(self, name, **kw):
        return self.node_mod.TpuNode(name, **{**self.node_kw, **kw})

    def cluster_service(self, **kw):
        return self._cluster_service(**{**self.node_kw, **kw})

    def index_service(self, *a, **kw):
        return self._index_service(*a, **{**self.node_kw, **kw})

    def server(self, **kw):
        srv = self._server(port=0, **kw)
        srv.start_background()
        _OPEN_SERVERS.append(srv)
        return srv

    def checksum(self, eng):
        return self.crashpoints.engine_state_checksum(eng)

    def reset(self):
        self.faults.clear()
        self.allocation.reset_relocation_stats()


JAX = Pkg("jax", j_node, j_allocation, j_faults, j_crashpoints, j_translog,
          j_transport, JClusterError, JClusterService, JIndexService, JServer)
PORT = Pkg("port", p_node, p_allocation, p_faults, p_crashpoints, p_translog,
           p_transport, PClusterError, PClusterService, PIndexService, PServer,
           device=CPU)
BOTH = (JAX, PORT)


def close_quietly(*nodes):
    for n in nodes:
        if n is None:
            continue
        try:
            n.close()
        except Exception:
            pass


def _close_since(mark_nodes: int, mark_servers: int) -> None:
    while len(_OPEN_SERVERS) > mark_servers:
        srv = _OPEN_SERVERS.pop()
        try:
            srv.httpd.shutdown()
            srv.httpd.server_close()
        except Exception:
            pass
    while len(_OPEN_NODES) > mark_nodes:
        close_quietly(_OPEN_NODES.pop())


def _check_port_batchers(before: set) -> None:
    """Every port batcher made since `before` is closed, its workers
    gone (the port's counterpart of tests/conftest.py's check, which
    reads only the JAX package's `live_batchers`)."""
    leaked, open_ = [], []
    for b in list(live_batchers):
        if id(b) in before:
            continue
        if not getattr(b, "_closed", False):
            open_.append(b)
            continue
        for t in list(b._threads):
            t.join(timeout=10.0)
            if t.is_alive():
                leaked.append(t.name)
    assert not open_, f"{len(open_)} port QueryBatcher(s) left open"
    assert not leaked, f"closed port QueryBatcher left live worker threads: {leaked}"


def _harness(request):
    """Per test: reset both packages' process-wide state, run the test
    under its time limit, close every node and server it started, and
    check the port's batchers."""
    for p in BOTH:
        p.reset()
    marks = (len(_OPEN_NODES), len(_OPEN_SERVERS))
    before = {id(b) for b in list(live_batchers)}
    limit = getattr(request.function, "time_limit_s", DEFAULT_LIMIT_S)
    try:
        with _Alarm(limit, request.node.nodeid):
            yield
    finally:
        _close_since(*marks)
        for p in BOTH:
            p.reset()
    _check_port_batchers(before)


# autouse in this file and in the files that import it; `cluster_harness`
# is the same fixture for a class of another file (`usefixtures`)
multinode_harness = pytest.fixture(autouse=True, name="multinode_harness")(_harness)
cluster_harness = pytest.fixture(name="cluster_harness")(_harness)


def twin(scenario, *args, **kw):
    """Runs `scenario(pkg, *args)` on the JAX package, then on the port,
    closing the nodes each run started before the next; returns both
    runs' observations (ref, got)."""
    out = []
    for p in BOTH:
        marks = (len(_OPEN_NODES), len(_OPEN_SERVERS))
        try:
            out.append(scenario(p, *args, **kw))
        finally:
            _close_since(*marks)
            p.reset()
    return out[0], out[1]


def make_cluster(p: Pkg, n, tmp_path=None, **kw):
    """n started nodes of package `p`; node-0 (lowest id) is master.
    Data paths, when asked for, are per package under `tmp_path`."""
    def path(i):
        return str(tmp_path / p.name / f"node-{i}") if tmp_path else None

    nodes = [p.node("node-0", data_path=path(0), **kw)]
    for i in range(1, n):
        nodes.append(p.node(f"node-{i}", seeds=[nodes[0].address],
                            data_path=path(i), **kw))
    return nodes


def wait_until(cond, timeout=15.0, interval=0.05, msg="condition"):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if cond():
            return
        time.sleep(interval)
    raise AssertionError(f"timed out waiting for {msg}")


def page(resp):
    """(id, score) of each hit; a sorted page's sort values instead."""
    return [
        (h["_id"], h.get("_score"), h.get("sort"))
        for h in resp["hits"]["hits"]
    ]


def _close(a, b):
    if a is None or b is None:
        return a is b
    return abs(float(a) - float(b)) <= RTOL * max(abs(float(a)), abs(float(b)), 1e-30)


def assert_same_page(got, ref):
    """Ids position by position; scores within rtol; inside a run of
    scores tied within rtol the run's ids as a set."""
    assert len(got) == len(ref), (got, ref)
    for (gi, gs, gsort), (ri, rs, rsort) in zip(got, ref):
        assert _close(gs, rs), (got, ref)
        assert gsort == rsort, (got, ref)
    i = 0
    while i < len(ref):
        j = i + 1
        while j < len(ref) and _close(ref[j][1], ref[i][1]):
            j += 1
        assert {g[0] for g in got[i:j]} == {r[0] for r in ref[i:j]}, (got, ref)
        i = j


def assert_same_response(got, ref):
    """A search response: totals, `_shards` accounting, the page and
    the aggregations (`avg`-style values within rtol)."""
    assert got["hits"]["total"] == ref["hits"]["total"]
    assert got["_shards"] == ref["_shards"]
    assert_same_page(page(got), page(ref))
    assert_close_tree(got.get("aggregations"), ref.get("aggregations"))


def assert_close_tree(got, ref, path="$"):
    if isinstance(ref, dict):
        assert isinstance(got, dict) and set(got) == set(ref), (path, got, ref)
        for k in ref:
            assert_close_tree(got[k], ref[k], f"{path}.{k}")
    elif isinstance(ref, list):
        assert isinstance(got, list) and len(got) == len(ref), (path, got, ref)
        for i, (g, r) in enumerate(zip(got, ref)):
            assert_close_tree(g, r, f"{path}[{i}]")
    elif isinstance(ref, float) and not isinstance(ref, bool):
        assert _close(got, ref), (path, got, ref)
    else:
        assert got == ref, (path, got, ref)


def routing_table(node, index):
    """The index's routing entries as the master publishes them."""
    return {
        sid: {k: v for k, v in entry.items()}
        for sid, entry in node.state["indices"][index]["routing"].items()
    }


# ---------------------------------------------------------------------------
# the card
# ---------------------------------------------------------------------------


@pytest.mark.skipif(torch.cuda.is_available(), reason="a CUDA device is present")
def test_node_without_a_card_raises():
    """`TpuNode` serves on "cuda" unless the caller passes another
    device; with no card it raises before it binds a port or starts a
    thread (no fallback to the CPU)."""
    threads = threading.active_count()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        p_node.TpuNode("node-0")
    assert threading.active_count() == threads
    n = PORT.node("node-0")
    assert n.device == torch.device("cpu")
    assert n.cluster.device == torch.device("cpu")


def test_every_index_of_a_node_serves_on_its_device():
    """The node's device reaches each `IndexService` it builds from the
    cluster state (the port's one change to the reference node)."""
    a, b = make_cluster(PORT, 2)
    b.create_index("dev", {"settings": {"number_of_shards": 2}})
    for n in (a, b):
        idx = n.indices["dev"]
        assert idx.device == torch.device("cpu")
        for eng in idx.local_shards.values():
            assert eng.device == torch.device("cpu")


# ---------------------------------------------------------------------------
# tests/test_multinode.py
# ---------------------------------------------------------------------------


class TestMembership:
    def test_join_and_state_convergence(self):
        def run(p):
            a, b = make_cluster(p, 2)
            assert a.is_master() and not b.is_master()
            assert set(a.state["nodes"]) == {"node-0", "node-1"}
            assert b.state["nodes"] == a.state["nodes"]
            assert b.state["version"] == a.state["version"]
            return {"version": a.state["version"], "master": b.state["master"],
                    "nodes": sorted(a.state["nodes"])}

        ref, got = twin(run)
        assert got == ref

    def test_three_nodes(self):
        def run(p):
            a, b, c = make_cluster(p, 3)
            assert set(c.state["nodes"]) == {"node-0", "node-1", "node-2"}
            return {"version": c.state["version"], "master": c.state["master"]}

        ref, got = twin(run)
        assert got == ref


DOCS5 = {
    "1": "the quick brown fox",
    "2": "lazy brown dog",
    "3": "quick dog runs fast",
    "4": "slow green turtle",
    "5": "quick silver fox",
}


class TestDistributedIndex:
    def test_create_on_a_bulk_on_b_search_from_a(self):
        def run(p):
            a, b = make_cluster(p, 2)
            r = b.create_index("dist", {
                "settings": {"number_of_shards": 4},
                "mappings": {"properties": {"body": {"type": "text"}}},
            })
            assert r["acknowledged"]
            assert set(r["routing"].values()) == {"node-0", "node-1"}
            assert set(a.indices["dist"].local_shards) | set(
                b.indices["dist"].local_shards) == {0, 1, 2, 3}
            results = b.bulk("dist", [
                {"op": "index", "id": k, "source": {"body": v}}
                for k, v in DOCS5.items()
            ])
            assert all(x["ok"] and x["result"] == "created" for x in results)
            a.refresh("dist")
            resp = a.search("dist", {"query": {"match": {"body": "quick"}}})
            assert {h["_id"] for h in resp["hits"]["hits"]} == {"1", "3", "5"}
            assert resp["hits"]["total"]["value"] == 3
            resp_b = b.search("dist", {"query": {"match": {"body": "quick"}}})
            assert page(resp_b) == page(resp)
            return {
                "create": r,
                "bulk": [(x["_id"], x["result"], x.get("_seq_no")) for x in results],
                "routing": routing_table(a, "dist"),
                "resp": resp,
            }

        ref, got = twin(run)
        assert got["create"] == ref["create"]
        assert got["bulk"] == ref["bulk"]
        assert got["routing"] == ref["routing"]
        assert_same_response(got["resp"], ref["resp"])

    def test_get_and_delete_cross_node(self):
        def run(p):
            a, b = make_cluster(p, 2)
            a.create_index("kv", {"settings": {"number_of_shards": 3}})
            for i in range(10):
                a.index_doc("kv", f"d{i}", {"n": i})
            got = [b.get_doc("kv", f"d{i}") for i in range(10)]
            for i, doc in enumerate(got):
                assert doc is not None and doc["_source"]["n"] == i
            deleted = b.delete_doc("kv", "d3")
            assert deleted["result"] == "deleted"
            assert a.get_doc("kv", "d3") is None
            return {"docs": got, "deleted": deleted}

        ref, got = twin(run)
        assert got == ref

    def test_score_parity_with_single_node(self):
        """Same docs, same coordinator order whichever node coordinates;
        and the port's pages equal the JAX package's."""
        def run(p):
            a, b = make_cluster(p, 2)
            a.create_index("par", {"settings": {"number_of_shards": 2}})
            for i, t in enumerate(["alpha beta", "alpha gamma", "beta gamma",
                                   "alpha alpha"]):
                b.index_doc("par", str(i), {"body": t})
            b.refresh("par")
            ra = a.search("par", {"query": {"match": {"body": "alpha"}}})
            rb = b.search("par", {"query": {"match": {"body": "alpha"}}})
            assert [h["_id"] for h in ra["hits"]["hits"]] == [
                h["_id"] for h in rb["hits"]["hits"]]
            return ra

        ref, got = twin(run)
        assert_same_response(got, ref)

    def test_duplicate_create_rejected(self):
        def run(p):
            a, b = make_cluster(p, 2)
            a.create_index("dup")
            with pytest.raises(Exception) as ei:
                b.create_index("dup")
            assert "already exists" in str(ei.value)
            return type(ei.value).__name__, getattr(ei.value, "status", None)

        ref, got = twin(run)
        assert got == ref

    def test_delete_index_removes_everywhere(self):
        def run(p):
            a, b = make_cluster(p, 2)
            a.create_index("tmp", {"settings": {"number_of_shards": 2}})
            assert "tmp" in a.indices and "tmp" in b.indices
            out = b.delete_index("tmp")
            assert "tmp" not in a.indices and "tmp" not in b.indices
            with pytest.raises(p.NodeError):
                a.search("tmp", {})
            return out

        ref, got = twin(run)
        assert got == ref


class TestPersistence:
    def test_node_restart_recovers_local_shards(self, tmp_path):
        def run(p):
            a, b = make_cluster(p, 2, tmp_path)
            a.create_index("pers", {"settings": {"number_of_shards": 2}})
            for i in range(6):
                a.index_doc("pers", str(i), {"body": f"doc number {i}"})
            a.refresh("pers")
            for li in b.indices.values():
                for eng in li.shards:
                    eng.flush()
            b_docs = sum(e.num_docs for e in b.indices["pers"].shards)
            b.close()
            b2 = p.node("node-1", seeds=[a.address],
                        data_path=str(tmp_path / p.name / "node-1"))
            # the node may rejoin before failure detection removed it: its
            # copies are then demoted and peer-recover in background
            # threads, so count its docs only once the table is green and
            # no recovery is in flight
            wait_until(
                lambda: a.cluster.health()["status"] == "green"
                and not b2._recovering,
                msg="green with no recovery in flight",
            )
            assert sum(e.num_docs for e in b2.indices["pers"].shards) == b_docs
            resp = a.search("pers", {"query": {"match": {"body": "doc"}}})
            assert resp["hits"]["total"]["value"] == 6
            return {"b_docs": b_docs, "resp": resp,
                    "routing": routing_table(a, "pers")}

        ref, got = twin(run)
        assert got["b_docs"] == ref["b_docs"]
        assert got["routing"] == ref["routing"]
        assert_same_response(got["resp"], ref["resp"])

    def test_master_restart_recovers_metadata(self, tmp_path):
        def run(p):
            path = str(tmp_path / p.name / "node-0")
            a = p.node("node-0", data_path=path)
            a.create_index("solo", {"settings": {"number_of_shards": 2}})
            for i in range(5):
                a.index_doc("solo", str(i), {"body": f"persisted doc {i}"})
            a.refresh("solo")
            for li in a.indices.values():
                for eng in li.shards:
                    eng.flush()
            a.close()
            seen = []
            for _gen in range(2):
                a2 = p.node("node-0", data_path=path)
                assert "solo" in a2.state["indices"], "metadata lost on restart"
                assert "solo" in a2.indices, "local index not re-created"
                assert sum(e.num_docs for e in a2.indices["solo"].shards) == 5
                doc = a2.get_doc("solo", "3")
                assert doc["_source"]["body"] == "persisted doc 3"
                resp = a2.search("solo", {"query": {"match": {"body": "persisted"}}})
                assert resp["hits"]["total"]["value"] == 5
                seen.append({"version": a2.state["version"], "doc": doc,
                             "resp": resp})
                a2.close()
            return seen

        ref, got = twin(run)
        for g, r in zip(got, ref):
            assert g["version"] == r["version"]
            assert g["doc"] == r["doc"]
            assert_same_response(g["resp"], r["resp"])


# ---------------------------------------------------------------------------
# tests/test_distributed_search.py: one 3-node cluster per package
# ---------------------------------------------------------------------------


def _lib_docs():
    genres = ["scifi", "fantasy", "crime"]
    return [
        {
            "op": "index",
            "id": f"d{i}",
            "source": {
                "title": f"book {i} of the quick saga",
                "body": ("the quick brown fox story" if i % 3 == 0
                         else "slow turtle tales of patience"),
                "genre": genres[i % 3],
                "year": 1960 + i,
                "vec": [1.0 * (i % 5), 1.0, 0.5 * (i % 3), 0.1 * i],
            },
        }
        for i in range(60)
    ]


LIB_MAPPING = {
    "properties": {
        "title": {"type": "text"},
        "body": {"type": "text"},
        "genre": {"type": "keyword"},
        "year": {"type": "integer"},
        "vec": {"type": "dense_vector", "dims": 4},
    }
}


@pytest.fixture(scope="module")
def lib():
    """A 6-shard index over 3 nodes, created through a non-master node,
    in each package: {"jax": nodes, "port": nodes}."""
    clusters, started = {}, []
    try:
        with _Alarm(120, "building the 3-node clusters"):
            for p in BOTH:
                a = p.unstarted_node("node-0").start()
                started.append(a)
                b = p.unstarted_node("node-1", seeds=[a.address]).start()
                started.append(b)
                c = p.unstarted_node("node-2", seeds=[a.address]).start()
                started.append(c)
                r = b.create_index("lib", {"settings": {"number_of_shards": 6},
                                           "mappings": LIB_MAPPING})
                assert set(r["routing"].values()) == {"node-0", "node-1", "node-2"}
                assert all(x["ok"] for x in c.bulk("lib", _lib_docs()))
                b.refresh("lib")
                clusters[p.name] = [a, b, c]
        assert routing_table(clusters["port"][0], "lib") == routing_table(
            clusters["jax"][0], "lib")
        yield clusters
    finally:
        close_quietly(*started)


def both_search(lib, coord, body, index="lib"):
    """The same body through node `coord` of each package: (ref, got)."""
    ref = lib["jax"][coord].search(index, body)
    got = lib["port"][coord].search(index, body)
    assert_same_response(got, ref)
    return ref, got


class TestCrossNodeQueryPhase:
    def test_match_with_total(self, lib):
        body = {"query": {"match": {"body": "quick"}}, "size": 30}
        for p in BOTH:
            resp = lib[p.name][2].search("lib", body)
            assert resp["hits"]["total"]["value"] == 20
            assert len(resp["hits"]["hits"]) == 20
            assert resp["_shards"]["total"] == 6
            resp2 = lib[p.name][0].search("lib", body)
            assert [h["_id"] for h in resp["hits"]["hits"]] == [
                h["_id"] for h in resp2["hits"]["hits"]]
        both_search(lib, 2, body)
        both_search(lib, 0, body)

    def test_bool_and_term_queries(self, lib):
        body = {"query": {"bool": {
            "must": [{"match": {"body": "quick"}}],
            "filter": [{"term": {"genre": "scifi"}}],
        }}, "size": 50}
        ref, got = both_search(lib, 0, body)
        assert {h["_id"] for h in got["hits"]["hits"]} == {
            f"d{i}" for i in range(0, 60, 3)}

    def test_aggs_cross_node(self, lib):
        body = {"size": 0, "aggs": {
            "by_genre": {"terms": {"field": "genre"},
                         "aggs": {"avg_year": {"avg": {"field": "year"}}}},
            "year_stats": {"stats": {"field": "year"}},
        }}
        ref, got = both_search(lib, 1, body)
        buckets = {b["key"]: b for b in got["aggregations"]["by_genre"]["buckets"]}
        assert set(buckets) == {"scifi", "fantasy", "crime"}
        assert buckets["scifi"]["doc_count"] == 20
        expected = sum(1960 + i for i in range(0, 60, 3)) / 20
        assert buckets["scifi"]["avg_year"]["value"] == pytest.approx(expected)
        assert got["aggregations"]["year_stats"]["min"] == 1960
        assert got["aggregations"]["year_stats"]["max"] == 2019

    def test_sort_cross_node(self, lib):
        ref, got = both_search(lib, 2, {"sort": [{"year": {"order": "desc"}}],
                                        "size": 5})
        assert [h["sort"][0] for h in got["hits"]["hits"]] == [
            2019, 2018, 2017, 2016, 2015]

    def test_knn_cross_node(self, lib):
        ref, got = both_search(lib, 0, {"knn": {
            "field": "vec", "query_vector": [4.0, 1.0, 1.0, 5.9],
            "k": 3, "num_candidates": 20,
        }, "size": 3})
        assert len(got["hits"]["hits"]) == 3
        assert got["hits"]["hits"][0]["_id"] == "d59"

    def test_highlight_cross_node(self, lib):
        ref, got = both_search(lib, 1, {
            "query": {"match": {"body": "fox"}},
            "highlight": {"fields": {"body": {}}}, "size": 5,
        })
        assert got["hits"]["hits"]
        for g, r in zip(got["hits"]["hits"], ref["hits"]["hits"]):
            assert "<em>fox</em>" in g["highlight"]["body"][0]
            assert g["highlight"] == r["highlight"]

    def test_source_filtering_cross_node(self, lib):
        ref, got = both_search(lib, 2, {"query": {"match_all": {}},
                                        "_source": ["genre"], "size": 4})
        for g, r in zip(got["hits"]["hits"], ref["hits"]["hits"]):
            assert set(g["_source"]) == {"genre"}
            assert g["_source"] == r["_source"]

    def test_count_cross_node(self, lib):
        body = {"query": {"term": {"genre": "crime"}}}
        ref = lib["jax"][1].count("lib", body)
        got = lib["port"][1].count("lib", body)
        assert got["count"] == 20 and got["_shards"]["total"] == 6
        assert got == ref

    def test_scroll_cross_node(self, lib):
        seen = {}
        for p in BOTH:
            a = lib[p.name][0]
            resp = a.cluster.create_scroll(
                "lib", {"query": {"match_all": {}}, "size": 25}, "1m")
            pages = [[h["_id"] for h in resp["hits"]["hits"]]]
            sid = resp["_scroll_id"]
            while True:
                nxt = a.cluster.continue_scroll(sid, "1m")
                if not nxt["hits"]["hits"]:
                    break
                pages.append([h["_id"] for h in nxt["hits"]["hits"]])
            assert len({i for pg in pages for i in pg}) == 60
            seen[p.name] = pages
        assert seen["port"] == seen["jax"]

    def test_pit_search_after_cross_node(self, lib):
        seen = {}
        for p in BOTH:
            c = lib[p.name][2]
            pit = c.cluster.open_pit("lib", "1m")
            collected = []
            body = {"pit": {"id": pit["id"]},
                    "sort": [{"year": {"order": "asc"}}], "size": 23}
            resp = c.cluster.pit_search(body)
            while resp["hits"]["hits"]:
                collected.extend((h["_id"], h["sort"][0])
                                 for h in resp["hits"]["hits"])
                body["search_after"] = resp["hits"]["hits"][-1]["sort"]
                resp = c.cluster.pit_search(body)
            assert [s for _, s in collected] == list(range(1960, 2020))
            c.cluster.close_pit(pit["id"])
            seen[p.name] = collected
        assert seen["port"] == seen["jax"]


def _http(base, method, path, body=None):
    data = json.dumps(body).encode() if body is not None else None
    req = urllib.request.Request(base + path, data=data, method=method,
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=60) as resp:
            return resp.status, json.loads(resp.read() or b"null")
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read() or b"null")


@pytest.fixture(scope="module")
def es(lib):
    """HTTP to a server fronting node-2 (not the master) of each
    package: call(method, path, body) → {"jax": (status, body),
    "port": (status, body)}."""
    servers = {}
    try:
        for p in BOTH:
            srv = p._server(port=0, cluster=lib[p.name][2].cluster)
            srv.start_background()
            servers[p.name] = srv

        def call(method, path, body=None):
            return {
                name: _http(f"http://127.0.0.1:{srv.port}", method, path, body)
                for name, srv in servers.items()
            }

        yield call
    finally:
        for srv in servers.values():
            srv.httpd.shutdown()
            srv.httpd.server_close()


class TestRestOverCluster:
    def test_rest_search_with_aggs(self, es):
        out = es("POST", "/lib/_search", {
            "query": {"match": {"body": "quick"}},
            "aggs": {"g": {"terms": {"field": "genre"}}}, "size": 3,
        })
        (js, jb), (ps, pb) = out["jax"], out["port"]
        assert ps == js == 200
        assert pb["hits"]["total"]["value"] == 20
        assert len(pb["aggregations"]["g"]["buckets"]) > 0
        assert_same_response(pb, jb)

    def test_rest_doc_crud_routes_cross_node(self, es):
        out = es("PUT", "/lib/_doc/restdoc",
                 {"body": "quick rest doc", "genre": "scifi", "year": 2021})
        assert out["port"][0] in (200, 201) and out["port"] == out["jax"]
        out = es("GET", "/lib/_doc/restdoc")
        status, body = out["port"]
        assert status == 200 and body["found"] and body["_source"]["year"] == 2021
        assert out["port"] == out["jax"]
        out = es("DELETE", "/lib/_doc/restdoc")
        assert out["port"][0] == 200 and out["port"] == out["jax"]

    def test_rest_create_index_via_master_roundtrip(self, es):
        steps = [
            ("PUT", "/restidx", {"settings": {"number_of_shards": 3}}),
            ("PUT", "/restidx/_doc/1", {"t": "hello world"}),
            ("POST", "/restidx/_refresh", None),
            ("POST", "/restidx/_search", {"query": {"match": {"t": "hello"}}}),
            ("DELETE", "/restidx", None),
            ("POST", "/restidx/_search", {}),
        ]
        seen = [es(*s) for s in steps]
        statuses = [o["port"][0] for o in seen]
        assert statuses[0] == 200 and seen[0]["port"][1]["acknowledged"]
        assert statuses[1] in (200, 201)
        assert statuses[3] == 200 and seen[3]["port"][1]["hits"]["total"]["value"] == 1
        assert statuses[4] == 200 and statuses[5] == 404
        assert statuses == [o["jax"][0] for o in seen]
        assert_same_response(seen[3]["port"][1], seen[3]["jax"][1])
        assert seen[5]["port"][1]["error"]["type"] == seen[5]["jax"][1]["error"]["type"]

    def test_rest_cluster_health_reports_nodes(self, es):
        out = es("GET", "/_cluster/health")
        (js, jb), (ps, pb) = out["jax"], out["port"]
        assert ps == 200 and pb["number_of_nodes"] == 3
        assert pb == jb


class TestTorchBackendCrossNode:
    """test_distributed_search.py's `TestJaxBackendCrossNode` on the
    port: the torch backend (batcher and `TorchExecutor` on CPU tensors)
    across nodes, hit for hit against the port's numpy backend and the
    JAX package's numpy backend."""

    @time_limit(180)
    def test_torch_backend_parity_across_nodes(self):
        rng = np.random.default_rng(17)
        words = ["alpha", "beta", "gamma", "delta", "epsilon", "zeta", "eta",
                 "theta"]
        docs = [" ".join(rng.choice(words, size=int(rng.integers(3, 9))))
                for _ in range(500)]

        def build(p, backend):
            a = p.node("node-0", cluster_name=f"pt-{p.name}-{backend}")
            b = p.node("node-1", seeds=[a.address],
                       cluster_name=f"pt-{p.name}-{backend}")
            a.create_index("c", {
                "settings": {"number_of_shards": 4, "number_of_replicas": 0,
                             "search.backend": backend},
                "mappings": {"properties": {"body": {"type": "text"}}},
            })
            a.bulk("c", [{"op": "index", "id": str(i), "source": {"body": t}}
                         for i, t in enumerate(docs)])
            a.refresh("c")
            return a, b

        ta, tb = build(PORT, "torch")
        na, nb = build(PORT, "numpy")
        ja, jb = build(JAX, "numpy")
        bodies = [
            {"query": {"match": {"body": "alpha beta"}}, "size": 15},
            {"query": {"term": {"body": "alpha"}}, "size": 15},
            {"query": {"bool": {"must": [{"term": {"body": "alpha"}}],
                                "should": [{"match": {"body": "gamma delta"}}]}},
             "size": 15},
            {"query": {"match": {"body": {"query": "alpha epsilon",
                                          "operator": "and"}}}, "size": 15},
        ]
        for body in bodies:
            rt = tb.search("c", body)
            assert_same_response(rt, nb.search("c", body))
            assert_same_response(rt, jb.search("c", body))
        assert any(idx._batcher.stats["jobs"] > 0
                   for node in (ta, tb) for idx in node.indices.values())


class TestFieldsOption:
    def test_fields_and_wildcards(self):
        def run(p):
            c = p.cluster_service()
            try:
                c.create_index("f", {
                    "settings": {"number_of_shards": 1},
                    "mappings": {"properties": {
                        "title": {"type": "text"},
                        "meta_a": {"type": "keyword"},
                        "meta_b": {"type": "integer"},
                    }},
                })
                idx = c.get_index("f")
                idx.index_doc("1", {"title": "hello", "meta_a": "x", "meta_b": 7})
                idx.refresh()
                r = c.search("f", {
                    "query": {"match": {"title": "hello"}},
                    "fields": ["title", {"field": "meta_*"}],
                    "_source": False,
                })
                h = r["hits"]["hits"][0]
                assert h["fields"]["title"] == ["hello"]
                assert h["fields"]["meta_a"] == ["x"]
                assert h["fields"]["meta_b"] == [7]
                assert "_source" not in h
                return r
            finally:
                c.close()

        ref, got = twin(run)
        assert_same_response(got, ref)
        assert got["hits"]["hits"][0]["fields"] == ref["hits"]["hits"][0]["fields"]


# ---------------------------------------------------------------------------
# tests/test_quorum.py
# ---------------------------------------------------------------------------


def quorum_cluster(p, n):
    """fd loops parked (huge interval); ticks are driven by hand."""
    return make_cluster(p, n, fd_interval=120.0, fd_retries=2)


def partition(p, nodes, groups):
    """Blocks transport.send across partition groups (by target
    address); returns the healer."""
    group_of_addr, group_of_node = {}, {}
    for gi, group in enumerate(groups):
        for node in group:
            group_of_addr[node.address] = gi
            group_of_node[node.name] = gi
    originals = [(node, node.transport.send) for node in nodes]
    for node in nodes:
        gi = group_of_node[node.name]
        orig = node.transport.send

        def send(address, action, payload, timeout=30.0, _orig=orig, _gi=gi):
            target = group_of_addr.get(tuple(address))
            if target is not None and target != _gi:
                raise p.transport.ConnectTransportError(
                    f"simulated partition to {address}")
            return _orig(address, action, payload, timeout)

        node.transport.send = send

    def heal():
        for node, orig in originals:
            node.transport.send = orig

    return heal


def tick_master_checks(node, times):
    for _ in range(times):
        node._check_master()


def _masters(nodes):
    return [(n.name, n.is_master(), n.state.get("master"), n._quorum_lost)
            for n in nodes]


class TestQuorum:
    def test_symmetric_partition_single_active_master(self):
        def run(p):
            a, b, c = quorum_cluster(p, 3)
            heal = partition(p, [a, b, c], [[a, c], [b]])
            tick_master_checks(b, 3)
            assert not b.is_master() and b.state.get("master") == "node-0"
            a._check_followers()
            assert a.is_master() and not a._quorum_lost
            a.create_index("maj", {"settings": {"number_of_shards": 1}})
            assert "maj" in a.indices
            seen = _masters([a, b, c])
            heal()
            return seen, routing_table(a, "maj")

        ref, got = twin(run)
        assert got == ref

    def test_isolated_master_refuses_mutations_majority_elects(self):
        def run(p):
            a, b, c = quorum_cluster(p, 3)
            heal = partition(p, [a, b, c], [[a], [b, c]])
            a._check_followers()
            assert a.is_master() and a._quorum_lost
            with pytest.raises(p.NotMasterError):
                a.cluster.create_index("split", {})
            tick_master_checks(b, 3)
            assert b.is_master()
            b.create_index("ok", {"settings": {"number_of_shards": 1}})
            assert "ok" in b.indices and "ok" in c.indices
            heal()
            a._check_followers()
            assert not a.is_master()
            assert a.state.get("master") == "node-1"
            assert a._quorum_lost is False
            return _masters([a, b, c]), routing_table(b, "ok")

        ref, got = twin(run)
        assert got == ref

    def test_quorum_restores_after_reconnect(self):
        def run(p):
            a, b = quorum_cluster(p, 2)
            heal = partition(p, [a, b], [[a], [b]])
            a._check_followers()
            assert a._quorum_lost
            with pytest.raises(p.NotMasterError):
                a.cluster.create_index("nope", {})
            heal()
            a._check_followers()
            assert not a._quorum_lost
            a.create_index("yes", {"settings": {"number_of_shards": 1}})
            assert "yes" in a.indices
            return _masters([a, b]), routing_table(a, "yes")

        ref, got = twin(run)
        assert got == ref

    def test_dead_master_excluded_from_candidate_set(self):
        def run(p):
            a, b = quorum_cluster(p, 2)
            a.close()
            tick_master_checks(b, 3)
            assert b.is_master()
            assert set(b.state["nodes"]) == {"node-1"}
            b.create_index("after", {"settings": {"number_of_shards": 1}})
            assert "after" in b.indices
            return _masters([b]), routing_table(b, "after")

        ref, got = twin(run)
        assert got == ref


# ---------------------------------------------------------------------------
# the REST tier over a node: reroute, allocation explain, `_nodes/stats`
# ---------------------------------------------------------------------------


class TestRestNodeMode:
    def test_reroute_explain_and_relocation_stats_over_http(self):
        """`_cluster/reroute` and `allocation/explain` answer through
        `DistributedClusterService`, and `_nodes/stats` carries the
        `relocation` block, as in the JAX package's REST tier."""
        def run(p):
            nodes = make_cluster(p, 3, fd_interval=0.1, fd_retries=2)
            a = nodes[0]
            a.create_index("mv", {"settings": {"number_of_shards": 1,
                                               "number_of_replicas": 1}})
            for i in range(10):
                a.index_doc("mv", f"d{i}", {"body": f"doc {i}"})
            a.refresh("mv")
            wait_until(lambda: a.cluster.health()["status"] == "green")
            srv = p.server(cluster=a.cluster)
            base = f"http://127.0.0.1:{srv.port}"
            entry = a.state["indices"]["mv"]["routing"]["0"]
            dst = next(n.name for n in nodes
                       if n.name not in [entry["primary"]] + entry["replicas"])
            s1, explain = _http(base, "POST", "/_cluster/allocation/explain",
                                {"index": "mv", "shard": 0})
            s2, rr = _http(base, "POST", "/_cluster/reroute", {"commands": [
                {"move": {"index": "mv", "shard": 0,
                          "from_node": entry["primary"], "to_node": dst}}]})
            wait_until(lambda: not a.state["indices"]["mv"]["routing"]["0"]
                       .get("relocating")
                       and a.cluster.health()["status"] == "green", timeout=30)
            s3, stats = _http(base, "GET", "/_nodes/stats")
            assert (s1, s2, s3) == (200, 200, 200)
            node_stats = next(iter(stats["nodes"].values()))
            rel = node_stats["relocation"]
            assert rel["started"] == rel["completed"] == 1
            s4, pg = _http(base, "POST", "/mv/_search",
                           {"query": {"match": {"body": "doc"}}, "size": 20})
            assert s4 == 200
            return {
                "explain": {k: explain[k] for k in ("index", "shard",
                                                     "current_state")},
                "decisions": sorted(
                    (d["node_name"], d["node_decision"])
                    for d in explain["node_allocation_decisions"]),
                "reroute": rr["explanations"],
                "relocation": {k: rel[k] for k in ("started", "completed",
                                                   "cancelled", "failed",
                                                   "handoffs")},
                "routing": routing_table(a, "mv"),
                "page": pg,
            }

        ref, got = twin(run)
        for k in ("explain", "decisions", "reroute", "relocation", "routing"):
            assert got[k] == ref[k], k
        assert_same_response(got["page"], ref["page"])
