"""Durable nodes of the port against the JAX package's, on the CPU.

Both REST servers run with data paths (the port's as
`ElasticsearchTpuServer(device="cpu", data_path=...)`, the JAX
package's with the numpy backend as the reference): create, `_bulk`,
`_flush`, more writes, a restart (a clean close, or a crash that drops
the processes' state without a flush), and the same pages before and
after. Then tests/test_snapshots.py's snapshot contract on the port's
`ClusterService` (repository CRUD, repositories across a restart,
snapshot, delete and restore with versions and seq_nos, rename, the
refusal to restore over an open index, blob dedup, garbage collection
on delete, doc-mode snapshots of a diskless node), held to the JAX
package's node where the two can be compared, a restored index serving
on the node's device, and the CLI (`python -m elasticsearch_tpu_torch`)
in a subprocess. `TestDistributedSnapshots` snapshots an index whose
shards lie on two nodes of each package and restores it through the
master.
"""

import json
import os
import subprocess
import sys
import urllib.error
import urllib.request
from pathlib import Path

import numpy as np
import pytest

from elasticsearch_tpu.cluster.service import ClusterService as JClusterService
from elasticsearch_tpu.rest.server import ElasticsearchTpuServer as JServer

from elasticsearch_tpu_torch.cluster.service import ClusterError, ClusterService
from elasticsearch_tpu_torch.index import segment_build
from elasticsearch_tpu_torch.rest.server import ElasticsearchTpuServer
from elasticsearch_tpu_torch.search.executor_torch import TorchExecutor

from test_torch_multinode import (  # noqa: F401  (cluster_harness: usefixtures)
    PORT,
    assert_same_response,
    cluster_harness,
    routing_table,
    twin,
)

REPO = Path(__file__).resolve().parent.parent
RTOL = 1e-5
DIMS = 8
WORDS = ["red", "green", "blue", "cyan", "magenta", "yellow", "black", "white", "grey"]
MAPPING = {
    "properties": {
        "body": {"type": "text"},
        "n": {"type": "integer"},
        "vec": {"type": "dense_vector", "dims": DIMS, "similarity": "cosine"},
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


def ok(port, method, path, body=None, ndjson=None):
    status, out = call(port, method, path, body, ndjson)
    assert status == 200, (method, path, out)
    return out


def make_docs(n, seed, start=0):
    rng = np.random.default_rng(seed)
    w = 1.0 / np.arange(1, len(WORDS) + 1)
    w /= w.sum()
    return [
        (f"r{i}", {"body": " ".join(rng.choice(WORDS, int(rng.integers(2, 12)), p=w)),
                   "vec": [float(x) for x in rng.normal(size=DIMS)],
                   "n": (i * 13) % 50})
        for i in range(start, start + n)
    ]


def bulk_lines(docs):
    out = []
    for doc_id, src in docs:
        out += [{"index": {"_id": doc_id}}, src]
    return out


def knn(i, k=5, nc=40):
    rng = np.random.default_rng(40 + i)
    return {"field": "vec", "query_vector": [float(x) for x in rng.normal(size=DIMS)],
            "k": k, "num_candidates": nc}


# every page holds every hit (size above the index's doc count), so a
# run of tied scores is never cut by the page end
SEARCHES = [
    {"query": {"match": {"body": "red green"}}, "size": 200},
    {"query": {"match": {"body": {"query": "blue cyan", "operator": "and"}}}, "size": 200},
    {"query": {"bool": {"must": [{"term": {"body": "red"}}],
                        "should": [{"match": {"body": "blue cyan"}}]}}, "size": 200},
    {"knn": knn(0)},
    {"query": {"match": {"body": "black"}}, "knn": knn(1), "rank": {"rrf": {}}, "size": 10},
    {"query": {"range": {"n": {"gte": 10, "lt": 30}}}, "size": 200, "sort": [{"n": "asc"}, "_doc"]},
]


def same_served(ref, got):
    """Same totals, ids (a run of scores tied within RTOL as a set),
    scores within RTOL and sources."""
    assert got["hits"]["total"] == ref["hits"]["total"]
    rh, gh = ref["hits"]["hits"], got["hits"]["hits"]
    assert len(gh) == len(rh)
    if any(h.get("sort") for h in rh):
        assert [(h["_id"], h["sort"][0]) for h in gh] == [(h["_id"], h["sort"][0]) for h in rh]
        return
    rs = np.array([h["_score"] for h in rh], dtype=float)
    np.testing.assert_allclose([h["_score"] for h in gh], rs, rtol=RTOL, atol=1e-6)
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


def pages(port, index="r"):
    return [ok(port, "POST", f"/{index}/_search", body) for body in SEARCHES]


def start_pair(tmp_path):
    jsrv = JServer(port=0, data_path=str(tmp_path / "jax"))
    tsrv = ElasticsearchTpuServer(port=0, device="cpu", data_path=str(tmp_path / "port"))
    for srv in (jsrv, tsrv):
        srv.start_background()
    return jsrv, tsrv


def crash_node(srv):
    """A power loss for an in-process node: every engine drops what its
    translog has not fsynced, nothing is flushed, the HTTP listener
    goes away."""
    for idx in srv.cluster.indices.values():
        idx.crash()
    srv.httpd.shutdown()
    srv.httpd.server_close()


@pytest.mark.parametrize("restart", ["close", "crash"])
def test_restart_serves_the_jax_nodes_pages(tmp_path, monkeypatch, restart):
    """Create, `_bulk`, `_flush`, more writes (acknowledged, unflushed),
    a restart; the port's pages equal the JAX package's numpy backend
    before and after, and after a crash the replayed tail was built on
    the port's device (CPU tensors here)."""
    monkeypatch.setenv("ES_TPU_DEVICE_BUILD", "auto")
    jsrv, tsrv = start_pair(tmp_path)
    first, later = make_docs(120, 8), make_docs(40, 9, start=120)
    try:
        for srv, backend in ((jsrv, "numpy"), (tsrv, "torch")):
            ok(srv.port, "PUT", "/r", {"settings": {"number_of_shards": 2, "search.backend": backend,
                                                    "translog.durability": "request"},
                                       "mappings": MAPPING})
            out = ok(srv.port, "POST", "/r/_bulk?refresh=true", ndjson=bulk_lines(first))
            assert not out["errors"]
            ok(srv.port, "POST", "/r/_flush")
            out = ok(srv.port, "POST", "/r/_bulk?refresh=true", ndjson=bulk_lines(later))
            assert not out["errors"]
            ok(srv.port, "DELETE", "/r/_doc/r5?refresh=true")
        before = [pages(jsrv.port), pages(tsrv.port)]
        for ref, got in zip(*before):
            same_served(ref, got)
    finally:
        for srv in (jsrv, tsrv):
            if restart == "crash":
                crash_node(srv)
            else:
                srv.close()
    stats0 = dict(segment_build.INGEST_STATS)
    jsrv, tsrv = start_pair(tmp_path)
    try:
        stats1 = segment_build.INGEST_STATS
        if restart == "crash":
            # each shard replayed its unflushed tail into one refresh,
            # built on the device
            assert stats1["device_builds"] >= stats0["device_builds"] + 2
            assert stats1["host_builds"] == stats0["host_builds"]
        after = [pages(jsrv.port), pages(tsrv.port)]
        for ref, got in zip(*after):
            same_served(ref, got)
        for old, new in zip(before[1], after[1]):
            same_served(old, new)
        idx = tsrv.cluster.get_index("r")
        ex = idx._executor(idx.shards[0])
        assert isinstance(ex, TorchExecutor) and ex.device.type == "cpu"
        assert ok(tsrv.port, "GET", "/r/_count")["count"] == 159
    finally:
        jsrv.close()
        tsrv.close()


def test_snapshot_and_restore_over_rest(tmp_path):
    """The snapshot endpoints on both servers: register, snapshot,
    delete the index, restore, restore under a rename; the port's
    restored indexes serve the JAX node's pages."""
    jsrv, tsrv = start_pair(tmp_path)
    docs = make_docs(90, 3)
    try:
        for srv, backend in ((jsrv, "numpy"), (tsrv, "torch")):
            name = "jax" if srv is jsrv else "port"
            ok(srv.port, "PUT", "/r", {"settings": {"number_of_shards": 2, "search.backend": backend},
                                       "mappings": MAPPING})
            ok(srv.port, "POST", "/r/_bulk?refresh=true", ndjson=bulk_lines(docs))
            ok(srv.port, "PUT", "/_snapshot/repo",
               {"type": "fs", "settings": {"location": str(tmp_path / f"repo-{name}")}})
            out = ok(srv.port, "PUT", "/_snapshot/repo/s1?wait_for_completion=true", {"indices": "r"})
            assert out["snapshot"]["state"] == "SUCCESS"
            ok(srv.port, "DELETE", "/r")
            ok(srv.port, "POST", "/_snapshot/repo/s1/_restore", {})
            ok(srv.port, "POST", "/_snapshot/repo/s1/_restore",
               {"indices": "r", "rename_pattern": "r", "rename_replacement": "r_copy"})
            status, out = call(srv.port, "POST", "/_snapshot/repo/s1/_restore", {})
            assert status == 400 and "already exists" in json.dumps(out)
        for index in ("r", "r_copy"):
            for ref, got in zip(pages(jsrv.port, index), pages(tsrv.port, index)):
                same_served(ref, got)
            idx = tsrv.cluster.get_index(index)
            ex = idx._executor(idx.shards[0])
            assert isinstance(ex, TorchExecutor) and ex.device.type == "cpu"
    finally:
        jsrv.close()
        tsrv.close()


# ---------------------------------------------------------------------------
# tests/test_snapshots.py on the port's ClusterService
# ---------------------------------------------------------------------------


@pytest.fixture
def cluster(tmp_path):
    c = ClusterService(data_path=str(tmp_path / "data"), device="cpu")
    yield c
    c.close()


@pytest.fixture
def jcluster(tmp_path):
    c = JClusterService(data_path=str(tmp_path / "jdata"))
    yield c
    c.close()


def repo_body(tmp_path, name="repo1"):
    return {"type": "fs", "settings": {"location": str(tmp_path / name)}}


def seed(cluster, name="src", n=12, backend="torch"):
    cluster.create_index(
        name,
        {
            "settings": {"number_of_shards": 2, "search.backend": backend},
            "mappings": {"properties": {"body": {"type": "text"}, "n": {"type": "integer"}}},
        },
    )
    idx = cluster.get_index(name)
    for i in range(n):
        idx.index_doc(f"d{i}", {"body": f"snapshot doc number {i}", "n": i})
    idx.refresh()
    return idx


BODY = {"query": {"match": {"body": "snapshot number"}}, "size": 20}


class TestRepository:
    def test_register_get_delete(self, cluster, tmp_path):
        assert cluster.put_repository("r", repo_body(tmp_path))["acknowledged"]
        assert "r" in cluster.get_repository("r")
        assert cluster.delete_repository("r")["acknowledged"]
        with pytest.raises(ClusterError) as ei:
            cluster.get_repository("r")
        assert ei.value.status == 404

    def test_bad_type_rejected(self, cluster):
        with pytest.raises(ClusterError):
            cluster.put_repository("r", {"type": "s3", "settings": {}})

    def test_repositories_survive_restart(self, cluster, tmp_path):
        cluster.put_repository("r", repo_body(tmp_path))
        c2 = ClusterService(data_path=cluster.data_path, device="cpu")
        try:
            assert "r" in c2.get_repository("r")
        finally:
            c2.close()

    def test_unknown_repository_is_a_404(self, cluster):
        with pytest.raises(ClusterError) as ei:
            cluster.create_snapshot("nope", "s", {})
        assert ei.value.status == 404


class TestSnapshotRestore:
    def test_snapshot_delete_index_restore(self, cluster, jcluster, tmp_path):
        seed(cluster)
        seed(jcluster, backend="numpy")
        for c, repo in ((cluster, "p"), (jcluster, "j")):
            c.put_repository("r", repo_body(tmp_path, repo))
            out = c.create_snapshot("r", "snap1", {"indices": "src"})
            assert out["snapshot"]["state"] == "SUCCESS"
        baseline = cluster.search("src", BODY)
        cluster.delete_index("src")
        cluster.restore_snapshot("r", "snap1")
        restored = cluster.search("src", BODY)
        assert restored["hits"]["total"] == baseline["hits"]["total"]
        assert [h["_id"] for h in restored["hits"]["hits"]] == [h["_id"] for h in baseline["hits"]["hits"]]
        assert [h["_score"] for h in restored["hits"]["hits"]] == [h["_score"] for h in baseline["hits"]["hits"]]
        jcluster.delete_index("src")
        jcluster.restore_snapshot("r", "snap1")
        same_served(jcluster.search("src", BODY), restored)

    def test_restore_preserves_versions_and_seqnos(self, cluster, jcluster, tmp_path):
        got = []
        for c, repo, backend in ((cluster, "p", "torch"), (jcluster, "j", "numpy")):
            idx = seed(c, n=4, backend=backend)
            idx.index_doc("d0", {"body": "updated snapshot doc", "n": 100})
            idx.refresh()
            c.put_repository("r", repo_body(tmp_path, repo))
            c.create_snapshot("r", "s", {"indices": "src"})
            before = idx.get_doc("d0")
            c.delete_index("src")
            c.restore_snapshot("r", "s")
            after = c.get_index("src").get_doc("d0")
            assert after["_version"] == before["_version"] == 2
            assert after["_seq_no"] == before["_seq_no"]
            assert after["_source"]["n"] == 100
            got.append([(d, c.get_index("src").get_doc(d)["_version"], c.get_index("src").get_doc(d)["_seq_no"])
                        for d in ("d0", "d1", "d2", "d3")])
        assert got[0] == got[1]

    def test_restore_with_rename(self, cluster, tmp_path):
        seed(cluster)
        cluster.put_repository("r", repo_body(tmp_path))
        cluster.create_snapshot("r", "s", {"indices": "src"})
        cluster.restore_snapshot(
            "r", "s", {"indices": "src", "rename_pattern": "src", "rename_replacement": "copy"}
        )
        assert cluster.count("copy")["count"] == 12
        assert cluster.count("src")["count"] == 12
        same_served(cluster.search("src", BODY), cluster.search("copy", BODY))

    def test_restore_refuses_existing_index(self, cluster, tmp_path):
        seed(cluster)
        cluster.put_repository("r", repo_body(tmp_path))
        cluster.create_snapshot("r", "s", {"indices": "src"})
        with pytest.raises(ClusterError) as ei:
            cluster.restore_snapshot("r", "s")
        assert "already exists" in str(ei.value)

    def test_incremental_blob_dedup(self, cluster, tmp_path):
        seed(cluster)
        cluster.put_repository("r", repo_body(tmp_path))
        cluster.create_snapshot("r", "s1", {"indices": "src"})
        blobs = os.path.join(str(tmp_path / "repo1"), "blobs")
        n1 = len(os.listdir(blobs))
        cluster.create_snapshot("r", "s2", {"indices": "src"})
        assert len(os.listdir(blobs)) == n1
        out = cluster.get_snapshot("r", "_all")
        assert {s["snapshot"] for s in out["snapshots"]} == {"s1", "s2"}

    def test_delete_snapshot_gcs_blobs(self, cluster, tmp_path):
        seed(cluster)
        cluster.put_repository("r", repo_body(tmp_path))
        cluster.create_snapshot("r", "s1", {"indices": "src"})
        cluster.delete_snapshot("r", "s1")
        blobs = os.path.join(str(tmp_path / "repo1"), "blobs")
        assert os.listdir(blobs) == []
        with pytest.raises(ClusterError) as ei:
            cluster.get_snapshot("r", "s1")
        assert ei.value.status == 404

    def test_restored_index_serves_on_the_node_device(self, cluster, tmp_path):
        seed(cluster)
        cluster.put_repository("r", repo_body(tmp_path))
        cluster.create_snapshot("r", "s", {"indices": "src"})
        cluster.delete_index("src")
        cluster.restore_snapshot("r", "s")
        idx = cluster.get_index("src")
        assert idx.device.type == "cpu"
        assert all(e.device == idx.device and e.path is not None for e in idx.shards)
        assert cluster.search("src", BODY)["hits"]["hits"]
        ex = idx._executor(idx.shards[0])
        assert isinstance(ex, TorchExecutor) and ex.device.type == "cpu"


class TestInMemorySnapshots:
    def test_docs_mode_roundtrip(self, tmp_path):
        c = ClusterService(device="cpu")  # diskless: doc-mode snapshot payloads
        try:
            c.create_index("mem", {"settings": {"number_of_shards": 1}})
            idx = c.get_index("mem")
            for i in range(5):
                idx.index_doc(f"m{i}", {"body": f"memory doc {i}"})
            idx.refresh()
            c.put_repository("r", repo_body(tmp_path))
            c.create_snapshot("r", "s", {"indices": "mem"})
            c.delete_index("mem")
            c.restore_snapshot("r", "s")
            assert c.count("mem")["count"] == 5
            assert c.get_index("mem").device.type == "cpu"
        finally:
            c.close()

    def test_file_snapshot_restores_into_a_diskless_node(self, cluster, tmp_path):
        """A file-mode snapshot restored on a node without a data path
        replays the docs the scratch engine dumps, with their versions."""
        idx = seed(cluster, n=6)
        idx.index_doc("d2", {"body": "snapshot doc number two again", "n": 2})
        idx.refresh()
        cluster.put_repository("r", repo_body(tmp_path))
        cluster.create_snapshot("r", "s", {"indices": "src"})
        c = ClusterService(device="cpu")
        try:
            c.put_repository("r", repo_body(tmp_path))
            c.restore_snapshot("r", "s")
            assert c.count("src")["count"] == 6
            doc = c.get_index("src").get_doc("d2")
            assert doc["_version"] == 2 and doc["_seq_no"] == idx.get_doc("d2")["_seq_no"]
        finally:
            c.close()


# ---------------------------------------------------------------------------
# tests/test_snapshots.py's TestDistributedSnapshots on the port's nodes
# ---------------------------------------------------------------------------


@pytest.mark.usefixtures("cluster_harness")
class TestDistributedSnapshots:
    """A snapshot of an index whose shards lie on two nodes (the remote
    shards come over the transport: files from nodes with data paths,
    docs from diskless ones), then a restore through the master, held
    to the JAX package's nodes doing the same steps."""

    @staticmethod
    def _run(p, tmp_path, with_paths):
        def path(name):
            return str(tmp_path / p.name / name) if with_paths else None

        a = p.node("node-0", data_path=path("n0"), fd_interval=0.2)
        b = p.node("node-1", seeds=[a.address], data_path=path("n1"),
                   fd_interval=0.2)
        a.create_index("dist", {"settings": {"number_of_shards": 4,
                                             "number_of_replicas": 0}})
        for i in range(20):
            a.index_doc("dist", f"d{i}", {"body": f"distributed doc {i}"})
        a.refresh("dist")
        a.cluster.put_repository("r", repo_body(tmp_path, f"repo-{p.name}"))
        payloads = a.indices["dist"].snapshot_shards()
        out = a.cluster.create_snapshot("r", "s", {"indices": "dist"})
        assert out["snapshot"]["state"] == "SUCCESS"
        before = a.search("dist", {"query": {"match": {"body": "distributed"}},
                                   "size": 30})
        a.delete_index("dist")
        a.cluster.restore_snapshot("r", "s")
        a.refresh("dist")
        resp = a.search("dist", {"query": {"match": {"body": "distributed"}},
                                 "size": 30})
        assert resp["hits"]["total"]["value"] == 20
        owners = {e["primary"]
                  for e in a.state["indices"]["dist"]["routing"].values()}
        assert owners == {"node-0", "node-1"}
        return {
            "modes": {sid: sorted(pl) for sid, pl in payloads.items()},
            "shards": out["snapshot"]["shards"],
            "before": before,
            "after": resp,
            "routing": routing_table(a, "dist"),
            "devices": {n.name: sorted({str(getattr(e, "device", None))
                                        for e in n.indices["dist"].shards})
                        for n in (a, b)},
        }

    def _check(self, ref, got):
        assert got["modes"] == ref["modes"]
        assert got["shards"] == ref["shards"]
        assert got["routing"] == ref["routing"]
        assert_same_response(got["before"], ref["before"])
        assert_same_response(got["after"], ref["after"])
        # the restored pages are the pages served before the snapshot
        assert_same_response(got["after"], got["before"])

    def test_snapshot_and_restore_across_nodes(self, tmp_path):
        ref, got = twin(self._run, tmp_path, True)
        assert set(map(tuple, got["modes"].values())) == {("files",)}
        self._check(ref, got)

    def test_diskless_nodes_snapshot_docs_across_nodes(self, tmp_path):
        ref, got = twin(self._run, tmp_path, False)
        assert set(map(tuple, got["modes"].values())) == {("docs",)}
        self._check(ref, got)

    def test_restored_shards_serve_on_each_node_device(self, tmp_path):
        got = self._run(PORT, tmp_path, True)
        assert got["devices"] == {"node-0": ["cpu"], "node-1": ["cpu"]}


# ---------------------------------------------------------------------------
# the CLI in a subprocess
# ---------------------------------------------------------------------------


def run_cli(*args):
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO)
    env.pop("CUDA_VISIBLE_DEVICES", None)
    return subprocess.run(
        [sys.executable, "-m", "elasticsearch_tpu_torch", *args],
        capture_output=True, text=True, timeout=120, env=env, cwd=str(REPO),
    )


class TestCli:
    def test_version(self):
        import torch

        out = run_cli("version")
        assert out.returncode == 0, out.stderr
        data = json.loads(out.stdout)
        assert data["distribution"] == "elasticsearch-tpu-torch"
        assert data["torch"] == torch.__version__ and data["cuda"] == torch.version.cuda
        assert "jax" not in data

    def test_help(self):
        out = run_cli("--help")
        assert out.returncode == 0
        for cmd in ("serve", "version", "check", "plugin"):
            assert cmd in out.stdout

    def test_plugin_list(self):
        out = run_cli("plugin", "list")
        assert out.returncode == 0, out.stderr
        assert json.loads(out.stdout) == {"plugins": []}

    def test_check_fails_without_cuda(self):
        """This host has no CUDA device: `check` exits 1 and names it; it
        never checks the CPU instead."""
        out = run_cli("check")
        assert out.returncode == 1, (out.stdout, out.stderr)
        data = json.loads(out.stdout)
        assert data["checks_passed"] is False
        assert any("CUDA" in f for f in data["failures"])

    @pytest.mark.skipif(__import__("torch").cuda.is_available(), reason="a CUDA device is present")
    def test_serve_node_mode_fails_without_cuda(self, tmp_path):
        """`serve --node-name ... --seeds ...` starts a `TpuNode` on the
        card: with no CUDA device it exits non-zero naming it, and never
        serves from the CPU instead."""
        out = run_cli("serve", "--node-name", "node-1", "--seeds", "127.0.0.1:1",
                      "--transport-port", "0", "--port", "0", "--data-path", str(tmp_path / "n"))
        assert out.returncode != 0, (out.stdout, out.stderr)
        assert "no CUDA device" in out.stderr and "TpuNode [node-1]" in out.stderr
        assert "http://" not in out.stdout

    def test_unknown_command(self):
        out = run_cli("frobnicate")
        assert out.returncode == 2 and "unknown command" in out.stderr
