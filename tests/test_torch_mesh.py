"""The port's serving mesh against its own fan-out and the JAX package's
mesh, on the CPU.

The same documents (made with numpy from a seed) go into a JAX package
`IndexService` (`search.backend: jax`, whose mesh runs on the 8 virtual
CPU devices tests/conftest.py forces) and a port `IndexService`
(`search.backend: torch`, `device="cpu"`, whose mesh is one device with
every entry folded onto it). Each test twins a test of the reference's
tests/test_mesh.py, tests/test_sharded.py, or the mesh classes of
test_aggs_device.py, test_ann_ivf.py, test_rerank.py, test_sparse.py
and test_ingest_nrt.py, running its steps on both packages.

Tolerances: the port's forced mesh equals the port's own fan-out
(`ES_TPU_MESH=off`) BIT FOR BIT — ids, order, scores, max_score and
totals — exactly where the reference holds its mesh to its fan-out bit
for bit (the same-field bool is held within rtol 1e-5 in both packages,
as the reference's test states). Against the JAX package's forced mesh
the pages agree by id position (a run of scores tied within rtol 1e-5
as a set), scores within rtol 1e-5 (float32 sums taken in another order
by each package), totals and aggregations exactly. Port-only cases: one
device and fold = E, `auto` never engaging on one device, the data axis
clamping to 1, a real error inside a mesh dispatch raising instead of
falling back, and the `mesh` ledger bytes coming back on release.
"""

import json
import os

import numpy as np
import pytest
import torch

from elasticsearch_tpu.cluster.indices import IndexService as JIndexService
from elasticsearch_tpu.common.faults import faults as jfaults
from elasticsearch_tpu.common.memory import hbm_ledger as jledger
from elasticsearch_tpu.search import aggs_device as jaggs_device

from elasticsearch_tpu_torch.cluster.indices import IndexService
from elasticsearch_tpu_torch.common.faults import faults
from elasticsearch_tpu_torch.common.memory import hbm_ledger
from elasticsearch_tpu_torch.parallel import mesh_executor as port_mex
from elasticsearch_tpu_torch.search import aggs_device
from elasticsearch_tpu_torch.search.batcher import live_batchers

torch.set_num_threads(1)

pytestmark = pytest.mark.mesh

RTOL = 1e-5
DIMS = 8
VOCAB = ["alpha", "beta", "gamma", "delta", "epsilon", "zeta", "eta", "theta"]
MAPPING = {
    "properties": {
        "title": {"type": "text"},
        "body": {"type": "text"},
        "vec": {"type": "dense_vector", "dims": DIMS, "similarity": "cosine"},
    }
}
MESH_ENVS = ("ES_TPU_MESH", "ES_TPU_MESH_DATA")


@pytest.fixture(autouse=True)
def _mesh_env():
    """No test may leak a forced mesh mode into the rest of tier-1."""
    old = {k: os.environ.get(k) for k in MESH_ENVS}
    yield
    for k, v in old.items():
        if v is None:
            os.environ.pop(k, None)
        else:
            os.environ[k] = v


@pytest.fixture(autouse=True)
def _reset_port_singletons():
    """The port keeps its own process-wide admission controller and
    fault registry; tests/conftest.py resets only the JAX package's."""
    yield
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


# ---------------------------------------------------------------------------
# services over the same docs, and the comparisons
# ---------------------------------------------------------------------------


def make_docs(n_batches, per_batch, seed):
    rng = np.random.default_rng(seed)
    waves = []
    doc = 0
    for _ in range(n_batches):
        wave = []
        for _ in range(per_batch):
            words = rng.choice(VOCAB, size=int(rng.integers(3, 8)))
            v = rng.normal(size=DIMS)
            wave.append((str(doc), {
                "title": " ".join(rng.choice(VOCAB, size=2)),
                "body": " ".join(words),
                "vec": [float(x) for x in v],
            }))
            doc += 1
        waves.append(wave)
    return waves


def fill_waves(svc, waves):
    for wave in waves:
        for doc_id, src in wave:
            svc.index_doc(doc_id, dict(src))
        svc.refresh()


def jax_service(name, n_shards, settings=None, mapping=MAPPING):
    return JIndexService(
        name,
        settings={"number_of_shards": n_shards, "search.backend": "jax", **(settings or {})},
        mappings_json=mapping,
    )


def port_service(name, n_shards, settings=None, mapping=MAPPING):
    return IndexService(
        name,
        settings={"number_of_shards": n_shards, "search.backend": "torch", **(settings or {})},
        mappings_json=mapping, device="cpu",
    )


def make_pair(name, n_shards=4, batches=2, per_batch=60, seed=0):
    """(JAX IndexService, port IndexService) over the same docs, one
    segment per refresh wave per shard."""
    waves = make_docs(batches, per_batch, seed)
    pair = (jax_service(name, n_shards), port_service(name, n_shards))
    for svc in pair:
        fill_waves(svc, waves)
    return pair


def close_all(*svcs):
    for svc in svcs:
        svc.close()


@pytest.fixture(scope="module")
def pair():
    p = make_pair("mesh-parity")
    yield p
    close_all(*p)


def hits_of(resp):
    return [(h["_id"], h["_score"]) for h in resp["hits"]["hits"]]


def mesh_vs_seq(svc, body):
    """(mesh response, per-shard response); asserts the mesh actually
    served the first one."""
    mex = svc.mesh_executor()
    os.environ["ES_TPU_MESH"] = "force"
    try:
        routed0 = mex.stats["routed"]
        rm = svc.search(json.loads(json.dumps(body)))
        assert mex.stats["routed"] == routed0 + 1, "request not mesh-routed"
    finally:
        os.environ["ES_TPU_MESH"] = "off"
    rs = svc.search(json.loads(json.dumps(body)))
    return rm, rs


def assert_parity(rm, rs, totals=True):
    """Bit for bit: ids, order, scores, max_score, totals."""
    assert hits_of(rm) == hits_of(rs)
    assert rm["hits"]["max_score"] == rs["hits"]["max_score"]
    if totals:
        assert rm["hits"]["total"] == rs["hits"]["total"]
    assert rm["_shards"]["failed"] == 0
    assert rm["timed_out"] is False


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


def same_response(ref, got, what="", totals=True):
    """The port's page against the JAX package's: ids by position (tie
    runs as sets), scores within rtol 1e-5, totals exact."""
    if totals:
        assert got["hits"].get("total") == ref["hits"].get("total"), what
    rh, gh = ref["hits"]["hits"], got["hits"]["hits"]
    rs = np.array([h["_score"] for h in rh])
    assert len(gh) == len(rh), what
    np.testing.assert_allclose([h["_score"] for h in gh], rs, rtol=RTOL, atol=0, err_msg=what)
    same_ids([h["_id"] for h in rh], rs, [h["_id"] for h in gh], what)


def twin(pair, body, totals=True):
    """Runs one body through both packages' mesh and fan-out: each
    package's mesh equals its own fan-out bit for bit, and the port's
    mesh equals the JAX package's within the stated tolerance. Returns
    the port's (mesh, fan-out) responses."""
    jsvc, psvc = pair
    jm, js = mesh_vs_seq(jsvc, body)
    pm, ps = mesh_vs_seq(psvc, body)
    assert_parity(jm, js, totals)
    assert_parity(pm, ps, totals)
    same_response(jm, pm, json.dumps(body), totals)
    return pm, ps


TEXT_BODIES = [
    {"query": {"match": {"body": "alpha gamma"}}, "size": 10},
    {"query": {"match": {"body": {"query": "alpha beta", "operator": "and"}}}, "size": 10},
    {"query": {"match": {"body": {"query": "alpha beta gamma",
                                  "minimum_should_match": 2}}}, "size": 10},
    {"query": {"bool": {"must": [{"term": {"body": "alpha"}}],
                        "should": [{"match": {"title": "beta"}}]}}, "size": 10},
    {"query": {"bool": {"should": [{"match": {"body": "gamma"}},
                                   {"match": {"title": "delta"}}]}}, "size": 10},
    {"query": {"multi_match": {"query": "gamma delta",
                               "fields": ["title^2", "body"]}}, "size": 10},
    {"query": {"multi_match": {"query": "alpha epsilon", "fields": ["title", "body"],
                               "type": "most_fields"}}, "size": 10},
]


# ---------------------------------------------------------------------------
# tests/test_mesh.py twins
# ---------------------------------------------------------------------------


class TestFloatExactParity:
    def test_match_bool_multimatch(self, pair):
        for body in TEXT_BODIES:
            twin(pair, body)

    def test_bool_same_field_multi_clause(self, pair):
        # must + multi-term should on ONE field: the per-shard bool on
        # these small segments walks the query tree, whose f32
        # association order differs from the flat plan's tile order in
        # the last ulp (in both packages). Contract: identical ranking,
        # scores within rtol 1e-5, equal totals.
        body = {
            "query": {"bool": {"must": [{"term": {"body": "alpha"}}],
                               "should": [{"match": {"body": "beta gamma"}}]}},
            "size": 10,
        }
        for svc in pair:
            rm, rs = mesh_vs_seq(svc, body)
            assert [h[0] for h in hits_of(rm)] == [h[0] for h in hits_of(rs)]
            np.testing.assert_allclose(
                [h[1] for h in hits_of(rm)], [h[1] for h in hits_of(rs)], rtol=RTOL, atol=0
            )
            assert rm["hits"]["total"] == rs["hits"]["total"]

    def test_knn(self, pair):
        rng = np.random.default_rng(3)
        for k, nc in ((8, 20), (5, 7), (10, 200)):
            body = {
                "knn": {"field": "vec",
                        "query_vector": [float(x) for x in rng.normal(size=DIMS)],
                        "k": k, "num_candidates": nc},
                "size": k,
            }
            twin(pair, body)

    def test_knn_size_beyond_k(self, pair):
        # size > knn.k: the per-shard path serves up to k hits PER SHARD,
        # so the page can hold up to k x n_shards hits — the mesh collect
        # applies the same per-shard rank caps, not a global k cut
        rng = np.random.default_rng(4)
        body = {
            "knn": {"field": "vec",
                    "query_vector": [float(x) for x in rng.normal(size=DIMS)],
                    "k": 3, "num_candidates": 10},
            "size": 20,
        }
        pm, _ = twin(pair, body)
        assert len(pm["hits"]["hits"]) > 3  # several shards contribute

    def test_pagination_and_source(self, pair):
        body = {"query": {"match": {"body": "alpha gamma"}},
                "from": 5, "size": 7, "_source": False}
        pm, _ = twin(pair, body)
        assert all("_source" not in h for h in pm["hits"]["hits"])
        body2 = {"query": {"match": {"body": "alpha"}}, "size": 3, "_source": ["title"]}
        pm, ps = twin(pair, body2)
        assert [h.get("_source") for h in pm["hits"]["hits"]] == [
            h.get("_source") for h in ps["hits"]["hits"]
        ]

    def test_track_total_hits_variants(self, pair):
        for tth in (True, False, 5):
            body = {"query": {"match": {"body": "alpha"}}, "size": 5, "track_total_hits": tth}
            if tth == 5:
                # pruning may engage per shard; both paths agree on the
                # capped value and the page stays identical
                for svc in pair:
                    rm, rs = mesh_vs_seq(svc, body)
                    assert rm["hits"]["total"]["value"] == rs["hits"]["total"]["value"]
                    assert hits_of(rm) == hits_of(rs)
                continue
            pm, ps = twin(pair, body, totals=tth is not False)
            if tth is False:
                assert "total" not in pm["hits"] and "total" not in ps["hits"]


class TestLayouts:
    def test_fold_more_entries_than_devices(self):
        # 4 shards x 3 refresh generations = 12 entries: the JAX package
        # folds them onto 8 devices (fold 2), the port onto its one
        # device (fold 12 = E)
        p = make_pair("mesh-fold", n_shards=4, batches=3, per_batch=40, seed=5)
        try:
            os.environ["ES_TPU_MESH"] = "force"
            jsnap = p[0].mesh_executor().ensure_snapshot()
            snap = p[1].mesh_executor().ensure_snapshot()
            assert len(jsnap.entries) == len(snap.entries) == 12
            assert jsnap.fold >= 2
            assert snap.fold == 12 and snap.e_pad == 12
            assert snap.mesh.shape == {"data": 1, "shards": 1}
            for body in (TEXT_BODIES[0], TEXT_BODIES[3]):
                twin(p, body)
        finally:
            close_all(*p)

    def test_non_power_of_two_shards(self):
        p = make_pair("mesh-npot", n_shards=5, batches=1, per_batch=75, seed=6)
        try:
            for body in (TEXT_BODIES[0], TEXT_BODIES[5]):
                twin(p, body)
        finally:
            close_all(*p)

    def test_data_axis_parity(self):
        # ES_TPU_MESH_DATA=2: the JAX package shards the query batch over
        # a 2-wide data axis; the port's one device clamps it to 1, with
        # the same pages
        p = make_pair("mesh-data-axis", n_shards=3, batches=1, per_batch=60, seed=11)
        os.environ["ES_TPU_MESH_DATA"] = "2"
        try:
            for body in (TEXT_BODIES[0], TEXT_BODIES[3]):
                twin(p, body)
            snap = p[1].mesh_executor().ensure_snapshot()
            assert snap.mesh.shape["data"] == 1
        finally:
            close_all(*p)

    def test_make_mesh_folding_api(self):
        import jax

        from elasticsearch_tpu.parallel import fold_factor as jfold
        from elasticsearch_tpu.parallel import make_mesh as jmake

        from elasticsearch_tpu_torch.parallel import fold_factor, make_mesh

        jdevs = jax.devices()
        devs = [torch.device("cuda", i) for i in range(len(jdevs))]
        for n_shards, pick in ((5, None), (12, None), (12, 1)):
            jm = jmake(n_shards, devices=jdevs[:pick] if pick else jdevs)
            m = make_mesh(n_shards, devices=devs[:pick] if pick else devs)
            assert m.shape == dict(jm.shape)
            assert fold_factor(m, n_shards) == jfold(jm, n_shards)
        assert make_mesh(5, devices=devs).shape["shards"] == 5
        assert fold_factor(make_mesh(12, devices=devs[:1]), 12) == 12
        with pytest.raises(ValueError):
            make_mesh(4, n_data=2, devices=devs[:1])


class TestRoutingPredicate:
    def test_auto_mode_engages_multi_shard(self, pair):
        # auto engages with >= 2 devices: the JAX package's 8 virtual
        # devices route the body; the port's one device keeps the fan-out
        os.environ.pop("ES_TPU_MESH", None)  # auto
        body = {"query": {"match": {"body": "alpha"}}, "size": 3}
        jsvc, psvc = pair
        jmex, pmex = jsvc.mesh_executor(), psvc.mesh_executor()
        assert jmex.available()
        assert not pmex.available()
        jr0, pr0 = jmex.stats["routed"], pmex.stats["routed"]
        same_response(jsvc.search(dict(body)), psvc.search(dict(body)))
        assert jmex.stats["routed"] == jr0 + 1
        assert pmex.stats["routed"] == pr0

    def test_single_shard_stays_sequential(self):
        p = make_pair("mesh-1shard", n_shards=1, batches=1, per_batch=30, seed=7)
        try:
            os.environ.pop("ES_TPU_MESH", None)  # auto
            body = {"query": {"match": {"body": "alpha"}}, "size": 3}
            for svc in p:
                assert not svc.mesh_executor().available()
            r = p[1].search(dict(body))
            assert r["hits"]["hits"]
            same_response(p[0].search(dict(body)), r)
        finally:
            close_all(*p)

    def test_ineligible_bodies_fall_through(self, pair):
        os.environ["ES_TPU_MESH"] = "force"
        for svc in pair:
            mex = svc.mesh_executor()
            routed0 = mex.stats["routed"]
            # aggs (not mesh-eligible), sort, timeout: the shard path
            svc.search({
                "query": {"match": {"body": "alpha"}}, "size": 0,
                "aggs": {"n": {"value_count": {"field": "title"}}},
            })
            svc.search({"query": {"match": {"body": "alpha"}},
                        "sort": [{"_id": "asc"}], "size": 3})
            svc.search({"query": {"match": {"body": "alpha"}}, "timeout": "10s", "size": 3})
            assert mex.stats["routed"] == routed0


class TestLifecycle:
    def test_generation_bump_rebuilds_snapshot(self):
        p = make_pair("mesh-gen", n_shards=3, batches=1, per_batch=45, seed=8)
        try:
            os.environ["ES_TPU_MESH"] = "force"
            pages = []
            for svc in p:
                mex = svc.mesh_executor()
                r = svc.search({"query": {"match": {"body": "theta"}}, "size": 50})
                before_ids = {h["_id"] for h in r["hits"]["hits"]}
                rebuilds0 = mex.stats["rebuilds"]
                svc.index_doc("fresh-doc", {"title": "theta", "body": "theta theta theta",
                                            "vec": [0.0] * DIMS})
                svc.refresh()
                r2 = svc.search({"query": {"match": {"body": "theta"}}, "size": 50})
                ids2 = {h["_id"] for h in r2["hits"]["hits"]}
                assert "fresh-doc" in ids2 and "fresh-doc" not in before_ids
                assert mex.stats["rebuilds"] == rebuilds0 + 1
                pages.append(r2)
            same_response(*pages)
        finally:
            close_all(*p)

    def test_hbm_budget_degrades_to_sequential(self, monkeypatch):
        p = make_pair("mesh-hbm", n_shards=3, batches=1, per_batch=45, seed=9)
        body = {"query": {"match": {"body": "alpha"}}, "size": 10}
        try:
            meshed = []
            for svc, ledger in zip(p, (jledger, hbm_ledger)):
                os.environ["ES_TPU_MESH"] = "force"
                mex = svc.mesh_executor()
                monkeypatch.setattr(ledger, "budget", ledger.used + 1)
                degraded0 = ledger.stats_counters["degraded"]
                rm = svc.search(dict(body))
                assert mex.stats["fallbacks"] >= 1
                assert mex.stats["degraded"] >= 1
                assert mex.stats["routed"] == 0
                assert ledger.stats_counters["degraded"] > degraded0
                monkeypatch.undo()
                os.environ["ES_TPU_MESH"] = "off"
                assert hits_of(rm) == hits_of(svc.search(dict(body)))
                meshed.append(rm)
            same_response(*meshed)
        finally:
            close_all(*p)

    def test_snapshot_release_returns_ledger_bytes(self):
        p = make_pair("mesh-ledger", n_shards=2, batches=1, per_batch=30, seed=10)
        try:
            os.environ["ES_TPU_MESH"] = "force"
            for svc, ledger in zip(p, (jledger, hbm_ledger)):
                base = ledger.stats()["by_category"].get("mesh", 0)
                svc.search({"query": {"match": {"body": "alpha"}}, "size": 5})
                charged = ledger.stats()["by_category"].get("mesh", 0)
                assert charged > base
                svc.mesh_executor().close()
                # every byte this index's snapshot charged comes back
                assert ledger.stats()["by_category"].get("mesh", 0) == base
        finally:
            close_all(*p)


class TestFaultInjection:
    @staticmethod
    def _inject(reg, site):
        reg.configure({
            "seed": 0,
            "rules": [{"site": site, "match": {"mesh": 1}, "kind": "error",
                       "prob": 1.0, "times": 1}],
        })

    def _check(self, pair, body, site):
        out = []
        for svc, reg in zip(pair, (jfaults, faults)):
            os.environ["ES_TPU_MESH"] = "off"
            rs = svc.search(dict(body))
            os.environ["ES_TPU_MESH"] = "force"
            mex = svc.mesh_executor()
            fb0 = mex.stats["fallbacks"]
            self._inject(reg, site)
            try:
                rm = svc.search(dict(body))
            finally:
                reg.clear()
            assert mex.stats["fallbacks"] == fb0 + 1
            assert hits_of(rm) == hits_of(rs)
            assert rm["_shards"]["failed"] == 0
            out.append(rm)
        same_response(*out)

    def test_dispatch_fault_falls_back(self, pair):
        self._check(pair, {"query": {"match": {"body": "alpha gamma"}}, "size": 10},
                    "batcher.dispatch")

    def test_collect_fault_falls_back(self, pair):
        body = {"knn": {"field": "vec", "query_vector": [0.5] * DIMS, "k": 6,
                        "num_candidates": 20}, "size": 6}
        self._check(pair, body, "batcher.collect")


class TestObservability:
    def test_device_stats_rows(self, pair):
        os.environ["ES_TPU_MESH"] = "force"
        jsvc, psvc = pair
        for svc in pair:
            svc.search({"query": {"match": {"body": "alpha"}}, "size": 5})
        assert len(jsvc._batcher.device_stats()) >= 2  # 8 virtual devices
        rows = psvc._batcher.device_stats()
        # the port's mesh spans the index's one device
        assert [r["id"] for r in rows] == [0]
        for row in rows:
            assert set(row) == {"id", "device_busy_ms", "flops", "mfu"}
            assert row["device_busy_ms"] >= 0.0 and row["mfu"] >= 0.0
            assert row["flops"] > 0

    def test_nodes_stats_devices_and_mesh_block(self):
        from elasticsearch_tpu.cluster.service import ClusterService as JCluster
        from elasticsearch_tpu.rest.actions import RestActions as JActions

        from elasticsearch_tpu_torch.cluster.service import ClusterService
        from elasticsearch_tpu_torch.rest.actions import RestActions

        blocks = []
        for cluster, actions, backend in (
            (JCluster(), JActions, "jax"),
            (ClusterService(device="cpu"), RestActions, "torch"),
        ):
            try:
                os.environ["ES_TPU_MESH"] = "force"
                cluster.create_index("meshstats", {
                    "settings": {"number_of_shards": 2, "search.backend": backend},
                    "mappings": {"properties": {"body": {"type": "text"}}},
                })
                idx = cluster.indices["meshstats"]
                for i in range(24):
                    idx.index_doc(str(i), {"body": f"alpha beta w{i % 5}"})
                idx.refresh()
                idx.search({"query": {"match": {"body": "alpha"}}, "size": 5})
                _, resp = actions(cluster).nodes_stats(None, {}, {})
                pipe = resp["nodes"]["node-0"]["pipeline"]
                assert pipe["mesh"]["routed"] >= 1
                assert len(pipe["devices"]) >= 1
                for row in pipe["devices"]:
                    assert {"id", "device_busy_ms", "flops", "mfu"} <= set(row)
                blocks.append(pipe["mesh"])
            finally:
                for svc in list(cluster.indices.values()):
                    svc.close()
        assert set(blocks[1]) == set(blocks[0])
        assert blocks[1]["routed"] == blocks[0]["routed"] == 1

    def test_stats_snapshot_shape(self, pair):
        keys = {"routed", "launches", "jobs", "rebuilds", "degraded", "fallbacks",
                "entries", "devices"}
        jsnap = pair[0].mesh_executor().stats_snapshot()
        snap = pair[1].mesh_executor().stats_snapshot()
        assert keys <= set(jsnap) and keys <= set(snap)
        assert snap["devices"] == 1


# ---------------------------------------------------------------------------
# the port-only contract
# ---------------------------------------------------------------------------


def test_one_device_folds_every_entry(pair):
    """The port's mesh is the index's one device: `shards` 1 wide, fold =
    E, and one launch per batcher group."""
    psvc = pair[1]
    os.environ["ES_TPU_MESH"] = "force"
    mex = psvc.mesh_executor()
    snap = mex.ensure_snapshot()
    assert snap.mesh.shape == {"data": 1, "shards": 1}
    assert snap.fold == len(snap.entries) == snap.e_pad == 8  # 4 shards x 2 waves
    assert str(snap.device) == "cpu"
    l0, j0 = mex.stats["launches"], mex.stats["jobs"]
    psvc.search({"query": {"match": {"body": "alpha"}}, "size": 5})
    assert (mex.stats["launches"], mex.stats["jobs"]) == (l0 + 1, j0 + 1)


def test_multi_device_mesh_is_refused():
    """A grid of several distinct devices is the multi-card mesh, which
    the port does not have: a step over it raises."""
    from elasticsearch_tpu_torch.parallel.mesh import make_mesh, mesh_device

    with pytest.raises(ValueError, match="12c"):
        mesh_device(make_mesh(2, devices=[torch.device("cuda", 0), torch.device("cuda", 1)]))
    assert str(mesh_device(make_mesh(3, devices=["cpu"]))) == "cpu"


def test_real_error_in_mesh_dispatch_raises(pair, monkeypatch):
    """Only MeshUnavailable, an injected fault or a closed batcher send a
    mesh request to the fan-out: a real error inside a dispatch reaches
    the caller."""
    psvc = pair[1]
    os.environ["ES_TPU_MESH"] = "force"
    mex = psvc.mesh_executor()
    fb0 = mex.stats["fallbacks"]

    def boom(self, jobs, kb):
        raise RuntimeError("device fault inside the mesh step")

    monkeypatch.setattr(port_mex.MeshExecutor, "dispatch_match", boom)
    with pytest.raises(RuntimeError, match="device fault inside the mesh step"):
        psvc.search({"query": {"match": {"body": "alpha"}}, "size": 5})
    assert mex.stats["fallbacks"] == fb0


def test_closed_batcher_falls_back():
    psvc = port_service("mesh-closed", 2)
    try:
        fill_waves(psvc, make_docs(1, 30, 12))
        os.environ["ES_TPU_MESH"] = "force"
        mex = psvc.mesh_executor()
        psvc._batcher.close()
        r = psvc.search({"query": {"match": {"body": "alpha"}}, "size": 5})
        assert mex.stats["fallbacks"] == 1 and mex.stats["routed"] == 0
        os.environ["ES_TPU_MESH"] = "off"
        assert hits_of(r) == hits_of(psvc.search({"query": {"match": {"body": "alpha"}},
                                                  "size": 5}))
    finally:
        psvc.close()


# ---------------------------------------------------------------------------
# tests/test_sharded.py twins
# ---------------------------------------------------------------------------

SH_VOCAB = [
    "quick", "brown", "fox", "lazy", "dog", "jumps", "river", "stone",
    "cloud", "rain", "forest", "mountain", "search", "engine", "index",
]
SH_MAPPING = {
    "properties": {
        "body": {"type": "text"},
        "embedding": {"type": "dense_vector", "dims": 8, "similarity": "cosine"},
    }
}


def make_shards(pkg, n_shards=4, docs_per_shard=40, seed=7):
    """Per-shard segments built by one package's SegmentBuilder."""
    import importlib

    analysis = importlib.import_module(f"{pkg}.analysis")
    mapping = importlib.import_module(f"{pkg}.index.mapping")
    segment = importlib.import_module(f"{pkg}.index.segment")
    rng = np.random.default_rng(seed)
    mappings = mapping.Mappings(SH_MAPPING)
    reg = analysis.AnalysisRegistry()
    parser = mapping.DocumentParser(mappings, reg)
    segments = []
    for s in range(n_shards):
        builder = segment.SegmentBuilder(mappings)
        for i in range(docs_per_shard):
            words = rng.choice(SH_VOCAB, size=int(rng.integers(3, 12))).tolist()
            vec = rng.standard_normal(8).astype(np.float32)
            builder.add(parser.parse(f"{s}-{i}", {"body": " ".join(words),
                                                  "embedding": vec.tolist()}))
        segments.append(builder.build())
    return mappings, reg, segments


@pytest.fixture(scope="module")
def sharded():
    """(JAX ShardedIndex on a (data=2, shards=4) mesh, port ShardedIndex
    on its one device) over the same docs."""
    from elasticsearch_tpu.parallel import ShardedIndex as JSharded
    from elasticsearch_tpu.parallel import make_mesh as jmake

    from elasticsearch_tpu_torch.parallel import ShardedIndex, make_mesh

    _, _, jsegs = make_shards("elasticsearch_tpu")
    mappings, reg, segs = make_shards("elasticsearch_tpu_torch")
    jidx = JSharded(jmake(n_shards=4, n_data=2), jsegs, "body", vector_field="embedding")
    idx = ShardedIndex(make_mesh(4, devices=["cpu"]), segs, "body", vector_field="embedding")
    return jidx, idx, mappings, reg, segs


def oracle_merge(segments, mappings, reg, terms, operator, k):
    """Per-shard numpy oracle search merged coordinator-style (score
    desc, shard asc, doc asc)."""
    from elasticsearch_tpu_torch.search import dsl
    from elasticsearch_tpu_torch.search.executor import NumpyExecutor, ShardReader

    entries = []
    total = 0
    for si, seg in enumerate(segments):
        ex = NumpyExecutor(ShardReader([seg], mappings, reg))
        q = dsl.parse_query({"match": {"body": {"query": " ".join(terms), "operator": operator}}})
        td = ex.search(q, size=seg.num_docs)
        total += td.total
        entries.extend((-h.score, si, h.local_doc) for h in td.hits)
    entries.sort()
    return entries[:k], total


SH_QUERIES = [
    (["quick", "fox"], "or"), (["lazy", "dog", "river"], "or"),
    (["forest", "mountain"], "and"), (["search", "engine"], "or"),
    (["quick"], "or"), (["stone", "cloud"], "and"), (["rain"], "or"),
    (["index", "fox"], "or"),
]


class TestShardedBM25:
    def test_matches_per_shard_oracle_merge(self, sharded):
        from elasticsearch_tpu.parallel import build_sharded_bm25_step as jbuild

        from elasticsearch_tpu_torch.parallel import build_sharded_bm25_step

        jidx, idx, mappings, reg, segs = sharded
        term_lists = [t for t, _ in SH_QUERIES]
        ops = [o for _, o in SH_QUERIES]
        out = build_sharded_bm25_step(idx, k=10)(*idx.compile_queries(term_lists, ops))
        jout = jbuild(jidx, k=10)(*jidx.compile_queries(term_lists, ops))
        scores, docs, totals = (t.numpy() for t in out)
        doc_base = np.cumsum([0] + [s.num_docs for s in segs[:-1]])
        for bi, (terms, op) in enumerate(SH_QUERIES):
            expect, exp_total = oracle_merge(segs, mappings, reg, terms, op, 10)
            assert totals[bi] == exp_total == int(np.asarray(jout.totals)[bi])
            got = [(float(scores[bi, j]), int(docs[bi, j]))
                   for j in range(10) if np.isfinite(scores[bi, j])]
            assert len(got) == len(expect)
            for (negs, si, local), (gs, gd) in zip(expect, got):
                assert gd == doc_base[si] + local
                np.testing.assert_allclose(gs, -negs, rtol=RTOL)
            np.testing.assert_array_equal(docs[bi], np.asarray(jout.global_docs)[bi])
            np.testing.assert_allclose(scores[bi], np.asarray(jout.scores)[bi], rtol=RTOL)

    def test_empty_and_unknown_terms(self, sharded):
        from elasticsearch_tpu_torch.parallel import build_sharded_bm25_step

        _, idx, _, _, _ = sharded
        out = build_sharded_bm25_step(idx, k=5)(
            *idx.compile_queries([["zzzznotaterm"], ["fox"]] * 4, ["or"] * 8)
        )
        assert out.totals.numpy()[0] == 0
        assert not np.isfinite(out.scores.numpy()[0]).any()
        assert out.totals.numpy()[1] > 0


class TestShardedKnn:
    def test_matches_host_brute_force(self, sharded):
        from elasticsearch_tpu.parallel import build_sharded_knn_step as jbuild

        from elasticsearch_tpu_torch.parallel import build_sharded_knn_step

        jidx, idx, _, _, segs = sharded
        q = np.random.default_rng(3).standard_normal((8, 8)).astype(np.float32)
        out = build_sharded_knn_step(idx, k=10, similarity="cosine")(q)
        jout = jbuild(jidx, k=10, similarity="cosine")(q)
        docs, scores = out.global_docs.numpy(), out.scores.numpy()
        allv = np.concatenate([s.vectors["embedding"].unit_vectors for s in segs], axis=0)
        qn = q / np.linalg.norm(q, axis=1, keepdims=True)
        ref = (1.0 + qn @ allv.T) / 2.0
        for bi in range(8):
            order = np.argsort(-ref[bi], kind="stable")[:10]
            np.testing.assert_array_equal(docs[bi], order)
            np.testing.assert_allclose(scores[bi], ref[bi][order], rtol=RTOL)
            np.testing.assert_array_equal(docs[bi], np.asarray(jout.global_docs)[bi])


class TestRRF:
    def test_fuse_ranks(self, sharded):
        from elasticsearch_tpu.parallel import build_sharded_bm25_step as jbm25
        from elasticsearch_tpu.parallel import build_sharded_knn_step as jknn
        from elasticsearch_tpu.parallel import rrf_fuse as jrrf

        from elasticsearch_tpu_torch.parallel import (
            build_sharded_bm25_step,
            build_sharded_knn_step,
            rrf_fuse,
        )

        jidx, idx, _, _, _ = sharded
        qv = np.random.default_rng(5).standard_normal((8, 8)).astype(np.float32)
        lex = build_sharded_bm25_step(idx, k=10)(*idx.compile_queries([["quick", "fox"]] * 8, ["or"] * 8))
        vec = build_sharded_knn_step(idx, k=10)(qv)
        s, d = (t.numpy() for t in rrf_fuse(lex, vec, k=10))
        jlex = jbm25(jidx, k=10)(*jidx.compile_queries([["quick", "fox"]] * 8, ["or"] * 8))
        js, jd = (np.asarray(t) for t in jrrf(jlex, jknn(jidx, k=10)(qv), k=10))
        # fused scores are RRF sums: bounded by 2/(60+1), monotone per row
        assert (s[np.isfinite(s)] <= 2 / 61 + 1e-6).all()
        for bi in range(s.shape[0]):
            row = s[bi][np.isfinite(s[bi])]
            assert (np.diff(row) <= 1e-9).all()
            valid = d[bi][d[bi] >= 0]
            assert len(np.unique(valid)) == len(valid), "no duplicate docs"
        np.testing.assert_array_equal(d, jd)
        np.testing.assert_allclose(s, js, rtol=RTOL)


# ---------------------------------------------------------------------------
# TestMeshAggs twins (test_aggs_device.py)
# ---------------------------------------------------------------------------

AGG_WORDS = ["alpha", "beta", "gamma", "delta", "epsilon"]
CATS = ["red", "green", "blue", "black"]
AGG_MAPPING = {
    "properties": {
        "body": {"type": "text"}, "cat": {"type": "keyword"},
        "tags": {"type": "keyword"}, "price": {"type": "double"},
        "qty": {"type": "integer"}, "flag": {"type": "boolean"},
        "day": {"type": "date"}, "huge": {"type": "double"},
    }
}


def agg_docs(n, seed):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        doc = {
            "body": " ".join(rng.choice(AGG_WORDS, size=int(rng.integers(1, 4)))),
            "cat": str(rng.choice(CATS)),
            "tags": [str(t) for t in rng.choice(CATS, size=int(rng.integers(0, 3)),
                                                replace=False)],
            "qty": int(rng.integers(0, 50)),
            "flag": bool(rng.integers(0, 2)),
        }
        if rng.random() > 0.15:
            doc["price"] = int(rng.integers(1, 500))
        if rng.random() > 0.15:
            doc["day"] = int(1_700_000_000_000 + int(rng.integers(0, 90)) * 86_400_000)
        if rng.random() > 0.5:
            doc["huge"] = float(rng.random() * 1e17 + 0.123456789)
        out.append((str(i), doc))
    return out


def agg_trio(name, n_docs, n_shards, seed):
    """(JAX, port, port numpy backend) services over the same docs, two
    refresh rounds (several segments per shard)."""
    docs = agg_docs(n_docs, seed)
    svcs = (
        jax_service(name, n_shards, mapping=AGG_MAPPING),
        port_service(name, n_shards, mapping=AGG_MAPPING),
        port_service(name + "-np", n_shards, settings={"search.backend": "numpy"},
                     mapping=AGG_MAPPING),
    )
    half = n_docs // 2
    for svc in svcs:
        fill_waves(svc, [docs[:half], docs[half:]])
    return svcs


def _rt(body):
    return json.loads(json.dumps(body))


class TestMeshAggs:
    def test_mesh_agg_parity(self, monkeypatch):
        """Agg bodies execute as ONE stacked launch and equal the
        per-shard path, the numpy backend and the JAX package's mesh."""
        jx, px, pn = agg_trio("mesh-aggs", 160, 4, 41)
        try:
            bodies = [
                {"size": 0, "aggs": {
                    "s": {"stats": {"field": "qty"}},
                    "cats": {"terms": {"field": "cat"}},
                    "dh": {"date_histogram": {"field": "day", "fixed_interval": "7d"}}}},
                {"size": 0, "query": {"match": {"body": "alpha"}},
                 "aggs": {"cats": {"terms": {"field": "cat"}},
                          "m": {"max": {"field": "qty"}}}},
                {"size": 0, "query": {"match_all": {}},
                 "aggs": {"h": {"histogram": {"field": "qty", "interval": 10}}}},
                {"size": 0, "aggs": {"mn": {"min": {"field": "price"}},
                                     "av": {"avg": {"field": "qty"}},
                                     "sp": {"sum": {"field": "price"}},
                                     "vc": {"value_count": {"field": "price"}}}},
            ]
            monkeypatch.setenv("ES_TPU_MESH", "off")
            base = [px.search(_rt(b)) for b in bodies]
            oracle = [pn.search(_rt(b)) for b in bodies]
            monkeypatch.setenv("ES_TPU_MESH", "force")
            before = aggs_device.stats_snapshot()["mesh_routed"]
            jbefore = jaggs_device.stats_snapshot()["mesh_routed"]
            meshed = [px.search(_rt(b)) for b in bodies]
            jmeshed = [jx.search(_rt(b)) for b in bodies]
            for b0, bo, b1, bj in zip(base, oracle, meshed, jmeshed):
                assert b1["aggregations"] == b0["aggregations"] == bo["aggregations"]
                assert b1["aggregations"] == bj["aggregations"]
                assert b1["hits"]["total"] == b0["hits"]["total"] == bj["hits"]["total"]
                assert b1["hits"]["max_score"] == b0["hits"]["max_score"]
            assert aggs_device.stats_snapshot()["mesh_routed"] == before + len(bodies)
            assert jaggs_device.stats_snapshot()["mesh_routed"] >= jbefore + len(bodies)
            # a mesh-unsupported tree (filter agg) falls through to the
            # per-shard device engine — still exact, never an error
            fb = {"size": 0, "aggs": {"f": {"filter": {"term": {"cat": "red"}}}}}
            r_mesh = px.search(_rt(fb))
            assert aggs_device.stats_snapshot()["mesh_routed"] == before + len(bodies)
            monkeypatch.setenv("ES_TPU_MESH", "off")
            assert r_mesh["aggregations"] == px.search(_rt(fb))["aggregations"]
            assert r_mesh["aggregations"] == jx.search(_rt(fb))["aggregations"]
        finally:
            close_all(jx, px, pn)

    def test_mesh_auto_keeps_request_cache_path(self, monkeypatch):
        """In auto mode cacheable agg bodies stay on the shard path (the
        request cache owns them); on the port's one device auto keeps
        every body there, where the JAX package's 8 devices route the
        cache-opted-out body to its mesh."""
        jx, px, pn = agg_trio("mesh-aggs-auto", 80, 4, 51)
        try:
            monkeypatch.setenv("ES_TPU_MESH", "auto")
            body = {"size": 0, "aggs": {"s": {"stats": {"field": "qty"}}}}
            before = aggs_device.stats_snapshot()["mesh_routed"]
            jbefore = jaggs_device.stats_snapshot()["mesh_routed"]
            px.search(_rt(body))
            jx.search(_rt(body))
            assert jaggs_device.stats_snapshot()["mesh_routed"] == jbefore
            opted_out = {**_rt(body), "request_cache": False}
            r1 = px.search(dict(opted_out))
            r2 = px.search(_rt(body))
            assert r1["aggregations"] == r2["aggregations"]
            assert r1["aggregations"] == jx.search(dict(opted_out))["aggregations"]
            assert jaggs_device.stats_snapshot()["mesh_routed"] > jbefore
            assert aggs_device.stats_snapshot()["mesh_routed"] == before
        finally:
            close_all(jx, px, pn)


# ---------------------------------------------------------------------------
# TestMeshAnn twins (test_ann_ivf.py)
# ---------------------------------------------------------------------------

ANN_DIMS = 32
ANN_MAPPING = {
    "properties": {
        "body": {"type": "text"},
        "vec": {"type": "dense_vector", "dims": ANN_DIMS, "similarity": "cosine"},
    }
}
IVF = {"knn.type": "ivf", "knn.nlist": 8, "knn.nprobe": 4}


def clustered_vectors(n, seed, noise=0.5):
    rng = np.random.default_rng(seed)
    centers = np.random.default_rng(99).normal(size=(24, ANN_DIMS))
    asg = rng.integers(0, 24, size=n)
    v = centers[asg] + noise * rng.normal(size=(n, ANN_DIMS))
    return (v / np.linalg.norm(v, axis=1, keepdims=True)).astype(np.float32)


def ann_queries(vecs, n_q, seed):
    rng = np.random.default_rng(seed)
    picks = rng.choice(len(vecs), size=n_q, replace=False)
    q = vecs[picks] + 0.05 * rng.normal(size=(n_q, ANN_DIMS))
    return (q / np.linalg.norm(q, axis=1, keepdims=True)).astype(np.float32)


def ann_body(qv, k=10, nc=200):
    return {"knn": {"field": "vec", "query_vector": [float(x) for x in qv], "k": k,
                    "num_candidates": nc}, "size": k}


def ann_fill(svcs, vecs):
    words = ["alpha", "beta", "gamma", "delta"]
    for svc in svcs:
        for i, v in enumerate(vecs):
            svc.index_doc(str(i), {"body": words[i % 4], "vec": [float(x) for x in v]})
        svc.refresh()


class TestMeshAnn:
    @pytest.fixture(autouse=True)
    def _ann_floor(self, monkeypatch):
        """Test corpora are small: lower the small-segment exact floor
        of both packages so the IVF tier engages."""
        monkeypatch.setenv("ES_TPU_ANN_MIN_DOCS", "64")

    @pytest.mark.parametrize("quantized", [False, True])
    def test_mesh_ann_bit_exact_vs_per_shard(self, quantized):
        """The stacked probe (centroid scan per entry, each entry's
        cluster-major block, the num_candidates merge) equals the
        per-shard IVF path bit for bit (both probe the same per-segment
        indexes), in f32 and int8."""
        extra = {**IVF, "knn.quantization": "int8"} if quantized else IVF
        vecs = clustered_vectors(1200, seed=15)
        psvc = port_service(f"ivf-mesh-{int(quantized)}", 4, settings=extra,
                            mapping=ANN_MAPPING)
        try:
            ann_fill([psvc], vecs)
            mex = psvc.mesh_executor()
            for qv in ann_queries(vecs, 6, seed=43):
                os.environ["ES_TPU_MESH"] = "force"
                r0 = mex.stats["routed"]
                rm = psvc.search(ann_body(qv))
                assert mex.stats["routed"] == r0 + 1
                os.environ["ES_TPU_MESH"] = "off"
                assert_parity(rm, psvc.search(ann_body(qv)))
        finally:
            psvc.close()

    def test_mesh_ann_recall_gate(self):
        vecs = clustered_vectors(1200, seed=16)
        psvc = port_service("ivf-mesh-r", 4, settings=IVF, mapping=ANN_MAPPING)
        jsvc = jax_service("ivf-mesh-r", 4, settings=IVF, mapping=ANN_MAPPING)
        ora = port_service("ivf-mesh-np", 4, settings={"search.backend": "numpy"},
                           mapping=ANN_MAPPING)
        try:
            ann_fill([psvc, jsvc, ora], vecs)
            os.environ["ES_TPU_MESH"] = "force"
            recs, jrecs = [], []
            for qv in ann_queries(vecs, 10, seed=47):
                e = {h["_id"] for h in ora.search(ann_body(qv))["hits"]["hits"]}
                a = {h["_id"] for h in psvc.search(ann_body(qv))["hits"]["hits"]}
                ja = {h["_id"] for h in jsvc.search(ann_body(qv))["hits"]["hits"]}
                recs.append(len(a & e) / max(1, len(e)))
                jrecs.append(len(ja & e) / max(1, len(e)))
            assert psvc.mesh_executor().stats["routed"] == 10
            assert float(np.mean(recs)) >= 0.95
            assert float(np.mean(jrecs)) >= 0.95
        finally:
            close_all(psvc, jsvc, ora)


# ---------------------------------------------------------------------------
# TestMeshRerank twins (test_rerank.py)
# ---------------------------------------------------------------------------

RR_MAPPING = {
    "properties": {
        "body": {"type": "text"},
        "vec": {"type": "dense_vector", "dims": DIMS, "similarity": "cosine"},
        "toks": {"type": "rank_vectors", "dims": DIMS, "similarity": "dot_product"},
    }
}
RR_WORDS = ["alpha beta", "alpha gamma", "beta gamma", "alpha beta gamma"]


def rr_fill(svcs, n=80, seed=3, batches=1):
    rng = np.random.default_rng(seed)
    per = -(-n // batches)
    for b in range(batches):
        for i in range(b * per, min((b + 1) * per, n)):
            nt = 1 + i % 4
            v = rng.normal(size=DIMS)
            v /= np.linalg.norm(v)
            doc = {"body": RR_WORDS[i % 4], "vec": [float(x) for x in v],
                   "toks": rng.normal(size=(nt, DIMS)).round(3).tolist()}
            for svc in svcs:
                svc.index_doc(str(i), dict(doc))
        for svc in svcs:
            svc.refresh()
    return rng


def rescore_block(qv, window=20):
    return {
        "window_size": window,
        "query": {
            "rescore_query": {"rank_vectors": {"field": "toks", "query_vectors": qv}},
            "query_weight": 0.5,
            "rescore_query_weight": 2.0,
        },
    }


def qvecs(rng, n_tok=3):
    return rng.normal(size=(n_tok, DIMS)).round(3).tolist()


class TestMeshRerank:
    @pytest.mark.parametrize("quantized", [False, True])
    def test_mesh_rescore_bit_exact_vs_per_shard(self, quantized):
        """The fused first-stage + per-entry rescore step equals the
        per-shard path bit for bit (one live segment per shard — the
        routing precondition), f32 and int8, and the JAX package's
        mesh within rtol 1e-5."""
        extra = {"rerank.quantization": "int8"} if quantized else None
        name = f"rr-mesh-{int(quantized)}"
        p = (jax_service(name, 4, settings=extra, mapping=RR_MAPPING),
             port_service(name, 4, settings=extra, mapping=RR_MAPPING))
        try:
            rr_fill(p, n=120)
            bodies = [
                {"query": {"match": {"body": w.split()[0]}}, "size": 10,
                 "rescore": rescore_block(qvecs(np.random.default_rng(s)), window=20)}
                for s, w in enumerate(RR_WORDS[:3])
            ]
            for body in bodies:
                twin(p, body)
        finally:
            close_all(*p)

    def test_mesh_rescore_multi_segment_falls_back(self):
        """Shards with more than one live segment cannot take the
        per-entry window fusion: the request falls back to the
        per-shard path with identical results."""
        p = (jax_service("rr-mesh-ms", 2, mapping=RR_MAPPING),
             port_service("rr-mesh-ms", 2, mapping=RR_MAPPING))
        try:
            rng = rr_fill(p, n=80, batches=2)  # 2 segments per shard
            body = {"query": {"match": {"body": "alpha"}}, "size": 10,
                    "rescore": rescore_block(qvecs(rng), window=20)}
            pages = []
            for svc in p:
                os.environ["ES_TPU_MESH"] = "force"
                mex = svc.mesh_executor()
                fb0 = mex.stats["fallbacks"]
                a = svc.search(json.loads(json.dumps(body)))
                assert mex.stats["fallbacks"] == fb0 + 1
                os.environ["ES_TPU_MESH"] = "off"
                assert hits_of(a) == hits_of(svc.search(json.loads(json.dumps(body))))
                pages.append(a)
            same_response(*pages)
        finally:
            close_all(*p)


# ---------------------------------------------------------------------------
# TestMeshSparse twin (test_sparse.py)
# ---------------------------------------------------------------------------

SP_VOCAB = [f"tok{i:02d}" for i in range(40)]
SP_MAPPING = {
    "properties": {
        "ml": {"type": "sparse_vector"},
        "body": {"type": "text"},
        "vec": {"type": "dense_vector", "dims": 4, "similarity": "cosine"},
    }
}


def sparse_docs(n, vocab, seed, lo, hi):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        nt = int(rng.integers(lo, min(hi, len(vocab))))
        toks = [str(t) for t in rng.choice(vocab, size=nt, replace=False)]
        vec = {t: float(np.round(rng.random() * 3 + 0.05, 4)) for t in toks}
        out.append((str(i), {"ml": vec, "body": " ".join(toks),
                             "vec": [float(x) for x in rng.normal(size=4)]}))
    return out


class TestMeshSparse:
    @pytest.mark.parametrize("quant", ["int8", "none"])
    def test_mesh_vs_shard_parity(self, quant):
        docs = sparse_docs(240, SP_VOCAB[:30], 11, 2, 8)
        name = f"spm-{quant}"
        settings = {"sparse.quantization": quant}
        p = (jax_service(name, 4, settings=settings, mapping=SP_MAPPING),
             port_service(name, 4, settings=settings, mapping=SP_MAPPING))
        try:
            for svc in p:
                fill_waves(svc, [docs])
            rng = np.random.default_rng(5)
            for _ in range(4):
                toks = [str(t) for t in rng.choice(SP_VOCAB[:30], size=int(rng.integers(2, 6)),
                                                   replace=False)]
                body = {"query": {"sparse_vector": {
                    "field": "ml",
                    "query_vector": {t: float(np.round(rng.random() * 2 + 0.1, 4)) for t in toks},
                }}, "size": 10}
                twin(p, body)
        finally:
            close_all(*p)


# ---------------------------------------------------------------------------
# TestPrewarmAndMesh twin (test_ingest_nrt.py)
# ---------------------------------------------------------------------------


def test_mesh_incremental_rebuild_reuses_unchanged_shards():
    """A refresh of ONE shard rebuilds the stack reusing every other
    shard's rows, in both packages, with the per-shard path's pages."""
    words = ["alpha", "beta", "gamma", "delta", "epsilon", "zeta"]
    mapping = {"properties": {"body": {"type": "text"}}}
    p = (jax_service("mesh-incr", 4, mapping=mapping),
         port_service("mesh-incr", 4, mapping=mapping))
    body = {"query": {"match": {"body": "alpha beta"}}, "size": 10}
    try:
        pages = []
        for svc in p:
            from elasticsearch_tpu_torch.utils.murmur3 import shard_id

            rng = np.random.default_rng(5)
            for i in range(200):
                svc.index_doc(f"d{i}", {"body": " ".join(
                    rng.choice(words, size=int(rng.integers(3, 8))))})
            svc.refresh()
            os.environ["ES_TPU_MESH"] = "force"
            first = svc.search(dict(body))
            mesh = svc.mesh_executor()
            assert mesh.stats["routed"] >= 1 and first["hits"]["hits"]
            svc.index_doc("extra", {"body": "alpha zeta"})
            svc.local_shard(shard_id("extra", 4)).refresh()
            reused_before = mesh.stats["entries_reused"]
            second = svc.search(dict(body))
            assert mesh.stats["incremental_rebuilds"] >= 1
            # the three unchanged shards' rows copy over
            assert mesh.stats["entries_reused"] >= reused_before + 3
            os.environ["ES_TPU_MESH"] = "off"
            assert hits_of(second) == hits_of(svc.search(dict(body)))
            pages.append(second)
        same_response(*pages)
    finally:
        close_all(*p)


# ---------------------------------------------------------------------------
# the `_nodes/stats` schema gate (tests/test_nodes_stats_schema.py's
# REQUIRED key sets) against the port's node
# ---------------------------------------------------------------------------


def test_port_nodes_stats_carry_the_reference_schema():
    from test_nodes_stats_schema import REQUIRED

    from elasticsearch_tpu_torch.cluster.service import ClusterService
    from elasticsearch_tpu_torch.rest.actions import RestActions

    cluster = ClusterService(device="cpu")
    try:
        cluster.create_index("ns", {"settings": {"number_of_shards": 1}})
        idx = cluster.indices["ns"]
        idx.index_doc("1", {"body": "hello"})
        idx.refresh()
        idx.search({"query": {"match": {"body": "hello"}}})
        status, body = RestActions(cluster).nodes_stats(None, {}, {})
        assert status == 200
        node = body["nodes"]["node-0"]
        for path, keys in REQUIRED.items():
            cur = node
            for part in path.split("."):
                assert part in cur, f"missing block [{path}]"
                cur = cur[part]
            missing = keys - set(cur)
            assert not missing, f"block [{path}] lost keys {sorted(missing)}"
    finally:
        cluster.close()
