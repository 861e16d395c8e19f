"""The port's IVF ANN tier served through `IndexService(device="cpu")`,
against the JAX package's, on the CPU (the cases of the reference's
tests/test_ann_ivf.py, mesh cases aside).

Where the reference gates recall, the port is held to the numpy oracle
at recall@10 >= 0.95 on a seeded clustered corpus. Where a case can be
held hit for hit, the port and the JAX `IndexService` serve the same
docs over ONE shared set of IVF indexes: the reference's indexes are
built by its executor and carried into the port's executor cache by
`convert.ivf_index_from_reference`, so neither k-means can hide a
difference in the probe, the batcher's kNN family at every bucket, the
filtered executor path or the merge. Hits agree by total and ids, a
run of scores tied within rtol 1e-5 as a set, scores within rtol 1e-5.
"""

import os
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from elasticsearch_tpu.cluster.indices import IndexService as JIndexService
from elasticsearch_tpu.search.batcher import QueryBatcher as JBatcher
from elasticsearch_tpu.search.batcher import extract_knn_plan as j_knn_plan
from elasticsearch_tpu.search import dsl as jdsl

from elasticsearch_tpu_torch.cluster.indices import IndexService
from elasticsearch_tpu_torch.cluster.service import ClusterError
from elasticsearch_tpu_torch.common.settings import batch_buckets
from elasticsearch_tpu_torch.convert import ivf_index_from_reference
from elasticsearch_tpu_torch.ops import ivf, scoring
from elasticsearch_tpu_torch.search import ann as ann_mod
from elasticsearch_tpu_torch.search import dsl
from elasticsearch_tpu_torch.search.batcher import QueryBatcher, extract_knn_plan

torch.set_num_threads(1)

RTOL = 1e-5
DIMS = 32
N_CENTERS = 24
K = 10
IVF = {"knn.type": "ivf", "knn.nlist": 24, "knn.nprobe": 8}
MAPPING = {
    "properties": {
        "body": {"type": "text"},
        "vec": {"type": "dense_vector", "dims": DIMS, "similarity": "cosine"},
    }
}
WORDS = ["alpha", "beta", "gamma", "delta"]


@pytest.fixture(autouse=True)
def _ann_floor(monkeypatch):
    """Test corpora are small: lower the small-segment exact floor so the
    IVF tier engages (single tests raise it back to prove the floor)."""
    monkeypatch.setenv(ann_mod.ANN_MIN_DOCS_ENV, "64")
    yield
    from elasticsearch_tpu_torch.common.faults import faults
    from elasticsearch_tpu_torch.search.admission import admission

    admission.reset()
    if faults.active:
        faults.clear()


def clustered_vectors(n, seed, noise=0.5):
    """Unit vectors around N_CENTERS shared centers (the reference's
    test corpus): clustered enough that IVF recall means something."""
    rng = np.random.default_rng(seed)
    centers = np.random.default_rng(99).normal(size=(N_CENTERS, DIMS))
    asg = rng.integers(0, N_CENTERS, size=n)
    v = centers[asg] + noise * rng.normal(size=(n, DIMS))
    return (v / np.linalg.norm(v, axis=1, keepdims=True)).astype(np.float32)


def port_service(name, shards=1, extra=None, backend="torch"):
    settings = {"number_of_shards": shards, "search.backend": backend, **(extra or {})}
    return IndexService(name, settings=settings, mappings_json=MAPPING, device="cpu")


def ref_service(name, shards=1, extra=None, backend="jax"):
    settings = {"number_of_shards": shards, "search.backend": backend, **(extra or {})}
    return JIndexService(name, settings=settings, mappings_json=MAPPING)


def fill(svcs, vecs, batches=1, deletes=()):
    """The same docs into every service; batches > 1 refreshes between
    slices, so each shard holds several segments."""
    n = len(vecs)
    per = -(-n // batches)
    for b in range(batches):
        for i in range(b * per, min((b + 1) * per, n)):
            doc = {"body": WORDS[i % 4], "vec": [float(x) for x in vecs[i]]}
            for svc in svcs:
                svc.index_doc(str(i), dict(doc))
        for svc in svcs:
            svc.refresh()
    if deletes:
        for svc in svcs:
            for i in deletes:
                svc.delete_doc(str(i))
            svc.refresh()


def queries(vecs, n_q, seed=11, noise=0.05):
    rng = np.random.default_rng(seed)
    picks = rng.choice(len(vecs), size=n_q, replace=False)
    q = vecs[picks] + noise * rng.normal(size=(n_q, DIMS))
    return (q / np.linalg.norm(q, axis=1, keepdims=True)).astype(np.float32)


def knn_body(qv, k=K, nc=200, **extra):
    sec = {"field": "vec", "query_vector": [float(x) for x in qv], "k": k, "num_candidates": nc}
    sec.update(extra)
    return {"knn": sec, "size": k}


def hit_pairs(resp):
    return [(h["_id"], h["_score"]) for h in resp["hits"]["hits"]]


def mean_recall(svc, oracle, qs, k=K, **extra):
    recs = []
    for qv in qs:
        a = {h["_id"] for h in svc.search(knn_body(qv, k=k, **extra))["hits"]["hits"]}
        e = {h["_id"] for h in oracle.search(knn_body(qv, k=k))["hits"]["hits"]}
        recs.append(len(a & e) / max(1, len(e)))
    return float(np.mean(recs))


def same_ids(ref_ids, ref_scores, got_ids, what):
    assert len(got_ids) == len(ref_ids), (what, ref_ids, got_ids)
    i = 0
    while i < len(ref_ids):
        j = i + 1
        while j < len(ref_ids) and np.isclose(ref_scores[j], ref_scores[j - 1], rtol=RTOL, atol=0):
            j += 1
        assert set(got_ids[i:j]) == set(ref_ids[i:j]), (what, i, ref_ids, got_ids)
        i = j


def same_response(ref, got, what):
    assert got["hits"]["total"] == ref["hits"]["total"], what
    rh, gh = hit_pairs(ref), hit_pairs(got)
    rs = np.array([s for _, s in rh])
    assert len(gh) == len(rh), what
    np.testing.assert_allclose([s for _, s in gh], rs, rtol=RTOL, atol=1e-6, err_msg=what)
    same_ids([i for i, _ in rh], rs, [i for i, _ in gh], what)


def same_td(ref, got, what):
    assert got.total == ref.total, what
    rs = np.array([h.score for h in ref.hits])
    np.testing.assert_allclose([h.score for h in got.hits], rs, rtol=RTOL, atol=1e-6, err_msg=what)
    same_ids([h.doc_id for h in ref.hits], rs, [h.doc_id for h in got.hits], what)


def share_indexes(jsvc, tsvc, settings):
    """Builds the reference's IVF index of every (shard, segment) and
    puts the same layout into the port's executor cache, under the key
    the port's own build would use. Returns the spec."""
    spec = ann_mod.resolve(settings, SimpleNamespace(nprobe=None), False)
    key_tail = (int(spec.nlist), bool(spec.quantized), int(spec.min_docs))
    for jeng, teng in zip(jsvc.shards, tsvc.shards):
        jex, tex = jsvc._executor(jeng), tsvc._executor(teng)
        for si, seg in enumerate(tex.reader.segments):
            ref = jex.ann_index(si, "vec", spec)
            port = None if ref is None else ivf_index_from_reference(ref, device="cpu")
            tex._ann_indexes[(si, "vec") + key_tail] = port
    return spec


# ---------------------------------------------------------------------------
# recall gates (held to the numpy oracle, as the reference holds itself)
# ---------------------------------------------------------------------------


def test_single_segment_recall():
    vecs = clustered_vectors(1500, seed=1)
    svc, ora = port_service("ivf-s1", extra=IVF), port_service("ivf-s1-np", backend="numpy")
    try:
        fill([svc, ora], vecs)
        before = ann_mod.stats_snapshot()
        rec = mean_recall(svc, ora, queries(vecs, 16))
        after = ann_mod.stats_snapshot()
        assert rec >= 0.95
        # the probes ran (not a quiet exact routing)
        assert after["ann_searches"] > before["ann_searches"]
        assert after["builds"] >= before["builds"] + 1
        assert after["ledger_bytes"] > 0
        assert after["clusters_scanned"] > before["clusters_scanned"]
        assert after["exact_fallbacks"] == before["exact_fallbacks"]
    finally:
        svc.close()
        ora.close()


def test_multi_segment_multi_shard_recall():
    vecs = clustered_vectors(1600, seed=2)
    svc, ora = port_service("ivf-ms", shards=2, extra=IVF), port_service("ivf-ms-np", 2, backend="numpy")
    try:
        fill([svc, ora], vecs, batches=3)  # 3 segments per shard
        assert mean_recall(svc, ora, queries(vecs, 12)) >= 0.95
    finally:
        svc.close()
        ora.close()


def test_filtered_and_deleted_recall():
    """live ∧ filter bitset: the probe honors the candidate mask of the
    exact path — every hit passes the filter and survives the deletes,
    at oracle-level recall."""
    vecs = clustered_vectors(1500, seed=3)
    svc, ora = port_service("ivf-f", extra=IVF), port_service("ivf-f-np", backend="numpy")
    try:
        fill([svc, ora], vecs, deletes=range(0, 1500, 7))
        filt = {"term": {"body": "alpha"}}
        recs = []
        for qv in queries(vecs, 10, seed=13):
            body = knn_body(qv, nc=300, filter=filt)
            a = svc.search(dict(body))["hits"]["hits"]
            e = ora.search(dict(body))["hits"]["hits"]
            assert all(int(h["_id"]) % 4 == 0 and int(h["_id"]) % 7 != 0 for h in a)
            recs.append(len({h["_id"] for h in a} & {h["_id"] for h in e}) / max(1, len(e)))
        assert float(np.mean(recs)) >= 0.95
    finally:
        svc.close()
        ora.close()


def test_quantized_int8_recall():
    vecs = clustered_vectors(1500, seed=4)
    svc = port_service("ivf-q8", extra={**IVF, "knn.quantization": "int8"})
    ora = port_service("ivf-q8-np", backend="numpy")
    try:
        fill([svc, ora], vecs)
        assert mean_recall(svc, ora, queries(vecs, 16, seed=17)) >= 0.95
        tex = svc._executor(svc.shards[0])
        assert any(i is not None and i.qvecs_flat is not None for i in tex._ann_indexes.values())
    finally:
        svc.close()
        ora.close()


# ---------------------------------------------------------------------------
# hit for hit against the JAX IndexService over shared indexes
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("quant", ["none", "int8"])
@pytest.mark.parametrize("shards,batches", [(1, 1), (2, 3)])
def test_served_pages_match_reference_on_shared_indexes(quant, shards, batches):
    settings = {**IVF, "knn.quantization": quant}
    vecs = clustered_vectors(1400, seed=20 + shards)
    jsvc, tsvc = ref_service("sh", shards, settings), port_service("sh", shards, settings)
    try:
        fill([jsvc, tsvc], vecs, batches=batches, deletes=range(3, 1400, 11))
        share_indexes(jsvc, tsvc, {**settings, "number_of_shards": shards})
        for i, qv in enumerate(queries(vecs, 6, seed=5)):
            for body in (knn_body(qv), knn_body(qv, nc=40, nprobe=3),
                         knn_body(qv, filter={"term": {"body": WORDS[i % 4]}}),
                         knn_body(qv, similarity=0.9)):
                same_response(jsvc.search(dict(body)), tsvc.search(dict(body)), f"{quant} {body['knn'].keys()}")
    finally:
        jsvc.close()
        tsvc.close()


@pytest.fixture(scope="module")
def shared_pair():
    settings = dict(IVF)
    old = os.environ.get(ann_mod.ANN_MIN_DOCS_ENV)
    os.environ[ann_mod.ANN_MIN_DOCS_ENV] = "64"
    vecs = clustered_vectors(1200, seed=31)
    jsvc, tsvc = ref_service("bk", 1, settings), port_service("bk", 1, settings)
    fill([jsvc, tsvc], vecs, batches=2, deletes=range(0, 1200, 13))
    spec = share_indexes(jsvc, tsvc, {**settings, "number_of_shards": 1})
    yield jsvc, tsvc, spec, vecs
    jsvc.close()
    tsvc.close()
    if old is None:
        os.environ.pop(ann_mod.ANN_MIN_DOCS_ENV, None)
    else:
        os.environ[ann_mod.ANN_MIN_DOCS_ENV] = old


def _run_knn_group(b, ex, plans, rows):
    jobs = [b.submit_nowait(ex, p, K, kind="knn") for p in plans]
    b._collect_knn_group(jobs, b._dispatch_knn_group(jobs, rows=rows))
    return [b.wait(j, timeout=30) for j in jobs]


@pytest.mark.parametrize("rows", batch_buckets(scoring.BPAD))
def test_batcher_ivf_group_matches_reference_at_every_bucket(shared_pair, monkeypatch, rows):
    jsvc, tsvc, spec, vecs = shared_pair
    jex, tex = jsvc._executor(jsvc.shards[0]), tsvc._executor(tsvc.shards[0])
    jb, tb = JBatcher(workers=1), QueryBatcher(workers=1)
    monkeypatch.setattr(jb, "_ensure_thread", lambda: None)
    monkeypatch.setattr(tb, "_ensure_thread", lambda: None)
    qs = queries(vecs, rows, seed=rows)
    try:
        for n in sorted({rows, rows // 2 + 1}):  # full and partial occupancy
            jplans, tplans = [], []
            for i in range(n):
                body = knn_body(qs[i], nc=50 + 10 * (i % 3))["knn"]
                jsec, tsec = jdsl.parse_knn(body), dsl.parse_knn(body)
                jsec.ann = tsec.ann = spec
                jplans.append(j_knn_plan([jsec], jsvc.mappings))
                tplans.append(extract_knn_plan([tsec], tsvc.mappings))
            assert all(p.ann == spec for p in tplans)
            st0 = dict(ann_mod.ANN_STATS)
            ref = _run_knn_group(jb, jex, jplans, rows)
            got = _run_knn_group(tb, tex, tplans, rows)
            for i, (r, g) in enumerate(zip(ref, got)):
                same_td(r, g, f"rows={rows} job {i}")
            assert ann_mod.ANN_STATS["ann_searches"] - st0["ann_searches"] == n * len(tex.reader.segments)
    finally:
        jb.close()
        tb.close()


def test_jobs_with_other_nprobe_or_quantization_never_share_a_launch(shared_pair, monkeypatch):
    _jsvc, tsvc, spec, vecs = shared_pair
    tex = tsvc._executor(tsvc.shards[0])
    specs = [spec, ann_mod.AnnSpec(spec.nlist, 3, spec.quantized, spec.min_docs),
             ann_mod.AnnSpec(spec.nlist, spec.nprobe, True, spec.min_docs), None]
    b = QueryBatcher(workers=1)
    groups = []
    dispatch = b._dispatch_knn_group

    def recording(jobs, rows=None, record=True):
        groups.append({j.plan.ann for j in jobs})
        return dispatch(jobs, rows=rows, record=record)

    monkeypatch.setattr(b, "_dispatch_knn_group", recording)
    try:
        jobs = []
        for i, qv in enumerate(queries(vecs, 8, seed=3)):
            sec = dsl.parse_knn(knn_body(qv)["knn"])
            sec.ann = specs[i % 4]
            jobs.append(b.submit_nowait(tex, extract_knn_plan([sec], tsvc.mappings), K, kind="knn"))
        for j in jobs:
            b.wait(j, timeout=60)
    finally:
        b.close()
    assert groups and all(len(g) == 1 for g in groups)
    assert set().union(*groups) == set(specs)


def test_runtime_error_in_the_probe_fails_the_request(monkeypatch):
    """No fallback on a real failure: a RuntimeError inside the probe
    fails the request (bare knn on the batcher, filtered knn on the
    executor) instead of being served exact."""
    vecs = clustered_vectors(600, seed=40)
    svc = port_service("ivf-boom", extra=IVF)
    try:
        fill([svc], vecs)
        qv = queries(vecs, 2, seed=41)
        svc.search(knn_body(qv[0]))  # the executor and its index exist

        def boom(*a, **kw):
            raise RuntimeError("CUDA error: an illegal memory access was encountered")

        monkeypatch.setattr(ivf, "ann_topk_batch", boom)
        before = ann_mod.stats_snapshot()
        with pytest.raises(ClusterError, match="illegal memory access"):
            svc.search(knn_body(qv[1]))
        with pytest.raises(ClusterError, match="illegal memory access"):
            svc.search(knn_body(qv[1], filter={"term": {"body": "alpha"}}))
        assert ann_mod.stats_snapshot()["exact_fallbacks"] == before["exact_fallbacks"]
    finally:
        svc.close()


@pytest.mark.faults
def test_injected_probe_fault_serves_exact():
    """The `ann.probe` fault site is the reference's own route to the
    exact path: the page equals the exact index's and exact_fallbacks
    counts it."""
    from elasticsearch_tpu_torch.common.faults import faults

    vecs = clustered_vectors(700, seed=42)
    svc, exact = port_service("ivf-flt", extra=IVF), port_service("ivf-flt-x")
    try:
        fill([svc, exact], vecs)
        qv = queries(vecs, 2, seed=43)
        faults.configure({"rules": [{"site": "ann.probe", "kind": "error"}]})
        before = ann_mod.stats_snapshot()
        for body in (knn_body(qv[0]), knn_body(qv[1], filter={"term": {"body": "beta"}})):
            assert hit_pairs(svc.search(dict(body))) == hit_pairs(exact.search(dict(body)))
        assert ann_mod.stats_snapshot()["exact_fallbacks"] >= before["exact_fallbacks"] + 2
        assert ann_mod.stats_snapshot()["ann_searches"] == before["ann_searches"]
    finally:
        faults.clear()
        svc.close()
        exact.close()


# ---------------------------------------------------------------------------
# the exact path stays the oracle
# ---------------------------------------------------------------------------


def test_exact_escape_hatch_bit_for_bit():
    """`exact: true` on an ivf index reproduces the exact path bit for
    bit and the numpy oracle's ids."""
    vecs = clustered_vectors(1200, seed=5)
    svc, exact, ora = (port_service("ivf-esc", extra=IVF), port_service("ivf-esc-x"),
                       port_service("ivf-esc-np", backend="numpy"))
    try:
        fill([svc, exact, ora], vecs)
        before = ann_mod.stats_snapshot()
        for qv in queries(vecs, 6, seed=19):
            body = knn_body(qv)
            a = hit_pairs(svc.search({**body, "exact": True}))
            assert a == hit_pairs(exact.search(dict(body)))
            assert [i for i, _ in a] == [h["_id"] for h in ora.search(dict(body))["hits"]["hits"]]
        assert ann_mod.stats_snapshot()["exact_searches"] >= before["exact_searches"] + 6
    finally:
        for s in (svc, exact, ora):
            s.close()


def test_small_segment_floor_stays_exact(monkeypatch):
    monkeypatch.setenv(ann_mod.ANN_MIN_DOCS_ENV, "100000")
    vecs = clustered_vectors(600, seed=6)
    svc, exact = port_service("ivf-floor", extra=IVF), port_service("ivf-floor-x")
    try:
        fill([svc, exact], vecs)
        before = ann_mod.stats_snapshot()
        for qv in queries(vecs, 4, seed=23):
            body = knn_body(qv)
            assert hit_pairs(svc.search(dict(body))) == hit_pairs(exact.search(dict(body)))
        after = ann_mod.stats_snapshot()
        assert after["ann_searches"] == before["ann_searches"]
        assert after["small_segment_exact"] > before["small_segment_exact"]
    finally:
        svc.close()
        exact.close()


def test_per_request_nprobe_override():
    """nprobe == nlist scans every cluster: recall 1.0 against the exact
    path; nprobe 1 still returns k hits."""
    vecs = clustered_vectors(1200, seed=7)
    svc, exact = port_service("ivf-np", extra=IVF), port_service("ivf-np-x")
    try:
        fill([svc, exact], vecs)
        qs = queries(vecs, 6, seed=29)
        assert mean_recall(svc, exact, qs, nprobe=24) == 1.0
        for qv in qs[:3]:
            assert len(svc.search(knn_body(qv, nprobe=1))["hits"]["hits"]) == K
    finally:
        svc.close()
        exact.close()


# ---------------------------------------------------------------------------
# build machinery
# ---------------------------------------------------------------------------


def test_build_deterministic_across_executors():
    """The same segment clustered by two fresh services gives identical
    centroids, permutation and pages."""
    vecs = clustered_vectors(800, seed=8)
    a, b = port_service("ivf-d1", extra=IVF), port_service("ivf-d2", extra=IVF)
    try:
        fill([a, b], vecs)
        ia = [i for i in a._executor(a.shards[0])._ann_indexes.values() if i is not None]
        ib = [i for i in b._executor(b.shards[0])._ann_indexes.values() if i is not None]
        assert len(ia) == len(ib) == 1  # built with the generation (warm_ann)
        for name in ("centroids", "perm", "counts", "vecs_flat"):
            assert torch.equal(getattr(ia[0], name), getattr(ib[0], name))
        qv = queries(vecs, 1, seed=9)[0]
        assert hit_pairs(a.search(knn_body(qv))) == hit_pairs(b.search(knn_body(qv)))
    finally:
        a.close()
        b.close()


def test_rebuild_on_refresh_and_ledger_release():
    from elasticsearch_tpu_torch.common.memory import hbm_ledger

    def ann_bytes():
        return hbm_ledger.stats()["by_category"].get("ann", 0)

    ann0 = ann_bytes()  # the ledger is per process: other live indexes
    vecs = clustered_vectors(900, seed=9)
    svc = port_service("ivf-gen", extra=IVF)
    try:
        fill([svc], vecs)
        qv = queries(vecs, 1, seed=31)[0]
        svc.search(knn_body(qv))
        builds0 = ann_mod.stats_snapshot()["builds"]
        assert ann_bytes() > ann0
        svc.index_doc("extra", {"body": "alpha", "vec": [float(x) for x in vecs[0]]})
        svc.refresh()
        svc.search(knn_body(qv))
        assert ann_mod.stats_snapshot()["builds"] > builds0
    finally:
        svc.close()
    assert ann_bytes() == ann0


def test_device_memory_budget_degrades_to_exact(monkeypatch):
    from elasticsearch_tpu_torch.common.memory import hbm_ledger

    vecs = clustered_vectors(700, seed=10)
    # an absurd estimate makes ONLY the IVF build fail the ledger
    # precheck (the exact path's uploads still fit)
    monkeypatch.setattr(ivf.IvfSegmentIndex, "estimate_nbytes", staticmethod(lambda *a, **k: 1 << 60))
    svc, exact = port_service("ivf-hbm", extra=IVF), port_service("ivf-hbm-x")
    try:
        fill([svc, exact], vecs)
        degraded0 = hbm_ledger.stats()["degraded_allocations"]
        qv = queries(vecs, 1, seed=37)[0]
        assert hit_pairs(svc.search(knn_body(qv))) == hit_pairs(exact.search(knn_body(qv)))
        assert hbm_ledger.stats()["degraded_allocations"] > degraded0
        assert all(i is None for i in svc._executor(svc.shards[0])._ann_indexes.values())
    finally:
        svc.close()
        exact.close()


# ---------------------------------------------------------------------------
# validation and observability
# ---------------------------------------------------------------------------


def test_knn_section_bounds_are_400():
    for bad, what in (({"k": 10, "num_candidates": 5}, "num_candidates"), ({"k": 0}, r"\[k\]"),
                      ({"k": 2, "num_candidates": 10, "nprobe": 0}, "nprobe"),
                      ({"k": 2, "num_candidates": "nan"}, "num_candidates")):
        with pytest.raises(dsl.QueryParseError, match=what):
            dsl.parse_knn({"field": "vec", "query_vector": [0.0] * DIMS, **bad})


def test_service_surfaces_parse_error_not_500():
    from elasticsearch_tpu_torch.cluster.service import ClusterService

    c = ClusterService(device="cpu")
    try:
        c.create_index("v400", {"settings": {"knn.type": "ivf"},
                                "mappings": {"properties": {"vec": {"type": "dense_vector", "dims": 4}}}})
        idx = c.indices["v400"]
        idx.index_doc("a", {"vec": [0.1, 0.2, 0.3, 0.4]})
        idx.refresh()
        with pytest.raises(dsl.QueryParseError):
            idx.search({"knn": {"field": "vec", "query_vector": [0.1] * 4, "k": 10, "num_candidates": 3}})
    finally:
        c.close()


def test_k_above_num_docs_clamps_not_500():
    vecs = clustered_vectors(200, seed=12)
    svc, exact = port_service("ivf-clamp", extra=IVF), port_service("ivf-clamp-x")
    try:
        fill([svc, exact], vecs)
        qv = queries(vecs, 1, seed=41)[0]
        r = exact.search(knn_body(qv, k=500, nc=5000))
        assert len(r["hits"]["hits"]) == 200 and r["hits"]["total"]["value"] == 200
        r = svc.search(knn_body(qv, k=500, nc=5000))
        assert 0 < len(r["hits"]["hits"]) <= 200
        r = svc.search(knn_body(qv, k=500, nc=5000, nprobe=24))
        assert len(r["hits"]["hits"]) == 200
    finally:
        svc.close()
        exact.close()


def test_nodes_stats_knn_ann_block():
    from elasticsearch_tpu_torch.cluster.service import ClusterService
    from elasticsearch_tpu_torch.rest.actions import RestActions

    c = ClusterService(device="cpu")
    try:
        c.create_index("annstats", {"settings": {"knn.type": "ivf", "knn.nlist": 8},
                                    "mappings": {"properties": {"vec": {
                                        "type": "dense_vector", "dims": DIMS, "similarity": "cosine"}}}})
        idx = c.indices["annstats"]
        vecs = clustered_vectors(300, seed=14)
        for i, v in enumerate(vecs):
            idx.index_doc(str(i), {"vec": [float(x) for x in v]})
        idx.refresh()
        idx.search(knn_body(vecs[0]))
        _, resp = RestActions(c).nodes_stats(None, {}, {})
        blk = resp["nodes"]["node-0"]["knn"]["ann"]
        assert set(blk) >= {"ann_searches", "exact_searches", "small_segment_exact", "exact_fallbacks",
                            "probes", "clusters_scanned", "clusters_total", "builds", "build_ms",
                            "ledger_bytes"}
        assert blk["ann_searches"] >= 1 and blk["builds"] >= 1 and blk["ledger_bytes"] > 0
    finally:
        c.close()


def test_ivf_index_setting_validation():
    from elasticsearch_tpu_torch.common.settings import SettingsError, validate_index_settings

    out = validate_index_settings({"knn.type": "ivf", "knn.nlist": 64, "knn.nprobe": 4}, creating=True)
    assert out["knn.type"] == "ivf"
    with pytest.raises(SettingsError):
        validate_index_settings({"knn.type": "hnsw"}, creating=True)
    with pytest.raises(SettingsError):
        validate_index_settings({"knn.nprobe": 0}, creating=True)
