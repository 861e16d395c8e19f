"""The port's device segment builds and generation lifecycle against the
JAX package and the host `SegmentBuilder`, on the CPU.

Contract under test:
  * each function of the port's ops/index_build.py gives the JAX
    package's (run on JAX's CPU) and the host oracle's outputs bit for
    bit (dtype, shape, values) on the same seeded inputs;
  * a whole device-built segment equals the host build for every column
    family (postings and positions, BM25 impacts, norms, keyword
    ordinals, numerics, dense vectors, rank_vectors, sparse_vector),
    the empty and 1-doc builds included;
  * a device-built engine answers as the JAX package's device-built one;
  * only an injected `build.device` fault or a ledger degrade builds on
    the host: any other error fails the refresh and the old generation
    keeps serving;
  * a new generation adopts the old one's uploads of unchanged segments
    (counted through the ledger), and `prewarm` builds the serving
    caches and lets a real error out;
  * the device agg permutation tables equal the host argsort.

The mappings and documents are this file's own copy of
tests/test_ingest_nrt.py's rich set, with a sparse_vector field added.
"""

import copy

import numpy as np
import pytest
import torch

from elasticsearch_tpu.cluster.indices import IndexService as JIndexService
from elasticsearch_tpu.index.segment import sparse_plan as jsparse_plan
from elasticsearch_tpu.ops import index_build as jib

from elasticsearch_tpu_torch.analysis import AnalysisRegistry
from elasticsearch_tpu_torch.cluster.indices import IndexService
from elasticsearch_tpu_torch.common.faults import faults
from elasticsearch_tpu_torch.common.memory import hbm_ledger
from elasticsearch_tpu_torch.index import segment_build
from elasticsearch_tpu_torch.index.mapping import DocumentParser, Mappings
from elasticsearch_tpu_torch.index.segment import SegmentBuilder, sparse_from_plan, sparse_plan
from elasticsearch_tpu_torch.models import bm25
from elasticsearch_tpu_torch.models.rerank import quantize_tokens
from elasticsearch_tpu_torch.ops import index_build as ib
from elasticsearch_tpu_torch.search import aggs_device, executor_torch
from elasticsearch_tpu_torch.search.batcher import live_batchers

torch.set_num_threads(1)

CPU = torch.device("cpu")
RTOL = 1e-5
WORDS = [
    "alpha", "beta", "gamma", "delta", "epsilon", "zeta", "eta", "theta",
    "iota", "kappa", "lam", "mu",
]
DIMS = 8

RICH_MAPPINGS = {
    "properties": {
        "body": {"type": "text"},
        "title": {"type": "text"},
        "tag": {"type": "keyword"},
        "popularity": {"type": "integer"},
        "day": {"type": "date"},
        "emb": {"type": "dense_vector", "dims": DIMS, "similarity": "cosine"},
        "emb2": {"type": "dense_vector", "dims": 4, "similarity": "l2_norm"},
        "toks": {"type": "rank_vectors", "dims": 4, "similarity": "cosine"},
        "ml": {"type": "sparse_vector"},
    }
}


def rich_docs(n=120, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        src = {
            "body": " ".join(rng.choice(WORDS, size=int(rng.integers(1, 10)))),
            "popularity": int(rng.integers(0, 100)),
        }
        if i % 3 == 0:
            src["title"] = " ".join(rng.choice(WORDS, size=3))
        if i % 2 == 0:
            src["tag"] = [str(t) for t in rng.choice(["a", "b", "c", "d"], size=int(rng.integers(1, 4)))]
        if i % 4 == 0:
            src["day"] = "2026-01-%02d" % (1 + i % 27)
        if i % 2 == 1:
            src["emb"] = rng.normal(size=DIMS).astype(np.float32).tolist()
        if i % 5 == 0:
            src["emb2"] = rng.normal(size=4).astype(np.float32).tolist()
        if i % 3 == 1:
            src["toks"] = rng.normal(size=(int(rng.integers(1, 5)), 4)).astype(np.float32).tolist()
        if i % 3 == 2:
            src["ml"] = {str(w): float(rng.random() * 3) for w in rng.choice(WORDS, size=3)}
        out.append((f"d{i}", src))
    return out


def parsed_rich_docs(n=120, seed=0):
    maps = Mappings(RICH_MAPPINGS)
    parser = DocumentParser(maps, AnalysisRegistry())
    return maps, [parser.parse(i, s) for i, s in rich_docs(n, seed)]


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


@pytest.fixture
def device_build_auto(monkeypatch):
    monkeypatch.setenv("ES_TPU_DEVICE_BUILD", "auto")
    yield


def same_array(name, a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype, (name, a.dtype, b.dtype)
    assert a.shape == b.shape, (name, a.shape, b.shape)
    assert np.array_equal(a, b), name


def same_outputs(name, ref, got):
    assert len(ref) == len(got), name
    for i, (r, g) in enumerate(zip(ref, got)):
        same_array(f"{name}[{i}]", r, g)


def assert_segments_identical(host, dev):
    assert host.num_docs == dev.num_docs
    assert host.doc_ids == dev.doc_ids
    assert sorted(host.postings) == sorted(dev.postings)
    for f, hp in host.postings.items():
        dp = dev.postings[f]
        assert hp.terms == dp.terms, f
        for attr in (
            "term_df", "term_total_tf", "term_tile_start", "term_tile_count",
            "doc_ids", "tfs", "tile_max_tf", "tile_min_norm", "norms",
            "term_pos_start", "pos_offsets", "pos_data", "impacts", "impact_scales",
        ):
            ha, da = getattr(hp, attr), getattr(dp, attr)
            if ha is None or da is None:
                assert ha is None and da is None, (f, attr)
                continue
            same_array(f"{f}.{attr}", ha, da)
        assert vars(hp.stats) == vars(dp.stats), f
    assert sorted(host.ordinals) == sorted(dev.ordinals)
    for f, ho in host.ordinals.items():
        do = dev.ordinals[f]
        assert ho.ord_terms == do.ord_terms, f
        for attr in ("ords", "mv_ords", "mv_offsets"):
            same_array(f"{f}.{attr}", getattr(ho, attr), getattr(do, attr))
    assert sorted(host.vectors) == sorted(dev.vectors)
    for f, hv in host.vectors.items():
        dv = dev.vectors[f]
        assert hv.similarity == dv.similarity
        for attr in ("vectors", "exists", "unit_vectors"):
            ha, da = getattr(hv, attr), getattr(dv, attr)
            if ha is None or da is None:
                assert ha is None and da is None, (f, attr)
                continue
            same_array(f"{f}.{attr}", ha, da)
    assert sorted(host.multi_vectors) == sorted(dev.multi_vectors)
    for f, hm in host.multi_vectors.items():
        dm = dev.multi_vectors[f]
        for attr in ("tok_vectors", "tok_offsets", "exists"):
            same_array(f"{f}.{attr}", getattr(hm, attr), getattr(dm, attr))
    assert sorted(host.numerics) == sorted(dev.numerics)
    for f, hn in host.numerics.items():
        dn = dev.numerics[f]
        same_array(f"{f}.values", hn.values, dn.values)
        same_array(f"{f}.exists", hn.exists, dn.exists)
    assert sorted(host.sparse) == sorted(dev.sparse)
    for f, hs in host.sparse.items():
        ds = dev.sparse[f]
        assert hs.terms == ds.terms and hs.pruned == ds.pruned, f
        for attr in ("term_df", "term_tile_start", "term_tile_count", "doc_ids", "weights",
                     "qweights", "scales", "tile_max", "tile_qmax", "exists"):
            same_array(f"{f}.{attr}", getattr(hs, attr), getattr(ds, attr))


# ---------------------------------------------------------------------------
# each op against the JAX package's and the host oracle, bit for bit
# ---------------------------------------------------------------------------


def posting_stream(seed, n_docs=300, n_terms=40):
    """A term-major, doc-sorted posting stream with its tile plan (some
    terms span several tiles) and field lengths up to 2M tokens."""
    rng = np.random.default_rng(seed)
    tids, docs, tfs = [], [], []
    df = rng.integers(1, n_docs, n_terms)
    df[:3] = [1, 128, 257]
    for t in range(n_terms):
        d = np.sort(rng.choice(n_docs, int(df[t]), replace=False))
        tids.append(np.full(len(d), t, np.int64))
        docs.append(d.astype(np.int32))
        tfs.append(rng.integers(1, 9, len(d)).astype(np.int32))
    term_df = df.astype(np.int32)
    term_tile_count = ((term_df + 127) // 128).astype(np.int32)
    term_tile_start = np.zeros(n_terms, np.int32)
    np.cumsum(term_tile_count[:-1], out=term_tile_start[1:])
    lengths = rng.integers(0, 2_000_000, n_docs).astype(np.int64)
    lengths[:5] = [0, 1, 7, 40, 255]
    return (np.concatenate(tids), np.concatenate(docs), np.concatenate(tfs),
            term_tile_start, term_df, lengths, int(term_tile_count.sum()), n_docs)


@pytest.mark.parametrize("seed", [0, 1])
def test_postings_tiles_match_jax(seed):
    args = posting_stream(seed)
    ref = jib.postings_tiles_device(*args)
    got = ib.postings_tiles_device(*args, device=CPU)
    same_outputs("postings", ref, got)
    from elasticsearch_tpu_torch.utils.smallfloat import encode_norms

    same_array("norms vs host", encode_norms(args[5]), got[3])


@pytest.mark.parametrize("n_pairs", [0, 1, 900])
def test_ordinals_match_jax(n_pairs):
    rng = np.random.default_rng(n_pairs)
    n_docs = 200
    docs = rng.integers(0, n_docs, n_pairs).astype(np.int32)
    ords = rng.integers(0, 50, n_pairs).astype(np.int32)
    if n_pairs:
        # duplicates of (doc, ord) pairs, in arbitrary order
        docs[: n_pairs // 4] = docs[n_pairs // 4: 2 * (n_pairs // 4)]
        ords[: n_pairs // 4] = ords[n_pairs // 4: 2 * (n_pairs // 4)]
    got = ib.ordinals_device(docs, ords, n_docs, CPU)
    if n_pairs:
        same_outputs("ordinals", jib.ordinals_device(docs, ords, n_docs), got)
    # host oracle: sorted unique ords per doc, first ord per doc or -1
    per_doc = [sorted(set(ords[docs == d].tolist())) for d in range(n_docs)]
    same_array("ords", np.asarray([p[0] if p else -1 for p in per_doc], np.int32), got[0])
    same_array("mv_ords", np.asarray([o for p in per_doc for o in p], np.int32), got[1])
    same_array("mv_offsets", np.concatenate([[0], np.cumsum([len(p) for p in per_doc])]).astype(np.int32), got[2])


@pytest.mark.parametrize("dtype", [np.float32, np.float16])
def test_scatter_rows_match_jax(dtype):
    rng = np.random.default_rng(2)
    n_docs = 97
    idx = np.sort(rng.choice(n_docs, 40, replace=False)).astype(np.int32)
    rows = rng.normal(size=(40, 16)).astype(dtype)
    got = ib.scatter_rows_device(rows, idx, n_docs, CPU)
    same_outputs("scatter", jib.scatter_rows_device(rows, idx, n_docs), got)
    host = np.zeros((n_docs, 16), dtype)
    host[idx] = rows
    same_array("dense", host, got[0])


@pytest.mark.parametrize("m", [0, 1, 513])
def test_quantize_int8_matches_jax_and_host(m):
    rng = np.random.default_rng(3)
    mat = rng.normal(size=(m, 16)).astype(np.float32)
    if m > 1:
        mat[1] = 0.0  # a zero row: scale 0, quantized as 0
        mat[2] *= 1e-30
    got = ib.quantize_int8_device(mat, CPU)
    same_outputs("quantize vs host", quantize_tokens(mat), got)
    if m:
        same_outputs("quantize vs jax", jib.quantize_int8_device(mat), got)


def test_csr_offsets_match_jax():
    counts = np.random.default_rng(5).integers(0, 6, 333).astype(np.int32)
    counts[:4] = 0
    got = ib.csr_offsets_device(counts, len(counts), CPU)
    same_outputs("csr", jib.csr_offsets_device(counts, len(counts)), got)
    same_array("offsets", np.concatenate([[0], np.cumsum(counts)]).astype(np.int32), got[0])


@pytest.mark.parametrize("ratio", [0.0, 0.3])
def test_sparse_planes_match_jax_and_host(ratio):
    rng = np.random.default_rng(6)
    inv = {}
    for t in range(30):
        docs = rng.choice(400, int(rng.integers(1, 300)), replace=False)
        inv[f"t{t}"] = {int(d): float(np.float32(rng.random() * 4)) for d in docs}
    plan = sparse_plan(inv, ratio)
    got = ib.sparse_planes_device(plan, CPU)
    same_outputs("sparse vs jax", jib.sparse_planes_device(jsparse_plan(inv, ratio)), got)
    host = sparse_from_plan(plan, 400, np.ones(400, bool))
    same_outputs("sparse vs host", (host.doc_ids, host.weights, host.qweights, host.scales,
                                    host.tile_max, host.tile_qmax), got)


def test_text_impacts_match_jax_and_host():
    tids, docs, tfs, tts, term_df, lengths, n_tiles, n_docs = posting_stream(7)
    doc_ids, tf_tiles, _, norms, _ = ib.postings_tiles_device(
        tids, docs, tfs, tts, term_df, lengths, n_tiles, n_docs, CPU)
    cache = bm25.norm_inverse_cache(bm25.avg_field_length(int(tfs.sum()), n_docs))
    tile_term = np.repeat(np.arange(len(term_df), dtype=np.int32), (term_df + 127) // 128)
    got = ib.text_impacts_device(doc_ids, tf_tiles, norms, cache, tile_term, len(term_df), n_docs, CPU)
    ref = jib.text_impacts_device(doc_ids, tf_tiles, norms, cache, tile_term, len(term_df), n_docs)
    same_outputs("impacts vs jax", ref, got)
    # host: the same formula in numpy
    inv = cache[norms[np.clip(doc_ids, 0, n_docs - 1)].astype(np.int64)]
    imp = np.where(doc_ids >= 0, 1.0 - 1.0 / (1.0 + tf_tiles.astype(np.float32) * inv),
                   np.float32(0.0)).astype(np.float32)
    term_max = np.full(len(term_df), -np.inf, np.float32)
    np.maximum.at(term_max, tile_term, imp.max(axis=1))
    scales = (term_max / np.float32(127.0)).astype(np.float32)
    same_array("scales vs host", scales, got[1])


@pytest.mark.parametrize("nb", [1, 23, 5000])
def test_agg_perm_tables_match_jax_and_host(nb):
    ids = np.random.default_rng(nb).integers(0, nb + 1, size=997).astype(np.int64)
    got = ib.agg_perm_tables_device(ids, nb, CPU)
    same_outputs("perm vs jax", jib.agg_perm_tables_device(ids, nb), got)
    hperm = np.argsort(ids, kind="stable").astype(np.int32)
    same_array("perm", hperm, got[0])
    same_array("bounds", np.searchsorted(ids[hperm], np.arange(nb + 1)).astype(np.int32), got[1])
    assert ib.agg_perm_tables_device(ids[:0], nb, CPU) is None


def test_build_ops_are_counted():
    ib.reset_kernel_stats()
    ib.csr_offsets_device(np.ones(4, np.int32), 4, CPU)
    ib.csr_offsets_device(np.ones(4, np.int32), 4, CPU)
    snap = ib.kernel_stats_snapshot()
    assert snap["launches"] == {"rank_vectors": 2}
    assert snap["kernel_ms"]["rank_vectors"] >= 0.0


# ---------------------------------------------------------------------------
# whole segments: device build == host build, every family
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n", [1, 7, 137])
def test_device_build_bit_identical_all_families(device_build_auto, n):
    maps, docs = parsed_rich_docs(n)
    b = SegmentBuilder(maps)
    for d in docs:
        b.add(d)
    host = b.build()
    before = dict(segment_build.INGEST_STATS)
    dev = segment_build.build_segment(maps, docs, prefer_device=True, device=CPU)
    assert segment_build.INGEST_STATS["device_builds"] == before["device_builds"] + 1
    assert segment_build.INGEST_STATS["host_builds"] == before["host_builds"]
    assert_segments_identical(host, dev)


def test_empty_device_build_equals_host(device_build_auto):
    maps = Mappings(RICH_MAPPINGS)
    assert_segments_identical(SegmentBuilder(maps).build(),
                              segment_build._device_build(SegmentBuilder(maps), CPU))


def test_device_build_off_builds_on_host(monkeypatch):
    monkeypatch.setenv("ES_TPU_DEVICE_BUILD", "off")
    maps, docs = parsed_rich_docs(20)
    before = dict(segment_build.INGEST_STATS)
    segment_build.build_segment(maps, docs, prefer_device=True, device=CPU)
    assert segment_build.INGEST_STATS["host_builds"] == before["host_builds"] + 1
    assert segment_build.INGEST_STATS["device_builds"] == before["device_builds"]


BODIES = [
    {"query": {"match": {"body": "alpha beta"}}, "size": 20},
    {"query": {"bool": {"must": [{"match": {"body": "gamma"}}],
                        "filter": [{"terms": {"tag": ["a", "c"]}}]}}, "size": 20},
    {"query": {"range": {"popularity": {"gte": 30, "lt": 70}}}, "size": 20},
    {"knn": {"field": "emb", "query_vector": [0.3, -0.1, 0.5, 0.2, -0.7, 0.1, 0.0, 0.4],
             "k": 5, "num_candidates": 20}},
    {"query": {"sparse_vector": {"field": "ml", "query_vector": {"alpha": 1.0, "mu": 0.5}}}, "size": 10},
    {"size": 0, "request_cache": False,
     "aggs": {"t": {"terms": {"field": "tag"}, "aggs": {"p": {"avg": {"field": "popularity"}}}}}},
]


def same_response(ref, got, what):
    assert got["hits"]["total"] == ref["hits"]["total"], what
    rh, gh = ref["hits"]["hits"], got["hits"]["hits"]
    assert len(gh) == len(rh), what
    rs = np.array([h["_score"] or 0.0 for h in rh])
    np.testing.assert_allclose([h["_score"] or 0.0 for h in gh], rs, rtol=RTOL, atol=1e-6, err_msg=what)
    i = 0
    while i < len(rh):
        j = i + 1
        while j < len(rh) and np.isclose(rs[j], rs[j - 1], rtol=RTOL, atol=0):
            j += 1
        assert {h["_id"] for h in gh[i:j]} == {h["_id"] for h in rh[i:j]}, what
        i = j
    assert got.get("aggregations") == ref.get("aggregations"), what


def test_search_parity_device_built_engine_matches_jax(device_build_auto):
    """Two refresh waves built on the device by each package: every body
    answers as the JAX package's device-built engine."""
    docs = rich_docs(150, seed=7)
    jsvc = JIndexService("par", settings={"number_of_shards": 1, "search.backend": "jax"},
                         mappings_json=RICH_MAPPINGS)
    tsvc = IndexService("par", settings={"number_of_shards": 1}, mappings_json=RICH_MAPPINGS,
                        device="cpu")
    try:
        before = dict(segment_build.INGEST_STATS)
        for svc in (jsvc, tsvc):
            for i, (doc_id, src) in enumerate(docs):
                svc.index_doc(doc_id, copy.deepcopy(src))
                if i == 89:
                    svc.refresh()
            svc.refresh()
        assert segment_build.INGEST_STATS["device_builds"] == before["device_builds"] + 2
        assert segment_build.INGEST_STATS["host_builds"] == before["host_builds"]
        for body in BODIES:
            same_response(jsvc.search(copy.deepcopy(body)), tsvc.search(copy.deepcopy(body)), body)
    finally:
        jsvc.close()
        tsvc.close()


# ---------------------------------------------------------------------------
# the fault contract: host build only for an injected fault or a degrade
# ---------------------------------------------------------------------------


def _svc(docs):
    svc = IndexService("fault", settings={"number_of_shards": 1}, mappings_json=RICH_MAPPINGS,
                       device="cpu")
    for doc_id, src in docs:
        svc.index_doc(doc_id, src)
    return svc


def test_injected_build_fault_builds_on_host(device_build_auto):
    svc = _svc(rich_docs(30))
    try:
        faults.configure({"rules": [{"site": "build.device", "kind": "error"}]})
        before = dict(segment_build.INGEST_STATS)
        svc.refresh()
        assert segment_build.INGEST_STATS["fallbacks"] == before["fallbacks"] + 1
        assert segment_build.INGEST_STATS["host_builds"] == before["host_builds"] + 1
        assert svc.search({"size": 0, "track_total_hits": True})["hits"]["total"]["value"] == 30
    finally:
        svc.close()


def test_injected_build_fault_raises_under_force(monkeypatch):
    from elasticsearch_tpu_torch.common.faults import InjectedFault

    monkeypatch.setenv("ES_TPU_DEVICE_BUILD", "force")
    svc = _svc(rich_docs(10))
    try:
        faults.configure({"rules": [{"site": "build.device", "kind": "error"}]})
        with pytest.raises(InjectedFault):
            svc.refresh()
        faults.clear()
    finally:
        svc.close()


def test_ledger_degrade_builds_on_host(device_build_auto):
    svc = _svc(rich_docs(40))
    old_budget = hbm_ledger.budget
    before = dict(segment_build.INGEST_STATS)
    hbm_ledger.budget = hbm_ledger.used  # zero headroom
    try:
        svc.refresh()
    finally:
        hbm_ledger.budget = old_budget
    try:
        assert segment_build.INGEST_STATS["degraded"] == before["degraded"] + 1
        assert segment_build.INGEST_STATS["host_builds"] == before["host_builds"] + 1
        assert svc.search({"size": 0, "track_total_hits": True})["hits"]["total"]["value"] == 40
    finally:
        svc.close()


@pytest.mark.parametrize("op", ["postings_tiles_device", "ordinals_device", "sparse_planes_device"])
def test_runtime_error_in_a_build_op_fails_the_refresh(device_build_auto, monkeypatch, op):
    svc = _svc(rich_docs(30))
    try:
        svc.refresh()
        shard = svc.local_shard(0)
        gen = shard.change_generation
        svc.index_doc("late", {"body": "alpha late", "tag": ["z"], "ml": {"alpha": 1.0}})

        def boom(*a, **k):
            raise RuntimeError("device build op failed")

        monkeypatch.setattr(ib, op, boom)
        before = dict(segment_build.INGEST_STATS)
        with pytest.raises(RuntimeError, match="device build op failed"):
            svc.refresh()
        assert segment_build.INGEST_STATS["host_builds"] == before["host_builds"]
        assert segment_build.INGEST_STATS["fallbacks"] == before["fallbacks"]
        assert shard.change_generation == gen  # old generation serving
        assert shard.dirty  # the write is still buffered
        assert svc.search({"size": 0, "track_total_hits": True})["hits"]["total"]["value"] == 30
        monkeypatch.undo()
        monkeypatch.setenv("ES_TPU_DEVICE_BUILD", "auto")
        svc.refresh()
        assert svc.search({"size": 0, "track_total_hits": True})["hits"]["total"]["value"] == 31
    finally:
        svc.close()


# ---------------------------------------------------------------------------
# generation lifecycle: adoption and prewarm
# ---------------------------------------------------------------------------


def test_second_generation_adopts_unchanged_uploads(device_build_auto, monkeypatch):
    svc = _svc(rich_docs(60))
    uploads = []
    real = executor_torch.DevicePostings

    def counting(pf, device):
        uploads.append(pf)
        return real(pf, device)

    monkeypatch.setattr(executor_torch, "DevicePostings", counting)
    try:
        svc.refresh()
        shard = svc.local_shard(0)
        ex1 = svc._executor(shard)
        ex1.prewarm(svc.settings)
        seg0 = shard.reader().segments[0]
        assert len(uploads) == len(seg0.postings)
        old_cols = {c: dict(getattr(ex1.device_segments[0], c)._cache)
                    for c in ("postings", "numerics", "vectors", "ordinals")}
        old_bytes = sum(executor_torch._tree_nbytes(v) for cols in old_cols.values() for v in cols.values())
        assert old_bytes > 0
        for doc_id, src in rich_docs(5, seed=9):
            svc.index_doc("new" + doc_id, src)
        svc.refresh()
        ex2 = svc._executor(shard)
        assert ex2 is not ex1 and ex1._closed
        ds0 = ex2.device_segments[0]
        assert ds0.seg is seg0
        for c, cols in old_cols.items():
            for k, v in cols.items():
                assert getattr(ds0, c)._cache[k] is v, (c, k)
        assert ds0.adopted_bytes == old_bytes
        uploads.clear()
        ex2.prewarm(svc.settings)
        seg1 = shard.reader().segments[1]
        assert uploads == [seg1.postings[f] for f in seg1.postings]  # only the new segment
        # the ledger holds exactly the new executor's charges: the old
        # one released its own, the adopted bytes were charged again
        charged = {}
        for cat, nb in ex2._charges:
            charged[cat] = charged.get(cat, 0) + nb
        by_cat = hbm_ledger.stats()["by_category"]
        for cat in ("postings", "vectors"):
            assert by_cat.get(cat, 0) >= charged.get(cat, 0) > 0, cat
        assert sum(nb for _, nb in ex2._charges) >= old_bytes
    finally:
        svc.close()


def test_prewarm_builds_serving_caches(device_build_auto):
    svc = _svc(rich_docs(60))
    try:
        svc.refresh()
        ex = svc._executor(svc.local_shard(0))
        assert not ex._block_indexes  # lazy before prewarm
        ex.prewarm(svc.settings)
        assert ("body" in {f for _si, f in ex._block_indexes})
        assert ex._chunked_scorers and all(v is not None for v in ex._chunked_scorers.values())
        assert ex.device_segments[0].vectors._cache
        assert ex._rerank_columns
        assert svc.search({"query": {"match": {"body": "alpha"}}})["hits"]["total"]["value"] >= 1
    finally:
        svc.close()


def test_prewarm_lets_a_runtime_error_out(device_build_auto, monkeypatch):
    svc = _svc(rich_docs(30))
    try:
        svc.refresh()
        ex = svc._executor(svc.local_shard(0))

        def boom(si, field):
            raise RuntimeError("tiling upload failed")

        monkeypatch.setattr(ex, "block_index", boom)
        with pytest.raises(RuntimeError, match="tiling upload failed"):
            ex.prewarm(svc.settings)
    finally:
        svc.close()


def test_prewarm_skips_a_column_the_ledger_refuses(device_build_auto):
    svc = _svc(rich_docs(30))
    try:
        svc.refresh()
        ex = svc._executor(svc.local_shard(0))
        old_budget = hbm_ledger.budget
        hbm_ledger.budget = hbm_ledger.used  # the vector precheck trips
        try:
            ex.prewarm(svc.settings)
        finally:
            hbm_ledger.budget = old_budget
        assert not ex.device_segments[0].vectors._cache
        assert ex._block_indexes
    finally:
        svc.close()


# ---------------------------------------------------------------------------
# agg permutation tables on the device
# ---------------------------------------------------------------------------


def test_counts_layout_tables_equal_host_argsort(monkeypatch):
    svc = _svc(rich_docs(120))
    try:
        monkeypatch.setenv("ES_TPU_DEVICE_BUILD", "off")
        svc.refresh()
        shard = svc.local_shard(0)
        layouts = {}
        for mode in ("off", "auto"):
            monkeypatch.setenv("ES_TPU_DEVICE_BUILD", mode)
            ex = executor_torch.TorchExecutor(shard.reader(), device="cpu")
            ib.reset_kernel_stats()
            spaces = {
                "kw": aggs_device._space_kw(ex, 0, "tag"),
                "num": aggs_device._space_num(ex, 0, "popularity")[0],
                "hist": aggs_device._space_hist(ex, 0, "popularity", 10, 0)[0],
            }
            layouts[mode] = {k: aggs_device.counts_layout(ex, 0, (k,), sp) for k, sp in spaces.items()}
            launches = ib.kernel_stats_snapshot()["launches"].get("agg_tables", 0)
            assert launches == (3 if mode == "auto" else 0)
            ex.close()
        for k in ("kw", "num", "hist"):
            for part in ("map", "gate", "bounds"):
                same_array(f"{k}.{part}", layouts["off"][k][part].numpy(), layouts["auto"][k][part].numpy())
    finally:
        svc.close()
