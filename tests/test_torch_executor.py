"""The PyTorch port's shard executor against the JAX package's, on the
CPU: the same segments (built by the JAX package's SegmentBuilder and
carried across with `segment_from_reference`) go through `JaxExecutor`
and `TorchExecutor(device="cpu")`, and must give the same hits with
scores within rtol 1e-5 (the reference's own parity tolerance: float32
sums taken in another order) and the same ids position by position,
where a run of scores tied within rtol 1e-5 compares as a set. Date
ranges at millisecond precision are held to the JAX package's
`NumpyExecutor` instead: `JaxExecutor` rounds doc values to float32."""

import ast
from pathlib import Path

import numpy as np
import pytest
import torch

from elasticsearch_tpu.analysis import AnalysisRegistry as JAnalysis
from elasticsearch_tpu.index.mapping import DocumentParser as JParser
from elasticsearch_tpu.index.mapping import Mappings as JMappings
from elasticsearch_tpu.index.segment import SegmentBuilder as JBuilder
from elasticsearch_tpu.search import dsl as jdsl
from elasticsearch_tpu.search import executor_jax
from elasticsearch_tpu.search.executor import NumpyExecutor as JNumpy
from elasticsearch_tpu.search.executor import ShardReader as JReader
from elasticsearch_tpu.search.executor_jax import JaxExecutor

from elasticsearch_tpu_torch.analysis import AnalysisRegistry
from elasticsearch_tpu_torch.convert import segment_from_reference
from elasticsearch_tpu_torch.index.mapping import Mappings
from elasticsearch_tpu_torch.ops import scoring as tscoring
from elasticsearch_tpu_torch.search import dsl
from elasticsearch_tpu_torch.search.executor import NumpyExecutor, ShardReader
from elasticsearch_tpu_torch.search.executor_torch import TorchExecutor

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent

VOCAB = [
    "alpha", "bravo", "charlie", "delta", "echo", "foxtrot", "golf",
    "hotel", "india", "juliet", "kilo", "lima", "mike", "november",
    "oscar", "papa", "quebec", "romeo", "sierra", "tango",
]

MAPPING = {
    "properties": {
        "title": {"type": "text"},
        "body": {"type": "text"},
        "tag": {"type": "keyword"},
        "views": {"type": "integer"},
        "vec": {"type": "dense_vector", "dims": 8, "similarity": "cosine"},
    }
}


def zipf_text(rng, n_words):
    p = 1.0 / np.arange(1, len(VOCAB) + 1)
    p /= p.sum()
    return " ".join(rng.choice(VOCAB, size=n_words, p=p))


def build_readers(n_docs=300, n_segments=1, seed=7, mapping=MAPPING, fields=None):
    """(JAX package reader, port reader) over the same segments."""
    rng = np.random.default_rng(seed)
    jm = JMappings(mapping)
    ja = JAnalysis()
    parser = JParser(jm, ja)
    segs = []
    doc_num = 0
    for _ in range(n_segments):
        builder = JBuilder(jm)
        for _ in range(n_docs // n_segments):
            src = {
                "title": zipf_text(rng, int(rng.integers(2, 8))),
                "body": zipf_text(rng, int(rng.integers(5, 60))),
                "tag": str(rng.choice(["a", "b", "c", "d"])),
                "views": int(rng.integers(0, 1000)),
                "vec": rng.standard_normal(8).astype(np.float32).tolist(),
            }
            if fields is not None:
                src = {f: src[f] for f in fields}
            builder.add(parser.parse(f"doc-{doc_num}", src))
            doc_num += 1
        segs.append(builder.build())
    jreader = JReader(segs, jm, ja)
    treader = ShardReader(
        [segment_from_reference(s) for s in segs], Mappings(mapping), AnalysisRegistry()
    )
    return jreader, treader


JR, TR = build_readers()
JR_MULTI, TR_MULTI = build_readers(n_docs=200, n_segments=3, seed=11)
JAXEX, JAXEX_MULTI = JaxExecutor(JR), JaxExecutor(JR_MULTI)
TEX = TorchExecutor(TR, device="cpu")
TEX_MULTI = TorchExecutor(TR_MULTI, device="cpu")

# every row of tests/test_jax_parity.py QUERIES (the match rows first),
# plus match_none, a title match, dis_max, ids, match on a keyword and
# numeric terms
QUERIES = [
    {"match": {"body": "alpha"}},
    {"match": {"body": "alpha bravo charlie"}},
    {"match": {"body": {"query": "alpha bravo", "operator": "and"}}},
    {"match": {"body": {"query": "alpha bravo charlie delta", "minimum_should_match": 3}}},
    {"match": {"body": {"query": "alpha", "boost": 2.5}}},
    {"match_all": {}},
    {"match_none": {}},
    {"match": {"title": "bravo quebec"}},
    {"term": {"tag": "a"}},
    {"terms": {"tag": ["a", "c"]}},
    {"term": {"views": 500}},
    {"range": {"views": {"gte": 100, "lt": 700}}},
    {"range": {"tag": {"gte": "a", "lte": "b"}}},
    {"exists": {"field": "views"}},
    {"constant_score": {"filter": {"match": {"body": "echo"}}, "boost": 3.0}},
    {"multi_match": {"query": "alpha echo", "fields": ["title^2", "body"]}},
    {"multi_match": {"query": "alpha echo", "fields": ["title", "body"], "type": "most_fields"}},
    {"multi_match": {"query": "alpha echo", "fields": ["title", "body"], "tie_breaker": 0.3}},
    {
        "bool": {
            "must": [{"match": {"body": "alpha"}}],
            "filter": [{"range": {"views": {"gte": 50}}}],
            "should": [{"term": {"tag": "b"}}],
            "must_not": [{"term": {"tag": "d"}}],
        }
    },
    {
        "bool": {
            "should": [
                {"match": {"title": "bravo"}},
                {"match": {"body": "quebec tango"}},
            ],
            "minimum_should_match": 1,
        }
    },
    {"bool": {"must_not": [{"term": {"tag": "a"}}]}},
    {
        "bool": {
            "must": [
                {
                    "bool": {
                        "should": [
                            {"match": {"body": "alpha"}},
                            {"match": {"body": "bravo"}},
                        ]
                    }
                }
            ],
            "boost": 2.0,
        }
    },
    {"dis_max": {"queries": [{"match": {"title": "alpha"}}, {"match": {"body": "alpha echo"}}],
                 "tie_breaker": 0.4, "boost": 1.5}},
    {"ids": {"values": ["doc-3", "doc-17", "doc-150", "doc-299", "nope"]}},
    {"match": {"tag": "b"}},
    {"terms": {"views": [1, 2, 500, 999, 31]}},
    {"bool": {"filter": [{"terms": {"tag": ["b", "d"]}}, {"range": {"views": {"lt": 400}}}],
              "should": [{"match": {"body": "charlie"}}], "minimum_should_match": 0}},
]


def assert_same(res_ref, res, scores_rtol=1e-5):
    """Same total, scores within `scores_rtol`, ids position by position;
    within a run of reference scores tied within `scores_rtol` the run's
    ids agree as a set (only ulp-level differences in the sums may
    reorder such a run)."""
    assert res_ref.total == res.total
    assert len(res_ref.hits) == len(res.hits)
    ref_scores = np.array([h.score for h in res_ref.hits])
    scores = np.array([h.score for h in res.hits])
    np.testing.assert_allclose(scores, ref_scores, rtol=scores_rtol, atol=1e-6)
    ref_ids = [h.doc_id for h in res_ref.hits]
    ids = [h.doc_id for h in res.hits]
    i = 0
    while i < len(ref_ids):
        j = i + 1
        while j < len(ref_ids) and np.isclose(ref_scores[j], ref_scores[j - 1], rtol=scores_rtol, atol=0):
            j += 1
        assert set(ids[i:j]) == set(ref_ids[i:j]), (i, ref_ids, ids)
        i = j


@pytest.mark.parametrize("qi", range(len(QUERIES)))
def test_query_parity_single_segment(qi):
    ref = JAXEX.search(jdsl.parse_query(QUERIES[qi]), size=20)
    got = TEX.search(dsl.parse_query(QUERIES[qi]), size=20)
    assert_same(ref, got)


@pytest.mark.parametrize("qi", range(len(QUERIES)))
def test_query_parity_multi_segment(qi):
    ref = JAXEX_MULTI.search(jdsl.parse_query(QUERIES[qi]), size=20)
    got = TEX_MULTI.search(dsl.parse_query(QUERIES[qi]), size=20)
    assert_same(ref, got)


def test_port_oracle_matches_reference_oracle():
    """The port's copy of the NumPy oracle scores like the original."""
    for body in QUERIES:
        assert_same(
            JNumpy(JR).search(jdsl.parse_query(body), size=20),
            NumpyExecutor(TR).search(dsl.parse_query(body), size=20),
            scores_rtol=0,
        )


def _knn(params):
    return [jdsl.parse_knn(params)], [dsl.parse_knn(params)]


@pytest.mark.parametrize(
    "params",
    [
        {"k": 15, "num_candidates": 50},
        {"k": 10},
        {"k": 5, "num_candidates": 5, "boost": 2.0},
        {"k": 10, "similarity": 0.6},
        {"k": 10, "filter": {"term": {"tag": "b"}}},
        {"k": 8, "num_candidates": 20, "filter": {"bool": {"filter": [{"range": {"views": {"gte": 300}}}],
                                                             "must_not": [{"term": {"tag": "a"}}]}}},
    ],
)
def test_knn_parity(params):
    vec = np.random.default_rng(3).standard_normal(8).tolist()
    jk, tk = _knn({"field": "vec", "query_vector": vec, **params})
    assert_same(JAXEX.search(None, knn=jk, size=15), TEX.search(None, knn=tk, size=15))


@pytest.mark.parametrize("filt", [None, {"terms": {"tag": ["a", "c"]}}])
def test_knn_multi_segment_parity(filt):
    vec = np.random.default_rng(6).standard_normal(8).tolist()
    params = {"field": "vec", "query_vector": vec, "k": 12, "num_candidates": 30}
    if filt is not None:
        params["filter"] = filt
    jk, tk = _knn(params)
    assert_same(
        JAXEX_MULTI.search(None, knn=jk, size=12),
        TEX_MULTI.search(None, knn=tk, size=12),
    )


@pytest.mark.parametrize("boost", [1.0, 2.5])
def test_knn_global_cut_scatters_the_references_masks(boost):
    """The per-segment (mask, scores) that the global kNN cut hands the
    query phase — built on the device from one upload of the kept (doc,
    score) pairs — equal the reference's, which are built as numpy
    arrays and copied up: same docs, float32-equal scores."""
    vec = np.random.default_rng(12).standard_normal(8).tolist()
    jk, tk = _knn({"field": "vec", "query_vector": vec, "k": 17, "num_candidates": 25, "boost": boost})
    ref = JAXEX_MULTI._knn_topk_global(jk[0])
    got = TEX_MULTI._knn_topk_global(tk[0])
    assert len(ref) == len(got) == 3
    kept = 0
    for (rm, rs), (gm, gs) in zip(ref, got):
        np.testing.assert_array_equal(gm.numpy(), np.asarray(rm))
        np.testing.assert_allclose(gs.numpy(), np.asarray(rs), rtol=1e-6, atol=0)
        assert gs.dtype == torch.float32 and gm.dtype == torch.bool
        kept += int(gm.sum())
    assert kept == 17
    # the query row goes up through ops/scoring.upload (pinned on a card)
    q = TEX_MULTI._query_vector(tk[0])
    assert q.shape == (1, 8) and q.dtype == torch.float32


def test_hybrid_parity():
    vec = np.random.default_rng(5).standard_normal(8).tolist()
    jk, tk = _knn({"field": "vec", "query_vector": vec, "k": 10})
    body = {"match": {"body": "alpha bravo"}}
    assert_same(
        JAXEX.search(jdsl.parse_query(body), knn=jk, size=20),
        TEX.search(dsl.parse_query(body), knn=tk, size=20),
    )


def test_knn_query_node_parity():
    vec = np.random.default_rng(8).standard_normal(8).tolist()
    jk, tk = _knn({"field": "vec", "query_vector": vec, "num_candidates": 20})
    assert_same(
        JAXEX_MULTI.search(jdsl.KnnQueryWrapper(knn=jk[0]), size=20),
        TEX_MULTI.search(dsl.KnnQueryWrapper(knn=tk[0]), size=20),
    )


def test_pagination_and_min_score_parity():
    body = {"match": {"body": "alpha bravo charlie"}}
    assert_same(
        JAXEX.search(jdsl.parse_query(body), size=5, from_=5),
        TEX.search(dsl.parse_query(body), size=5, from_=5),
    )
    body = {"match": {"body": "alpha"}}
    assert_same(
        JAXEX.search(jdsl.parse_query(body), size=50, min_score=0.5),
        TEX.search(dsl.parse_query(body), size=50, min_score=0.5),
    )


def test_live_docs_parity():
    rng = np.random.default_rng(9)
    live = [rng.random(s.num_docs) > 0.3 for s in JR_MULTI.segments]
    jr = JReader(JR_MULTI.segments, JR_MULTI.mappings, JR_MULTI.analysis, live)
    tr = ShardReader(TR_MULTI.segments, TR_MULTI.mappings, TR_MULTI.analysis, live)
    body = {"match": {"body": "alpha echo"}}
    assert_same(
        JaxExecutor(jr).search(jdsl.parse_query(body), size=20),
        TorchExecutor(tr, device="cpu").search(dsl.parse_query(body), size=20),
    )


# ---- the batched fused route (fused_plan → FusedScorer → merge) ----

FUSED_MAPPING = {"properties": {"body": {"type": "text"}}}
# 2 segments of 1300 docs: the commonest words reach the dense hot-row
# threshold (doc_freq >= 1024), the rest go through rare tiles
JR_FUSED, TR_FUSED = build_readers(
    n_docs=2600, n_segments=2, seed=21, mapping=FUSED_MAPPING, fields=("body",)
)
FUSED_MIN = 1000

FUSED_QUERIES = [
    ("alpha bravo", 1),
    ("kilo lima mike", 1),
    ("alpha quebec tango", 2),
    ("bravo charlie delta echo", 4),
    ("sierra", 1),
]


def _plans(ex, fs_of, terms_msm, boost=1.0):
    analyzer = ex.reader.analysis.get(ex.reader.mappings.get("body").analyzer)
    out = []
    for si in range(len(ex.reader.segments)):
        fs = fs_of(si)
        out.append(
            (fs, [ex.fused_plan(fs, si, "body", analyzer.terms(t), boost, m) for t, m in terms_msm])
        )
    return out


def _torch_fused_route(tex, terms_msm, k):
    """The batched route a serving batcher drives, on the port."""
    items = []
    for si, (fs, plans) in enumerate(_plans(tex, lambda si: tex.fused_scorer(si, "body"), terms_msm)):
        assert fs is not None and all(p is not None for p in plans)
        with_cnt = any(m > 1 for _, m in terms_msm)
        pending = fs.search_async(plans, k, with_cnt, rows=len(plans))
        s, d, t = fs.device_result(pending)
        items.append((si, s, d, t))
    return tscoring.merge_segment_topk(items, k)


def test_fused_route_has_hot_rows():
    tex = TorchExecutor(TR_FUSED, device="cpu", fused_min_docs=FUSED_MIN)
    assert TorchExecutor(TR_FUSED, device="cpu").fused_scorer(0, "body") is None
    fs = tex.fused_scorer(0, "body")
    assert fs is not None and fs.dense is not None and fs.dense.shape[0] >= 1
    assert fs.dense.dtype == torch.uint8


@pytest.mark.parametrize("qi", range(len(FUSED_QUERIES)))
def test_fused_route_matches_per_query_route(qi):
    """fused_plan → FusedScorer.search_async → merge_segment_topk gives
    the per-query route's hits and totals."""
    tex = TorchExecutor(TR_FUSED, device="cpu", fused_min_docs=FUSED_MIN)
    text, msm = FUSED_QUERIES[qi]
    k = 10
    scores, segs, docs, totals = _torch_fused_route(tex, [(text, msm)], k)
    q = dsl.parse_query({"match": {"body": {"query": text, "minimum_should_match": msm}}})
    ref = TorchExecutor(TR_FUSED, device="cpu").search(q, size=k)
    assert int(totals[0].sum()) == ref.total
    n = len(ref.hits)
    np.testing.assert_allclose(scores[0][:n], [h.score for h in ref.hits], rtol=1e-5, atol=1e-6)
    for i, h in enumerate(ref.hits):
        if (segs[0][i], docs[0][i]) != (h.segment, h.local_doc):
            assert np.isclose(scores[0][i], h.score, rtol=1e-5)


def test_fused_route_matches_jax_fused_route(monkeypatch):
    """The port's fused scorer and merge against the JAX package's, both
    at a lowered FUSED_MIN_DOCS, on one batch of several queries."""
    monkeypatch.setattr(executor_jax, "FUSED_MIN_DOCS", FUSED_MIN)
    from elasticsearch_tpu.ops import scoring as jscoring

    jex = JaxExecutor(JR_FUSED)
    tex = TorchExecutor(TR_FUSED, device="cpu", fused_min_docs=FUSED_MIN)
    k = 10
    j_items = []
    for si, (fs, plans) in enumerate(_plans(jex, lambda si: jex.fused_scorer(si, "body"), FUSED_QUERIES)):
        s, d, t = fs.device_result(fs.search_async(plans, k, True, rows=8))
        j_items.append((si, s, d, t))
    js, jseg, jd, jt = jscoring.merge_segment_topk(j_items, k)
    t_items = []
    for si, (fs, plans) in enumerate(_plans(tex, lambda si: tex.fused_scorer(si, "body"), FUSED_QUERIES)):
        s, d, t = fs.device_result(fs.search_async(plans, k, True, rows=8))
        t_items.append((si, s, d, t))
    ts, tseg, td, tt = tscoring.merge_segment_topk(t_items, k)
    np.testing.assert_array_equal(tt, jt)
    np.testing.assert_allclose(ts, js, rtol=1e-5, atol=1e-6)
    diff = (tseg != jseg) | (td != jd)
    assert np.allclose(ts[diff], js[diff], rtol=1e-5)


def test_fused_plan_overflow_is_none():
    tex = TorchExecutor(TR_FUSED, device="cpu", fused_min_docs=FUSED_MIN)
    fs = tex.fused_scorer(0, "body")
    fs_small = tscoring.FusedScorer(fs.doc_ids, fs.tfs, fs.inv_norm, None, fs.dense, t_rare=1, n_hot_slots=0)
    fs_small.hot_rank = fs.hot_rank
    assert tex.fused_plan(fs_small, 0, "body", VOCAB, 1.0, 1) is None


# ---- the remaining query nodes, and what the port must not do ----


@pytest.mark.parametrize(
    "body",
    [
        {"match_phrase": {"body": "alpha bravo"}},
        {"bool": {"must": [{"prefix": {"body": "alp"}}]}},
        {"multi_match": {"query": "alpha", "fields": ["title", "body"], "type": "phrase"}},
        {"wildcard": {"body": "al*a"}},
        {"fuzzy": {"body": {"value": "alpah", "fuzziness": 2}}},
    ],
)
def test_unported_node_raises(body):
    """These nodes were cut before the port served them; now each is
    held to the JAX package (phrase: a device conjunction and a host
    position verify; prefix/wildcard/fuzzy: host expansion, one device
    pass)."""
    ref = JAXEX.search(jdsl.parse_query(body), size=20)
    got = TEX.search(dsl.parse_query(body), size=20)
    assert ref.total > 0
    assert_same(ref, got)


def test_knn_filter_raises_not_implemented():
    """A kNN filter made of a phrase node (cut before) is held to the
    JAX package."""
    params = {"field": "vec", "query_vector": [0.1] * 8, "k": 3,
              "filter": {"match_phrase": {"body": "alpha bravo"}}}
    jk, tk = _knn(params)
    ref = JAXEX.search(None, knn=jk, size=3)
    assert ref.hits
    assert_same(ref, TEX.search(None, knn=tk, size=3))


def test_default_device_is_cuda_and_does_not_fall_back():
    if torch.cuda.is_available():
        assert TorchExecutor(TR).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="cuda"):
            TorchExecutor(TR)


def test_ledger_charges_released_on_close():
    from elasticsearch_tpu_torch.common.memory import hbm_ledger

    before = hbm_ledger.used
    ex = TorchExecutor(TR, device="cpu")
    ex.search(dsl.parse_query({"match": {"body": "alpha"}}), size=3)
    assert hbm_ledger.used > before
    ex.close()
    assert hbm_ledger.used == before


def _imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


PORT_FILES = sorted((REPO / "elasticsearch_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(REPO)))
def test_port_imports_no_jax(path):
    """No module of the port, and not chip_smoke.py, imports jax or the
    JAX package (absolute imports; the port's relative imports resolve
    inside its own package)."""
    bad = [
        m for m in _imports(path)
        if m.split(".")[0] in ("jax", "jaxlib", "elasticsearch_tpu")
    ]
    assert not bad, f"{path} imports {bad}"


def _module_exists(base: Path, dotted: str) -> bool:
    target = base.joinpath(*dotted.split("."))
    return target.with_suffix(".py").is_file() or (target / "__init__.py").is_file()


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(REPO)))
def test_port_relative_imports_resolve_inside_the_port(path):
    """Every relative import of the port names a module the port has
    (its own copy), so no verbatim copy reaches for a module that was
    left behind in the JAX package."""
    missing = []
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if not isinstance(node, ast.ImportFrom) or node.level == 0:
            continue
        base = path.parent
        for _ in range(node.level - 1):
            base = base.parent
        assert (base / "__init__.py").is_file(), f"{path}: {node.level} dots leave the package"
        if node.module:
            if not _module_exists(base, node.module):
                missing.append(node.module)
            continue
        init = (base / "__init__.py").read_text()
        for a in node.names:
            if not _module_exists(base, a.name) and a.name not in init:
                missing.append(a.name)
    assert not missing, f"{path} imports missing port modules {missing}"


# ---- dates at millisecond precision (held to the reference's oracle) ----

DATE_MAPPING = {"properties": {"day": {"type": "date"}, "body": {"type": "text"}}}
DATE_DOCS = [1700000000000, 1700000000001, 1700000000050, 1700000100000]


def _date_readers():
    jm, ja = JMappings(DATE_MAPPING), JAnalysis()
    parser = JParser(jm, ja)
    builder = JBuilder(jm)
    for i, ms in enumerate(DATE_DOCS):
        builder.add(parser.parse(f"t{i}", {"day": ms, "body": "alpha" if i % 2 else "alpha bravo"}))
    seg = builder.build()
    return (
        JReader([seg], jm, ja),
        ShardReader([segment_from_reference(seg)], Mappings(DATE_MAPPING), AnalysisRegistry()),
    )


@pytest.mark.parametrize(
    "body,total",
    [
        ({"range": {"day": {"gt": 1700000000000}}}, 3),
        ({"range": {"day": {"gte": 1700000000001, "lt": 1700000000050}}}, 1),
        ({"bool": {"must": [{"match": {"body": "alpha"}}],
                   "filter": [{"range": {"day": {"gt": 1700000000000}}}]}}, 3),
        ({"term": {"day": 1700000000050}}, 1),
    ],
)
def test_date_range_at_millisecond_boundary_matches_numpy_oracle(body, total):
    """Numeric doc values stay float64 on the device: the port agrees
    with the reference's NumpyExecutor to the millisecond (JaxExecutor
    rounds to float32 and finds none of the three)."""
    jr, tr = _date_readers()
    ref = JNumpy(jr).search(jdsl.parse_query(body), size=10)
    got = TorchExecutor(tr, device="cpu").search(dsl.parse_query(body), size=10)
    assert ref.total == total
    assert_same(ref, got)
    ds = TorchExecutor(tr, device="cpu").device_segments[0]
    assert ds.numerics["day"][0].dtype == torch.float64
    assert ds.numerics["day"][1].dtype == torch.bool


# ---- the multi-field fused scorer (bool / multi_match serving engine) ----

MF_MAPPING = {"properties": {"title": {"type": "text"}, "body": {"type": "text"}}}
JR_MF, TR_MF = build_readers(n_docs=2600, n_segments=2, seed=31, mapping=MF_MAPPING, fields=("title", "body"))

# (per-field [(term, term_boost, counted)], msm): must/should mixes,
# counted-only, a zero term boost (counted via the 1e-30 nudge)
MF_JOBS = [
    ({"title": [("alpha", 2.0, True)], "body": [("alpha", 1.0, True), ("kilo", 1.0, True)]}, 1),
    ({"body": [("alpha", 1.0, True), ("bravo", 1.0, False), ("quebec", 1.0, False)]}, 1),
    ({"title": [("charlie", 1.0, True)], "body": [("delta", 1.0, True), ("echo", 1.0, False)]}, 2),
    ({"title": [("bravo", 0.0, True)], "body": [("sierra", 1.0, True)]}, 2),
    ({"title": [("tango", 1.0, True)], "body": [("tango", 1.0, True)]}, 1),
]


def _mf_route(ex, jobs, combine, tie, k, scoring_mod, rows=8):
    items = []
    for si in range(len(ex.reader.segments)):
        fs = ex.fused_scorer_mf(si, ("title", "body"))
        assert fs is not None
        plans = []
        for groups, msm in jobs:
            sections = [
                ex.fused_plan_field(si, f, ex.fused_parts(si, f), groups.get(f, []), 1.3)
                for f in ("title", "body")
            ]
            assert all(s is not None for s in sections)
            plans.append((sections, msm))
        items.append((si, *fs.device_result(fs.search_async(plans, k, combine, tie, rows=rows))))
    return scoring_mod.merge_segment_topk(items, k)


@pytest.mark.parametrize("combine,tie", [("sum", 0.0), ("max_tie", 0.3), ("max_tie", 0.0)])
def test_multi_fused_scorer_matches_reference(monkeypatch, combine, tie):
    """fused_plan_field → MultiFusedScorer.search_async → merge on both
    packages at a lowered fused size: totals equal, scores within rtol
    1e-5, ids by the tie-run rule."""
    monkeypatch.setattr(executor_jax, "FUSED_MIN_DOCS", FUSED_MIN)
    from elasticsearch_tpu.ops import scoring as jscoring

    jex = JaxExecutor(JR_MF)
    tex = TorchExecutor(TR_MF, device="cpu", fused_min_docs=FUSED_MIN)
    assert any(tex.fused_parts(0, f)["dense"] is not None for f in ("title", "body"))
    k = 10
    js, jseg, jd, jt = _mf_route(jex, MF_JOBS, combine, tie, k, jscoring)
    ts, tseg, td, tt = _mf_route(tex, MF_JOBS, combine, tie, k, tscoring)
    np.testing.assert_array_equal(tt, jt)
    np.testing.assert_allclose(ts, js, rtol=1e-5, atol=1e-6)
    for r in range(len(MF_JOBS)):
        fin = np.isfinite(js[r])
        np.testing.assert_array_equal(np.isfinite(ts[r]), fin)
        ref_ids = [f"{a}:{b}" for a, b in zip(jseg[r][fin], jd[r][fin])]
        got_ids = [f"{a}:{b}" for a, b in zip(tseg[r][fin], td[r][fin])]
        i = 0
        while i < len(ref_ids):
            j = i + 1
            while j < len(ref_ids) and np.isclose(js[r][fin][j], js[r][fin][j - 1], rtol=1e-5, atol=0):
                j += 1
            assert set(got_ids[i:j]) == set(ref_ids[i:j]), (r, i)
            i = j


@pytest.mark.parametrize("tb,expect", [(1.0, "pos"), (0.0, "nudged"), (-2.0, None)])
def test_fused_plan_field_sign_flag(monkeypatch, tb, expect):
    """|w| scores and w > 0 counts: a counted term carries a positive
    weight, an uncounted one the negated weight; a zero weight is nudged
    to 1e-30 (a normal float32) so it still counts; a negative weight
    gives None (the tree walk serves it) — as in the reference."""
    monkeypatch.setattr(executor_jax, "FUSED_MIN_DOCS", FUSED_MIN)
    jex = JaxExecutor(JR_MF)
    tex = TorchExecutor(TR_MF, device="cpu", fused_min_docs=FUSED_MIN)
    terms = [("kilo", tb, True), ("lima", tb, False), ("alpha", tb, True)]
    ref = jex.fused_plan_field(0, "body", jex.fused_parts(0, "body"), terms, 1.0)
    got = tex.fused_plan_field(0, "body", tex.fused_parts(0, "body"), terms, 1.0)
    if expect is None:
        assert ref is None and got is None
        return
    for r, g in zip(ref, got):
        np.testing.assert_array_equal(g, r)
    rare_w, hot_w = got[1], got[3]
    assert len(hot_w) >= 1  # "alpha" is a dense hot row
    w = np.concatenate([rare_w, hot_w])
    assert (w != 0).all()
    if expect == "nudged":
        assert np.all(np.abs(w) == np.float32(1e-30)) and np.finfo(np.float32).tiny < 1e-30
    n_lima = int(tex.reader.segments[0].postings["body"].term_tile_count[
        tex.reader.segments[0].postings["body"].term_id("lima")])
    assert (rare_w < 0).sum() == n_lima  # the uncounted term's tiles


# ---- the filtered-bool route and the filter-bitset cache ----

FILTERED = [
    # must match alone: the single-field engine
    ({"bool": {"must": [{"match": {"body": "alpha bravo"}}], "filter": [{"term": {"tag": "a"}}]}}, 10_000),
    ({"bool": {"must": [{"match": {"body": "alpha"}}], "filter": [{"range": {"views": {"gte": 200}}}]}}, False),
    # must + should: a ServePlan
    ({"bool": {"must": [{"term": {"body": "alpha"}}], "should": [{"match": {"body": "echo kilo"}}],
               "filter": [{"terms": {"tag": ["b", "c"]}}, {"range": {"views": {"lt": 800}}}]}}, 10_000),
    # should-only with an explicit msm
    ({"bool": {"should": [{"match": {"title": "bravo"}}, {"match": {"body": "quebec"}}],
               "minimum_should_match": 1, "filter": [{"exists": {"field": "views"}}]}}, 10_000),
]


def _filtered(ex, pkg_dsl, batcher_mod, body, tth, k=10):
    q = pkg_dsl.parse_query(body)
    stripped, fclauses = batcher_mod.split_filtered_bool(q)
    return ex.search_plan_filtered(stripped, fclauses, k, tth, ex.reader.mappings, ex.reader.analysis)


@pytest.mark.parametrize("fi", range(len(FILTERED)))
@pytest.mark.parametrize("multi", [False, True])
def test_search_plan_filtered_matches_reference(fi, multi):
    from elasticsearch_tpu.search import batcher as jbatcher

    from elasticsearch_tpu_torch.search import batcher as tbatcher
    from elasticsearch_tpu_torch.search.query_cache import CacheCtx, filter_cache

    body, tth = FILTERED[fi]
    jex = JAXEX_MULTI if multi else JAXEX
    tex = TorchExecutor(TR_MULTI if multi else TR, device="cpu")
    tex.cache_ctx = CacheCtx(f"filtered-{fi}-{multi}[0]", 1, "torch")
    ref = _filtered(jex, jdsl, jbatcher, body, tth)
    assert ref is not None
    before = filter_cache.node_stats()
    cold = _filtered(tex, dsl, tbatcher, body, tth)
    warm = _filtered(tex, dsl, tbatcher, body, tth)
    after = filter_cache.node_stats()
    for got in (cold, warm):
        assert_same(ref, got)
        assert got.relation == ref.relation
    n_seg = 3 if multi else 1
    n_filters = len(body["bool"]["filter"])
    # the cold run filled the cache, the warm run read it back
    assert after["miss_count"] - before["miss_count"] == n_seg * n_filters
    assert after["hit_count"] - before["hit_count"] == n_seg * n_filters
    assert after["cache_count"] - before["cache_count"] == n_seg * n_filters


def test_filter_cache_torch_and_np_entries_never_alias():
    """One shard key, one generation, one filter: the torch executor's
    entry is a device bool tensor, the numpy oracle's a packed host
    bitmap, and neither reads the other's."""
    from elasticsearch_tpu_torch.search.query_cache import CacheCtx, filter_cache

    tex = TorchExecutor(TR, device="cpu")
    npx = NumpyExecutor(TR)
    tex.cache_ctx = CacheCtx("alias[0]", 7, "torch")
    npx.cache_ctx = CacheCtx("alias[0]", 7, "np")
    q = dsl.parse_query({"term": {"tag": "c"}})
    fkey = dsl.canonical_key(q)
    t_mask = tex.filter_mask(q, 0)
    n_mask = npx.filter_mask(q, TR.segments[0])
    t_entry = filter_cache.get(tex.cache_ctx, 0, fkey)
    n_entry = filter_cache.get(npx.cache_ctx, 0, fkey)
    assert isinstance(t_entry, torch.Tensor) and t_entry.dtype == torch.bool
    assert t_entry.numel() == TR.segments[0].num_docs
    assert isinstance(n_entry, np.ndarray) and n_entry.dtype == np.uint8
    np.testing.assert_array_equal(t_mask.numpy(), n_mask)
    assert tex.filter_mask(q, 0) is t_entry  # a hit hands back the cached tensor


@pytest.mark.parametrize("body", [
    {"bool": {"must": [{"match": {"body": "alpha kilo"}}], "filter": [{"term": {"title": "bravo"}}]}},
    {"bool": {"must": [{"term": {"body": "alpha"}}], "should": [{"match": {"title": "echo kilo"}}],
              "filter": [{"term": {"body": "charlie"}}]}},
])
def test_search_plan_filtered_fused_matches_reference(monkeypatch, body):
    """At a lowered fused size the filtered route runs the fused scorers
    with the bitset as their live operand (1-row launches)."""
    from elasticsearch_tpu.search import batcher as jbatcher

    from elasticsearch_tpu_torch.search import batcher as tbatcher

    monkeypatch.setattr(executor_jax, "FUSED_MIN_DOCS", FUSED_MIN)
    tex = TorchExecutor(TR_MF, device="cpu", fused_min_docs=FUSED_MIN)
    ref = _filtered(JaxExecutor(JR_MF), jdsl, jbatcher, body, 10_000)
    got = _filtered(tex, dsl, tbatcher, body, 10_000)
    assert_same(ref, got)
    assert tex._fused_scorers or tex._fused_mf
    assert any(v is not None for v in list(tex._fused_scorers.values()) + list(tex._fused_mf.values()))
