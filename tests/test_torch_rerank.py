"""The port's second-stage rerank (`rescore` over `rank_vectors`) against
the JAX package's, on the CPU.

The same inputs, made with numpy from a seed, go through the JAX
package's functions and the port's: the maxsim + blend + sort op
(`ops/rerank.py`, every row bucket, f32 and int8 token rows, ragged
token counts with token-less docs, windows below and above the
candidate count, `query_weight` 0 and forced ties), the host oracle
(`models/rerank.py`, bit for bit), `search/rescorer.parse_rescore`'s
400s, the batcher's `rerank` family at every bucket, and
`IndexService` end to end (`match`, `retriever.rrf` and `rank.rrf` with
a rescore, int8 token rows, two shards, `?rescore=false`,
`ES_TPU_RERANK=off`, the brownout's window halving). Scores agree
within rtol 1e-5 (atol 1e-5 where a blend of a first-stage score and a
negative maxsim cancels towards 0); a permutation agrees exactly where
neighbouring blended scores differ by more than that, and as a set
inside a run of near-ties.

The degrade contract is the port's own, narrower than the reference's:
only an injected `rerank.score` fault, a column over the device-memory
budget or `ES_TPU_RERANK=off` keep the first-stage order; a
RuntimeError in the op fails the request.
"""

import copy
import json
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from elasticsearch_tpu.cluster.indices import IndexService as JIndexService
from elasticsearch_tpu.models import rerank as jrerank_model
from elasticsearch_tpu.ops import rerank as jrerank_ops
from elasticsearch_tpu.search import dsl as jdsl
from elasticsearch_tpu.search import rescorer as jrescorer
from elasticsearch_tpu.search.batcher import QueryBatcher as JBatcher

from elasticsearch_tpu_torch.cluster.indices import IndexService
from elasticsearch_tpu_torch.cluster.service import ClusterError, ClusterService
from elasticsearch_tpu_torch.common.settings import batch_buckets
from elasticsearch_tpu_torch.models import rerank as rerank_model
from elasticsearch_tpu_torch.ops import rerank as rerank_ops
from elasticsearch_tpu_torch.ops import scoring
from elasticsearch_tpu_torch.search import dsl, rescorer
from elasticsearch_tpu_torch.search.batcher import QueryBatcher, live_batchers

torch.set_num_threads(1)

RTOL = 1e-5
ATOL = 1e-5
DIMS = 8
MAPPINGS = {
    "properties": {
        "body": {"type": "text"},
        "vec": {"type": "dense_vector", "dims": DIMS, "similarity": "cosine"},
        "toks": {"type": "rank_vectors", "dims": DIMS, "similarity": "dot_product"},
    }
}
WORDS = ["alpha beta", "alpha gamma", "beta gamma", "alpha beta gamma"]


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


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------


def tie_runs(scores):
    """[start, end) runs of neighbouring scores equal within RTOL."""
    runs, i = [], 0
    while i < len(scores):
        j = i + 1
        while j < len(scores) and np.isclose(scores[j], scores[j - 1], rtol=RTOL, atol=0):
            j += 1
        runs.append((i, j))
        i = j
    return runs


def same_order(ref_scores, ref_items, got_scores, got_items, what=""):
    """Scores within RTOL/ATOL; items exactly where neighbouring
    reference scores differ by more than RTOL, as a set inside a run."""
    assert len(got_items) == len(ref_items), what
    np.testing.assert_allclose(got_scores, ref_scores, rtol=RTOL, atol=ATOL, err_msg=what)
    for i, j in tie_runs(ref_scores):
        assert set(got_items[i:j]) == set(ref_items[i:j]), (what, i, list(ref_items), list(got_items))


def same_page(ref, got, what=""):
    assert got["hits"]["total"] == ref["hits"]["total"], what
    rh, gh = ref["hits"]["hits"], got["hits"]["hits"]
    same_order([h["_score"] for h in rh], [h["_id"] for h in rh],
               [h["_score"] for h in gh], [h["_id"] for h in gh], what)


def pairs(resp):
    return [(h["_id"], h["_score"]) for h in resp["hits"]["hits"]]


def fill(svcs, n=80, seed=3, batches=1):
    """The reference tests' corpus: 1-4 token rows per doc, and every
    fifth doc without the rank_vectors field."""
    rng = np.random.default_rng(seed)
    per = -(-n // batches)
    for b in range(batches):
        for i in range(b * per, min((b + 1) * per, n)):
            v = rng.normal(size=DIMS)
            v /= np.linalg.norm(v)
            doc = {"body": WORDS[i % 4], "vec": [float(x) for x in v]}
            toks = rng.normal(size=(1 + i % 4, DIMS)).round(3).tolist()
            if i % 5 != 4:
                doc["toks"] = toks
            for svc in svcs:
                svc.index_doc(str(i), copy.deepcopy(doc))
        for svc in svcs:
            svc.refresh()
    return rng


def qvecs(rng, n_tok=3):
    return rng.normal(size=(n_tok, DIMS)).round(3).tolist()


def rescore_block(qv, window=20, qw=0.5, rw=2.0, field="toks"):
    return {
        "window_size": window,
        "query": {
            "rescore_query": {"rank_vectors": {"field": field, "query_vectors": qv}},
            "query_weight": qw,
            "rescore_query_weight": rw,
        },
    }


def make_pair(name, shards=1, extra=None):
    """(JAX IndexService on `jax`, port IndexService on `torch`, CPU)."""
    settings = {"number_of_shards": shards, **(extra or {})}
    return (
        JIndexService(name, settings={**settings, "search.backend": "jax"}, mappings_json=MAPPINGS),
        IndexService(name, settings={**settings, "search.backend": "torch"}, mappings_json=MAPPINGS,
                     device="cpu"),
    )


def close_all(svcs):
    for s in svcs:
        s.close()


# ---------------------------------------------------------------------------
# ops/rerank.py against the reference's _maxsim_rescore
# ---------------------------------------------------------------------------


def flat_column(rng, n_docs, quantized):
    """A flat rank_vectors column in the executors' gather layout: ragged
    token counts 0-4 (token-less docs included), `tmax` zero pad rows.
    Returns (reference column of jnp arrays, port column of tensors)."""
    import jax.numpy as jnp

    counts = rng.integers(0, 5, size=n_docs).astype(np.int32)
    starts = np.zeros(n_docs, np.int32)
    np.cumsum(counts[:-1], out=starts[1:])
    total = int(counts.sum())
    tmax = max(int(counts.max()), 1)
    toks = rng.normal(size=(total + tmax, DIMS)).astype(np.float32)
    toks[total:] = 0.0
    scales = None
    if quantized:
        toks, scales = rerank_model.quantize_tokens(toks)
    ref = {"starts": jnp.asarray(starts), "counts": jnp.asarray(counts), "toks": jnp.asarray(toks),
           "scales": None if scales is None else jnp.asarray(scales), "tmax": tmax}
    port = {"starts": torch.from_numpy(starts), "counts": torch.from_numpy(counts),
            "toks": torch.from_numpy(toks), "scales": None if scales is None else torch.from_numpy(scales),
            "tmax": tmax}
    return ref, port


def launch_inputs(rng, rows, n_docs, wb=16, qb=4, ties=False):
    qtoks = np.zeros((rows, qb, DIMS), np.float32)
    qvalid = np.zeros((rows, qb), bool)
    docs = np.zeros((rows, wb), np.int32)
    first = np.full((rows, wb), -np.inf, np.float32)
    valid = np.zeros((rows, wb), bool)
    n_real = max(1, rows - 1)  # one padded row when rows > 1
    for r in range(n_real):
        nq = 1 + r % qb
        qtoks[r, :nq] = rng.normal(size=(nq, DIMS)).astype(np.float32)
        qvalid[r, :nq] = True
        w = wb if r % 2 == 0 else 5  # full and partial candidate rows
        if ties:
            # the same doc at every other slot with the same first-stage
            # score: exact ties that only the first-stage rank breaks
            picks = np.repeat(rng.choice(n_docs, size=(w + 1) // 2, replace=False), 2)[:w]
            first[r, :w] = np.repeat(np.sort(rng.normal(size=(w + 1) // 2).astype(np.float32))[::-1], 2)[:w]
        else:
            picks = rng.choice(n_docs, size=w, replace=False)
            first[r, :w] = np.sort(rng.normal(size=w).astype(np.float32))[::-1]
        docs[r, :w] = picks
        valid[r, :w] = True
    return qtoks, qvalid, docs, first, valid


def run_both(ref_col, port_col, inputs, qw, rw, window):
    qtoks, qvalid, docs, first, valid = inputs
    ref = jrerank_ops.unpack_rescore(jrerank_ops.maxsim_rescore_batch(
        qtoks, qvalid, ref_col["starts"], ref_col["counts"], ref_col["toks"], ref_col["scales"],
        docs, first, valid, qw, rw, ref_col["tmax"], window))
    got = rerank_ops.unpack_rescore(rerank_ops.maxsim_rescore_batch(
        qtoks, qvalid, port_col["starts"], port_col["counts"], port_col["toks"], port_col["scales"],
        docs, first, valid, qw, rw, port_col["tmax"], window))
    return ref, got


def check_rows(ref, got, valid, what):
    (rs, rp), (gs, gp) = ref, got
    assert gs.dtype == np.float32 and gp.dtype == np.int32
    for r in range(rs.shape[0]):
        w = int(valid[r].sum())
        same_order(rs[r, :w], rp[r, :w], gs[r, :w], gp[r, :w], f"{what} row {r}")
        # padding sorts below every real candidate, in its own order
        assert not np.isfinite(gs[r, w:]).any()
        np.testing.assert_array_equal(gp[r, w:], rp[r, w:])


@pytest.mark.parametrize("quantized", [False, True], ids=["f32", "int8"])
@pytest.mark.parametrize("rows", [1, 4, 8, 16, 32])
def test_maxsim_matches_reference_every_row_bucket(rows, quantized):
    rng = np.random.default_rng(17 + rows)
    ref_col, port_col = flat_column(rng, 120, quantized)
    inputs = launch_inputs(rng, rows, 120)
    ref, got = run_both(ref_col, port_col, inputs, 0.7, 1.3, 16)
    check_rows(ref, got, inputs[4], f"rows {rows}")


@pytest.mark.parametrize("quantized", [False, True], ids=["f32", "int8"])
@pytest.mark.parametrize("case", ["window_below_candidates", "window_above_candidates",
                                  "query_weight_0", "forced_ties"])
def test_maxsim_matches_reference_windows_weights_ties(case, quantized):
    rng = np.random.default_rng(5)
    ref_col, port_col = flat_column(rng, 120, quantized)
    inputs = launch_inputs(rng, 8, 120, ties=case == "forced_ties")
    qw, rw, window = {"window_below_candidates": (0.7, 1.3, 5),
                      "window_above_candidates": (0.7, 1.3, 100),
                      "query_weight_0": (0.0, 1.0, 16),
                      "forced_ties": (1.0, 1.0, 12)}[case]
    ref, got = run_both(ref_col, port_col, inputs, qw, rw, window)
    check_rows(ref, got, inputs[4], case)
    if case == "forced_ties":
        # a doc's two slots tie exactly: the lower first-stage rank wins
        np.testing.assert_array_equal(got[1], ref[1])
    if case == "window_below_candidates":
        # the tail keeps its first-stage scores and order
        first = inputs[3]
        np.testing.assert_array_equal(got[1][0, 5:16], np.arange(5, 16, dtype=np.int32))
        np.testing.assert_array_equal(got[0][0, 5:16], first[0, 5:16])


def test_maxsim_candidates_matches_host_oracle():
    """Raw maxsim per candidate against `host_maxsim` /
    `host_maxsim_quantized` (token-less docs score 0.0)."""
    rng = np.random.default_rng(9)
    counts = rng.integers(0, 5, size=40).astype(np.int32)
    starts = np.zeros(40, np.int32)
    np.cumsum(counts[:-1], out=starts[1:])
    tmax = int(counts.max())
    toks = rng.normal(size=(int(counts.sum()) + tmax, DIMS)).astype(np.float32)
    q = rng.normal(size=(1, 3, DIMS)).astype(np.float32)
    docs = np.arange(40, dtype=np.int32)[None, :]
    for quantized in (False, True):
        rows, scales = (rerank_model.quantize_tokens(toks) if quantized else (toks, None))
        got = rerank_ops.maxsim_candidates(
            torch.from_numpy(q), torch.ones(1, 3, dtype=torch.bool), torch.from_numpy(starts),
            torch.from_numpy(counts), torch.from_numpy(rows),
            None if scales is None else torch.from_numpy(scales), torch.from_numpy(docs), tmax,
        ).numpy()[0]
        for d in range(40):
            s0, c = int(starts[d]), int(counts[d])
            exp = (rerank_model.host_maxsim_quantized(q[0], rows[s0:s0 + c], scales[s0:s0 + c])
                   if quantized else rerank_model.host_maxsim(q[0], rows[s0:s0 + c]))
            assert np.isclose(got[d], exp, rtol=RTOL, atol=ATOL), (quantized, d, got[d], exp)
            if c == 0:
                assert got[d] == 0.0


def test_rerank_flops_matches_reference():
    assert rerank_ops.rerank_flops(8, 4, 128, 180, 128) == jrerank_ops.rerank_flops(8, 4, 128, 180, 128)


# ---------------------------------------------------------------------------
# models/rerank.py: the host oracle, bit for bit
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_host_oracle_equals_reference_bit_for_bit(seed):
    rng = np.random.default_rng(seed)
    toks = rng.normal(size=(int(rng.integers(0, 9)), DIMS)).astype(np.float32)
    q = rng.normal(size=(3, DIMS)).astype(np.float32)
    assert rerank_model.host_maxsim(q, toks) == jrerank_model.host_maxsim(q, toks)
    qv, sc = rerank_model.quantize_tokens(toks)
    jqv, jsc = jrerank_model.quantize_tokens(toks)
    np.testing.assert_array_equal(qv, jqv)
    np.testing.assert_array_equal(sc, jsc)
    assert qv.dtype == jqv.dtype and sc.dtype == jsc.dtype
    assert (rerank_model.host_maxsim_quantized(q, qv, sc)
            == jrerank_model.host_maxsim_quantized(q, jqv, jsc))
    for sim in ("cosine", "dot_product"):
        np.testing.assert_array_equal(
            rerank_model.prepare_query_vectors(q.tolist(), DIMS, sim),
            jrerank_model.prepare_query_vectors(q.tolist(), DIMS, sim),
        )


# ---------------------------------------------------------------------------
# search/rescorer.py: request validation, the reference's 400s
# ---------------------------------------------------------------------------


def _vbody(**over):
    b = {"query": {"match": {"body": "alpha"}}, "size": 10,
         "rescore": rescore_block([[0.0] * DIMS], window=20)}
    b.update(over)
    return b


PARSE_400S = {
    "window_below_one": _vbody(rescore=rescore_block([[0.0] * DIMS], window=0)),
    "window_below_page": _vbody(size=30),
    "window_below_page_with_from": {**_vbody(), "from": 15},
    "missing_query": _vbody(rescore={"window_size": 20}),
    "unsupported_rescore_query": _vbody(rescore={"window_size": 20,
                                                 "query": {"rescore_query": {"match": {"body": "x"}}}}),
    "match_all_rescore_query": _vbody(rescore={"window_size": 20,
                                               "query": {"rescore_query": {"match_all": {}}}}),
    "empty_vectors": _vbody(rescore={"window_size": 20, "query": {"rescore_query": {"rank_vectors": {
        "field": "toks", "query_vectors": []}}}}),
    "ragged_vectors": _vbody(rescore={"window_size": 20, "query": {"rescore_query": {"rank_vectors": {
        "field": "toks", "query_vectors": [[0.0] * 4, [0.0] * 8]}}}}),
    "non_numeric_vectors": _vbody(rescore={"window_size": 20, "query": {"rescore_query": {"rank_vectors": {
        "field": "toks", "query_vectors": [["a"] * DIMS]}}}}),
    "two_rescorers": _vbody(rescore=[rescore_block([[0.0] * DIMS]), rescore_block([[0.0] * DIMS])]),
    "sort_and_rescore": _vbody(sort=[{"body": "asc"}]),
}


@pytest.mark.parametrize("name", sorted(PARSE_400S))
def test_parse_rescore_gives_the_references_400(name):
    body = PARSE_400S[name]
    with pytest.raises(jdsl.QueryParseError) as ref:
        jrescorer.parse_rescore(copy.deepcopy(body))
    with pytest.raises(dsl.QueryParseError) as got:
        rescorer.parse_rescore(copy.deepcopy(body))
    assert str(got.value) == str(ref.value)


def test_parse_rescore_spec_and_plan_match_reference():
    rng = np.random.default_rng(4)
    body = _vbody(rescore=rescore_block(qvecs(rng, 5), window=37, qw=0.25, rw=3.0))
    spec, jspec = rescorer.parse_rescore(body), jrescorer.parse_rescore(body)
    assert (spec.field, spec.query_vectors, spec.window_size, spec.query_weight,
            spec.rescore_query_weight) == (jspec.field, jspec.query_vectors, jspec.window_size,
                                           jspec.query_weight, jspec.rescore_query_weight)
    model = rerank_model.RerankModel("toks", DIMS, "dot_product", False)
    jmodel = jrerank_model.RerankModel("toks", DIMS, "dot_product", False)
    cands = [(float(9 - i), i % 2, i) for i in range(23)]

    class R:  # two segments of 30 and 40 docs
        segments = [type("S", (), {"num_docs": 30})(), type("S", (), {"num_docs": 40})()]

    p, jp = rescorer.build_plan(R, model, spec, cands), jrescorer.build_plan(R, jmodel, jspec, cands)
    assert (p.wb, p.qb, p.win_static) == (jp.wb, jp.qb, jp.win_static) == (32, 8, 32)
    np.testing.assert_array_equal(p.gdocs, jp.gdocs)
    np.testing.assert_array_equal(p.first, jp.first)
    np.testing.assert_array_equal(p.qtoks, jp.qtoks)


@pytest.fixture(scope="module")
def small_pair():
    pair = make_pair("rr-small")
    fill(pair, n=60)
    yield pair
    close_all(pair)


def test_unmapped_rescore_field_is_the_references_400(small_pair):
    body = _vbody(rescore=rescore_block([[0.0] * DIMS], field="nope"))
    with pytest.raises(jdsl.QueryParseError) as ref:
        small_pair[0].search(copy.deepcopy(body))
    with pytest.raises(dsl.QueryParseError) as got:
        small_pair[1].search(copy.deepcopy(body))
    assert str(got.value) == str(ref.value)


def test_sort_plus_rescore_is_a_400_through_the_service(small_pair):
    with pytest.raises(dsl.QueryParseError, match="sort"):
        small_pair[1].search(_vbody(sort=[{"body": "asc"}]))


def test_rescore_over_scroll_and_pit_is_400():
    from elasticsearch_tpu.cluster.service import ClusterService as JClusterService

    clusters = (JClusterService(), ClusterService(device="cpu"))
    msgs = []
    try:
        for c, backend, err in zip(clusters, ("jax", "torch"), (jdsl.QueryParseError, dsl.QueryParseError)):
            c.create_index("rr-scroll", {"settings": {"search.backend": backend}, "mappings": MAPPINGS})
            idx = c.indices["rr-scroll"]
            rng = np.random.default_rng(3)
            for i in range(10):
                idx.index_doc(str(i), {"body": WORDS[i % 4], "toks": rng.normal(size=(2, DIMS)).round(3).tolist()})
            idx.refresh()
            with pytest.raises(err, match="scroll") as e1:
                c.create_scroll("rr-scroll", _vbody(), "1m")
            pit = c.open_pit("rr-scroll", "1m")
            try:
                with pytest.raises(err, match="scroll") as e2:
                    c.pit_search({**_vbody(), "pit": {"id": pit["id"]}})
            finally:
                c.close_pit(pit["id"])
            msgs.append((str(e1.value), str(e2.value)))
    finally:
        for c in clusters:
            c.close()
    assert msgs[0] == msgs[1]


# ---------------------------------------------------------------------------
# IndexService end to end, held to the JAX package
# ---------------------------------------------------------------------------


def hybrid_body(rng, i, rescore=True, **rkw):
    v = rng.normal(size=DIMS)
    b = {"retriever": {"rrf": {"rank_window_size": 30, "retrievers": [
        {"standard": {"query": {"match": {"body": WORDS[i % 4].split()[0]}}}},
        {"knn": {"field": "vec", "query_vector": [float(x) for x in v], "k": 20, "num_candidates": 40}},
    ]}}, "size": 10}
    if rescore:
        b["rescore"] = rescore_block(qvecs(rng), window=30, **rkw)
    return b


def rank_body(rng, i):
    v = rng.normal(size=DIMS)
    return {"query": {"match": {"body": WORDS[i % 4].split()[1]}},
            "knn": {"field": "vec", "query_vector": [float(x) for x in v], "k": 15, "num_candidates": 30},
            "rank": {"rrf": {"rank_window_size": 25}}, "size": 8,
            "rescore": rescore_block(qvecs(rng), window=25, qw=1.0, rw=1.0)}


def match_body(rng, i):
    return {"query": {"match": {"body": WORDS[i % 4]}}, "size": 10,
            "rescore": rescore_block(qvecs(rng), window=20)}


BODIES = {"match": match_body, "retriever_rrf": hybrid_body, "rank_rrf": rank_body}


@pytest.mark.parametrize("quantized", [False, True], ids=["f32", "int8"])
@pytest.mark.parametrize("shards", [1, 2])
@pytest.mark.parametrize("kind", sorted(BODIES))
def test_rescore_matches_reference(kind, shards, quantized):
    extra = {"rerank.quantization": "int8"} if quantized else None
    pair = make_pair(f"rr-{kind}-{shards}-{int(quantized)}", shards=shards, extra=extra)
    try:
        fill(pair, n=80, batches=2)
        rng = np.random.default_rng(11)
        before = rerank_model.stats_snapshot()
        for i in range(4):
            body = BODIES[kind](rng, i)
            ref = pair[0].search(copy.deepcopy(body))
            got = pair[1].search(copy.deepcopy(body))
            assert ref["hits"]["hits"]
            same_page(ref, got, f"{kind} body {i}")
        after = rerank_model.stats_snapshot()
        # one local torch shard reranks on the card's path; two shards
        # rerank each shard's page there (plain search) or take the host
        # oracle over the fused candidates (retrievers), as the
        # reference routes them
        device = kind == "match" or shards == 1
        moved = "device_rescores" if device else "host_rescores"
        assert after[moved] >= before[moved] + 4
        assert after["fallbacks"] == before["fallbacks"]
        assert after["skipped"] == before["skipped"]
    finally:
        close_all(pair)


@pytest.mark.parametrize("profile", [False, True], ids=["plain", "profiled"])
def test_retriever_hooks_keep_the_references_signatures(small_pair, monkeypatch, profile):
    """A wrapper of `_run_retriever` / `_rescore_ranked` written against
    the reference's signatures keeps working: the profiler's kwargs ride
    only on profiled requests, in both packages."""
    seen = {}
    for cls, name in ((JIndexService, "_run_retriever"), (IndexService, "_run_retriever"),
                      (JIndexService, "_rescore_ranked"), (IndexService, "_rescore_ranked")):
        orig = getattr(cls, name)

        def hooked(self_svc, *args, _orig=orig, _key=(cls, name), **kw):
            seen[_key] = sorted(kw)
            return _orig(self_svc, *args, **kw)

        monkeypatch.setattr(cls, name, hooked)
    body = hybrid_body(np.random.default_rng(5), 0)
    if profile:
        body["profile"] = True
    ref = small_pair[0].search(copy.deepcopy(body))
    got = small_pair[1].search(copy.deepcopy(body))
    same_page(ref, got)
    for name in ("_run_retriever", "_rescore_ranked"):
        assert seen[(IndexService, name)] == seen[(JIndexService, name)], name
    assert seen[(IndexService, "_run_retriever")] == (["prof_out"] if profile else [])


def test_rescore_changes_the_page_and_keeps_totals(small_pair):
    rng = np.random.default_rng(21)
    body = {"query": {"match": {"body": "alpha"}}, "size": 10}
    plain = small_pair[1].search(copy.deepcopy(body))
    resc = small_pair[1].search({**body, "rescore": rescore_block(qvecs(rng), qw=0.0, rw=1.0)})
    assert resc["hits"]["total"] == plain["hits"]["total"]
    assert pairs(resc) != pairs(plain)


# ---------------------------------------------------------------------------
# the batcher's `rerank` family at every bucket
# ---------------------------------------------------------------------------


def _rerank_plans(pair, n):
    """(reference plan, port plan) pairs over each package's own
    first-stage candidates of one `match` body."""
    jsvc, tsvc = pair
    jex = jsvc._executor(jsvc.shards[0])
    tex = tsvc._executor(tsvc.shards[0])
    rng = np.random.default_rng(31)
    out = []
    for i in range(n):
        body = {"query": {"match": {"body": WORDS[i % 4].split()[i % 2]}}, "size": 10,
                "rescore": rescore_block(qvecs(rng, 1 + i % 5), window=10 + i % 7)}
        jspec, spec = jrescorer.parse_rescore(body), rescorer.parse_rescore(body)
        jtd = jex.search(jdsl.parse_query(body["query"]), size=10 + i % 9)
        ttd = tex.search(dsl.parse_query(body["query"]), size=10 + i % 9)
        jmodel = jrerank_model.resolve_model(jsvc.mappings, jsvc.settings, "toks")
        model = rerank_model.resolve_model(tsvc.mappings, tsvc.settings, "toks")
        jp = jrescorer.build_plan(jex.reader, jmodel, jspec, [(h.score, h.segment, h.local_doc) for h in jtd.hits])
        tp = rescorer.build_plan(tex.reader, model, spec, [(h.score, h.segment, h.local_doc) for h in ttd.hits])
        np.testing.assert_array_equal(tp.gdocs, jp.gdocs)
        out.append((jex, jp, tex, tp))
    return out


def _rerank_group(b, ex, plans, rows):
    jobs = [b.submit_nowait(ex, p, len(p.first), kind="rerank") for p in plans]
    b._collect_rerank_group(jobs, b._dispatch_rerank_group(jobs, rows=rows))
    return [b.wait(j, timeout=30) for j in jobs]


@pytest.fixture(scope="module")
def rerank_pair():
    pair = make_pair("rr-batch")
    fill(pair, n=90, batches=3)
    yield pair
    close_all(pair)


@pytest.mark.parametrize("rows", batch_buckets(scoring.BPAD))
def test_batcher_rerank_family_every_bucket(rerank_pair, monkeypatch, rows):
    plans = _rerank_plans(rerank_pair, min(rows, 9))
    groups = {}
    for p in plans:  # one launch per shared signature, as the batcher groups
        groups.setdefault(p[3].sig, []).append(p)
    jb, tb = JBatcher(workers=1), QueryBatcher(workers=1)
    monkeypatch.setattr(jb, "_ensure_thread", lambda: None)
    monkeypatch.setattr(tb, "_ensure_thread", lambda: None)
    try:
        for group in groups.values():
            ref = _rerank_group(jb, group[0][0], [g[1] for g in group], rows)
            got = _rerank_group(tb, group[0][2], [g[3] for g in group], rows)
            alone = [_rerank_group(tb, g[2], [g[3]], 1)[0] for g in group]
            for r, g, a in zip(ref, got, alone):
                assert g[0] == r[0] == "ok"
                same_order(r[1], r[2], g[1], g[2], f"bucket {rows}")
                np.testing.assert_array_equal(g[1], a[1])
                np.testing.assert_array_equal(g[2], a[2])
        assert tb.stats["rerank_jobs"] == len(plans) + len(plans)
        assert tb.stats["launches"] == len(groups) + len(plans)
    finally:
        jb.close()
        tb.close()


# ---------------------------------------------------------------------------
# the degrade contract
# ---------------------------------------------------------------------------


def test_injected_rerank_fault_keeps_the_first_stage_page(small_pair):
    from elasticsearch_tpu_torch.common.faults import faults

    rng = np.random.default_rng(41)
    plain = small_pair[1].search({"query": {"match": {"body": "alpha"}}, "size": 10})
    before = rerank_model.stats_snapshot()
    faults.configure({"rules": [{"site": "rerank.score", "kind": "error"}]})
    try:
        got = small_pair[1].search({"query": {"match": {"body": "alpha"}}, "size": 10,
                                    "rescore": rescore_block(qvecs(rng), qw=0.0, rw=1.0)})
    finally:
        faults.clear()
    assert pairs(got) == pairs(plain)
    after = rerank_model.stats_snapshot()
    assert after["fallbacks"] == before["fallbacks"] + 1
    assert after["device_rescores"] == before["device_rescores"]


def test_runtime_error_in_the_rerank_op_fails_the_request(small_pair, monkeypatch):
    def boom(*a, **k):
        raise RuntimeError("CUDA error: unspecified launch failure")

    monkeypatch.setattr(rerank_ops, "maxsim_rescore_batch", boom)
    before = rerank_model.stats_snapshot()
    rng = np.random.default_rng(43)
    with pytest.raises(ClusterError, match="unspecified launch failure"):
        small_pair[1].search({"query": {"match": {"body": "alpha"}}, "size": 10,
                              "rescore": rescore_block(qvecs(rng))})
    with pytest.raises(RuntimeError, match="unspecified launch failure"):
        small_pair[1].search(hybrid_body(rng, 0))
    after = rerank_model.stats_snapshot()
    assert after["fallbacks"] == before["fallbacks"]
    assert after["skipped"] == before["skipped"]


def test_memory_budget_degrades_to_skip(monkeypatch):
    from elasticsearch_tpu_torch.common.memory import hbm_ledger

    svc = IndexService("rr-hbm", settings={"search.backend": "torch"}, mappings_json=MAPPINGS, device="cpu")
    try:
        rng = fill([svc], n=60)
        body = {"query": {"match": {"body": "alpha"}}, "size": 10}
        plain = svc.search(copy.deepcopy(body))
        monkeypatch.setattr(hbm_ledger, "budget", hbm_ledger.used + 64)
        degraded0 = hbm_ledger.stats()["degraded_allocations"]
        skipped0 = rerank_model.stats_snapshot()["skipped"]
        got = svc.search({**body, "rescore": rescore_block(qvecs(rng))})
        assert pairs(got) == pairs(plain)
        assert hbm_ledger.stats()["degraded_allocations"] > degraded0
        assert rerank_model.stats_snapshot()["skipped"] > skipped0
        monkeypatch.setenv("ES_TPU_RERANK", "force")
        with pytest.raises(ClusterError, match="ES_TPU_RERANK=force"):
            svc.search({**body, "rescore": rescore_block(qvecs(rng))})
    finally:
        svc.close()


def test_rerank_mode_off_keeps_first_stage(small_pair, monkeypatch):
    rng = np.random.default_rng(47)
    body = {"query": {"match": {"body": "alpha"}}, "size": 10}
    plain = small_pair[1].search(copy.deepcopy(body))
    monkeypatch.setenv("ES_TPU_RERANK", "off")
    skipped0 = rerank_model.stats_snapshot()["skipped"]
    for b in ({**body, "rescore": rescore_block(qvecs(rng), qw=0.0, rw=1.0)}, hybrid_body(rng, 1)):
        ref = small_pair[0].search(copy.deepcopy(b))
        got = small_pair[1].search(copy.deepcopy(b))
        same_page(ref, got, "ES_TPU_RERANK=off")
    assert pairs(small_pair[1].search({**body, "rescore": rescore_block(qvecs(rng), qw=0.0, rw=1.0)})) == pairs(plain)
    assert rerank_model.stats_snapshot()["skipped"] >= skipped0 + 3


def test_ledger_released_on_generation_bump_and_close():
    from elasticsearch_tpu_torch.common.memory import hbm_ledger

    base = hbm_ledger.stats()["by_category"].get("rerank", 0)
    svc = IndexService("rr-gen", settings={"search.backend": "torch"}, mappings_json=MAPPINGS, device="cpu")
    try:
        rng = fill([svc], n=60)
        body = {"query": {"match": {"body": "alpha"}}, "size": 5, "rescore": rescore_block(qvecs(rng))}
        svc.search(copy.deepcopy(body))
        bytes0 = hbm_ledger.stats()["by_category"].get("rerank", 0) - base
        assert bytes0 > 0
        svc.index_doc("extra", {"body": "alpha", "toks": [[0.1] * DIMS]})
        svc.refresh()
        svc.search(copy.deepcopy(body))
        bytes1 = hbm_ledger.stats()["by_category"].get("rerank", 0) - base
        # the superseded column's charge is released, the new one charged:
        # one more token row, one more doc's start and count
        assert bytes1 == bytes0 + DIMS * 4 + 2 * 4
    finally:
        svc.close()
    assert hbm_ledger.stats()["by_category"].get("rerank", 0) == base


def test_brownout_tier2_halves_the_rescore_window():
    from elasticsearch_tpu.search.admission import apply_brownout as japply

    from elasticsearch_tpu_torch.search.admission import apply_brownout

    for window, tier in ((100, 2), (12, 2), (100, 1), (100, 0)):
        body = {"query": {"match": {"body": "alpha"}}, "size": 10,
                "rescore": rescore_block([[0.0] * DIMS], window=window)}
        assert apply_brownout(copy.deepcopy(body), tier) == japply(copy.deepcopy(body), tier)
    out, actions = apply_brownout({"size": 10, "rescore": rescore_block([[0.0] * DIMS], window=100)}, 2)
    assert out["rescore"]["window_size"] == 50 and "rescore_window_halved" in actions


def test_brownout_tier2_rescore_serves_like_the_reference(small_pair):
    """A tier-2 brownout body (window halved) is served and held to the
    reference as it is."""
    from elasticsearch_tpu_torch.search.admission import apply_brownout

    rng = np.random.default_rng(53)
    body, _ = apply_brownout({"query": {"match": {"body": "beta"}}, "size": 10,
                              "rescore": rescore_block(qvecs(rng), window=40)}, 2)
    assert body["rescore"]["window_size"] == 20
    same_page(small_pair[0].search(copy.deepcopy(body)), small_pair[1].search(copy.deepcopy(body)), "brownout")


# ---------------------------------------------------------------------------
# REST: ?rescore=false and the `rescore` block of _nodes/stats
# ---------------------------------------------------------------------------


def call(port, method, path, body=None):
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=data, method=method,
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


@pytest.fixture(scope="module")
def servers():
    from elasticsearch_tpu.rest.server import ElasticsearchTpuServer as JServer

    from elasticsearch_tpu_torch.rest.server import ElasticsearchTpuServer

    pair = (JServer(port=0), ElasticsearchTpuServer(port=0, device="cpu"))
    for srv, backend in zip(pair, ("jax", "torch")):
        srv.start_background()
        status, out = call(srv.port, "PUT", "/rr", {"settings": {"search.backend": backend},
                                                    "mappings": MAPPINGS})
        assert status == 200, out
        idx = srv.cluster.get_index("rr")
        fill([idx], n=50)
    yield pair
    for srv in pair:
        srv.close()


def test_rescore_false_escape_hatch(servers):
    rng = np.random.default_rng(61)
    body = {"query": {"match": {"body": "alpha"}}, "size": 10,
            "rescore": rescore_block(qvecs(rng), qw=0.0, rw=1.0)}
    plain = {"query": {"match": {"body": "alpha"}}, "size": 10}
    out = []
    for srv in servers:
        s1, with_rescore = call(srv.port, "POST", "/rr/_search", body)
        s2, without = call(srv.port, "POST", "/rr/_search?rescore=false", body)
        s3, first = call(srv.port, "POST", "/rr/_search", plain)
        assert s1 == s2 == s3 == 200
        assert pairs(without) == pairs(first)
        assert pairs(with_rescore) != pairs(first)
        out.append((with_rescore, without))
    same_page(out[0][0], out[1][0], "with rescore")
    same_page(out[0][1], out[1][1], "?rescore=false")


def test_nodes_stats_rescore_block(servers):
    rng = np.random.default_rng(67)
    for srv in servers:
        s, _ = call(srv.port, "POST", "/rr/_search", {"query": {"match": {"body": "beta"}}, "size": 5,
                                                      "rescore": rescore_block(qvecs(rng))})
        assert s == 200
    blocks = [call(srv.port, "GET", "/_nodes/stats")[1]["nodes"]["node-0"]["rescore"] for srv in servers]
    assert set(blocks[1]) == set(blocks[0])
    got = blocks[1]
    assert set(got) >= {"device_rescores", "host_rescores", "skipped", "fallbacks", "kernel_ms",
                        "windows", "ledger_bytes", "batched_jobs"}
    assert got["device_rescores"] >= 1 and got["ledger_bytes"] > 0
    assert got["batched_jobs"] >= 1 and got["windows"]
