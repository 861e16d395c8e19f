"""The port's remaining query nodes against the JAX package's, on the CPU.

`match_phrase` (slop 0 and 2, repeated terms) and `multi_match`
`type: phrase` run a device conjunction, then verify positions on the
host; `prefix`, `wildcard`, `regexp` and `fuzzy` expand on the host and
score in one device pass; `match_phrase_prefix`, `function_score`
(without a script), `boosting`, `more_like_this` and `nested` are the
oracle's host masks and scores, uploaded, as the reference routes them.
Each node is served alone, inside a `bool` filter, as a kNN filter and
as an aggregation's query, through the JAX package's `IndexService`
(`JaxExecutor`), the port's on `torch` (`device="cpu"`) and the port's
on `numpy` (its `NumpyExecutor`): the same totals and ids (a run of
scores tied within rtol 1e-5 as a set), scores within rtol 1e-5, equal
aggregations. A segment without positions takes the oracle's phrase
route; a script node (ROADMAP queue 1 item 14) is the oracle's host
mask and scores, uploaded.
"""

import copy
import dataclasses

import numpy as np
import pytest
import torch

from elasticsearch_tpu.cluster.indices import IndexService as JIndexService
from elasticsearch_tpu.search import dsl as jdsl
from elasticsearch_tpu.search.executor_jax import JaxExecutor

from elasticsearch_tpu_torch.cluster.indices import IndexService
from elasticsearch_tpu_torch.search import dsl
from elasticsearch_tpu_torch.search import executor_torch
from elasticsearch_tpu_torch.search.batcher import live_batchers
from elasticsearch_tpu_torch.search.executor import NumpyExecutor, ShardReader
from elasticsearch_tpu_torch.search.executor_torch import TorchExecutor

torch.set_num_threads(1)

RTOL = 1e-5
DIMS = 8
WORDS = ["alpha", "bravo", "charlie", "delta", "echo", "foxtrot", "golf", "hotel"]
ITEMS = ["apple", "banana", "cherry"]
MAPPING = {
    "properties": {
        "title": {"type": "text"},
        "body": {"type": "text"},
        "tag": {"type": "keyword"},
        "views": {"type": "integer"},
        "vec": {"type": "dense_vector", "dims": DIMS, "similarity": "cosine"},
        "items": {"type": "nested", "properties": {"name": {"type": "keyword"}, "qty": {"type": "integer"}}},
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


def make_docs(n, seed):
    """Zipf text over 8 words (so phrases, repeated terms and slops
    occur), filter columns and 0-2 nested items per doc."""
    rng = np.random.default_rng(seed)
    p = 1.0 / np.arange(1, len(WORDS) + 1)
    p /= p.sum()
    docs = []
    for i in range(n):
        docs.append((f"n{i}", {
            "title": " ".join(rng.choice(WORDS, int(rng.integers(1, 5)), p=p)),
            "body": " ".join(rng.choice(WORDS, int(rng.integers(3, 16)), p=p)),
            "tag": f"t{i % 3}",
            "views": int((i * 37) % 100),
            "vec": [float(x) for x in rng.normal(size=DIMS)],
            "items": [{"name": str(rng.choice(ITEMS)), "qty": int(rng.integers(0, 10))}
                      for _ in range(i % 3)],
        }))
    return docs


@pytest.fixture(scope="module")
def trio():
    """JAX `jax`, port `torch` (CPU) and port `numpy` services over the
    same docs: 1 shard, two refresh waves (two segments), two deletes."""
    docs = make_docs(150, seed=4)
    svcs = {
        "jax": JIndexService("nodes", settings={"search.backend": "jax"}, mappings_json=MAPPING),
        "torch": IndexService("nodes", settings={"search.backend": "torch"}, mappings_json=MAPPING,
                              device="cpu"),
        "numpy": IndexService("nodes", settings={"search.backend": "numpy"}, mappings_json=MAPPING,
                              device="cpu"),
    }
    for svc in svcs.values():
        for i, (doc_id, src) in enumerate(docs):
            svc.index_doc(doc_id, copy.deepcopy(src))
            if i == 79:
                svc.refresh()
        svc.refresh()
        for doc_id in ("n3", "n90"):
            svc.delete_doc(doc_id)
        svc.refresh()
    yield svcs
    for svc in svcs.values():
        svc.close()


NODES = {
    "match_phrase": {"match_phrase": {"body": "alpha bravo"}},
    "match_phrase_slop2": {"match_phrase": {"body": {"query": "alpha charlie", "slop": 2}}},
    "match_phrase_repeated": {"match_phrase": {"body": "alpha alpha"}},
    "prefix": {"prefix": {"body": "ch"}},
    "wildcard": {"wildcard": {"body": "b*o"}},
    "regexp": {"regexp": {"body": "d.l?ta"}},
    "fuzzy": {"fuzzy": {"body": {"value": "charly", "fuzziness": "AUTO"}}},
    "multi_match_phrase": {"multi_match": {"query": "alpha bravo", "fields": ["title^2", "body"],
                                           "type": "phrase"}},
    "match_phrase_prefix": {"match_phrase_prefix": {"body": "alpha br"}},
    "function_score": {"function_score": {
        "query": {"match": {"body": "alpha"}},
        "functions": [{"filter": {"term": {"tag": "t1"}}, "weight": 3},
                      {"field_value_factor": {"field": "views", "factor": 0.1, "modifier": "ln1p"}}],
        "score_mode": "sum", "boost_mode": "multiply"}},
    "boosting": {"boosting": {"positive": {"match": {"body": "alpha bravo"}},
                              "negative": {"term": {"tag": "t2"}}, "negative_boost": 0.2}},
    "more_like_this": {"more_like_this": {"fields": ["body"], "like": "alpha bravo charlie delta echo",
                                          "min_term_freq": 1, "min_doc_freq": 1}},
    "nested": {"nested": {"path": "items", "query": {"bool": {
        "must": [{"term": {"items.name": "apple"}}, {"range": {"items.qty": {"gte": 3}}}]}}}},
}


def knn_section(node):
    v = np.random.default_rng(8).normal(size=DIMS)
    return {"field": "vec", "query_vector": [float(x) for x in v], "k": 10, "num_candidates": 60,
            "filter": node}


CONTEXTS = {
    "alone": lambda node: {"query": node, "size": 20},
    "bool_filter": lambda node: {"query": {"bool": {"must": [{"match": {"body": "echo"}}],
                                                    "filter": [node]}}, "size": 20},
    "knn_filter": lambda node: {"knn": knn_section(node), "size": 10},
    "agg_query": lambda node: {"size": 0, "request_cache": False, "query": node,
                               "aggs": {"v": {"stats": {"field": "views"}}, "t": {"terms": {"field": "tag"}}}},
}


def same_response(ref, got, what):
    assert got["hits"]["total"] == ref["hits"]["total"], what
    rh, gh = ref["hits"]["hits"], got["hits"]["hits"]
    assert len(gh) == len(rh), what
    rs = np.array([h["_score"] for h in rh])
    np.testing.assert_allclose([h["_score"] for h in gh], rs, rtol=RTOL, atol=1e-6, err_msg=what)
    i = 0
    while i < len(rh):
        j = i + 1
        while j < len(rh) and np.isclose(rs[j], rs[j - 1], rtol=RTOL, atol=0):
            j += 1
        assert {h["_id"] for h in gh[i:j]} == {h["_id"] for h in rh[i:j]}, (what, rh, gh)
        i = j
    assert got.get("aggregations") == ref.get("aggregations"), what


@pytest.mark.parametrize("context", sorted(CONTEXTS))
@pytest.mark.parametrize("node", sorted(NODES))
def test_node_matches_reference(trio, node, context):
    body = CONTEXTS[context](NODES[node])
    ref = trio["jax"].search(copy.deepcopy(body))
    got = trio["torch"].search(copy.deepcopy(body))
    same_response(ref, got, f"{node} {context} (jax)")
    same_response(trio["numpy"].search(copy.deepcopy(body)), got, f"{node} {context} (numpy)")
    if context == "alone":
        assert ref["hits"]["total"]["value"] > 0, node


# ---- the routes, at the executor ----


def _readers(trio):
    jsvc, tsvc = trio["jax"], trio["torch"]
    return jsvc.shards[0].reader(), tsvc.shards[0].reader()


def _strip_positions(reader, cls):
    segs = []
    for seg in reader.segments:
        seg = copy.copy(seg)
        seg.postings = {f: dataclasses.replace(pf, term_pos_start=None, pos_offsets=None, pos_data=None)
                        for f, pf in seg.postings.items()}
        segs.append(seg)
    return cls(segs, reader.mappings, reader.analysis, reader.live_docs)


@pytest.mark.parametrize("node", ["match_phrase", "match_phrase_slop2", "multi_match_phrase"])
def test_phrase_takes_the_conjunction_route(trio, node):
    jr, tr = _readers(trio)
    before = dict(executor_torch.PHRASE_STATS)
    tex = TorchExecutor(tr, device="cpu")
    got = tex.search(dsl.parse_query(NODES[node]), size=20)
    after = dict(executor_torch.PHRASE_STATS)
    assert after["conjunction"] > before["conjunction"]
    assert after["candidates"] > before["candidates"]
    assert after["oracle"] == before["oracle"]
    ref = JaxExecutor(jr).search(jdsl.parse_query(NODES[node]), size=20)
    assert [h.doc_id for h in got.hits] == [h.doc_id for h in ref.hits]
    np.testing.assert_allclose([h.score for h in got.hits], [h.score for h in ref.hits], rtol=RTOL)
    tex.close()


def test_positionless_segment_takes_the_oracle_route(trio):
    from elasticsearch_tpu.search.executor import ShardReader as JReader

    jr, tr = _readers(trio)
    jr0, tr0 = _strip_positions(jr, JReader), _strip_positions(tr, ShardReader)
    assert not tr0.segments[0].postings["body"].has_positions
    for node in ("match_phrase", "match_phrase_repeated", "multi_match_phrase"):
        before = dict(executor_torch.PHRASE_STATS)
        tex = TorchExecutor(tr0, device="cpu")
        got = tex.search(dsl.parse_query(NODES[node]), size=20)
        after = dict(executor_torch.PHRASE_STATS)
        assert after["oracle"] > before["oracle"]
        assert after["conjunction"] == before["conjunction"]
        for ref in (JaxExecutor(jr0).search(jdsl.parse_query(NODES[node]), size=20),
                    NumpyExecutor(tr).search(dsl.parse_query(NODES[node]), size=20)):
            assert got.total == ref.total
            assert [h.doc_id for h in got.hits] == [h.doc_id for h in ref.hits]
            np.testing.assert_allclose([h.score for h in got.hits], [h.score for h in ref.hits], rtol=RTOL)
        tex.close()


def test_expanded_terms_score_in_one_pass(trio, monkeypatch):
    """prefix/wildcard/regexp/fuzzy score through `_field_terms_scored`
    once per segment, with the oracle's expansion."""
    _, tr = _readers(trio)
    tex = TorchExecutor(tr, device="cpu")
    calls = []
    real = tex._field_terms_scored
    monkeypatch.setattr(tex, "_field_terms_scored", lambda si, f, terms, b: calls.append(terms) or real(si, f, terms, b))
    for node in ("prefix", "wildcard", "regexp", "fuzzy"):
        calls.clear()
        q = dsl.parse_query(NODES[node])
        tex.search(q, size=5)
        assert len(calls) == len(tr.segments), node
        assert calls[0] == (tex._oracle._fuzzy_terms(q, tr.segments[0]) if node == "fuzzy"
                            else tex._oracle._expand_terms(q, tr.segments[0]))
    tex.close()


@pytest.mark.parametrize("body", [
    {"script_score": {"query": {"match": {"body": "alpha"}}, "script": {"source": "_score * 2"}}},
    {"function_score": {"query": {"match": {"body": "alpha"}},
                        "functions": [{"script_score": {"script": {"source": "_score"}}}]}},
])
def test_script_nodes_still_raise_naming_item_14(trio, body):
    """Script nodes raised naming ROADMAP queue 1 item 14 while it was
    cut; since it is ported they are the oracle's host masks and scores,
    uploaded, as the reference routes them, and answer as JaxExecutor."""
    jr, tr = _readers(trio)
    tex = TorchExecutor(tr, device="cpu")
    got = tex.search(dsl.parse_query(body), size=5)
    ref = JaxExecutor(jr).search(jdsl.parse_query(body), size=5)
    assert got.total == ref.total and ref.hits
    assert [h.doc_id for h in got.hits] == [h.doc_id for h in ref.hits]
    np.testing.assert_allclose([h.score for h in got.hits], [h.score for h in ref.hits], rtol=RTOL)
    tex.close()
