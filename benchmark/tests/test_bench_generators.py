"""The corpus and the traffic are functions of the seed."""

import numpy as np
import pytest
import torch

from benchmark.harness import corpus
from benchmark.harness.traffic import QueryMaker, norm_seed

TEXT = {"kind": "text", "field": "text", "passages": 3000,
        "assumed": {"vocab": 500, "zipf_s": 1.0, "length": {"mean": 56, "sigma": 0.45, "min": 4,
                                                               "max": 200}}}
VECS = {"kind": "vectors", "field": "emb", "rows": 2000, "dims": 24,
        "assumed": {"centres": 16, "noise": 0.5}}
MATCH = {"body": "match", "size": 10, "clients": 32, "shapes": 64,
         "query_terms": {"min": 2, "max": 12, "p": 0.4}}
KNN = {"body": "knn", "size": 10, "k": 10, "num_candidates": 100}
BIG = 2**31 + 12345


@pytest.mark.parametrize("cfg", [TEXT, VECS], ids=["text", "vectors"])
def test_corpus_is_a_function_of_the_seed(cfg):
    a, b, c = (corpus.make(cfg, s, "cpu") for s in (BIG, BIG, BIG + 1))
    for k, v in a.items():
        if isinstance(v, torch.Tensor):
            assert torch.equal(v, b[k])
            assert not torch.equal(v, c[k])


def test_text_corpus_shape():
    c = corpus.make(TEXT, 7, "cpu")
    lens = c["lengths"]
    assert len(lens) == 3000 and int(lens.min()) >= 4 and int(lens.max()) <= 200
    assert 45 <= float(lens.double().mean()) <= 67
    assert c["stream"].numel() == int(lens.sum())
    assert int(c["stream"].min()) >= 0 and int(c["stream"].max()) < 500
    # Zipf: the first term is the most frequent by far
    counts = torch.bincount(c["stream"].long(), minlength=500)
    assert int(counts.argmax()) == 0


def test_every_seed_gets_the_same_text_sizes():
    """The lengths and each term's count are the same multiset for every
    seed; only their placement follows the seed."""
    a, b = corpus.make(TEXT, 1, "cpu"), corpus.make(TEXT, 2, "cpu")
    assert torch.equal(a["lengths"].sort().values, b["lengths"].sort().values)
    assert torch.equal(torch.bincount(a["stream"].long(), minlength=500),
                       torch.bincount(b["stream"].long(), minlength=500))
    assert not torch.equal(a["lengths"], b["lengths"])


def test_vectors_are_unit_rows():
    c = corpus.make(VECS, 7, "cpu")
    assert torch.allclose(torch.linalg.vector_norm(c["vectors"], dim=1), torch.ones(2000), atol=1e-5)


@pytest.mark.parametrize("mix,cfg", [(MATCH, TEXT), (KNN, VECS)], ids=["match", "knn"])
def test_bodies_are_a_function_of_seed_client_and_number(mix, cfg):
    ctx = corpus.client_context(cfg, corpus.make(cfg, 3, "cpu"))
    m1, m2, m3 = (QueryMaker(mix, cfg, ctx, s) for s in (BIG, BIG, BIG + 1))
    for c, i in ((0, 0), (5, 17), (31, 999)):
        assert m1.body(c, i) == m2.body(c, i)
        assert m1.body(c, i) != m3.body(c, i)
    assert m1.body(0, 0) != m1.body(0, 1) != m1.body(1, 0)


def test_match_terms_are_distinct_and_sized():
    m = QueryMaker(MATCH, TEXT, {}, 11)
    sizes = []
    for i in range(400):
        t = m.terms(i % 32, i)
        assert len(set(t)) == len(t) and 2 <= len(t) <= 12
        sizes.append(len(t))
    assert 5 <= np.mean(sizes) <= 7


def test_every_seed_gets_the_same_queries_in_its_own_order():
    """A run's g-th request takes query perm[g % shapes]: each cycle over
    the queries holds every one once."""
    a, b = QueryMaker(MATCH, TEXT, {}, 5), QueryMaker(MATCH, TEXT, {}, 6)
    assert a.shapes == b.shapes and list(a.perm) != list(b.perm)
    for m in (a, b):
        seen = [tuple(m.terms(g % 32, g // 32)) for g in range(64)]
        assert sorted(seen) == sorted(tuple(x) for x in m.shapes)
        assert m.terms(0, 2) == m.shapes[int(m.perm[0])]
    assert [a.terms(c, 0) for c in range(32)] != [b.terms(c, 0) for c in range(32)]


def test_seeds_of_any_size():
    for s in (0, 1, 2**31 - 1, 2**31 + 5, 2**40, -3):
        assert 0 <= norm_seed(s) < 2**63
        corpus.generator(s, "cpu", 1)
