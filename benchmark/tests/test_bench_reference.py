"""The plain references against a brute-force NumPy loop at a tiny size,
and the reference's own Lucene norm against the port's."""

import math

import numpy as np
import torch

from benchmark.harness import corpus
from benchmark.reference import bm25, knn

TEXT = {"kind": "text", "field": "text", "passages": 400,
        "assumed": {"vocab": 60, "zipf_s": 1.0, "length": {"mean": 20, "sigma": 0.5, "min": 1,
                                                              "max": 200}}}


def test_byte4_matches_lucene_and_the_port():
    from elasticsearch_tpu_torch.utils import smallfloat

    for i in list(range(0, 3000)) + [10**5, 2**20 + 3, 2**31 - 1]:
        assert bm25.int_to_byte4(i) == smallfloat.int_to_byte4(i)
    for b in range(256):
        assert bm25.byte4_to_int(b) == smallfloat.byte4_to_int(b)
    lens = torch.arange(0, 5000)
    want = [smallfloat.byte4_to_int(smallfloat.int_to_byte4(int(x))) for x in lens]
    assert bm25.decoded_lengths(lens).tolist() == want


def _brute_bm25(stream, lengths, terms, k1=1.2, b=0.75):
    n = len(lengths)
    docs, off = [], 0
    for ln in lengths:
        docs.append(stream[off:off + ln])
        off += ln
    avgdl = lengths.sum() / n
    dl = [bm25.byte4_to_int(bm25.int_to_byte4(int(x))) for x in lengths]
    scores = np.zeros(n)
    hit = np.zeros(n, bool)
    for t in terms:
        df = sum(1 for d in docs if t in d)
        idf = math.log(1 + (n - df + 0.5) / (df + 0.5))
        for j, d in enumerate(docs):
            tf = int(np.sum(d == t))
            if tf:
                hit[j] = True
                scores[j] += idf * tf / (tf + k1 * (1 - b + b * dl[j] / avgdl))
    order = sorted(np.nonzero(hit)[0], key=lambda j: (-scores[j], j))
    return order, scores, int(hit.sum())


def test_bm25_top10_matches_a_brute_force_loop():
    c = corpus.make(TEXT, 5, "cpu")
    stream, lengths = c["stream"].numpy(), c["lengths"].numpy()
    ref = bm25.Bm25(c["stream"], c["lengths"], 60, 1.2, 0.75)
    for terms in ([0, 5], [3, 17, 40], [59], [1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11]):
        docs, vals, count, s, hit = ref.top(terms, 10)
        order, want, wcount = _brute_bm25(stream, lengths, terms)
        assert count == wcount
        assert docs.tolist() == order[:10]
        np.testing.assert_allclose(vals.numpy(), want[order[:10]], rtol=1e-12)
        np.testing.assert_allclose(s.numpy(), want, rtol=1e-12)


def test_knn_top10_matches_a_brute_force_loop():
    rng = np.random.default_rng(3)
    rows = rng.standard_normal((700, 16)).astype(np.float32)
    q = rng.standard_normal((5, 16)).astype(np.float32)
    S = knn.scores(torch.from_numpy(q), torch.from_numpy(rows))
    for j in range(5):
        want = [(1 + float(np.dot(q[j].astype(np.float64), r.astype(np.float64))
                           / np.linalg.norm(q[j].astype(np.float64))
                           / np.linalg.norm(r.astype(np.float64)))) / 2 for r in rows]
        order = sorted(range(700), key=lambda i: (-want[i], i))[:10]
        docs, vals = knn.top(S[j], 10)
        assert docs.tolist() == order
        np.testing.assert_allclose(vals.numpy(), np.asarray(want)[order], rtol=1e-13)


def test_knn_ties_rank_by_doc_id():
    s = torch.tensor([0.5, 0.9, 0.9, 0.1, 0.9], dtype=torch.float64)
    docs, vals = knn.top(s, 3)
    assert docs.tolist() == [1, 2, 4]
