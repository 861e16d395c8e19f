"""The port's hand-written CUDA kernel against its plain version, and
the served routes (match, knn, bool, multi_match, filtered bool, hybrid
RRF) against the numpy backend, on the card. Every test here carries the `cuda` marker, needs an NVIDIA GPU and
nvcc, decides so inside its fixture and skips without them. The module
imports neither jax nor the JAX package, so on a machine with the card
it also runs where only PyTorch is installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q
"""

import numpy as np
import pytest
import torch

from elasticsearch_tpu_torch.ops import int8_knn

torch.set_num_threads(1)

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the int8 kNN kernel has no CPU mode")
    return torch.device("cuda", 0)


def _inputs(B, N, d, seed, device):
    rng = np.random.default_rng(seed)
    q, scales = int8_knn.quantize_int8(rng.standard_normal((N, d)).astype(np.float32))
    queries = rng.standard_normal((B, q.shape[1])).astype(np.float32)
    return (
        torch.from_numpy(queries).to(device),
        torch.from_numpy(q).to(device),
        torch.from_numpy(scales).to(device),
    )


def _raw_inputs(B, N, d, seed, device):
    """Unpadded int8 rows of width d (quantize_int8 pads d to 128)."""
    rng = np.random.default_rng(seed)
    v = rng.integers(-127, 128, size=(N, d), dtype=np.int8)
    scales = rng.uniform(0.001, 0.02, size=N).astype(np.float32)
    queries = rng.standard_normal((B, d)).astype(np.float32)
    return (
        torch.from_numpy(queries).to(device),
        torch.from_numpy(v).to(device),
        torch.from_numpy(scales).to(device),
    )


@pytest.mark.parametrize(
    "B,N,d",
    [
        (1, 1, 128), (5, 127, 128), (32, 4096, 768), (33, 1000, 256), (70, 129, 384),
        # tail chunks narrower than 64 (d % 64 = 16, 16, 16)
        (8, 513, 16), (17, 1, 80), (17, 513, 208),
        # 32 queries do not fit at 4096-d: two chunks of 8 (the second ragged)
        (9, 700, 4096),
    ],
)
def test_kernel_matches_plain(cuda, B, N, d):
    """Ragged doc tails (N not a multiple of 64), ragged k-chunks, every
    query-chunk size and odd B: within 1e-5 of max|dots| of the plain
    version and of a float64 product (f32 sums in another order)."""
    make = _inputs if d % 128 == 0 else _raw_inputs
    q, v, s = make(B, N, d, B * 1000 + N, cuda)
    before = int8_knn.int8_dot_scores.launches
    out = int8_knn.int8_dot_scores(q, v, s)
    torch.cuda.synchronize(cuda)
    assert int8_knn.int8_dot_scores.launches == before + 1
    ref = int8_knn.int8_dot_scores_plain(q, v, s)
    assert out.shape == (B, N)
    tol = 1e-5 * float(ref.abs().max())
    assert float((out - ref).abs().max()) <= tol
    exact = (q.double() @ v.double().T) * s.double()
    assert float((out.double() - exact).abs().max()) <= tol


def test_kernel_exact_over_spread_magnitudes(cuda):
    """Query rows scaled over 10^±30 and elements spread over 2^±10 in
    each row: the bf16x3 split keeps every row to 1e-5 of its own
    max|dots| against float64 (a lost lo part would show on small rows)."""
    rng = np.random.default_rng(11)
    B, N, d = 24, 2000, 768
    q, v, s = _inputs(B, N, d, 11, cuda)
    spread = 10.0 ** rng.uniform(-30, 30, (B, 1)) * 2.0 ** rng.uniform(-10, 10, (B, d))
    q = q * torch.from_numpy(spread.astype(np.float32)).to(cuda)
    out = int8_knn.int8_dot_scores(q, v, s)
    torch.cuda.synchronize(cuda)
    exact = (q.double() @ v.double().T) * s.double()
    row_max = exact.abs().max(dim=1).values
    err = (out.double() - exact).abs().max(dim=1).values
    assert bool(torch.isfinite(out).all())
    assert bool((err <= 1e-5 * row_max).all()), (err / row_max).max()


def test_kernel_checks_its_inputs(cuda):
    q, v, s = _inputs(2, 64, 128, 1, cuda)
    with pytest.raises(ValueError, match="multiple of 16"):
        int8_knn.int8_dot_scores(q[:, :120].contiguous(), v[:, :120].contiguous(), s)
    with pytest.raises(TypeError):
        int8_knn.int8_dot_scores(q.double(), v, s)
    with pytest.raises(ValueError, match="contiguous"):
        int8_knn.int8_dot_scores(q.t().contiguous().t(), v, s)
    with pytest.raises(ValueError, match="aligned"):
        int8_knn.int8_dot_scores(q[:, :16].contiguous(), v.reshape(-1)[1:1 + 64 * 16].reshape(64, 16), s)


def test_quantized_search_on_card_matches_cpu(cuda):
    rng = np.random.default_rng(7)
    vectors = rng.standard_normal((3000, 96)).astype(np.float32)
    queries = rng.standard_normal((40, 96)).astype(np.float32)
    gpu = int8_knn.QuantizedVectors(vectors, device=cuda)
    cpu = int8_knn.QuantizedVectors(vectors, device="cpu")
    gs, gd = gpu.search(queries, 10)
    cs, cd = cpu.search(queries, 10)
    np.testing.assert_allclose(gs.cpu().numpy(), cs.numpy(), rtol=1e-5)
    diff = gd.cpu().numpy() != cd.numpy()
    assert np.allclose(gs.cpu().numpy()[diff], cs.numpy()[diff], rtol=1e-5)


# ---- serving on the card: the port's IndexService, torch vs numpy ----


def _served_pair(monkeypatch, cuda):
    """Two port IndexServices over the same docs (2 shards, two
    refreshes, a delete): `search.backend: torch` on the card and the
    numpy oracle."""
    from elasticsearch_tpu_torch.cluster.indices import IndexService

    monkeypatch.setenv("ES_TPU_BG_REFRESH", "off")
    monkeypatch.setenv("ES_TPU_DEVICE_BUILD", "off")
    mapping = {"properties": {"body": {"type": "text"}, "title": {"type": "text"},
                              "n": {"type": "integer"}, "day": {"type": "date"},
                              "vec": {"type": "dense_vector", "dims": 16, "similarity": "cosine"}}}
    words = ["ant", "bee", "cat", "dog", "eel", "fox", "gnu", "hen"]
    p = 1.0 / np.arange(1, len(words) + 1)
    rng = np.random.default_rng(5)
    docs = [(f"c{i}", {"body": " ".join(rng.choice(words, int(rng.integers(2, 12)), p=p / p.sum())),
                       "vec": [float(x) for x in rng.normal(size=16)],
                       "title": f"{words[i % 8]} {words[(i * 3) % 8]}",
                       "n": i % 50, "day": 1700000000000 + (i % 7) * 86400000 + i % 3})
            for i in range(300)]
    pair = []
    for backend in ("torch", "numpy"):
        svc = IndexService(f"card-{backend}", settings={"number_of_shards": 2, "search.backend": backend},
                           mappings_json=mapping, device=cuda)
        for i, (doc_id, src) in enumerate(docs):
            svc.index_doc(doc_id, src)
            if i == 150:
                svc.refresh()
        svc.delete_doc("c7")
        svc.refresh()
        pair.append(svc)
    return pair


def _same_served(ref, got):
    assert got["hits"]["total"] == ref["hits"]["total"]
    rh, gh = ref["hits"]["hits"], got["hits"]["hits"]
    assert len(gh) == len(rh)
    rs = np.array([h["_score"] for h in rh])
    np.testing.assert_allclose([h["_score"] for h in gh], rs, rtol=1e-5, atol=1e-6)
    # ids position by position; a run of scores tied within 1e-5 as a set
    i = 0
    while i < len(rh):
        j = i + 1
        while j < len(rh) and np.isclose(rs[j], rs[j - 1], rtol=1e-5, atol=0):
            j += 1
        assert {h["_id"] for h in gh[i:j]} == {h["_id"] for h in rh[i:j]}, (rh, gh)
        i = j


TEXT_BODIES = {
    "bool": [{"query": {"bool": {"must": [{"term": {"body": "ant"}}],
                                 "should": [{"match": {"body": "cat dog"}}, {"match": {"title": "bee"}}]}}},
             {"query": {"bool": {"should": [{"match": {"body": "eel"}}, {"match": {"body": "fox"}},
                                            {"match": {"title": "gnu"}}], "minimum_should_match": 2}}}],
    "multi_match": [{"query": {"multi_match": {"query": "ant hen", "fields": ["title^2", "body"],
                                               "tie_breaker": 0.3}}},
                    {"query": {"multi_match": {"query": "bee cat", "fields": ["title", "body"],
                                               "type": "most_fields"}}}],
    "filtered_bool": [{"query": {"bool": {"must": [{"term": {"body": "bee"}}],
                                          "should": [{"match": {"body": "cat"}}],
                                          "filter": [{"term": {"body": "dog"}}, {"range": {"n": {"gte": 20}}}]}}},
                      # a date range at an odd-millisecond boundary
                      {"query": {"bool": {"must": [{"match": {"body": "ant"}}],
                                          "filter": [{"range": {"day": {"gt": 1700086400001}}}]}}},
                      {"query": {"bool": {"must": [{"match": {"body": "ant"}}],
                                          "filter": [{"range": {"day": {"gt": 1700086400000}}}]}}}],
}


def _same_fused(oracle, body, got, c=60):
    """A hybrid page against RRF over the oracle's two legs: each served
    score lies between the least and the most RRF that the legs' ranks
    allow (ranks inside a run of leg scores tied within 1e-5 may
    permute), and no candidate whose least RRF beats the page's last
    score is missing."""
    rrf = body["retriever"]["rrf"] if "retriever" in body else body["rank"]["rrf"]
    if "retriever" in body:
        std, knn = (r for r in rrf["retrievers"])
        legs = [{"query": std["standard"]["query"]}, {"knn": knn["knn"]}]
    else:
        legs = [{"query": body["query"]}, {"knn": body["knn"]}]
    lo, hi = {}, {}
    for leg in legs:
        hits = oracle.search({**leg, "size": 10, "_source": False})["hits"]["hits"]
        s = [h["_score"] for h in hits]
        i = 0
        while i < len(s):
            j = i + 1
            while j < len(s) and np.isclose(s[j], s[j - 1], rtol=1e-5, atol=0):
                j += 1
            for h in hits[i:j]:
                lo[h["_id"]] = lo.get(h["_id"], 0.0) + 1.0 / (c + j)
                hi[h["_id"]] = hi.get(h["_id"], 0.0) + 1.0 / (c + i + 1)
            i = j
    gh = got["hits"]["hits"]
    assert len(gh) == min(10, len(lo))
    for h in gh:
        assert lo[h["_id"]] * (1 - 1e-5) <= h["_score"] <= hi[h["_id"]] * (1 + 1e-5), (h, lo, hi)
    floor = gh[-1]["_score"] * (1 + 1e-5)
    assert not [d for d in set(lo) - {h["_id"] for h in gh} if lo[d] > floor]


@pytest.mark.parametrize("route", ["match", "knn", "bool", "multi_match", "filtered_bool", "hybrid"])
def test_served_route_on_card_matches_numpy(cuda, monkeypatch, route):
    from elasticsearch_tpu_torch.search.executor_torch import TorchExecutor

    svc, oracle = _served_pair(monkeypatch, cuda)
    try:
        rng = np.random.default_rng(9)
        if route == "match":
            bodies = [{"query": {"match": {"body": q}}} for q in ("ant bee", "cat", "dog eel fox")]
            bodies.append({"query": {"match": {"body": {"query": "ant bee cat", "operator": "and"}}}})
        elif route == "knn":
            bodies = [{"knn": {"field": "vec", "query_vector": [float(x) for x in rng.normal(size=16)],
                               "k": 5, "num_candidates": 25}} for _ in range(4)]
        elif route == "hybrid":
            bodies = [
                {"retriever": {"rrf": {"retrievers": [
                    {"standard": {"query": {"multi_match": {"query": q, "fields": ["title", "body"]}}}},
                    {"knn": {"field": "vec", "query_vector": [float(x) for x in rng.normal(size=16)],
                             "k": 8, "num_candidates": 30}}], "rank_constant": 60}}}
                for q in ("ant bee", "cat", "dog eel")
            ]
            bodies.append({"query": {"match": {"body": "fox"}}, "rank": {"rrf": {}},
                           "knn": {"field": "vec", "query_vector": [float(x) for x in rng.normal(size=16)],
                                   "k": 5, "num_candidates": 20}})
        else:
            bodies = TEXT_BODIES[route]
        for body in bodies:
            if route == "hybrid":
                _same_fused(oracle, body, svc.search(body))
            else:
                _same_served(oracle.search(body), svc.search(body))
        ex = svc._executor(svc.shards[0])
        assert isinstance(ex, TorchExecutor) and ex.device.type == "cuda"
        if route == "hybrid":
            # two shards: the legs run on the leg pool, the fuse on the host
            assert svc.rrf_stats["host_fused"] == len(bodies)
        elif route == "filtered_bool":
            # the filtered route scores per request, its bitsets cached
            from elasticsearch_tpu_torch.search.query_cache import filter_cache

            assert filter_cache.stats_for_index(svc.uuid)["cache_count"] > 0
        else:
            assert svc._batcher.stats["launches"] > 0
        assert torch.get_float32_matmul_precision() == "highest"
    finally:
        svc.close()
        oracle.close()
