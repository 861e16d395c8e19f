"""The port's ops/scoring.py against the JAX package's, on the CPU, on
the same numpy-seeded inputs: exact on integers (docs, totals, counts,
dense tf rows), scores within rtol 1e-5 / atol 1e-6 (float32 sums in
another order), and the same doc-asc order among tied scores."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from elasticsearch_tpu.ops import scoring as jscoring
from elasticsearch_tpu_torch.ops import scoring as tscoring

torch.set_num_threads(1)

RTOL, ATOL = 1e-5, 1e-6
TILE = 128


def t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def postings(rng, n_docs, n_terms, max_df, max_tf=6):
    """A tiled postings column: per term a sorted doc list padded with -1
    to whole tiles, tf in [1, max_tf]."""
    docs_rows, tf_rows = [], []
    for _ in range(n_terms):
        df = int(rng.integers(1, max_df))
        d = np.sort(rng.choice(n_docs, size=df, replace=False)).astype(np.int32)
        tf = rng.integers(1, max_tf + 1, size=df).astype(np.int32)
        nt = -(-df // TILE)
        dp = np.full(nt * TILE, -1, np.int32)
        tp = np.zeros(nt * TILE, np.int32)
        dp[:df], tp[:df] = d, tf
        docs_rows.append(dp.reshape(nt, TILE))
        tf_rows.append(tp.reshape(nt, TILE))
    return np.concatenate(docs_rows), np.concatenate(tf_rows)


def assert_topk_same(s_ref, d_ref, s, d):
    """Same scores; same docs except where two scores tie within tolerance."""
    s_ref, d_ref, s, d = (np.asarray(x) for x in (s_ref, d_ref, s, d))
    fin = np.isfinite(s_ref)
    np.testing.assert_array_equal(np.isfinite(s), fin)
    np.testing.assert_allclose(s[fin], s_ref[fin], rtol=RTOL, atol=ATOL)
    diff = (d != d_ref) & fin
    assert np.allclose(s[diff], s_ref[diff], rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_score_tiles(seed):
    rng = np.random.default_rng(seed)
    n = 700
    doc_ids, tfs = postings(rng, n, 12, 300)
    T = 16
    idx = rng.integers(0, len(doc_ids), size=T)
    w = rng.random(T).astype(np.float32) * 3
    v = rng.random(T) > 0.2
    inv = (rng.random(n) * 0.5 + 0.1).astype(np.float32)
    js, jc = jscoring.score_tiles(
        jnp.asarray(doc_ids[idx]), jnp.asarray(tfs[idx]), jnp.asarray(w),
        jnp.asarray(v), jnp.asarray(inv), n,
    )
    ts, tc = tscoring.score_tiles(t(doc_ids[idx]), t(tfs[idx]), t(w), t(v), t(inv), n)
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=RTOL, atol=ATOL)


def test_pad_tiles_and_buckets():
    for n in (0, 1, 7, 8, 9, 100):
        assert tscoring.next_bucket(n) == jscoring.next_bucket(n)
    a = tscoring.pad_tiles(np.arange(5, dtype=np.int32), np.ones(5, np.float32))
    b = jscoring.pad_tiles(np.arange(5, dtype=np.int32), np.ones(5, np.float32))
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
    assert tscoring.text_plan_flops(3, 2, 100) == jscoring.text_plan_flops(3, 2, 100)
    assert tscoring.knn_flops(4, 100, 8) == jscoring.knn_flops(4, 100, 8)
    for name in ("BPAD", "FUSED_T_RARE", "FUSED_H", "DENSE_TF_MAX"):
        assert getattr(tscoring, name) == getattr(jscoring, name)


@pytest.mark.parametrize("k", [1, 5, 40])
def test_topk_tie_order_matches_lax_top_k(k):
    """Heavy ties: the port's selection keeps the lowest index among
    equal scores, as lax.top_k does."""
    rng = np.random.default_rng(k)
    x = rng.integers(0, 4, size=(6, 300)).astype(np.float32)
    x[2, :] = -np.inf
    x[3, 100:] = -np.inf
    js, jd = jscoring.topk_hits(jnp.asarray(x), jnp.ones(x.shape, bool), k)
    ts, td = tscoring.topk_hits(t(x), torch.ones(x.shape, dtype=torch.bool), k)
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))


NEG_NAN = np.array([0xFFC00000], np.uint32).view(np.float32)[0]

# rows whose `lax.top_k` order a tie-exact selection on values alone gets
# wrong: NaN ranks above +inf, a NaN with its sign bit below -inf, +0.0
# above -0.0 (the IEEE total order), lowest index first among equal bits
TOTAL_ORDER_ROWS = [
    ([1, np.nan, 3, 2, 0.5], 5, [1, 2, 3, 0, 4]),
    ([np.nan, 1, np.nan, 2, 0], 5, [0, 2, 3, 1, 4]),
    ([0.0, -0.0, 0.0, -0.0], 4, [0, 2, 1, 3]),
    ([NEG_NAN, -np.inf, 1, np.nan], 4, [3, 2, 1, 0]),
    ([-np.inf, -np.inf, NEG_NAN], 3, [0, 1, 2]),
]


def assert_topk_desc_bitwise(x, k):
    """topk_desc gives lax.top_k's indices, and its values bit for bit."""
    x = np.ascontiguousarray(x, np.float32)
    jv, ji = (np.asarray(a) for a in jax.lax.top_k(jnp.asarray(x), k))
    tv, ti = tscoring.topk_desc(t(x), k)
    np.testing.assert_array_equal(ti.numpy(), ji)
    np.testing.assert_array_equal(tv.numpy().view(np.uint32), jv.view(np.uint32))
    return ti.numpy()


@pytest.mark.parametrize("row,k,want", TOTAL_ORDER_ROWS)
def test_topk_desc_total_order_matches_lax_top_k(row, k, want):
    got = assert_topk_desc_bitwise(np.array(row, np.float32), k)
    np.testing.assert_array_equal(got, want)
    for kk in range(1, k):  # every shorter prefix too
        assert_topk_desc_bitwise(np.array(row, np.float32), kk)


@pytest.mark.parametrize("seed", range(6))
def test_topk_desc_random_specials_and_batch_shape(seed):
    """Random rows drawn from {NaN, -NaN, ±0, ±inf, ±1, 2}, many ties, a
    random k, k = n, and a [2, 3, n] batch shape."""
    rng = np.random.default_rng(seed)
    pool = np.array([np.nan, NEG_NAN, 0.0, -0.0, np.inf, -np.inf, 1.0, -1.0, 2.0], np.float32)
    x = pool[rng.integers(0, len(pool), size=(2, 3, 37))]
    for k in (int(rng.integers(1, 37)), 37):
        assert_topk_desc_bitwise(x, k)
    v, i = tscoring.topk_desc(t(x), 0)
    assert v.shape == (2, 3, 0) and i.shape == (2, 3, 0) and i.dtype == torch.int64


def test_build_dense_rows():
    rng = np.random.default_rng(4)
    n = 900
    doc_ids, tfs = postings(rng, n, 6, 800, max_tf=300)
    hot_tiles = np.arange(len(doc_ids), dtype=np.int32)[::2]
    rank = (np.arange(len(hot_tiles)) % 3).astype(np.int32)
    jd = jscoring.build_dense_rows(
        jnp.asarray(doc_ids), jnp.asarray(tfs), jnp.asarray(hot_tiles),
        jnp.asarray(rank), n_hot=3, n_docs=n,
    )
    td = tscoring.build_dense_rows(t(doc_ids), t(tfs), t(hot_tiles), t(rank), 3, n)
    assert td.dtype == torch.uint8
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))


def fused_setup(seed, with_live):
    rng = np.random.default_rng(seed)
    n = 1500
    doc_ids, tfs = postings(rng, n, 30, 400)
    inv = (rng.random(n) * 0.5 + 0.1).astype(np.float32)
    n_hot = 5
    dense = rng.integers(0, 4, size=(n_hot, n)).astype(np.uint8)
    live = rng.random(n) > 0.25 if with_live else None
    plans = []
    for j in range(7):
        nt = int(rng.integers(0, 20))
        rt = rng.choice(len(doc_ids), size=nt, replace=False).astype(np.int64)
        rw = (rng.random(nt) * 2 + 0.1).astype(np.float32)
        nh = int(rng.integers(0, 4))
        hr = rng.choice(n_hot, size=nh, replace=False).astype(np.int64)
        hw = (rng.random(nh) * 2 + 0.1).astype(np.float32)
        plans.append((rt, rw, hr, hw, int(rng.integers(1, 3))))
    # a tie row: the same tile twice at one weight scores docs equally
    plans.append((np.array([0], np.int64), np.array([1.0], np.float32),
                  np.empty(0, np.int64), np.empty(0, np.float32), 1))
    jfs = jscoring.FusedScorer(
        jnp.asarray(doc_ids), jnp.asarray(tfs), inv, live, jnp.asarray(dense),
        t_rare=32, n_hot_slots=4,
    )
    tfs_ = tscoring.FusedScorer(
        t(doc_ids), t(tfs), inv, live, t(dense), t_rare=32, n_hot_slots=4
    )
    return jfs, tfs_, plans


@pytest.mark.parametrize("with_cnt", [False, True])
@pytest.mark.parametrize("with_live", [False, True])
def test_fused_scorer(with_cnt, with_live):
    jfs, tfs_, plans = fused_setup(5, with_live)
    k = 25
    np.testing.assert_array_equal(
        tfs_.pack_plans(plans, rows=8), jfs.pack_plans(plans, rows=8)
    )
    js, jd, jt = jfs.search(plans, k, with_cnt, rows=8)
    ts, td, tt = tfs_.search(plans, k, with_cnt, rows=8)
    np.testing.assert_array_equal(tt, jt)
    assert_topk_same(js, jd, ts, td)
    # the all-equal row: doc-asc order exactly
    np.testing.assert_array_equal(td[7], jd[7])


def test_fused_scorer_live_override_and_device_result():
    jfs, tfs_, plans = fused_setup(6, False)
    live = np.random.default_rng(0).random(tfs_.n_docs) > 0.5
    k = 10
    js, jd, jt = jfs.search(plans, k, True, live=jnp.asarray(live), rows=8)
    pending = tfs_.search_async(plans, k, True, live=torch.from_numpy(live), rows=8)
    s, d, tot = tscoring.FusedScorer.device_result(pending)
    assert s.dtype == torch.float32 and d.dtype == torch.int32
    np.testing.assert_array_equal(tot.numpy(), jt)
    assert_topk_same(js, jd, s.numpy(), d.numpy())


def test_merge_segment_topk():
    rng = np.random.default_rng(7)
    B, k = 4, 6
    j_items, t_items = [], []
    for si, width in enumerate((6, 3, 6)):
        s = np.sort(rng.integers(0, 5, size=(B, width)).astype(np.float32), axis=1)[:, ::-1]
        s[1, -2:] = -np.inf
        s = np.ascontiguousarray(s)
        d = np.sort(rng.integers(0, 50, size=(B, width)), axis=1).astype(np.int32)
        tot = rng.integers(0, 100, size=B).astype(np.int32)
        j_items.append((si * 2, jnp.asarray(s), jnp.asarray(d), jnp.asarray(tot)))
        t_items.append((si * 2, t(s), t(d), t(tot)))
    ref = jscoring.merge_segment_topk(j_items, k)
    got = tscoring.merge_segment_topk(t_items, k)
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("sim", ["cosine", "dot_product", "max_inner_product", "l2_norm"])
def test_knn_topk(sim):
    rng = np.random.default_rng(8)
    vecs = rng.standard_normal((400, 16)).astype(np.float32)
    if sim == "cosine":
        vecs /= np.linalg.norm(vecs, axis=1, keepdims=True)
    q = rng.standard_normal((3, 16)).astype(np.float32)
    exists = rng.random(400) > 0.1
    js, jd = jscoring.knn_topk(jnp.asarray(q), jnp.asarray(vecs), jnp.asarray(exists), sim, 20)
    ts, td = tscoring.knn_topk(t(q), t(vecs), t(exists), sim, 20)
    assert_topk_same(js, jd, ts.numpy(), td.numpy())
    np.testing.assert_allclose(
        tscoring.knn_scores(t(q), t(vecs), sim).numpy(),
        np.asarray(jscoring.knn_scores(jnp.asarray(q), jnp.asarray(vecs), sim)),
        rtol=RTOL, atol=ATOL,
    )


def test_knn_topk_batch():
    rng = np.random.default_rng(9)
    vecs = rng.standard_normal((300, 8)).astype(np.float32)
    q = np.zeros((8, 8), np.float32)
    q[:3] = rng.standard_normal((3, 8))
    valid = np.arange(8) < 3
    exists = np.ones(300, bool)
    js, jd, jt = jscoring.knn_topk_batch(
        jnp.asarray(q), jnp.asarray(valid), jnp.asarray(vecs), jnp.asarray(exists),
        "dot_product", 10,
    )
    ts, td, tt = tscoring.knn_topk_batch(t(q), t(valid), t(vecs), t(exists), "dot_product", 10)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    assert_topk_same(js, jd, ts.numpy(), td.numpy())
