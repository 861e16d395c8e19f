"""The port's IVF ops (ops/ivf.py) against the JAX package's, on the CPU.

k-means and the cluster-major layout are held to the reference's on a
seeded mixture of well-separated Gaussian blobs: the same assignment,
starts, counts and permutation, centroids within rtol 1e-5 (f32 sums in
another order), the same cluster count after the splits. Two port
builds from one seed are bit-identical. The probe is held to the
reference's on ONE shared index (the reference's layout carried over by
`convert.ivf_index_from_reference`), so k-means cannot hide a probe
fault: every similarity, f32/f16/int8 rows, with and without a
candidate mask, B in {1, 8, 13, 32} (the QCHUNK path and the
single-chunk path), on a corpus with duplicate rows, whose exact ties
the reference breaks by the lowest cluster-major slot. Scores agree
within rtol 1e-5 and docs position by position; inside a run of scores
tied within rtol the docs agree as a set.
"""

import functools

import numpy as np
import pytest
import torch

from elasticsearch_tpu.ops import ivf as jivf
from elasticsearch_tpu_torch.convert import ivf_index_from_reference
from elasticsearch_tpu_torch.ops import ivf

torch.set_num_threads(1)

RTOL = 1e-5
DIMS = 32
SIMS = ("cosine", "dot_product", "max_inner_product", "l2_norm")


def blobs(n, n_centers, seed, noise=0.05, dups=0):
    """n rows around n_centers far-apart centers; `dups` of them repeat
    earlier rows exactly (duplicate vectors tie exactly in the probe)."""
    rng = np.random.default_rng(seed)
    centers = 4.0 * rng.normal(size=(n_centers, DIMS))
    asg = rng.integers(0, n_centers, size=n)
    v = (centers[asg] + noise * rng.normal(size=(n, DIMS))).astype(np.float32)
    if dups:
        src = rng.choice(n - dups, size=dups, replace=False)
        v[n - dups:] = v[src]
    return v


def prepared(v, similarity):
    """The rows an index is built over: unit rows for cosine and
    dot_product (as the mapping stores them), raw rows of norm about 1
    otherwise (l2_norm's |q|² + |v|² - 2 q·v loses digits to
    cancellation in proportion to the norms, in both packages alike)."""
    if similarity in ("cosine", "dot_product"):
        return (v / np.linalg.norm(v, axis=1, keepdims=True)).astype(np.float32)
    return (v / (4.0 * np.sqrt(DIMS))).astype(np.float32)


@pytest.mark.parametrize("n,n_centers,nlist,seed", [
    (2000, 200, 16, 1), (3000, 300, 40, 2), (4000, 400, 64, 3),
])
def test_kmeans_and_layout_match_reference(n, n_centers, nlist, seed):
    """Tight blobs, several per cluster, so every cluster boundary runs
    through empty space: a centroid that differs in the last ulp cannot
    move a row to another cluster."""
    v = prepared(blobs(n, n_centers, seed, noise=0.01), "cosine")
    rc, ra = jivf.kmeans(v, nlist, seed=seed)
    pc, pa = ivf.kmeans(v, nlist, seed=seed, device="cpu")
    assert pc.shape == rc.shape  # the same cluster count after splits
    np.testing.assert_array_equal(pa, ra)
    np.testing.assert_allclose(pc, rc, rtol=RTOL, atol=1e-6)
    ref = jivf.IvfSegmentIndex(v, "cosine", nlist, seed)
    got = ivf.IvfSegmentIndex(v, "cosine", nlist, seed, device="cpu")
    assert (got.nlist, got.cmax, got.n, got.dims) == (ref.nlist, ref.cmax, ref.n, ref.dims)
    for name in ("starts", "counts", "perm", "vecs_flat"):
        np.testing.assert_array_equal(getattr(got, name).numpy(), np.asarray(getattr(ref, name)))
    assert got.nbytes == ref.nbytes


@pytest.mark.parametrize("similarity,quantized", [
    ("cosine", False), ("cosine", True), ("l2_norm", False), ("max_inner_product", True),
])
def test_two_port_builds_are_bit_identical(similarity, quantized):
    v = prepared(blobs(2500, 20, 7, noise=0.5), similarity)
    a = ivf.IvfSegmentIndex(v, similarity, 24, 42, quantized=quantized, device="cpu")
    b = ivf.IvfSegmentIndex(v, similarity, 24, 42, quantized=quantized, device="cpu")
    for name in ("centroids", "starts", "counts", "perm", "vecs_flat", "v2_flat",
                 "qvecs_flat", "scales_flat"):
        x, y = getattr(a, name), getattr(b, name)
        assert (x is None) == (y is None), name
        if x is not None:
            assert torch.equal(x, y), name


@functools.lru_cache(maxsize=None)
def shared_index(similarity, rows):
    """(reference index, port index over the same layout, corpus) for one
    similarity and row storage (f32, f16 or int8)."""
    v = prepared(blobs(1800, 12, 5, noise=0.6, dups=120), similarity)
    if rows == "f16":
        v = v.astype(np.float16)
    ref = jivf.IvfSegmentIndex(v, similarity, 16, 9, quantized=rows == "int8")
    return ref, ivf_index_from_reference(ref, device="cpu"), v


def same_rows(rs, rd, gs, gd, what):
    """Per row: scores within RTOL (-inf padding equal), docs position
    by position, a run of reference scores tied within RTOL as a set."""
    assert gs.shape == rs.shape and gd.shape == rd.shape, what
    np.testing.assert_allclose(gs, rs, rtol=RTOL, atol=0, err_msg=what)
    for b in range(rs.shape[0]):
        i = 0
        while i < rs.shape[1]:
            j = i + 1
            while j < rs.shape[1] and np.isclose(rs[b, j], rs[b, j - 1], rtol=RTOL, atol=0):
                j += 1
            assert set(gd[b, i:j]) == set(rd[b, i:j]), f"{what}: row {b} ranks {i}-{j - 1}"
            i = j


@pytest.mark.parametrize("B", [1, 8, 13, 32])
@pytest.mark.parametrize("masked", [False, True], ids=["all", "cand"])
@pytest.mark.parametrize("rows", ["f32", "f16", "int8"])
@pytest.mark.parametrize("similarity", SIMS)
def test_probe_matches_reference_on_shared_index(similarity, rows, masked, B):
    ref, got, v = shared_index(similarity, rows)
    rng = np.random.default_rng(B)
    picks = rng.choice(len(v), size=B, replace=False)
    q = (v[picks].astype(np.float32) + 0.05 * rng.normal(size=(B, DIMS))).astype(np.float32)
    valid = np.ones(B, bool)
    if B > 1:
        valid[-1] = False  # a padded row of a bucket
    cand = rng.random(ref.n) < 0.7 if masked else None
    quant = rows == "int8"
    rs, rd = jivf.ann_topk_batch(ref, q, valid, cand, nprobe=3, k=20, quantized=quant)
    gs, gd = ivf.ann_topk_batch(
        got, torch.from_numpy(q), torch.from_numpy(valid),
        None if cand is None else torch.from_numpy(cand), nprobe=3, k=20, quantized=quant,
    )
    rs, rd = np.asarray(rs), np.asarray(rd)
    assert gs.dtype == torch.float32
    same_rows(rs, rd, gs.numpy(), gd.numpy(), f"{similarity}/{rows}/{B}")
    if B > 1:
        assert not np.isfinite(gs.numpy()[-1]).any() and (gd.numpy()[-1] == 0).all()


def test_duplicate_rows_tie_by_lowest_slot():
    """Duplicates score bit-identically; the probe keeps them in slot
    (cluster-major) order, as lax.top_k keeps the lowest index."""
    ref, got, v = shared_index("cosine", "f32")
    q = v[-120:-100]  # rows that have an exact duplicate earlier
    valid = np.ones(len(q), bool)
    rs, rd = jivf.ann_topk_batch(ref, q, valid, None, nprobe=2, k=6)
    gs, gd = ivf.ann_topk_batch(got, torch.from_numpy(np.ascontiguousarray(q)),
                                torch.from_numpy(valid), None, nprobe=2, k=6)
    gs, gd = gs.numpy(), gd.numpy()
    assert (gs[:, 0] == gs[:, 1]).any()  # the duplicate pair ties exactly
    np.testing.assert_array_equal(gd, np.asarray(rd))
    slot_of = np.empty(got.n, np.int64)
    slot_of[got.perm.numpy()[: got.n]] = np.arange(got.n)
    for b in range(len(q)):
        for j in range(gs.shape[1] - 1):
            if gs[b, j] == gs[b, j + 1]:
                assert slot_of[gd[b, j]] < slot_of[gd[b, j + 1]]


@pytest.mark.parametrize("n", [1, 15, 16, 100, 4096, 1_000_000])
def test_auto_nlist_and_estimates_match_reference(n):
    assert ivf.auto_nlist(n) == jivf.auto_nlist(n)
    for nlist, quant, item in ((ivf.auto_nlist(n), False, 4), (2000, True, 2), (7, True, 4)):
        assert ivf.IvfSegmentIndex.estimate_nbytes(n, 768, nlist, quant, itemsize=item) == (
            jivf.IvfSegmentIndex.estimate_nbytes(n, 768, nlist, quant, itemsize=item))
    for args in ((1, 2000, 8, 750, 768), (32, 2000, 32, 750, 768), (13, 16, 3, 120, 32)):
        assert ivf.ann_flops(*args) == jivf.ann_flops(*args)
