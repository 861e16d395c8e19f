"""The port's int8 kNN scoring (ops/int8_knn.py) against the JAX
package's Pallas kernel (ops/pallas_knn.py) on the CPU: the plain
version against the Pallas kernel run in interpret mode, as the JAX
package itself runs it off the TPU. The hand-written CUDA kernel runs
only on the card; `chip_smoke.py` holds it against the plain version
there. Here the tests check that a non-CPU tensor never falls back."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from elasticsearch_tpu.ops import pallas_knn
from elasticsearch_tpu_torch.convert import quantized_from_reference
from elasticsearch_tpu_torch.ops import int8_knn

torch.set_num_threads(1)


def test_quantize_int8_identical():
    v = np.random.default_rng(0).standard_normal((100, 72)).astype(np.float32)
    for a, b in zip(int8_knn.quantize_int8(v), pallas_knn.quantize_int8(v)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("B,N,d", [(3, 512, 128), (8, 1024, 256), (33, 512, 128)])
def test_plain_matches_pallas_interpret(B, N, d):
    """Dot products within 1e-5 of max|dots| (the contraction is f32 in
    both, summed in another order)."""
    rng = np.random.default_rng(B)
    q, scales = pallas_knn.quantize_int8(rng.standard_normal((N, d)).astype(np.float32))
    queries = rng.standard_normal((B, d)).astype(np.float32)
    ref = np.asarray(
        pallas_knn.int8_dot_scores(
            jnp.asarray(queries), jnp.asarray(q), jnp.asarray(scales), interpret=True
        )
    )
    got = int8_knn.int8_dot_scores(
        torch.from_numpy(queries), torch.from_numpy(q), torch.from_numpy(scales)
    ).numpy()
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5 * np.abs(ref).max())


@pytest.mark.parametrize("sim", ["cosine", "dot_product", "max_inner_product"])
def test_search_topk_identical(sim):
    rng = np.random.default_rng(2)
    vectors = rng.standard_normal((1100, 96)).astype(np.float32)
    queries = rng.standard_normal((4, 96)).astype(np.float32)
    ref_qv = pallas_knn.QuantizedVectors(vectors, similarity=sim)
    rs, rd = ref_qv.search(queries, k=10, interpret=True)
    for qv in (
        int8_knn.QuantizedVectors(vectors, similarity=sim, device="cpu"),
        quantized_from_reference(ref_qv, device="cpu"),
    ):
        assert (qv.n, qv.n_pad, qv.d_pad) == (ref_qv.n, ref_qv.n_pad, ref_qv.d_pad)
        np.testing.assert_array_equal(qv.qvecs.numpy(), np.asarray(ref_qv.qvecs))
        s, d = qv.search(queries, k=10)
        np.testing.assert_array_equal(d.numpy(), np.asarray(rd))
        np.testing.assert_allclose(s.numpy(), np.asarray(rs), rtol=1e-5)
        assert qv.flops(4) == ref_qv.flops(4)


def test_padding_docs_excluded():
    rng = np.random.default_rng(3)
    vectors = rng.standard_normal((100, 16)).astype(np.float32)  # < DOC_BLOCK
    qv = int8_knn.QuantizedVectors(vectors, similarity="cosine", device="cpu")
    s, docs = qv.search(rng.standard_normal((1, 16)), k=50)
    assert (docs.numpy() < 100).all()
    ref = pallas_knn.QuantizedVectors(vectors, similarity="cosine")
    _, rdocs = ref.search(rng.standard_normal((1, 16)), k=500)
    assert np.asarray(rdocs).shape == (1, 100)
    assert qv.search(rng.standard_normal((1, 16)), k=500)[1].shape == (1, 100)


def test_int8_recall_vs_exact():
    rng = np.random.default_rng(1)
    n, d, k = 2000, 96, 10
    vectors = rng.standard_normal((n, d)).astype(np.float32)
    qv = int8_knn.QuantizedVectors(vectors, similarity="cosine", device="cpu")
    queries = rng.standard_normal((4, d)).astype(np.float32)
    _, docs = qv.search(queries, k=k)
    vn = vectors / np.linalg.norm(vectors, axis=1, keepdims=True)
    qn = queries / np.linalg.norm(queries, axis=1, keepdims=True)
    exact = (1 + qn @ vn.T) / 2
    for bi in range(4):
        top = set(np.argsort(-exact[bi])[:k].tolist())
        assert len(top & set(docs[bi].tolist())) / k >= 0.8


def test_cpu_tensors_take_the_plain_version_without_counting():
    before = int8_knn.int8_dot_scores.launches
    q = torch.ones(2, 16)
    v = torch.ones(5, 16, dtype=torch.int8)
    s = torch.full((5,), 0.5)
    out = int8_knn.int8_dot_scores(q, v, s)
    np.testing.assert_array_equal(out.numpy(), np.full((2, 5), 8.0, np.float32))
    assert int8_knn.int8_dot_scores.launches == before


def test_non_cpu_tensors_never_fall_back():
    """A tensor off the CPU launches the kernel or raises: here a `meta`
    tensor (no kernel) and a mixed-device call both raise."""
    before = int8_knn.int8_dot_scores.launches
    q = torch.empty(2, 16, device="meta")
    v = torch.empty(5, 16, dtype=torch.int8, device="meta")
    s = torch.empty(5, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        int8_knn.int8_dot_scores(q, v, s)
    with pytest.raises(ValueError, match="several devices"):
        int8_knn.int8_dot_scores(torch.ones(2, 16), v, s)
    assert int8_knn.int8_dot_scores.launches == before


def test_cuda_without_a_card_raises():
    """The entry point defaults to the card; without one it raises
    instead of quietly running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the no-card path does not apply")
    vectors = np.random.default_rng(4).standard_normal((10, 16)).astype(np.float32)
    with pytest.raises((RuntimeError, AssertionError)):
        int8_knn.QuantizedVectors(vectors)
    assert int8_knn.int8_dot_scores.launches == 0


def test_kernel_source_and_build_flags():
    """What the build compiles: the sm_90a CUDA source with a C entry
    point taking the stream, returning the launch error."""
    src = int8_knn.SOURCE.read_text()
    assert 'extern "C" int es_int8_dot_scores' in src
    assert "cudaGetLastError" in src
    assert "pallas_knn.py:_score_kernel" in src
    assert "mma.sync.aligned.m16n8k16" in src
    assert "arch=compute_90a,code=sm_90a" in int8_knn.NVCC_FLAGS


def _f32_from_bits(*bits):
    return np.array(bits, np.uint32).view(np.float32)


def _split_cases():
    rng = np.random.default_rng(5)
    unit = rng.standard_normal((64, 768))
    unit /= np.linalg.norm(unit, axis=1, keepdims=True)
    n = 200_000
    return {
        "unit_768": unit,
        "standard_normal": rng.standard_normal(n),
        "spread_1e30": rng.choice([-1.0, 1.0], n) * 10.0 ** rng.uniform(-30, 30, n),
        "signed_zeros": np.array([0.0, -0.0]),
        # the smallest normal, the widest mantissa whose lo part stays a
        # normal bf16 (exponent -110), and the largest f32 that does not
        # round to a bf16 infinity
        "extremes": np.concatenate([
            _f32_from_bits(0x00800000, 0x80800000, 0x08FFFFFF, 0x88FFFFFF),
            _f32_from_bits(0x7F7F7FFF, 0xFF7F7FFF, 0x3F800001, 0xBF7FFFFF),
        ]),
    }


@pytest.mark.parametrize("case", sorted(_split_cases()))
def test_bf16x3_split_is_exact(case):
    """The kernel's query split: hi + mid + lo rebuilds every f32 bit for
    bit (zeros by value: -0.0 keeps its sign in hi, and -0.0 + 0.0 is
    +0.0), and each part is a bf16 value, so its products are exact."""
    x = torch.from_numpy(np.asarray(_split_cases()[case], np.float32))
    hi, mid, lo = int8_knn.bf16x3_split(x)
    assert hi.dtype == mid.dtype == lo.dtype == torch.bfloat16
    total = (hi.float() + mid.float()) + lo.float()
    assert torch.equal(total, x)
    nz = x != 0
    assert torch.equal(total[nz].view(torch.int32), x[nz].view(torch.int32))
    assert torch.equal(torch.signbit(hi.float()), torch.signbit(x))
    # the three parts in float64 sum to the same value: nothing was rounded
    assert torch.equal(hi.double() + mid.double() + lo.double(), x.double())


@pytest.mark.parametrize("d", [16, 208, 768])
def test_three_pass_product_matches_float64(d):
    """What the kernel computes, on the CPU: three products of bf16 query
    parts by the int8 rows (each bf16 product exact in f32), summed in
    f32, then scaled; within 1e-6 of max|dots| of a float64 product."""
    rng = np.random.default_rng(d)
    v, scales = int8_knn.quantize_int8(rng.standard_normal((4096, d)).astype(np.float32))
    q = torch.from_numpy(rng.standard_normal((32, v.shape[1])).astype(np.float32))
    vt = torch.from_numpy(v).to(torch.bfloat16)
    s = torch.from_numpy(scales)
    dots = sum(part.float() @ vt.float().T for part in reversed(int8_knn.bf16x3_split(q)))
    got = dots * s[None, :]
    exact = (q.double() @ torch.from_numpy(v).double().T) * s.double()[None, :]
    assert float((got.double() - exact).abs().max()) <= 1e-6 * float(exact.abs().max())


@pytest.mark.parametrize(
    "B,d,qb",
    [(32, 768, 32), (1, 768, 8), (9, 768, 16), (70, 384, 32), (9, 4096, 8), (3, 4800, 8)],
)
def test_query_chunk_fits_shared_memory(B, d, qb):
    """Queries per block: the smallest variant that holds B, else the
    largest whose three bf16 panels fit a Hopper block's shared memory."""
    assert int8_knn.query_chunk(B, d) == qb
    assert int8_knn.query_smem_bytes(qb, d) <= int8_knn.SMEM_LIMIT


def test_query_chunk_rejects_too_wide_vectors():
    with pytest.raises(ValueError, match="too wide"):
        int8_knn.query_chunk(1, 4816)
