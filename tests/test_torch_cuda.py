"""The port's hand-written CUDA kernel against its plain version, on the
card. Every test here carries the `cuda` marker, needs an NVIDIA GPU and
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
