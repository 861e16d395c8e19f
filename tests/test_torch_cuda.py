"""The port's hand-written CUDA kernel against its plain version, and
the served routes (match, knn, bool, multi_match, filtered bool, hybrid
RRF, sparse_vector, aggregations, IVF kNN, sorts, phrase and the other
remaining query nodes, rescore) against the numpy backend, segments
built on the card (ops/index_build.py) against the host build, a node
with a data path reopened after a crash (its tail replayed into a build
on the card) against the numpy backend, and `python -m
elasticsearch_tpu_torch check`, a two-node cluster (replication,
failover, peer recovery) against the numpy backend, and the JAX
package's tests of exact float equality that the card's float atomics
used to break, on the same bodies bit for bit and twice over, on the
card. Every test here carries the `cuda` marker, needs an NVIDIA GPU and
nvcc, decides so inside its fixture and skips without them. The module
imports neither jax nor the JAX package, so on a machine with the card
it also runs where only PyTorch is installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q
"""

import time

import numpy as np
import pytest
import torch

from elasticsearch_tpu_torch.ops import int8_knn
from scatter_cases import (SCATTER_KINDS, applied, hard_scatter_case, impact_pass_case, parent_chunk_pass,
                           parent_impact_pass, tile_pass_case)

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


def _scatter_inputs(R, C, n_tiles, seed):
    """int32 targets [R, n_tiles*128], distinct within each tile (invalid
    slots aim at the overflow column C-1 with +0.0 and inc 0; tile 2
    repeats tile 0, tile 1 is empty), f32 values of mixed signs and
    magnitudes, int32 increments, nonzero starting acc and cnt."""
    rng = np.random.default_rng(seed)
    S = n_tiles * 128
    tgt = np.full((R, S), C - 1, np.int32)
    src = np.zeros((R, S), np.float32)
    for r in range(R):
        for ti in range(n_tiles):
            if ti == 1:
                continue
            n_valid = int(rng.integers(1, min(128, C - 1) + 1))
            slots = rng.choice(128, size=n_valid, replace=False)
            tgt[r, ti * 128 + slots] = rng.choice(C - 1, size=n_valid, replace=False)
            src[r, ti * 128 + slots] = rng.standard_normal(n_valid) * 10.0 ** rng.integers(-3, 4, n_valid)
        if n_tiles > 2:
            tgt[r, 256:384], src[r, 256:384] = tgt[r, :128], src[r, :128]
    inc = (tgt != C - 1).astype(np.int32)
    acc = rng.standard_normal((R, C)).astype(np.float32)
    acc[:, C - 1] = 0.0
    cnt = rng.integers(0, 5, size=(R, C)).astype(np.int32)
    cnt[:, C - 1] = 0
    return [torch.from_numpy(x) for x in (acc, cnt, tgt, src, inc)]


def _kind_inputs(kind, R, C, S, seed):
    acc, cnt, tgt, src, inc = hard_scatter_case(kind, R, C, S, seed)
    return [torch.from_numpy(x) for x in (acc, cnt, tgt, src, inc)], applied(tgt, src, inc, C)


@pytest.mark.parametrize(
    "kind,R,C,S,with_cnt",
    [
        ("tiles", 1, 300, 512, False), ("tiles", 1, 300, 512, True), ("tiles", 3, 129, 768, True),
        ("tiles", 32, 701, 384, True),
        # several buckets a row, rows whose starts are not 16-byte aligned
        ("tiles", 2, 200_003, 5120, True), ("tiles", 5, 130_001, 1536, False),
        ("tiles", 1, 1_000_001, 8192, True),
        # the hard inputs; a bucket of more slots than one piece (C = 2)
        *[(k, R, C, S, True) for k in SCATTER_KINDS for R, C, S in ((1, 300, 16_384), (32, 5_003, 4096))],
        ("all_valid", 1, 2, 10_240, True), ("one_cell_every_tile", 1, 1_000_001, 262_144, False),
        # one launch (at most 2,048 slots a row), and a row past one window
        # of 2^25 slots, one cell in every tile of both windows
        ("repeat_in_tile", 32, 1_000_001, 2048, True), ("all_valid", 1, 2, 1024, False),
        ("one_cell_every_tile", 1, 1_000_001, (1 << 25) + (1 << 17), True),
        # route (b)'s and (f)'s full shapes
        ("sparse", 32, 1_000_001, 32_768, False), ("sparse", 32, 1_000_001, 65_536, True),
    ],
)
def test_ordered_scatter_matches_plain_bit_for_bit(cuda, kind, R, C, S, with_cnt):
    """csrc/ordered_scatter.cu against its plain version on the CPU
    (scatter_add_, slot order) over the slots it applies: equal bits,
    twice, one launch each."""
    from elasticsearch_tpu_torch.ops import ordered_scatter as osc

    if kind == "tiles":
        acc, cnt, tgt, src, inc = _scatter_inputs(R, C, S // 128, R * 1000 + C)
        ref = (tgt, src, inc)
    else:
        (acc, cnt, tgt, src, inc), ref = _kind_inputs(kind, R, C, S, R * 1000 + C)
        ref = [torch.from_numpy(x) for x in ref]
    want, want_cnt = osc.ordered_scatter_add_plain(acc.clone(), ref[0], ref[1], cnt.clone(), ref[2])
    for _ in range(2):
        a, c = acc.to(cuda), cnt.to(cuda)
        before = osc.ordered_scatter_add.launches
        if with_cnt:
            osc.ordered_scatter_add(a, tgt.to(cuda), src.to(cuda), c, inc.to(cuda))
        else:
            osc.ordered_scatter_add(a, tgt.to(cuda), src.to(cuda))
        torch.cuda.synchronize(cuda)
        assert osc.ordered_scatter_add.launches == before + 1
        np.testing.assert_array_equal(a.cpu().numpy().view(np.int32), want.numpy().view(np.int32))
        np.testing.assert_array_equal(c.cpu().numpy(), (want_cnt if with_cnt else cnt).numpy())


def test_ordered_scatter_makes_no_host_sync(cuda):
    """A launch at route (f)'s shape under torch's sync debug mode "error":
    the wrapper sizes its scratch and grids from the shapes alone and
    never waits for the card."""
    from elasticsearch_tpu_torch.ops import ordered_scatter as osc

    (acc, cnt, tgt, src, inc), ref = _kind_inputs("sparse", 32, 1_000_001, 65_536, 3)
    a, c, t, s, i = (x.to(cuda) for x in (acc, cnt, tgt, src, inc))
    torch.cuda.synchronize(cuda)
    torch.cuda.set_sync_debug_mode("error")
    try:
        osc.ordered_scatter_add(a, t, s, c, i)
        osc.ordered_scatter_add(a[0], t[0], s[0])  # one row, as score_tiles launches
        osc.ordered_scatter_add(a[1], t[1, :2048], s[1, :2048])  # one row, one launch
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize(cuda)
    want = osc.ordered_scatter_add_plain(acc.clone(), *[torch.from_numpy(x) for x in ref[:2]], cnt.clone(),
                                         torch.from_numpy(ref[2]))[0]
    osc.ordered_scatter_add_plain(want[0], *[torch.from_numpy(x[0]) for x in ref[:2]])
    osc.ordered_scatter_add_plain(want[1], *[torch.from_numpy(x[1, :2048].copy()) for x in ref[:2]])
    assert torch.equal(a.cpu().view(torch.int32), want.view(torch.int32))


def test_ordered_scatter_concurrent_launches_of_other_widths(cuda):
    """Threads launching at once with slices of other sizes, as a
    fan-out over segments of different sizes does: every launch is
    accepted (the kernel's shared-memory limit is not set per launch,
    where one thread's smaller limit could refuse another's launch) and
    every result is the plain version's."""
    from concurrent.futures import ThreadPoolExecutor

    from elasticsearch_tpu_torch.ops import ordered_scatter as osc

    shapes = [(1, 300, 4), (2, 200_003, 8), (4, 5_001, 6), (1, 1_000_001, 4)]
    cases = [_scatter_inputs(R, C, nt, seed) for seed, (R, C, nt) in enumerate(shapes)]
    wants = [osc.ordered_scatter_add_plain(acc.clone(), tgt, src, cnt.clone(), inc)[0].view(torch.int32)
             for acc, cnt, tgt, src, inc in cases]
    on_card = [[x.to(cuda) for x in c] for c in cases]
    wants = [w.to(cuda) for w in wants]

    def run(i):
        acc, cnt, tgt, src, inc = on_card[i % len(cases)]
        same = []
        for _ in range(25):
            a, c = acc.clone(), cnt.clone()
            osc.ordered_scatter_add(a, tgt, src, c, inc)
            same.append(torch.equal(a.view(torch.int32), wants[i % len(cases)]))
        return same

    with ThreadPoolExecutor(8) as pool:
        results = list(pool.map(run, range(8)))
    torch.cuda.synchronize(cuda)
    assert all(all(r) for r in results)


def test_int8_concurrent_launches_of_other_widths(cuda):
    """Two threads launching the int8 kernel at once with query panels of
    other sizes (d of 128 and 4096, the same 8-query variant, and a
    32-query one beside them), several rounds: every launch is accepted
    (each variant's shared-memory limit is set once to the card's
    maximum, not to a launch's own size, where one thread's smaller limit
    could refuse another's launch) and every result is within 1e-5 of
    max|dots| of the plain version's."""
    from concurrent.futures import ThreadPoolExecutor

    shapes = [(8, 2000, 128), (8, 700, 4096), (32, 3000, 768), (16, 513, 208)]
    cases = [_inputs(B, N, d, 500 + i, cuda) if d % 128 == 0 else _raw_inputs(B, N, d, 500 + i, cuda)
             for i, (B, N, d) in enumerate(shapes)]
    wants = [int8_knn.int8_dot_scores_plain(*c) for c in cases]
    torch.cuda.synchronize(cuda)

    def run(i):
        errs = []
        for _ in range(20):
            for j in (i, i + 2):
                out = int8_knn.int8_dot_scores(*cases[j])
                errs.append(float((out - wants[j]).abs().max()) / float(wants[j].abs().max()))
        return errs

    with ThreadPoolExecutor(2) as pool:
        errs = [e for r in pool.map(run, range(2)) for e in r]
    torch.cuda.synchronize(cuda)
    assert len(errs) == 80 and max(errs) <= 1e-5, max(errs)


def test_ordered_scatter_checks_its_inputs(cuda):
    from elasticsearch_tpu_torch.ops import ordered_scatter as osc

    acc, cnt, tgt, src, inc = (x.to(cuda) for x in _scatter_inputs(2, 300, 3, 5))
    with pytest.raises(TypeError):
        osc.ordered_scatter_add(acc, tgt.long(), src)
    with pytest.raises(ValueError, match="whole 128-slot tiles"):
        osc.ordered_scatter_add(acc, tgt[:, :200].contiguous(), src[:, :200].contiguous())
    with pytest.raises(ValueError, match="contiguous"):
        osc.ordered_scatter_add(acc, tgt.t().contiguous().t(), src)
    with pytest.raises(ValueError, match="several devices"):
        osc.ordered_scatter_add(acc, tgt.cpu(), src)


# the cell's width: MS MARCO passage's 8,841,823 docs and the overflow column
MSMARCO_CELLS = 8_841_824
RAGGED32 = (10_784, 0, 511, 512, 513, 1_025, 16, 17) + tuple(range(0, 12_000, 500))
TILE_PASSES = [
    # (name, C, rows' tiles): the cell's median second pass, 32 ragged rows at
    # its width, one row across two windows, 32 rows across windows, one launch
    ("cell", MSMARCO_CELLS, (10_784,)),
    ("cell_ragged32", MSMARCO_CELLS, RAGGED32),
    ("cell_two_windows", MSMARCO_CELLS, (30_000,)),
    ("ragged32_windows", 100_001, tuple(range(0, 3_200, 100))),
    ("one_launch", 1_000_001, (16, 0, 3, 16)),
]


@pytest.mark.parametrize("with_cnt", [False, True])
@pytest.mark.parametrize("name,C,lengths", TILE_PASSES)
def test_bm25_tile_add_matches_plain_and_parent(cuda, name, C, lengths, with_cnt):
    """csrc/ordered_scatter.cu's BM25 tile add, one call a pass, against
    its plain version on the CPU and against the parent's path on the
    card (PyTorch's gathers and formula over 512-tile chunks, then the
    ordered scatter-add), from the same nonzero accumulators: equal bits
    and counts, twice; its launches are the layout's windows."""
    from elasticsearch_tpu_torch.ops import ordered_scatter as osc
    from elasticsearch_tpu_torch.ops import scoring

    R = len(lengths)
    doc_ids, tfs, inv, tiles, weights = tile_pass_case(C, lengths, C + R)
    rng = np.random.default_rng(R)
    acc0 = torch.from_numpy(rng.random((R, C), np.float32))
    acc0[:, -1] = 0.0
    cnt0 = torch.from_numpy(rng.integers(0, 3, (R, C)).astype(np.int32)) if with_cnt else None
    host = [torch.from_numpy(x) for x in (doc_ids, tfs, inv)]
    want, want_cnt = scoring.bm25_tile_add_plain(acc0.clone(), None if cnt0 is None else cnt0.clone(), *host,
                                                 tiles, weights)
    d, f, iv = (x.to(cuda) for x in host)
    lay = osc.tile_layout(C, list(lengths))
    assert (lay.windows >= 2) == name.endswith("windows") and (lay.window == 0) == (name == "one_launch")
    assert lay.scratch_words <= R * C
    for _ in range(2):
        a, c = acc0.to(cuda), None if cnt0 is None else cnt0.to(cuda)
        before = osc.launch_tile_add.launches
        assert scoring.bm25_tile_add(a, c, d, f, iv, tiles, weights) == lay.windows
        torch.cuda.synchronize(cuda)
        assert osc.launch_tile_add.launches == before + lay.windows
        assert torch.equal(a.cpu().view(torch.int32), want.view(torch.int32))
        assert c is None or torch.equal(c.cpu(), want_cnt)
    a, c = acc0.to(cuda), None if cnt0 is None else cnt0.to(cuda)
    parent_chunk_pass(a, c, d, f, iv, tiles, weights)
    torch.cuda.synchronize(cuda)
    assert torch.equal(a.cpu().view(torch.int32), want.view(torch.int32))
    assert c is None or torch.equal(c.cpu(), want_cnt)


def test_bm25_tile_add_makes_no_host_sync(cuda):
    """Passes across two windows, in one window and in one launch under
    torch's sync debug mode "error": the plan goes up pinned and
    asynchronously, and the layout comes from the tile counts alone."""
    from elasticsearch_tpu_torch.ops import scoring

    C = 300_001
    doc_ids, tfs, inv, tiles, weights = tile_pass_case(C, (3_000, 0, 200, 16), 5)
    d, f, iv = (torch.from_numpy(x).to(cuda) for x in (doc_ids, tfs, inv))
    a = torch.zeros(4, C, device=cuda)
    c = torch.zeros(4, C, dtype=torch.int32, device=cuda)
    passes = [(tiles, weights), (tiles[1:], weights[1:]), ([tiles[3]], [weights[3]])]
    torch.cuda.synchronize(cuda)
    torch.cuda.set_sync_debug_mode("error")
    try:
        for tl, wl in passes:
            scoring.bm25_tile_add(a, c, d, f, iv, tl, wl)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    want, want_cnt = torch.zeros(4, C), torch.zeros(4, C, dtype=torch.int32)
    for tl, wl in passes:
        scoring.bm25_tile_add_plain(want, want_cnt, *(torch.from_numpy(x) for x in (doc_ids, tfs, inv)), tl, wl)
    assert torch.equal(a.cpu().view(torch.int32), want.view(torch.int32)) and torch.equal(c.cpu(), want_cnt)


def test_bm25_tile_add_checks_its_inputs(cuda):
    """No fallback: what the kernel does not take raises."""
    from elasticsearch_tpu_torch.ops import scoring

    doc_ids, tfs, inv, tiles, weights = tile_pass_case(1_001, (40, 3), 9)
    d, f, iv = (torch.from_numpy(x).to(cuda) for x in (doc_ids, tfs, inv))
    a = torch.zeros(2, 1_001, device=cuda)
    with pytest.raises(TypeError):
        scoring.bm25_tile_add(a, None, d.long(), f, iv, tiles, weights)
    with pytest.raises(ValueError, match="one CUDA device"):
        scoring.bm25_tile_add(a, None, d.cpu(), f, iv, tiles, weights)
    with pytest.raises(ValueError, match="inv_norm"):
        scoring.bm25_tile_add(a, None, d, f, iv[:-1], tiles, weights)
    with pytest.raises(ValueError, match="lists for 2 rows"):
        scoring.bm25_tile_add(a, None, d, f, iv, tiles * 2, weights * 2)


# the ELSER cell's mean pass (68,352 tiles a job) at its width, 32 ragged rows
# at that width, 32 rows across windows, one launch
IMPACT_PASSES = [
    ("cell", MSMARCO_CELLS, (68_352,)),
    ("cell_ragged32", MSMARCO_CELLS, RAGGED32),
    ("ragged32_windows", 100_001, tuple(range(0, 3_200, 100))),
    ("one_launch", 1_000_001, (16, 0, 3, 16)),
]


@pytest.mark.parametrize("name,C,lengths", IMPACT_PASSES)
@pytest.mark.parametrize("quantized", [False, True])
def test_impact_tile_add_matches_plain_and_parent(cuda, quantized, name, C, lengths):
    """csrc/ordered_scatter.cu's impact tile add, one call a pass, f32 and
    int8 impacts, against its plain version on the CPU and against the
    replaced 512-tile loop on the card (`parent_impact_pass`), from the
    same nonzero accumulators: equal bits and counts, twice; its launches
    are the layout's windows."""
    from elasticsearch_tpu_torch.ops import impact
    from elasticsearch_tpu_torch.ops import ordered_scatter as osc

    R = len(lengths)
    doc_ids, values, tiles, weights = impact_pass_case(C, lengths, C + R, quantized)
    rng = np.random.default_rng(R)
    acc0 = torch.from_numpy(rng.random((R, C), np.float32))
    acc0[:, -1] = 0.0
    cnt0 = torch.from_numpy(rng.integers(0, 3, (R, C)).astype(np.int32))
    host = [torch.from_numpy(x) for x in (doc_ids, values)]
    want, want_cnt = impact.impact_tile_add_plain(acc0.clone(), cnt0.clone(), *host, tiles, weights)
    d, v = (x.to(cuda) for x in host)
    lay = osc.tile_layout(C, list(lengths))
    assert (lay.windows >= 2) == (name in ("cell", "ragged32_windows")) and (lay.window == 0) == (name == "one_launch")
    for _ in range(2):
        a, c = acc0.to(cuda), cnt0.to(cuda)
        before = osc.launch_impact_add.launches
        assert impact.impact_tile_add(a, c, d, v, tiles, weights) == lay.windows
        torch.cuda.synchronize(cuda)
        assert osc.launch_impact_add.launches == before + lay.windows
        assert torch.equal(a.cpu().view(torch.int32), want.view(torch.int32))
        assert torch.equal(c.cpu(), want_cnt)
    a, c = acc0.to(cuda), cnt0.to(cuda)
    parent_impact_pass(a, c, d, v, tiles, weights)
    torch.cuda.synchronize(cuda)
    assert torch.equal(a.cpu().view(torch.int32), want.view(torch.int32))
    assert torch.equal(c.cpu(), want_cnt)


@pytest.mark.parametrize("quantized", [False, True])
def test_impact_score_pass_launches_the_kernel(cuda, quantized):
    """`ImpactScorer.score_pass` on the card is one `impact_tile_add` call
    a pass: it advances `launch_impact_add.launches` by the layout's
    windows, makes no host sync (torch's sync debug mode "error"), and
    matches the plain version on the CPU bit for bit."""
    from elasticsearch_tpu_torch.ops import impact
    from elasticsearch_tpu_torch.ops import ordered_scatter as osc

    C = 300_001
    lengths = (3_000, 0, 200, 16)
    doc_ids, values, tiles, weights = impact_pass_case(C, lengths, 5, quantized)
    sc = impact.ImpactScorer(doc_ids, values, C - 1, device=cuda)
    acc, cnt = sc.new_acc(4)
    passes = [(tiles, weights), (tiles[2:], weights[2:])]
    torch.cuda.synchronize(cuda)
    before = osc.launch_impact_add.launches
    torch.cuda.set_sync_debug_mode("error")
    try:
        launched = [sc.score_pass(acc, cnt, tl, wl) for tl, wl in passes]
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert launched == [osc.tile_layout(C, [len(x) for x in tl] + [0] * (4 - len(tl))).windows
                        for tl, _ in passes]
    assert osc.launch_impact_add.launches == before + sum(launched) and launched[0] >= 1
    want, want_cnt = torch.zeros(4, C), torch.zeros(4, C, dtype=torch.int32)
    for tl, wl in passes:
        impact.impact_tile_add_plain(want, want_cnt, torch.from_numpy(doc_ids), torch.from_numpy(values), tl, wl)
    assert torch.equal(acc.cpu().view(torch.int32), want.view(torch.int32)) and torch.equal(cnt.cpu(), want_cnt)


def test_impact_tile_add_checks_its_inputs(cuda):
    """No fallback: what the kernel does not take raises."""
    from elasticsearch_tpu_torch.ops import impact

    doc_ids, values, tiles, weights = impact_pass_case(1_001, (40, 3), 9, False)
    d, v = (torch.from_numpy(x).to(cuda) for x in (doc_ids, values))
    a = torch.zeros(2, 1_001, device=cuda)
    c = torch.zeros(2, 1_001, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="one CUDA device"):
        impact.impact_tile_add(a, c, d.cpu(), v, tiles, weights)
    with pytest.raises(ValueError, match="one CUDA device"):
        impact.impact_tile_add(a, c.cpu(), d, v, tiles, weights)
    with pytest.raises(TypeError, match="f32 or int8 impacts"):
        impact.impact_tile_add(a, c, d, v.half(), tiles, weights)
    with pytest.raises(TypeError):
        impact.impact_tile_add(a, c, d.long(), v, tiles, weights)
    with pytest.raises(TypeError):
        impact.impact_tile_add(a.double(), c, d, v, tiles, weights)
    with pytest.raises(ValueError, match="postings"):
        impact.impact_tile_add(a, c, d, v[:-1].contiguous(), tiles, weights)
    with pytest.raises(ValueError, match="lists for 2 rows"):
        impact.impact_tile_add(a, c, d, v, tiles * 2, weights * 2)


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
        assert isinstance(ex, TorchExecutor) and ex.device.type == cuda.type
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


def _sparse_pair(cuda, quant):
    """(torch IndexService on the card, numpy IndexService) over the same
    `sparse_vector` docs, 2 shards, two refreshes each."""
    from elasticsearch_tpu_torch.cluster.indices import IndexService

    mapping = {"properties": {"ml": {"type": "sparse_vector"}, "cat": {"type": "keyword"},
                              "qty": {"type": "integer"}, "day": {"type": "date"}}}
    rng = np.random.default_rng(12)
    vocab = [f"tok{i:02d}" for i in range(12)]
    docs = []
    for i in range(900):
        toks = rng.choice(vocab, size=int(rng.integers(2, 6)), replace=False)
        docs.append((str(i), {"ml": {str(t): float(np.round(rng.random() * 3 + 0.05, 4)) for t in toks},
                              "cat": f"c{i % 5}", "qty": int(rng.integers(0, 60)),
                              "day": 1_700_000_000_000 + int(rng.integers(0, 40)) * 86_400_000}))
    out = []
    for backend, device in (("torch", cuda), ("numpy", "cpu")):
        svc = IndexService(f"sp-{backend}", settings={"number_of_shards": 2, "search.backend": backend,
                                                      "sparse.quantization": quant},
                           mappings_json=mapping, device=device)
        for j, (doc_id, src) in enumerate(docs):
            svc.index_doc(doc_id, src)
            if j == len(docs) // 2:
                svc.refresh()
        svc.refresh()
        out.append(svc)
    return out, vocab, rng


@pytest.mark.parametrize("quant", ["int8", "none"])
def test_served_sparse_on_card_matches_numpy(cuda, quant):
    """Bare `sparse_vector` bodies on the card: fp32 (`none`, or
    `"exact": true` on an int8 index) hold the numpy backend's hits by
    ids (tie runs within rtol 1e-5 as sets) and scores within rtol 1e-5;
    the int8 column holds recall@10 >= 0.95."""
    from elasticsearch_tpu_torch.search.executor_torch import TorchExecutor

    (svc, oracle), vocab, rng = _sparse_pair(cuda, quant)
    try:
        rec = []
        for i in range(12):
            qv = {str(t): float(np.round(rng.random() * 2 + 0.1, 4))
                  for t in rng.choice(vocab, size=int(rng.integers(2, 5)), replace=False)}
            body = {"query": {"sparse_vector": {"field": "ml", "query_vector": qv}}, "size": 10}
            ref = oracle.search(body)
            exact = {**body, "exact": True}
            got = svc.search(exact)
            rel = got["hits"]["total"]["relation"]
            if rel == "eq":
                assert got["hits"]["total"] == ref["hits"]["total"]
            else:  # pruned tiles: the total is a lower bound
                assert rel == "gte" and got["hits"]["total"]["value"] <= ref["hits"]["total"]["value"]
            _same_hits_only(ref, got)
            if quant == "int8":
                want = {h["_id"] for h in ref["hits"]["hits"]}
                have = {h["_id"] for h in svc.search(body)["hits"]["hits"]}
                rec.append(len(want & have) / max(len(want), 1))
        if rec:
            assert np.mean(rec) >= 0.95, rec
        ex = svc._executor(svc.shards[0])
        assert isinstance(ex, TorchExecutor) and ex.device.type == cuda.type
        assert svc._batcher.stats["sparse_jobs"] > 0
    finally:
        svc.close()
        oracle.close()


def _same_hits_only(ref, got):
    rh, gh = ref["hits"]["hits"], got["hits"]["hits"]
    rs = [h["_score"] for h in rh]
    assert len(gh) == len(rh)
    np.testing.assert_allclose([h["_score"] for h in gh], rs, rtol=1e-5, atol=1e-6)
    i = 0
    while i < len(rh):
        j = i + 1
        while j < len(rh) and np.isclose(rs[j], rs[j - 1], rtol=1e-5, atol=0):
            j += 1
        assert {h["_id"] for h in gh[i:j]} == {h["_id"] for h in rh[i:j]}
        i = j


def test_served_aggs_on_card_match_numpy(cuda):
    """bench.py's `cold_agg` and `repeated_agg` shapes and the other
    device-compiled trees on the card: the aggregations equal the numpy
    backend's, and they went through the device plan."""
    from elasticsearch_tpu_torch.search import aggs_device

    (svc, oracle), vocab, _rng = _sparse_pair(cuda, "int8")
    try:
        q = {"sparse_vector": {"field": "ml", "query_vector": {vocab[0]: 1.0, vocab[3]: 0.5}}}
        bodies = [
            {"size": 0, "request_cache": False, "query": q,
             "aggs": {"by_day": {"date_histogram": {"field": "day", "fixed_interval": "1d"}},
                      "cats": {"terms": {"field": "cat"}}, "pop": {"stats": {"field": "qty"}}}},
            {"size": 0, "aggs": {"a": {"avg": {"field": "qty"}}}},
            {"size": 0, "aggs": {"r": {"range": {"field": "qty", "ranges": [{"to": 20}, {"from": 20}]},
                                       "aggs": {"s": {"sum": {"field": "qty"}}}},
                                 "p": {"percentiles": {"field": "qty", "percents": [10, 90]}},
                                 "f": {"filter": {"term": {"cat": "c1"}}}}},
        ]
        before = aggs_device.stats_snapshot()["device_routed"]
        for body in bodies:
            got, ref = svc.search(dict(body)), oracle.search(dict(body))
            assert got["aggregations"] == ref["aggregations"], body
            assert got["hits"]["total"] == ref["hits"]["total"]
        assert aggs_device.stats_snapshot()["device_routed"] >= before + 2 * len(bodies)
    finally:
        svc.close()
        oracle.close()


@pytest.mark.parametrize("quant", ["none", "int8"])
def test_served_ivf_on_card(cuda, monkeypatch, quant):
    """IVF kNN on the card: two builds from one seed are bit-identical,
    the served pages hold recall@10 >= 0.95 against the numpy backend,
    every segment was probed and none fell back to the exact path."""
    from elasticsearch_tpu_torch.cluster.indices import IndexService
    from elasticsearch_tpu_torch.ops import ivf
    from elasticsearch_tpu_torch.search import ann as ann_mod

    monkeypatch.setenv(ann_mod.ANN_MIN_DOCS_ENV, "64")
    rng = np.random.default_rng(21)
    centers = rng.normal(size=(24, 32))
    v = centers[rng.integers(0, 24, size=3000)] + 0.5 * rng.normal(size=(3000, 32))
    v = (v / np.linalg.norm(v, axis=1, keepdims=True)).astype(np.float32)
    a = ivf.IvfSegmentIndex(v, "cosine", 32, 7, quantized=True, device=cuda)
    b = ivf.IvfSegmentIndex(v, "cosine", 32, 7, quantized=True, device=cuda)
    for name in ("centroids", "perm", "counts", "qvecs_flat"):
        assert torch.equal(getattr(a, name), getattr(b, name)), name
    mapping = {"properties": {"vec": {"type": "dense_vector", "dims": 32, "similarity": "cosine"}}}
    out = []
    for backend, device, extra in (("torch", cuda, {"knn.type": "ivf", "knn.nlist": 32,
                                                    "knn.quantization": quant}),
                                   ("numpy", "cpu", {})):
        svc = IndexService(f"ivf-{backend}", settings={"number_of_shards": 2, "search.backend": backend, **extra},
                           mappings_json=mapping, device=device)
        for i, row in enumerate(v):
            svc.index_doc(str(i), {"vec": [float(x) for x in row]})
            if i == 1500:
                svc.refresh()
        svc.refresh()
        out.append(svc)
    svc, oracle = out
    try:
        before = ann_mod.stats_snapshot()
        rec = []
        for qv in v[rng.choice(len(v), size=16, replace=False)]:
            body = {"knn": {"field": "vec", "query_vector": [float(x) for x in qv], "k": 10,
                            "num_candidates": 100}, "size": 10}
            want = {h["_id"] for h in oracle.search(body)["hits"]["hits"]}
            rec.append(len(want & {h["_id"] for h in svc.search(body)["hits"]["hits"]}) / len(want))
        after = ann_mod.stats_snapshot()
        assert np.mean(rec) >= 0.95, rec
        assert after["ann_searches"] > before["ann_searches"]
        assert after["exact_fallbacks"] == before["exact_fallbacks"]
    finally:
        svc.close()
        oracle.close()


def test_served_sort_on_card_matches_numpy(cuda, monkeypatch):
    """A single numeric or date sort key collects on the card: ids, sort
    values and totals equal the numpy backend's, search_after included."""
    svc, oracle = _served_pair(monkeypatch, cuda)
    try:
        for sort in ([{"n": "desc"}], [{"day": "asc"}], [{"n": "asc"}, {"day": "desc"}]):
            body = {"query": {"match": {"body": "ant bee"}}, "sort": sort, "size": 12}
            for _ in range(3):
                got, ref = svc.search(dict(body)), oracle.search(dict(body))
                assert got["hits"]["total"] == ref["hits"]["total"]
                pages = [[(h["_id"], h["sort"]) for h in r["hits"]["hits"]] for r in (got, ref)]
                assert pages[0] == pages[1], sort
                if not pages[1]:
                    break
                body["search_after"] = pages[1][-1][1]
    finally:
        svc.close()
        oracle.close()


NODE_BODIES = [
    {"query": {"match_phrase": {"body": "ant bee"}}},
    {"query": {"match_phrase": {"body": {"query": "ant cat", "slop": 2}}}},
    {"query": {"multi_match": {"query": "ant bee", "fields": ["title^2", "body"], "type": "phrase"}}},
    {"query": {"prefix": {"body": "ca"}}},
    {"query": {"wildcard": {"body": "d?g"}}},
    {"query": {"fuzzy": {"body": {"value": "fax", "fuzziness": 1}}}},
    {"query": {"bool": {"must": [{"match": {"body": "cat"}}], "filter": [{"match_phrase": {"body": "ant bee"}}]}}},
    {"query": {"function_score": {"query": {"match": {"body": "eel"}},
                                  "functions": [{"field_value_factor": {"field": "n", "factor": 0.1,
                                                                        "modifier": "ln1p"}}]}}},
]


def test_served_nodes_on_card_match_numpy(cuda, monkeypatch):
    """Phrase (device conjunction, host position verify), expanded terms
    (one device pass) and a host-routed node, alone and as a filter."""
    from elasticsearch_tpu_torch.search import executor_torch

    svc, oracle = _served_pair(monkeypatch, cuda)
    try:
        before = executor_torch.PHRASE_STATS["conjunction"]
        for body in NODE_BODIES:
            ref = oracle.search(dict(body))
            assert ref["hits"]["hits"], body
            _same_served(ref, svc.search(dict(body)))
        assert executor_torch.PHRASE_STATS["conjunction"] > before
    finally:
        svc.close()
        oracle.close()


@pytest.mark.parametrize("quant", ["none", "int8"])
def test_served_rescore_on_card(cuda, monkeypatch, quant):
    """`rescore` over a rank_vectors column on the card, after `match` and
    after a 2-leg `retriever.rrf`: f32 pages equal the numpy backend's
    host maxsim; int8 ones rerank on the card too (no fallback, no skip)."""
    from elasticsearch_tpu_torch.cluster.indices import IndexService
    from elasticsearch_tpu_torch.models import rerank as rerank_model

    monkeypatch.setenv("ES_TPU_BG_REFRESH", "off")
    mapping = {"properties": {"body": {"type": "text"},
                              "vec": {"type": "dense_vector", "dims": 16, "similarity": "cosine"},
                              "toks": {"type": "rank_vectors", "dims": 16, "similarity": "dot_product"}}}
    words = ["ant", "bee", "cat", "dog"]
    rng = np.random.default_rng(9)
    pair = []
    for backend in ("torch", "numpy"):
        pair.append(IndexService(f"rr-{backend}", mappings_json=mapping, device=cuda,
                                 settings={"search.backend": backend, "rerank.quantization": quant}))
    for i in range(200):
        doc = {"body": " ".join(words[j] for j in range(4) if (i >> j) & 1) or "eel",
               "vec": [float(x) for x in rng.normal(size=16)],
               "toks": rng.normal(size=(1 + i % 5, 16)).round(3).tolist()}
        for svc in pair:
            svc.index_doc(f"r{i}", dict(doc))
    for svc in pair:
        svc.refresh()
    try:
        before = rerank_model.stats_snapshot()
        for i in range(4):
            resc = {"window_size": 30, "query": {"rescore_query": {"rank_vectors": {
                "field": "toks", "query_vectors": rng.normal(size=(3, 16)).round(3).tolist()}},
                "query_weight": 1.0, "rescore_query_weight": 1.0}}
            for body in ({"query": {"match": {"body": words[i]}}, "size": 10, "rescore": resc},
                         {"retriever": {"rrf": {"rank_window_size": 30, "retrievers": [
                             {"standard": {"query": {"match": {"body": words[i]}}}},
                             {"knn": {"field": "vec", "query_vector": [float(x) for x in rng.normal(size=16)],
                                      "k": 20, "num_candidates": 40}}]}},
                          "size": 10, "rescore": resc}):
                got, ref = pair[0].search(dict(body)), pair[1].search(dict(body))
                if quant == "none":
                    _same_served(ref, got)
                else:
                    assert len(got["hits"]["hits"]) == len(ref["hits"]["hits"])
        after = rerank_model.stats_snapshot()
        assert after["device_rescores"] >= before["device_rescores"] + 8
        assert after["fallbacks"] == before["fallbacks"] and after["skipped"] == before["skipped"]
    finally:
        for svc in pair:
            svc.close()


# ---- device segment builds on the card (ops/index_build.py) ----

BUILD_MAPPING = {"properties": {
    "body": {"type": "text"}, "tag": {"type": "keyword"}, "n": {"type": "integer"},
    "vec": {"type": "dense_vector", "dims": 16, "similarity": "cosine"},
    "vec2": {"type": "dense_vector", "dims": 8, "similarity": "l2_norm"},
    "toks": {"type": "rank_vectors", "dims": 8, "similarity": "cosine"},
    "ml": {"type": "sparse_vector"},
}}
BUILD_COLUMNS = {
    "postings": ("terms", "term_df", "term_total_tf", "term_tile_start", "term_tile_count", "doc_ids", "tfs",
                 "tile_max_tf", "tile_min_norm", "norms", "term_pos_start", "pos_offsets", "pos_data",
                 "impacts", "impact_scales"),
    "ordinals": ("ord_terms", "ords", "mv_ords", "mv_offsets"),
    "numerics": ("values", "exists"),
    "vectors": ("vectors", "exists", "unit_vectors"),
    "multi_vectors": ("tok_vectors", "tok_offsets", "exists"),
    "sparse": ("terms", "doc_ids", "weights", "qweights", "scales", "tile_max", "tile_qmax", "exists"),
}


def _build_docs(n, seed):
    words = ["ant", "bee", "cat", "dog", "eel", "fox", "gnu", "hen", "ibis", "jay"]
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        src = {"body": " ".join(rng.choice(words, int(rng.integers(1, 30)))), "n": int(rng.integers(0, 99)),
               "tag": [str(t) for t in rng.choice(words[:4], int(rng.integers(1, 4)))],
               "ml": {str(w): float(rng.random() * 3 + 0.05) for w in rng.choice(words, 3)}}
        if i % 3:
            src["vec"] = [float(x) for x in rng.normal(size=16)]
            src["toks"] = rng.normal(size=(int(rng.integers(1, 5)), 8)).tolist()
        if i % 4 == 0:
            src["vec2"] = [float(x) for x in rng.normal(size=8)]
        out.append((f"b{i}", src))
    return out


def test_device_build_on_card_is_bit_identical_to_host(cuda, monkeypatch):
    """Every column family built through ops/index_build.py on the card
    equals the host SegmentBuilder's, bit for bit."""
    from elasticsearch_tpu_torch.analysis import AnalysisRegistry
    from elasticsearch_tpu_torch.index import segment_build
    from elasticsearch_tpu_torch.index.mapping import DocumentParser, Mappings
    from elasticsearch_tpu_torch.index.segment import SegmentBuilder

    monkeypatch.setenv("ES_TPU_DEVICE_BUILD", "auto")
    maps = Mappings(BUILD_MAPPING)
    parser = DocumentParser(maps, AnalysisRegistry())
    docs = [parser.parse(i, s) for i, s in _build_docs(700, 3)]
    builder = SegmentBuilder(maps)
    for d in docs:
        builder.add(d)
    host = builder.build()
    before = segment_build.INGEST_STATS["device_builds"]
    dev = segment_build.build_segment(maps, docs, prefer_device=True, device=cuda)
    assert segment_build.INGEST_STATS["device_builds"] == before + 1
    for fam, attrs in BUILD_COLUMNS.items():
        h, d = getattr(host, fam), getattr(dev, fam)
        assert sorted(h) == sorted(d), fam
        for f in h:
            for attr in attrs:
                a, b = getattr(h[f], attr), getattr(d[f], attr)
                if isinstance(a, list) or a is None:
                    assert a == b, (fam, f, attr)
                else:
                    assert a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b), (fam, f, attr)


def test_device_built_index_on_card_matches_numpy(cuda, monkeypatch):
    """A torch index whose refreshes build on the card, with the
    generation swaps adopting and prewarming, answers as the numpy
    index over the same docs."""
    from elasticsearch_tpu_torch.cluster.indices import IndexService
    from elasticsearch_tpu_torch.index import segment_build

    monkeypatch.setenv("ES_TPU_BG_REFRESH", "off")
    monkeypatch.setenv("ES_TPU_DEVICE_BUILD", "auto")
    docs = _build_docs(400, 4)
    pair = []
    before = segment_build.INGEST_STATS["device_builds"]
    for backend in ("torch", "numpy"):
        # fp32 impact planes: the int8 twin is held by recall elsewhere
        svc = IndexService(f"build-{backend}", settings={"number_of_shards": 1, "search.backend": backend,
                                                        "sparse.quantization": "none"},
                           mappings_json=BUILD_MAPPING, device=cuda)
        for i, (doc_id, src) in enumerate(docs):
            svc.index_doc(doc_id, src)
            if i in (150, 300):
                svc.refresh()
                ex = svc._executor(svc.local_shard(0))
                if backend == "torch":
                    ex.prewarm(svc.settings)
        svc.refresh()
        pair.append(svc)
    try:
        assert segment_build.INGEST_STATS["device_builds"] == before + 3
        tex = pair[0]._executor(pair[0].local_shard(0))
        assert sum(ds.adopted_bytes for ds in tex.device_segments) > 0
        for body in ({"query": {"match": {"body": "cat dog"}}, "size": 20},
                     {"query": {"bool": {"must": [{"match": {"body": "eel"}}],
                                         "filter": [{"term": {"tag": "bee"}}]}}, "size": 20},
                     {"query": {"sparse_vector": {"field": "ml", "query_vector": {"fox": 1.0, "ant": 0.5}}},
                      "size": 10}):
            _same_served(pair[1].search(body), pair[0].search(body))
    finally:
        for svc in pair:
            svc.close()


def test_reopened_index_on_card_matches_numpy(cuda, monkeypatch, tmp_path):
    """A node on the card with a data path: flushed segments and an
    unflushed tail survive a restart, the reopened torch index serves
    the numpy index's pages, and its tail replay built on the card."""
    from elasticsearch_tpu_torch.cluster.service import ClusterService
    from elasticsearch_tpu_torch.index import segment_build
    from elasticsearch_tpu_torch.search.executor_torch import TorchExecutor

    monkeypatch.setenv("ES_TPU_BG_REFRESH", "off")
    monkeypatch.setenv("ES_TPU_DEVICE_BUILD", "auto")
    docs = _build_docs(300, 5)
    path = str(tmp_path / "node")
    c = ClusterService(data_path=path, device=cuda)
    for backend in ("torch", "numpy"):
        c.create_index(f"d-{backend}", {"settings": {"number_of_shards": 2, "search.backend": backend,
                                                     "sparse.quantization": "none",
                                                     "codec": "best_compression"},
                                        "mappings": BUILD_MAPPING})
        idx = c.get_index(f"d-{backend}")
        for doc_id, src in docs[:200]:
            idx.index_doc(doc_id, src)
        idx.flush()
        for doc_id, src in docs[200:]:
            idx.index_doc(doc_id, src)
    # a power loss: the tail lives only in the translogs
    for idx in c.indices.values():
        idx.crash()
    before = dict(segment_build.INGEST_STATS)
    c = ClusterService(data_path=path, device=cuda)
    try:
        assert segment_build.INGEST_STATS["device_builds"] >= before["device_builds"] + 2
        assert segment_build.INGEST_STATS["host_builds"] == before["host_builds"] + 2  # the numpy index
        t, n = c.get_index("d-torch"), c.get_index("d-numpy")
        ex = t._executor(t.shards[0])
        assert isinstance(ex, TorchExecutor) and ex.device.type == cuda.type
        for body in ({"query": {"match": {"body": "cat dog"}}, "size": 20},
                     {"knn": {"field": "vec", "query_vector": [0.1] * 16, "k": 10, "num_candidates": 50}},
                     {"query": {"sparse_vector": {"field": "ml", "query_vector": {"fox": 1.0, "ant": 0.5}}},
                      "size": 10}):
            _same_served(n.search(body), t.search(body))
        assert t.search({"size": 0, "track_total_hits": True})["hits"]["total"]["value"] == 300
    finally:
        c.close()


def test_cluster_on_card_matches_numpy(cuda, monkeypatch, tmp_path):
    """Two nodes on the card over localhost TCP: an index of 4 shards and
    1 replica serves the numpy index's pages from either node; a node
    holding primaries dies and its replicas are promoted with nothing
    lost; it restarts and peer-recovers, every engine on the card and
    every build of the recovery on the card."""
    from elasticsearch_tpu_torch.cluster.node import TpuNode
    from elasticsearch_tpu_torch.cluster.service import ClusterService
    from elasticsearch_tpu_torch.index import segment_build

    monkeypatch.setenv("ES_TPU_BG_REFRESH", "off")
    monkeypatch.setenv("ES_TPU_DEVICE_BUILD", "auto")
    docs = _build_docs(300, 6)
    fd = {"fd_interval": 0.2, "fd_retries": 2}
    oracle = ClusterService(device=cuda)
    a = TpuNode("node-0", data_path=str(tmp_path / "n0"), device=cuda, **fd).start()
    b = TpuNode("node-1", seeds=[a.address], data_path=str(tmp_path / "n1"), device=cuda, **fd).start()
    b2 = None
    try:
        settings = {"number_of_shards": 4, "sparse.quantization": "none"}
        a.create_index("c", {"settings": {**settings, "number_of_replicas": 1}, "mappings": BUILD_MAPPING})
        oracle.create_index("c", {"settings": {**settings, "search.backend": "numpy"}, "mappings": BUILD_MAPPING})
        for doc_id, src in docs:
            assert b.index_doc("c", doc_id, src)["result"] == "created"
            oracle.get_index("c").index_doc(doc_id, src)
        a.refresh("c")
        oracle.get_index("c").refresh()
        bodies = ({"query": {"match": {"body": "cat dog"}}, "size": 20},
                  {"knn": {"field": "vec", "query_vector": [0.1] * 16, "k": 10, "num_candidates": 50}})
        for node in (a, b):
            for body in bodies:
                _same_served(oracle.search("c", body), node.search("c", body))
            for eng in node.indices["c"].local_shards.values():
                assert eng.device.type == cuda.type
        b.close()
        deadline = time.time() + 30
        while set(a.state["nodes"]) != {"node-0"} and time.time() < deadline:
            time.sleep(0.05)
        assert set(a.state["nodes"]) == {"node-0"}
        a.refresh("c")
        assert a.count("c")["count"] == 300
        for body in bodies:
            _same_served(oracle.search("c", body), a.search("c", body))
        before = dict(segment_build.INGEST_STATS)
        b2 = TpuNode("node-1", seeds=[a.address], data_path=str(tmp_path / "n1"), device=cuda, **fd).start()
        deadline = time.time() + 60
        while a.cluster.health()["status"] != "green" and time.time() < deadline:
            time.sleep(0.05)
        assert a.cluster.health()["status"] == "green"
        assert segment_build.INGEST_STATS["host_builds"] == before["host_builds"]
        assert sum(e.num_docs for e in b2.indices["c"].local_shards.values()) == 300
        for eng in b2.indices["c"].local_shards.values():
            assert eng.device.type == cuda.type
        for body in bodies:
            _same_served(oracle.search("c", body), b2.search("c", body))
    finally:
        for node in (b2, b, a):
            if node is not None:
                node.close()
        oracle.close()


def test_check_passes_on_card(cuda):
    """`python -m elasticsearch_tpu_torch check` exits 0 with a card."""
    import json
    import os
    import subprocess
    import sys
    from pathlib import Path

    repo = Path(__file__).resolve().parent.parent
    env = dict(os.environ, PYTHONPATH=str(repo))
    out = subprocess.run([sys.executable, "-m", "elasticsearch_tpu_torch", "check"],
                         capture_output=True, text=True, timeout=300, env=env, cwd=str(repo))
    assert out.returncode == 0, (out.stdout, out.stderr)
    data = json.loads(out.stdout)
    assert data["checks_passed"] is True and data["hbm_budget_bytes"] > 0


# ---- the serving mesh on the card (parallel/mesh_executor.py) ----


def _mesh_vs_fanout(monkeypatch, svc, body):
    """(forced mesh response, per-shard fan-out response) of one body on
    the same index; the first one must be mesh-routed."""
    mex = svc.mesh_executor()
    monkeypatch.setenv("ES_TPU_MESH", "force")
    routed0 = mex.stats["routed"]
    got = svc.search(dict(body))
    assert mex.stats["routed"] == routed0 + 1, body
    monkeypatch.setenv("ES_TPU_MESH", "off")
    return got, svc.search(dict(body))


def test_mesh_on_card_matches_fanout(cuda, monkeypatch):
    """`ES_TPU_MESH=force` on the card: match, bool, multi_match and
    exact kNN pages equal the same index's per-shard fan-out (ids with
    tie runs within rtol 1e-5 as sets, scores within rtol 1e-5, as
    against the numpy backend), one launch per group, no fallback."""
    svc, oracle = _served_pair(monkeypatch, cuda)
    try:
        rng = np.random.default_rng(13)
        bodies = [{"query": {"match": {"body": q}}} for q in ("ant bee", "cat", "dog eel fox")]
        bodies += TEXT_BODIES["bool"] + TEXT_BODIES["multi_match"]
        bodies += [{"knn": {"field": "vec", "query_vector": [float(x) for x in rng.normal(size=16)],
                            "k": 5, "num_candidates": 25}} for _ in range(3)]
        mex = svc.mesh_executor()
        for body in bodies:
            got, ref = _mesh_vs_fanout(monkeypatch, svc, body)
            _same_served(ref, got)
            _same_served(oracle.search(dict(body)), got)
        assert mex.stats["fallbacks"] == 0 and mex.stats["degraded"] == 0
        assert mex.stats["launches"] == len(bodies)
        snap = mex.ensure_snapshot()
        # every visible card is a slot: one card folds every entry
        assert snap.device.type == "cuda"
        assert snap.mesh.shape["shards"] == min(len(snap.entries), torch.cuda.device_count())
        assert snap.fold == -(-len(snap.entries) // snap.mesh.shape["shards"])
    finally:
        svc.close()
        oracle.close()


@pytest.mark.parametrize("n_data", [1, 2])
def test_mesh_grid_on_card_matches_fanout(cuda, monkeypatch, n_data):
    """The forced mesh over a grid of 4 slots (every card in turn, on a
    machine with one card 4 slots on it; `data` 1 or 2): each slot holds
    its fold of the stack on its card, and match, bool, multi_match and
    exact kNN pages equal the fan-out's and the numpy backend's (ids
    with tie runs as sets, scores within rtol 1e-5)."""
    svc, oracle = _served_pair(monkeypatch, cuda)
    try:
        n = torch.cuda.device_count()
        slots = [torch.device("cuda", i % n) for i in range(4)]
        mex = svc.mesh_executor()
        monkeypatch.setattr(mex, "_devices", lambda: slots)
        if n_data > 1:
            monkeypatch.setenv("ES_TPU_MESH_DATA", str(n_data))
        mex.close()
        rng = np.random.default_rng(17)
        bodies = [{"query": {"match": {"body": q}}} for q in ("ant bee", "cat", "dog eel fox")]
        bodies += TEXT_BODIES["bool"][:2] + TEXT_BODIES["multi_match"][:2]
        bodies += [{"knn": {"field": "vec", "query_vector": [float(x) for x in rng.normal(size=16)],
                            "k": 5, "num_candidates": 25}} for _ in range(3)]
        for body in bodies:
            got, ref = _mesh_vs_fanout(monkeypatch, svc, body)
            _same_served(ref, got)
            _same_served(oracle.search(dict(body)), got)
        snap = mex.ensure_snapshot()
        assert snap.mesh.shape == {"data": n_data, "shards": 4 // n_data}
        view = mex._text_view(snap, "body")
        for r, row in enumerate(snap.mesh.devices):
            for c, dev in enumerate(row):
                assert view["doc_ids"].at(r, c).device == dev
        assert mex.stats["fallbacks"] == 0 and mex.stats["degraded"] == 0
    finally:
        svc.mesh_executor().close()
        svc.close()
        oracle.close()


@pytest.mark.parametrize("quant", ["int8", "none"])
def test_mesh_sparse_and_aggs_on_card(cuda, monkeypatch, quant):
    """The forced mesh's `sparse_vector` pages equal the fan-out's on the
    card, and its size-0 aggregations equal the numpy backend's."""
    (svc, oracle), vocab, rng = _sparse_pair(cuda, quant)
    try:
        for _ in range(6):
            qv = {str(t): float(np.round(rng.random() * 2 + 0.1, 4))
                  for t in rng.choice(vocab, size=int(rng.integers(2, 5)), replace=False)}
            body = {"query": {"sparse_vector": {"field": "ml", "query_vector": qv}}, "size": 10}
            got, ref = _mesh_vs_fanout(monkeypatch, svc, {**body, "track_total_hits": True})
            _same_served(ref, got)
        q = {"match_all": {}}
        for body in ({"size": 0, "request_cache": False, "query": q,
                      "aggs": {"by_day": {"date_histogram": {"field": "day", "fixed_interval": "1d"}},
                               "cats": {"terms": {"field": "cat"}}, "pop": {"stats": {"field": "qty"}}}},
                     {"size": 0, "request_cache": False, "aggs": {"a": {"avg": {"field": "qty"}}}}):
            got, ref = _mesh_vs_fanout(monkeypatch, svc, body)
            assert got["aggregations"] == ref["aggregations"] == oracle.search(dict(body))["aggregations"]
            assert got["hits"]["total"] == ref["hits"]["total"]
        mex = svc.mesh_executor()
        assert mex.stats["fallbacks"] == 0 and mex.stats["degraded"] == 0
    finally:
        svc.close()
        oracle.close()


# ---- the card's accumulation order: the reference tests of exact float
# equality that the card's float atomics broke (tests/test_sparse.py's
# TestImpactKernel and TestServingParity, tests/test_rerank.py's
# TestMeshRerank), on the same bodies bit for bit, each body run twice
# and the two runs' bits compared ----

SPARSE_VOCAB = [f"tok{i:02d}" for i in range(40)]
SPARSE_MAPPINGS = {"properties": {"ml": {"type": "sparse_vector"}, "body": {"type": "text"},
                                  "vec": {"type": "dense_vector", "dims": 4, "similarity": "cosine"}}}


def _exact_pages(ref, got, what):
    """`ref` and `got` are lists of (id, score) in rank order: the same
    ids position by position and the same float32 score bits."""
    assert [d for d, _ in got] == [d for d, _ in ref], what
    rb = np.asarray([s for _, s in ref], np.float32).view(np.int32)
    gb = np.asarray([s for _, s in got], np.float32).view(np.int32)
    np.testing.assert_array_equal(gb, rb, err_msg=what)


def _sparse_docs(n=300, seed=3):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        toks = [str(t) for t in rng.choice(SPARSE_VOCAB, size=int(rng.integers(2, 9)), replace=False)]
        out.append((str(i), {"ml": {t: float(np.round(rng.random() * 3 + 0.05, 4)) for t in toks},
                             "body": " ".join(toks), "vec": [float(x) for x in rng.normal(size=4)]}))
    return out


def _sparse_qbody(seed, size=10, exact=False):
    rng = np.random.default_rng(seed)
    toks = [str(t) for t in rng.choice(SPARSE_VOCAB, size=int(rng.integers(2, 6)), replace=False)]
    b = {"query": {"sparse_vector": {"field": "ml", "query_vector": {
        t: float(np.round(rng.random() * 2 + 0.1, 4)) for t in toks}}}, "size": size}
    return {**b, "exact": True} if exact else b


@pytest.mark.parametrize("quantized", [False, True])
@pytest.mark.parametrize("k", [5, 16, 40])
def test_impact_scorer_on_card(cuda, quantized, k):
    """tests/test_sparse.py::TestImpactKernel::test_scorer_matches_oracle
    on the card: `ImpactScorer` against the term-at-a-time fp32 oracle,
    bit for bit, twice."""
    from elasticsearch_tpu_torch.analysis import AnalysisRegistry
    from elasticsearch_tpu_torch.index.mapping import DocumentParser, Mappings
    from elasticsearch_tpu_torch.index.segment import SegmentBuilder
    from elasticsearch_tpu_torch.ops import impact as impact_ops

    maps = Mappings({"properties": {"ml": {"type": "sparse_vector"}}})
    parser = DocumentParser(maps, AnalysisRegistry())
    b = SegmentBuilder(maps)
    for i, s in _sparse_docs():
        b.add(parser.parse(i, {"ml": s["ml"]}))
    seg = b.build()
    sf = seg.sparse["ml"]
    plane = sf.qweights if quantized else sf.weights
    sc = impact_ops.ImpactScorer(sf.doc_ids, plane, seg.num_docs, device=cuda)
    rng = np.random.default_rng(17)
    tile_lists, weight_lists, oracles = [], [], []
    for _ in range(6):
        toks = [str(t) for t in rng.choice(SPARSE_VOCAB, size=4, replace=False)]
        ws = [float(np.round(rng.random() * 2 + 0.1, 4)) for _ in toks]
        tids, tws, _bws, starts, counts = impact_ops.impact_tile_lists(sf, toks, ws, quantized)
        tile_lists.append(np.concatenate([np.arange(s, s + c, dtype=np.int64) for s, c in zip(starts, counts)])
                          if len(tids) else np.zeros(0, np.int64))
        weight_lists.append(np.concatenate([np.full(int(c), tw, np.float32) for tw, c in zip(tws, counts)])
                            if len(tids) else np.zeros(0, np.float32))
        acc = np.zeros(seg.num_docs, np.float32)
        for tid, tw in zip(tids, tws):
            start, count = int(sf.term_tile_start[tid]), int(sf.term_tile_count[tid])
            d = sf.doc_ids[start : start + count].ravel()
            v = plane[start : start + count].ravel()
            m = d >= 0
            np.add.at(acc, d[m], np.float32(tw) * v[m].astype(np.float32))
        oracles.append(acc)
    runs = []
    for _ in range(2):
        acc, cnt = sc.new_acc()
        acc, cnt = sc.score_into(acc, cnt, tile_lists, weight_lists)
        runs.append((acc[:len(oracles), :-1].cpu().numpy(), *sc.finalize(acc, cnt, k)))
    for acc, scores, docs, totals in runs:
        for ji, oracle in enumerate(oracles):
            np.testing.assert_array_equal(acc[ji].view(np.int32), oracle.view(np.int32), err_msg=str(ji))
            matched = np.flatnonzero(oracle != 0.0)
            want = sorted(matched, key=lambda d: (-oracle[d], d))[: min(k, seg.num_docs)]
            finite = np.isfinite(scores[ji])
            got = [(int(d), s) for d, s in zip(docs[ji][finite], scores[ji][finite])]
            _exact_pages([(int(d), oracle[d]) for d in want], got, ji)
            assert int(totals[ji]) == len(matched)
    for a, b in zip(*runs):
        np.testing.assert_array_equal(np.asarray(a).view(np.int32), np.asarray(b).view(np.int32))


@pytest.mark.parametrize("case", ["fp32", "exact"])
def test_sparse_serving_on_card(cuda, monkeypatch, case):
    """tests/test_sparse.py::TestServingParity's fp32 and exact-escape
    bodies on the card against the numpy backend, bit for bit, each body
    twice."""
    from elasticsearch_tpu_torch.cluster.indices import IndexService

    monkeypatch.setenv("ES_TPU_BG_REFRESH", "off")
    quant = "none" if case == "fp32" else "int8"
    pair = []
    for backend, device in (("torch", cuda), ("numpy", "cpu")):
        svc = IndexService(f"order-sp-{case}-{backend}", mappings_json=SPARSE_MAPPINGS, device=device,
                           settings={"number_of_shards": 1, "search.backend": backend,
                                     "sparse.quantization": quant})
        for i, s in _sparse_docs():
            svc.index_doc(i, s)
        svc.refresh()
        pair.append(svc)
    bodies = ([_sparse_qbody(s, size=z) for s in range(12) for z in (5, 16, 40)] if case == "fp32"
              else [_sparse_qbody(s, exact=True) for s in range(8)])
    try:
        for i, b in enumerate(bodies):
            got, ref, again = (svc.search(dict(b)) for svc in (pair[0], pair[1], pair[0]))
            ref, got, again = ([(h["_id"], h["_score"]) for h in r["hits"]["hits"]] for r in (ref, got, again))
            _exact_pages(ref, got, i)
            _exact_pages(got, again, i)
    finally:
        for svc in pair:
            svc.close()


@pytest.mark.parametrize("quantized", [False, True])
def test_mesh_rescore_on_card(cuda, monkeypatch, quantized):
    """tests/test_rerank.py::TestMeshRerank::test_mesh_rescore_bit_exact_vs_per_shard
    on the card: the forced mesh's fused rescore against the per-shard
    path of the same 4-shard index, bit for bit, each body twice."""
    from elasticsearch_tpu_torch.cluster.indices import IndexService

    monkeypatch.setenv("ES_TPU_BG_REFRESH", "off")
    dims = 8
    mapping = {"properties": {"body": {"type": "text"},
                              "vec": {"type": "dense_vector", "dims": dims, "similarity": "cosine"},
                              "toks": {"type": "rank_vectors", "dims": dims, "similarity": "dot_product"}}}
    words = ["alpha beta", "alpha gamma", "beta gamma", "alpha beta gamma"]
    settings = {"number_of_shards": 4, "search.backend": "torch"}
    if quantized:
        settings["rerank.quantization"] = "int8"
    svc = IndexService(f"order-rr-{int(quantized)}", settings=settings, mappings_json=mapping, device=cuda)
    try:
        rng = np.random.default_rng(3)
        for i in range(120):
            v = rng.normal(size=dims)
            svc.index_doc(str(i), {"body": words[i % 4], "vec": [float(x) for x in v / np.linalg.norm(v)],
                                   "toks": rng.normal(size=(1 + i % 4, dims)).round(3).tolist()})
        svc.refresh()
        bodies = [{"query": {"match": {"body": w.split()[0]}}, "size": 10,
                   "rescore": {"window_size": 20, "query": {
                       "rescore_query": {"rank_vectors": {
                           "field": "toks",
                           "query_vectors": np.random.default_rng(s).normal(size=(3, dims)).round(3).tolist()}},
                       "query_weight": 0.5, "rescore_query_weight": 2.0}}}
                  for s, w in enumerate(words[:3])]
        for i, body in enumerate(bodies):
            runs = [_mesh_vs_fanout(monkeypatch, svc, body) for _ in range(2)]
            (got, ref), (got2, ref2) = (
                [[(h["_id"], h["_score"]) for h in r["hits"]["hits"]] for r in run] for run in runs
            )
            _exact_pages(ref, got, i)
            _exact_pages(got, got2, i)
            _exact_pages(ref, ref2, i)
        mex = svc.mesh_executor()
        assert mex.stats["fallbacks"] == 0 and mex.stats["degraded"] == 0
    finally:
        svc.close()
