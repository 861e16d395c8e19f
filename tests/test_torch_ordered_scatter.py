"""The port's float accumulator, ops/ordered_scatter.py, on the CPU.

`ordered_scatter_add_plain` (what the wrapper runs for CPU tensors, and
what the CUDA kernel is held to on the card) against `scatter_add_`,
`index_add_`, numpy's `np.add.at` and the JAX package's `.at[].add`, bit
for bit; the invariant the kernel relies on (valid targets distinct
within each 128-slot tile) at every call the served paths make; each
rewired site against the JAX package's counterpart bit for bit; and the
mesh rescore, multiplied in the per-shard path's shapes, against the
per-shard path.

The BM25 sites take dyadic `inv_norm` values (multiples of 1/64): XLA
on the CPU contracts `1 + tf * inv` into one fused multiply-add and
PyTorch rounds the product first, and with a dyadic `inv` the product
is exact, so both packages make the same contributions and the
comparison holds the accumulation order alone. `tests/test_torch_scoring.py`
holds the same sites at any `inv` within rtol 1e-5.
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from elasticsearch_tpu.ops import impact as jimpact
from elasticsearch_tpu.ops import scoring as jscoring
from elasticsearch_tpu_torch.ops import impact as timpact
from elasticsearch_tpu_torch.ops import ordered_scatter as osc
from elasticsearch_tpu_torch.ops import scoring as tscoring
from elasticsearch_tpu_torch.parallel import sharded as tsharded
from scatter_cases import applied, hard_scatter_case, parent_chunk_pass, parent_chunks

torch.set_num_threads(1)

TILE = 128


def t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def bits(x):
    return np.asarray(x, np.float32).view(np.int32)


def scatter_inputs(R, C, n_tiles, seed, repeat=False, empty_tiles=()):
    """tgt int32 [R, n_tiles*128] with distinct valid targets in each
    tile (invalid slots aim at the overflow column C-1 with +0.0 and inc
    0), src f32 of mixed signs and magnitudes (so the order shows), inc
    int32, and a nonzero starting acc/cnt. `repeat`: tile 2 repeats tile
    0 (a query token given twice); `empty_tiles`: tiles with no valid
    slot."""
    rng = np.random.default_rng(seed)
    S = n_tiles * TILE
    tgt = np.full((R, S), C - 1, np.int32)
    src = np.zeros((R, S), np.float32)
    for r in range(R):
        for ti in range(n_tiles):
            if ti in empty_tiles:
                continue
            n_valid = int(rng.integers(1, min(TILE, C - 1) + 1))
            slots = rng.choice(TILE, size=n_valid, replace=False)
            docs = rng.choice(C - 1, size=n_valid, replace=False)
            tgt[r, ti * TILE + slots] = docs
            src[r, ti * TILE + slots] = (
                rng.standard_normal(n_valid) * 10.0 ** rng.integers(-3, 4, n_valid)
            ).astype(np.float32)
        if repeat and n_tiles > 2:
            tgt[r, 2 * TILE : 3 * TILE] = tgt[r, :TILE]
            src[r, 2 * TILE : 3 * TILE] = src[r, :TILE]
    inc = (tgt != C - 1).astype(np.int32)
    acc0 = rng.standard_normal((R, C)).astype(np.float32)
    acc0[:, C - 1] = 0.0
    cnt0 = rng.integers(0, 5, size=(R, C)).astype(np.int32)
    cnt0[:, C - 1] = 0
    return tgt, src, inc, acc0, cnt0


def sequential(acc0, tgt, src):
    """The reference order: one addition after another, slot order."""
    out = acc0.copy()
    for r in range(out.shape[0]):
        np.add.at(out[r], tgt[r], src[r])
    return out


CASES = [
    # (R, C, n_tiles, repeat, empty tiles)
    (1, 300, 4, True, ()),
    (1, 1000, 9, False, (3, 4)),
    (32, 200, 5, True, (1,)),
    (32, 700, 3, False, ()),
    (3, 129, 6, True, (0, 5)),
]


@pytest.mark.parametrize("R,C,n_tiles,repeat,empty", CASES)
def test_plain_matches_scatter_index_add_numpy_and_jax(R, C, n_tiles, repeat, empty):
    tgt, src, inc, acc0, cnt0 = scatter_inputs(R, C, n_tiles, R * 100 + C, repeat, empty)
    want = sequential(acc0, tgt, src)
    acc, cnt = t(acc0.copy()), t(cnt0.copy())
    out, cout = osc.ordered_scatter_add(acc, t(tgt), t(src), cnt, t(inc))
    assert out is acc and cout is cnt
    np.testing.assert_array_equal(bits(acc.numpy()), bits(want))
    want_cnt = cnt0.copy()
    for r in range(R):
        np.add.at(want_cnt[r], tgt[r], inc[r])
    np.testing.assert_array_equal(cnt.numpy(), want_cnt)
    # scatter_add_ along rows, and index_add_ over the flat [R*C] view
    sa = t(acc0.copy()).scatter_add_(1, t(tgt).long(), t(src))
    flat = (t(tgt).long() + torch.arange(R)[:, None] * C).reshape(-1)
    ia = t(acc0.copy()).view(-1).index_add_(0, flat, t(src).reshape(-1)).view(R, C)
    np.testing.assert_array_equal(bits(sa.numpy()), bits(want))
    np.testing.assert_array_equal(bits(ia.numpy()), bits(want))
    # the JAX package's accumulation, `.at[].add` row by row
    ja = jax.vmap(lambda a, d, v: a.at[d].add(v))(jnp.asarray(acc0), jnp.asarray(tgt), jnp.asarray(src))
    np.testing.assert_array_equal(bits(ja), bits(want))


@pytest.mark.parametrize("C,n_tiles", [(300, 4), (2000, 12)])
def test_plain_one_dimensional_acc_from_zero(C, n_tiles):
    """score_tiles' shape: one row, acc a [C] vector of zeros, against
    `jnp.zeros(C).at[tgt].add(src)`; the int plane is optional."""
    tgt, src, _, _, _ = scatter_inputs(1, C, n_tiles, C, repeat=True, empty_tiles=(1,))
    acc = torch.zeros(C)
    out, cnt = osc.ordered_scatter_add(acc, t(tgt[0]), t(src[0]))
    assert out is acc and cnt is None
    ja = jnp.zeros(C, jnp.float32).at[jnp.asarray(tgt[0])].add(jnp.asarray(src[0]))
    np.testing.assert_array_equal(bits(acc.numpy()), bits(ja))
    np.testing.assert_array_equal(bits(acc.numpy()), bits(sequential(np.zeros((1, C), np.float32), tgt, src)[0]))


def test_wrapper_rejects_what_the_kernel_does_not_take():
    tgt, src, inc, acc0, cnt0 = scatter_inputs(2, 50, 2, 0)
    with pytest.raises(ValueError, match="go together"):
        osc.ordered_scatter_add(t(acc0), t(tgt), t(src), cnt=t(cnt0))
    with pytest.raises(ValueError, match="no kernel for device"):
        osc.ordered_scatter_add(t(acc0).to("meta"), t(tgt).to("meta"), t(src).to("meta"))
    before = osc.ordered_scatter_add.launches
    osc.ordered_scatter_add(t(acc0.copy()), t(tgt), t(src), t(cnt0.copy()), t(inc))
    assert osc.ordered_scatter_add.launches == before  # the CPU launches nothing


# ---- the kernel's host-side layout, and a CPU mirror of its passes ----

# route (a)'s widest one-row launch: score_tiles over a query's tiles,
# padded to a power of two; a row past one window (MAX_CHUNKS chunks):
# score_tiles over an expansion of many terms on a large segment
ROUTE_A_MAX_S = 1 << 19
PAST_ONE_WINDOW = (1 << 25) + (1 << 17)


@pytest.mark.parametrize("R", [1, 32])
@pytest.mark.parametrize("C", [2, 129, 300_001, 1_000_001])
@pytest.mark.parametrize("S", [128, 2048, 65_536, ROUTE_A_MAX_S, PAST_ONE_WINDOW])
def test_layout_holds_the_worst_case(R, C, S):
    """`layout` sizes scratch and grids from the shapes alone for every
    slot valid. The buckets cover the row's cells [0, C-1) without a
    bucket past them, a sort key (the cell in its bucket) takes at most 20
    bits and a position in a piece 16, the grids are within the card's
    limits, and one row has as many buckets as 32 rows of the same slots
    (the card is filled from the slots, not the rows). A row of at most
    CHUNK slots takes one launch and no scratch. Otherwise windows of at
    most MAX_CHUNKS chunks cover the row's slots, every chunk's slots fit
    its staging place and one sort, and the scratch holds the count table
    and the staged planes of one window."""
    for with_cnt in (False, True):
        lay = osc.layout(R, C, S, with_cnt)
        cells = C - 1
        assert R <= 65_535  # the grids' y
        if S <= osc.CHUNK:
            assert (lay.chunks, lay.windows, lay.count_words, lay.stage_slots, lay.scratch_words) == (0, 1, 0, 0, 0)
        else:
            window = lay.chunks * osc.CHUNK
            assert 1 <= lay.chunks <= osc.MAX_CHUNKS  # the chunk grid's x
            assert lay.windows * window >= S > (lay.windows - 1) * window
            assert lay.windows == 1 or lay.chunks == osc.MAX_CHUNKS
            assert (lay.windows > 1) == (S > osc.MAX_CHUNKS * osc.CHUNK)
            assert lay.stage_slots == R * window >= R * min(S, window)
            assert lay.count_words == R * lay.buckets * lay.chunks
            assert lay.scratch_words == lay.count_words + (3 if with_cnt else 2) * lay.stage_slots
        assert lay.buckets * lay.width >= cells > (lay.buckets - 1) * lay.width
        assert 1 <= lay.buckets <= osc.MAX_BUCKETS and 1 <= lay.width <= osc.MAX_WIDTH
        assert (lay.width - 1).bit_length() <= 20 and osc.CHUNK <= 1 << 16  # key bits; 16-bit positions
        assert R * lay.buckets <= 2**31 - 1  # the apply grid's x
        aim = min(osc.BUCKETS, -(-R * S // osc.SLOTS_PER_BUCKET), R * cells)
        assert aim // 2 <= R * lay.buckets <= max(aim, R * -(-cells // osc.MAX_WIDTH)) + R


def test_layout_refuses_what_the_kernel_cannot_hold():
    for S in (128, 4096):
        with pytest.raises(ValueError, match="cells a row"):
            osc.layout(1, osc.MAX_BUCKETS * osc.MAX_WIDTH + 2, S, False)
    with pytest.raises(ValueError, match="no layout"):
        osc.layout(1, 1, 128, False)
    # a row of any length takes windows
    assert osc.layout(1, 300, (osc.MAX_CHUNKS + 1) * osc.CHUNK, False).windows == 2


def _add_runs(arow, crow, t, v, i):
    """One sort and its runs: the slots ordered by (cell, position), each
    cell's run added left to right onto the cell's value, one f32 add at
    a time, and its increments onto the count."""
    order = torch.sort(t, stable=True).indices
    pt, pv = t[order], v[order]
    cells, runs = torch.unique_consecutive(pt, return_counts=True)
    starts = torch.cumsum(runs, 0) - runs
    a = arow[cells].clone()
    for k in range(int(runs.max())):  # the k-th add of every run longer than k
        more = runs > k
        a[more] = a[more] + pv[starts[more] + k]
    arow[cells] = a
    if crow is not None:
        crow.index_add_(0, cells, torch.segment_reduce(i[order].double(), "sum", lengths=runs).to(torch.int32))


def scatter_passes(acc, tgt, src, cnt=None, inc=None):
    """csrc/ordered_scatter.cu's passes in plain torch on the CPU, over
    the wrapper's `layout` (used only here). One launch (rows of at most
    CHUNK slots): each bucket keeps the row's slots that aim in it, in
    slot order, and adds their runs. Otherwise, window after window: each
    chunk keeps its valid slots in slot order and orders them by (bucket,
    position); each bucket gathers its slots chunk by chunk, in pieces of
    CHUNK, and adds each piece's runs."""
    acc2 = acc.view(1, -1) if acc.dim() == 1 else acc
    R, C = acc2.shape
    S = tgt.numel() // R
    tgt2, src2 = tgt.reshape(R, S), src.reshape(R, S)
    inc2 = torch.zeros_like(tgt2) if inc is None else inc.reshape(R, S)
    cnt2 = None if cnt is None else (cnt.view(1, -1) if cnt.dim() == 1 else cnt)
    lay = osc.layout(R, C, S, cnt is not None)
    CH = osc.CHUNK
    for r in range(R):
        arow, crow = acc2[r], None if cnt2 is None else cnt2[r]
        if not lay.chunks:
            t = tgt2[r].long()
            for lo in range(0, C - 1, lay.width):
                keep = torch.nonzero((t >= lo) & (t < min(lo + lay.width, C - 1))).flatten()  # slot order
                if len(keep):
                    _add_runs(arow, crow, t[keep], src2[r][keep], inc2[r][keep])
            continue
        window = lay.chunks * CH
        for w0 in range(0, S, window):
            staged = []  # per chunk: (bucket, target, value, inc), ordered by (bucket, position)
            for c0 in range(w0, min(S, w0 + window), CH):
                t = tgt2[r, c0:c0 + CH].long()
                keep = torch.nonzero((t >= 0) & (t < C - 1)).flatten()  # slot order
                tv = t[keep]
                order = torch.sort(tv // lay.width, stable=True).indices
                staged.append(((tv // lay.width)[order], tv[order], src2[r, c0:c0 + CH][keep][order],
                               inc2[r, c0:c0 + CH][keep][order]))
            for b in range(lay.buckets):
                parts = [[x[bk == b] for x in xs] for bk, *xs in staged]
                t, v, i = (torch.cat([part[j] for part in parts]) for j in range(3))
                for p0 in range(0, len(t), CH):
                    _add_runs(arow, crow, t[p0:p0 + CH], v[p0:p0 + CH], i[p0:p0 + CH])
    return acc, cnt


PASS_CASES = [
    # (kind, R, C, S): hard inputs at small widths; every slot valid and C = 2
    # puts more slots in one bucket than one piece holds
    ("sparse", 3, 1_001, 4096),
    ("all_valid", 2, 300, 2048),
    ("all_valid", 1, 2, 5120),
    ("one_cell_every_tile", 1, 20_001, 32_768),
    ("one_cell_every_tile", 4, 129, 1024),
    ("repeat_in_tile", 2, 5_003, 2048),
    ("out_of_range", 3, 700, 2048),
    ("signed_zero_subnormal", 2, 70, 4096),
    ("sparse", 1, 1_000_001, 12_800),
]


@pytest.mark.parametrize("kind,R,C,S", PASS_CASES)
def test_passes_match_plain_and_jax_bit_for_bit(kind, R, C, S):
    """The kernel's passes (`scatter_passes`) on the slots as given
    against `ordered_scatter_add_plain`, `np.add.at` and the JAX
    package's `.at[].add` on the slots the function applies (targets
    outside [0, C-1) taken to the overflow column with +0.0 and inc 0):
    the same bits, the same counts. XLA's CPU runtime flushes subnormals
    to zero, so the JAX comparison of the subnormal case runs on the
    same inputs with their subnormals flushed; the order is what it
    holds. Rows of at most CHUNK slots take the one-launch pass."""
    _hold_passes(kind, R, C, S)


@pytest.mark.parametrize("kind,R,C,S", [
    ("one_cell_every_tile", 1, 3_001, 10_240),
    ("all_valid", 2, 2, 9_216),
    ("repeat_in_tile", 3, 501, 8_192),
])
def test_passes_in_windows_match_plain_and_jax(kind, R, C, S, monkeypatch):
    """A row past one window, at a small width: with MAX_CHUNKS lowered to
    2 a row of a few thousand slots spans several windows, and a cell
    found in every window (every tile, at C = 2 every slot) gets its adds
    window after window: the same bits as the plain version and JAX."""
    osc.layout.cache_clear()
    monkeypatch.setattr(osc, "MAX_CHUNKS", 2)
    try:
        assert osc.layout(R, C, S, True).windows >= 2
        _hold_passes(kind, R, C, S)
    finally:
        osc.layout.cache_clear()


def _hold_passes(kind, R, C, S):
    acc0, cnt0, tgt, src, inc = hard_scatter_case(kind, R, C, S, R * 100 + C + S)
    at, asrc, ainc = applied(tgt, src, inc, C)
    got, got_cnt = scatter_passes(t(acc0.copy()), t(tgt), t(src), t(cnt0.copy()), t(inc))
    want, want_cnt = osc.ordered_scatter_add_plain(t(acc0.copy()), t(at), t(asrc), t(cnt0.copy()), t(ainc))
    np.testing.assert_array_equal(bits(got.numpy()), bits(want.numpy()))
    np.testing.assert_array_equal(bits(got.numpy()), bits(sequential(acc0, at, asrc)))
    np.testing.assert_array_equal(got_cnt.numpy(), want_cnt.numpy())
    if kind == "signed_zero_subnormal":
        tiny = np.finfo(np.float32).tiny
        acc0, src, asrc = (np.where(np.abs(x) < tiny, np.copysign(np.float32(0), x), x).astype(np.float32)
                           for x in (acc0, src, asrc))
        got, _ = scatter_passes(t(acc0.copy()), t(tgt), t(src))
    ja = jax.vmap(lambda a, d, v: a.at[d].add(v))(jnp.asarray(acc0), jnp.asarray(at), jnp.asarray(asrc))
    np.testing.assert_array_equal(bits(got.numpy()), bits(ja))
    # and the one-row form, without the count plane
    one, _ = scatter_passes(t(acc0[0].copy()), t(tgt[0]), t(src[0]))
    np.testing.assert_array_equal(bits(one.numpy()), bits(np.asarray(ja)[0]))


def test_concurrent_builds_of_one_source(tmp_path, monkeypatch):
    """Threads of one process building the same library at once (the
    batcher's workers at first use): each compiles into a temp file of
    its own, and every thread gets the library."""
    from concurrent.futures import ThreadPoolExecutor

    from elasticsearch_tpu_torch.ops import nvcc

    fake = tmp_path / "nvcc"
    fake.write_text('#!/bin/sh\nwhile [ "$1" != "-o" ]; do shift; done\nsleep 0.3\necho lib > "$2"\n')
    fake.chmod(0o755)
    monkeypatch.setattr(nvcc, "nvcc", lambda: str(fake))
    monkeypatch.setattr(nvcc, "BUILD_DIR", tmp_path / "_build")
    with ThreadPoolExecutor(4) as pool:
        built = list(pool.map(lambda _: nvcc.build(osc.SOURCE)[0], range(4)))
    assert len(set(built)) == 1 and built[0].read_text() == "lib\n"
    assert sorted(p.name for p in (tmp_path / "_build").iterdir()) == [built[0].name]


def test_kernel_source_and_build_flags(tmp_path, monkeypatch):
    """No float atomics and no claimed places; each shared-memory limit is
    set to the card's maximum, never to a launch's size; and the layout's
    constants reach the source only as `-D` flags from this module (the
    source refuses to build without them and holds them to its shared
    memory with static_asserts)."""
    from elasticsearch_tpu_torch.ops import int8_knn, nvcc

    src = osc.SOURCE.read_text()
    assert "extern \"C\" int es_ordered_scatter_add(" in src
    assert "atomicAdd" not in src and "atomicCAS" not in src  # no float atomics, no claimed places
    assert "__fadd_rn(" in src
    sets = re.findall(r"cudaFuncSetAttribute\(([^;]*);", src, re.S)
    assert sets and all(re.search(r"MaxDynamicSharedMemorySize,\s*SMEM_MAX\)$", x.strip()) for x in sets)
    for name in osc.DEFINES:
        assert f"!defined({name})" in src
        assert re.search(rf"constexpr int \w+ = {name};", src), name
    assert "static_assert(apply_smem(MAX_CHUNKS) <= SMEM_MAX" in src
    int8 = int8_knn.SOURCE.read_text()
    sets = re.findall(r"cudaFuncSetAttribute\(([^;]*);", int8, re.S)
    assert sets and all(x.strip().endswith("SMEM_MAX)") for x in sets)
    # the command line: sm_90a, and this module's constants
    fake = tmp_path / "nvcc"
    fake.write_text('#!/bin/sh\nargs="$*"\nwhile [ "$1" != "-o" ]; do shift; done\necho "$args" > "$2"\n')
    fake.chmod(0o755)
    monkeypatch.setattr(nvcc, "nvcc", lambda: str(fake))
    monkeypatch.setattr(nvcc, "BUILD_DIR", tmp_path / "_build")
    line = osc.build()[0].read_text().split()
    assert "arch=compute_90a,code=sm_90a" in line and str(osc.SOURCE) == line[-1]
    assert [x for x in line if x.startswith("-D")] == sorted(f"-D{k}={v}" for k, v in osc.DEFINES.items())
    assert osc.SOURCE.parent == nvcc.CSRC


# ---- the tile invariant at every call the served paths make ----

MAPPING = {"properties": {"body": {"type": "text"}, "title": {"type": "text"},
                          "ml": {"type": "sparse_vector"}}}
WORDS = [f"w{i}" for i in range(30)]


def _docs(n, seed):
    rng = np.random.default_rng(seed)
    for i in range(n):
        body = " ".join(rng.choice(WORDS, size=int(rng.integers(3, 12))))
        title = " ".join(rng.choice(WORDS[:10], size=int(rng.integers(1, 4))))
        toks = rng.choice(WORDS, size=int(rng.integers(1, 6)), replace=False)
        ml = {str(w): float(np.round(rng.random() * 3 + 0.05, 3)) for w in toks}
        yield str(i), {"body": body, "title": title, "ml": ml}


def _check_tiles(tgt, acc):
    C = acc.shape[-1]
    tiles = tgt.reshape(-1, TILE).numpy()
    for row in tiles:
        valid = row[row != C - 1]
        assert len(np.unique(valid)) == len(valid), "a doc twice in one tile"
        assert ((valid >= 0) & (valid < C - 1)).all()


def test_every_served_scatter_keeps_targets_distinct_within_a_tile(monkeypatch):
    """match, bool (counted), multi_match and sparse_vector through the
    fan-out and through the forced mesh, and the fused scorers: every
    target plane handed to the accumulator holds distinct valid targets
    in each 128-slot tile."""
    from elasticsearch_tpu_torch.cluster.indices import IndexService
    from elasticsearch_tpu_torch.parallel import sharded

    seen = {}
    real = osc.ordered_scatter_add

    def checked(module):
        def fn(acc, tgt, src, cnt=None, inc=None):
            _check_tiles(tgt, acc)
            seen[module] = seen.get(module, 0) + 1
            return real(acc, tgt, src, cnt, inc)
        return fn

    for mod, name in ((tscoring, "scoring"), (timpact, "impact"), (sharded, "sharded")):
        monkeypatch.setattr(mod, "ordered_scatter_add", checked(name))
    svc = IndexService("osc-invariant", settings={"number_of_shards": 2, "search.backend": "torch"},
                       mappings_json=MAPPING, device="cpu")
    try:
        for i, src in _docs(400, 1):
            svc.index_doc(i, src)
        svc.refresh()
        bodies = [
            {"query": {"match": {"body": "w1 w2 w3 w1"}}},
            {"query": {"bool": {"must": [{"match": {"body": "w4"}}],
                                "should": [{"match": {"title": "w2 w5"}}]}}},
            {"query": {"match": {"body": {"query": "w6 w7 w8", "minimum_should_match": 2}}}},
            {"query": {"multi_match": {"query": "w1 w3", "fields": ["title^2", "body"]}}},
            {"query": {"sparse_vector": {"field": "ml", "query_vector": {"w1": 1.5, "w9": 0.7, "w2": 0.1}}}},
        ]
        for mode in ("off", "force"):
            monkeypatch.setenv("ES_TPU_MESH", mode)
            for b in bodies:
                assert svc.search(dict(b))["hits"]["total"]["value"] > 0, b
    finally:
        svc.close()
    jfs, tfs_, plans = fused_inputs(3)
    tfs_.search(plans, 10, True, rows=8)
    mfs = multi_fused(4)[1]
    mfs.search(multi_plans(4, mfs), 10, "max_tie", 0.5, rows=8)
    assert seen.get("scoring", 0) >= 3 and seen.get("impact", 0) >= 1 and seen.get("sharded", 0) >= 2, seen


# ---- each rewired site against the JAX package's, bit for bit ----


def dyadic_inv(rng, n):
    return (rng.integers(8, 40, size=n) / 64).astype(np.float32)


def postings(rng, n_docs, n_terms, max_df, max_tf=6):
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


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_score_tiles_bits_match_reference(seed):
    rng = np.random.default_rng(seed)
    n = 700
    doc_ids, tfs = postings(rng, n, 12, 300)
    idx = rng.integers(0, len(doc_ids), size=24)
    idx[5] = idx[1]  # one tile twice
    w = (rng.random(24) * 3).astype(np.float32)
    v = rng.random(24) > 0.2
    inv = dyadic_inv(rng, n)
    js, jc = jscoring.score_tiles(jnp.asarray(doc_ids[idx]), jnp.asarray(tfs[idx]), jnp.asarray(w),
                                  jnp.asarray(v), jnp.asarray(inv), n)
    ts, tc = tscoring.score_tiles(t(doc_ids[idx]), t(tfs[idx]), t(w), t(v), t(inv), n)
    np.testing.assert_array_equal(bits(ts.numpy()), bits(js))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))


def tile_pass_inputs(rng, n, lengths, n_terms=40, max_df=3000):
    """Postings of `n_terms` terms over n docs, dyadic inv_norm, and one
    ragged list a row: `lengths[r]` tiles drawn from the postings (so a
    tile may repeat, as a query's repeated term does), a weight a tile."""
    doc_ids, tfs = postings(rng, n, n_terms, min(max_df, n))
    inv = dyadic_inv(rng, n)
    tiles = [rng.integers(0, len(doc_ids), size=m).astype(np.int64) for m in lengths]
    weights = [(rng.random(m) * 2 + 0.1).astype(np.float32) for m in lengths]
    return doc_ids, tfs, inv, tiles, weights


PASS_LENGTHS = [
    # (rows, tiles a row): around one 512-tile chunk, ragged rows, empty rows
    (1, (511,)), (1, (512,)), (1, (513,)), (1, (1025,)),
    (3, (513, 0, 1025)),
    (32, tuple([511, 512, 513, 1025, 0, 3, 16, 17] * 4)),
]


@pytest.mark.parametrize("with_cnt", [False, True])
@pytest.mark.parametrize("rows,lengths", PASS_LENGTHS)
def test_pass_bits_match_chunk_loop_and_reference(rows, lengths, with_cnt):
    """One `bm25_tile_add` call over each row's whole list against the
    parent's per-512-tile `_chunk_scores` + `ordered_scatter_add` loop and
    the JAX package's `_chunk_add` / `_chunk_add_cnt` loop, from the same
    nonzero accumulators: the same bits and counts. Rows past the lists
    add nothing."""
    rng = np.random.default_rng(rows * 7 + len(lengths) + with_cnt)
    n = 2000
    doc_ids, tfs, inv, tiles, weights = tile_pass_inputs(rng, n, lengths)
    acc0 = rng.random((rows + 1, n + 1)).astype(np.float32)
    acc0[:, n] = 0
    cnt0 = rng.integers(0, 3, size=(rows + 1, n + 1)).astype(np.int32)
    cnt0[:, n] = 0
    ta, tc = t(acc0.copy()), t(cnt0.copy()) if with_cnt else None
    assert tscoring.bm25_tile_add(ta, tc, t(doc_ids), t(tfs), t(inv), tiles, weights) == 1

    la, lc = t(acc0.copy()), t(cnt0.copy()) if with_cnt else None
    parent_chunk_pass(la, lc, t(doc_ids), t(tfs), t(inv), tiles, weights)
    np.testing.assert_array_equal(bits(ta.numpy()), bits(la.numpy()))

    ja, jc = jnp.asarray(acc0[:rows]), jnp.asarray(cnt0[:rows])
    args = (jnp.asarray(doc_ids), jnp.asarray(tfs), jnp.asarray(inv))

    for ti, tw, tv in parent_chunks(rows, tiles, weights, tscoring.TCHUNK):
        chunk = (jnp.asarray(ti), jnp.asarray(tw), jnp.asarray(tv))
        if with_cnt:
            ja, jc = jscoring._chunk_add_cnt(*args, ja, jc, *chunk)
        else:
            ja = jscoring._chunk_add(*args, ja, *chunk)
    np.testing.assert_array_equal(bits(ta.numpy()[:rows]), bits(ja))
    np.testing.assert_array_equal(bits(ta.numpy()[rows]), bits(acc0[rows]))
    if with_cnt:
        np.testing.assert_array_equal(tc.numpy(), lc.numpy())
        np.testing.assert_array_equal(tc.numpy()[:rows], np.asarray(jc))
        np.testing.assert_array_equal(tc.numpy()[rows], cnt0[rows])


@pytest.mark.parametrize("with_cnt", [False, True])
def test_chunk_add_bits_match_reference(with_cnt):
    """Two passes into the same accumulators (the essential terms, then
    the surviving tiles of the hot terms), through `ChunkedScorer`'s
    `score_pass` and the JAX package's `score_into` (its `_chunk_add` /
    `_chunk_add_cnt` loop): the same bits and counts after each."""
    rng = np.random.default_rng(7 + with_cnt)
    n, B = 900, 4
    doc_ids, tfs = postings(rng, n, 20, 500)
    inv = dyadic_inv(rng, n)
    js = jscoring.ChunkedScorer(jnp.asarray(doc_ids), jnp.asarray(tfs), inv)
    ts = tscoring.ChunkedScorer(t(doc_ids), t(tfs), inv)
    ja, jc = js.new_acc(with_cnt, rows=B)
    ta, tc = ts.new_acc(with_cnt, rows=B)
    for lengths in ((16, 0, 600, 3), (513, 40, 0, 1)):
        tl = [rng.integers(0, len(doc_ids), size=m).astype(np.int64) for m in lengths]
        tl[0][3:5] = tl[0][0]  # one tile twice
        wl = [(rng.random(m) * 2).astype(np.float32) for m in lengths]
        ja, jc = js.score_into(ja, jc, tl, wl)
        assert ts.score_pass(ta, tc, tl, wl) == 1
        np.testing.assert_array_equal(bits(ta.numpy()), bits(ja))
        if with_cnt:
            np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))


def tile_passes(acc, cnt, doc_ids, tfs, inv_norm, tile_lists, weight_lists):
    """csrc/ordered_scatter.cu's BM25 tile add in plain torch on the CPU,
    over `tile_layout` and `pack_tiles` and with the kernels' own index
    arithmetic: the window's chunks, rows end to end; a chunk block finds
    its row by the chunk offsets, reads its 16 tiles from the postings,
    keeps the valid slots in slot order with their contributions, and
    stages them by (bucket, position) at its place; the count table is
    bucket-major over each row's chunks of the window; a (row, bucket)
    block gathers its slots chunk by chunk in pieces of CHUNK and adds each
    piece's runs. With window 0, each (row, bucket) keeps the row's slots
    that aim in its bucket and adds their runs."""
    R, C = acc.shape
    lens = [len(x) for x in tile_lists] + [0] * (R - len(tile_lists))
    lay = osc.tile_layout(C, lens)
    plan = osc.pack_tiles(tile_lists, weight_lists, R)
    off, coff = plan[: R + 1], plan[R + 1 : 2 * R + 2]
    tiles = plan[2 * R + 2 : 2 * R + 2 + lay.tiles]
    weights = plan[2 * R + 2 + lay.tiles :].view(np.float32)
    CH, TPC, nb, width = osc.CHUNK, osc.TILES_A_CHUNK, lay.buckets, lay.width

    def slots(r, q0):  # row r's slots q0 .. q0 + CHUNK: targets, contributions, in slot order
        js = np.arange(off[r] + q0 // 128, min(off[r] + q0 // 128 + TPC, off[r + 1]))
        if not len(js):
            return torch.zeros(0, dtype=torch.long), torch.zeros(0)
        ti = t(tiles[js].astype(np.int64))[None]
        tgt, s, valid = tscoring._chunk_scores(doc_ids, tfs, inv_norm, ti, t(weights[js])[None],
                                               torch.ones_like(ti, dtype=torch.bool))
        keep = valid.flatten() & (tgt.flatten() < C - 1)
        return tgt.flatten()[keep].long(), s.flatten()[keep]

    def row_chunks(r, g0, g1):
        a, b = max(coff[r], g0), min(coff[r + 1], g1)
        return a - g0, max(b - a, 0)

    if not lay.window:
        for r in range(R):
            tg, v = slots(r, 0)
            for b in range(nb):
                keep = (tg >= b * width) & (tg < min((b + 1) * width, C - 1))
                if keep.any():
                    _add_runs(acc[r], None if cnt is None else cnt[r], tg[keep], v[keep],
                              torch.ones(int(keep.sum()), dtype=torch.int32))
        return lay
    for g0 in range(0, lay.chunks, lay.window):
        g1 = min(g0 + lay.window, lay.chunks)
        W = g1 - g0
        counts = np.full(nb * W, -1, np.int64)
        stage = [None] * W
        for f in range(W):
            g = g0 + f
            r = int(np.searchsorted(coff, g, side="right")) - 1  # the last row starting at or before g
            lo, n = row_chunks(r, g0, g1)
            c = f - lo
            tg, v = slots(r, int(g - coff[r]) * CH)
            order = torch.sort(tg // width, stable=True).indices
            tg, v = tg[order], v[order]
            stage[lo + c] = (tg, v)
            bk = (tg // width).numpy()
            for b in range(nb):
                idx = np.flatnonzero(bk == b)
                counts[nb * lo + b * n + c] = (int(idx[0]) << 16 | len(idx)) if len(idx) else 0
        for r in range(R):
            lo, n = row_chunks(r, g0, g1)
            for b in range(nb):
                parts = []
                for c in range(n):
                    p = int(counts[nb * lo + b * n + c])
                    tg, v = stage[lo + c]
                    parts.append((tg[p >> 16 : (p >> 16) + (p & 0xFFFF)], v[p >> 16 : (p >> 16) + (p & 0xFFFF)]))
                tg = torch.cat([x[0] for x in parts]) if parts else torch.zeros(0, dtype=torch.long)
                v = torch.cat([x[1] for x in parts]) if parts else torch.zeros(0)
                for p0 in range(0, len(tg), CH):
                    _add_runs(acc[r], None if cnt is None else cnt[r], tg[p0 : p0 + CH], v[p0 : p0 + CH],
                              torch.ones(len(tg[p0 : p0 + CH]), dtype=torch.int32))
        assert (counts >= 0).all()  # every (chunk, bucket) word written
    return lay


@pytest.mark.parametrize("rows,lengths,C,windows", [
    (1, (16,), 5_001, 1),  # one launch, row_kernel
    (3, (16, 0, 9), 2_001, 1),
    (1, (513,), 100_001, 2),  # one row across windows
    (4, (40, 0, 300, 17), 3_001, 12),  # ragged rows, two chunks a window
    (5, (100, 33, 0, 250, 64), 20_001, 2),  # a row split across two windows
])
def test_tile_passes_match_plain(rows, lengths, C, windows):
    """The kernels' passes (`tile_passes`) against the plain version,
    with and without the count plane: the same bits and counts; the
    layout takes the windows named, its scratch within the accumulator's
    words (at least one chunk)."""
    rng = np.random.default_rng(C + rows)
    doc_ids, tfs, inv, tiles, weights = tile_pass_inputs(rng, C - 1, lengths)
    acc0 = rng.standard_normal((rows, C)).astype(np.float32)
    acc0[:, -1] = 0
    cnt0 = rng.integers(0, 3, size=(rows, C)).astype(np.int32)
    args = (t(doc_ids), t(tfs), t(inv), tiles, weights)
    for with_cnt in (False, True):
        want, want_cnt = tscoring.bm25_tile_add_plain(t(acc0.copy()), t(cnt0.copy()) if with_cnt else None, *args)
        got, got_cnt = t(acc0.copy()), t(cnt0.copy()) if with_cnt else None
        lay = tile_passes(got, got_cnt, *args)
        assert lay.windows == windows, lay
        assert lay.scratch_words <= max(rows * C, lay.buckets + 2 * osc.CHUNK)
        np.testing.assert_array_equal(bits(got.numpy()), bits(want.numpy()))
        if with_cnt:
            np.testing.assert_array_equal(got_cnt.numpy(), want_cnt.numpy())


def test_tile_layout_follows_the_pass():
    """The scratch follows the pass's own tiles (not rows x its longest
    row) and never exceeds the accumulator's words but by one chunk's; a
    window holds at most MAX_CHUNKS chunks; the cell's one-row passes take
    one window, or two past 1,726 chunks; rows of at most 16 tiles take
    one launch and no scratch."""
    C = 8_841_824
    one = osc.tile_layout(C, [10_784])
    assert (one.chunks, one.window, one.windows) == (674, 674, 1) and one.scratch_words <= C
    assert osc.tile_layout(C, [28_000]).windows == 2
    ragged = osc.tile_layout(C, [10_784] + [0] * 31)
    assert ragged.scratch_words == one.scratch_words and ragged.buckets == one.buckets
    wide = osc.tile_layout(C, [65_536] * 32)
    assert wide.window == osc.MAX_CHUNKS and wide.windows == 8 and wide.scratch_words <= 32 * C
    assert osc.tile_layout(C, [16, 3, 0]).window == 0 == osc.tile_layout(C, [16]).scratch_words
    tiny = osc.tile_layout(301, [40])
    assert tiny.window == 1 and tiny.windows == 3 and tiny.scratch_words == tiny.buckets + 2 * osc.CHUNK
    with pytest.raises(ValueError, match="no layout"):
        osc.tile_layout(C, [0, 0])


def fused_inputs(seed, with_live=False):
    rng = np.random.default_rng(seed)
    n = 1500
    doc_ids, tfs = postings(rng, n, 30, 400)
    inv = dyadic_inv(rng, n)
    dense = rng.integers(0, 4, size=(5, n)).astype(np.uint8)
    live = rng.random(n) > 0.25 if with_live else None
    plans = []
    for _ in range(7):
        nt = int(rng.integers(1, 20))
        rt = rng.choice(len(doc_ids), size=nt, replace=False).astype(np.int64)
        rt = np.concatenate([rt, rt[:1]])  # a query token given twice
        rw = (rng.random(nt + 1) * 2 + 0.1).astype(np.float32)
        nh = int(rng.integers(0, 4))
        hr = rng.choice(5, size=nh, replace=False).astype(np.int64)
        hw = (rng.random(nh) * 2 + 0.1).astype(np.float32)
        plans.append((rt, rw, hr, hw, int(rng.integers(1, 3))))
    jfs = jscoring.FusedScorer(jnp.asarray(doc_ids), jnp.asarray(tfs), inv, live, jnp.asarray(dense),
                               t_rare=32, n_hot_slots=4)
    tfs_ = tscoring.FusedScorer(t(doc_ids), t(tfs), inv, live, t(dense), t_rare=32, n_hot_slots=4)
    return jfs, tfs_, plans


@pytest.mark.parametrize("with_cnt,with_live", [(False, False), (True, False), (True, True)])
def test_fused_query_bits_match_reference(with_cnt, with_live):
    jfs, tfs_, plans = fused_inputs(11 + with_cnt, with_live)
    js, jd, jt = jfs.search(plans, 40, with_cnt, rows=8)
    ts, td, tt = tfs_.search(plans, 40, with_cnt, rows=8)
    np.testing.assert_array_equal(bits(ts), bits(js))
    np.testing.assert_array_equal(td, jd)
    np.testing.assert_array_equal(tt, jt)


def multi_fused(seed):
    rng = np.random.default_rng(seed)
    n = 1200
    jparts, tparts = [], []
    for _ in range(2):
        doc_ids, tfs = postings(rng, n, 25, 400)
        inv = dyadic_inv(rng, n)
        dense = rng.integers(0, 4, size=(3, n)).astype(np.uint8)
        jparts.append({"doc_ids": jnp.asarray(doc_ids), "tfs": jnp.asarray(tfs), "inv_norm": jnp.asarray(inv),
                       "dense": jnp.asarray(dense), "hot_rank": None})
        tparts.append({"doc_ids": t(doc_ids), "tfs": t(tfs), "inv_norm": t(inv), "dense": t(dense),
                       "hot_rank": None})
    live = rng.random(n) > 0.2
    jm = jscoring.MultiFusedScorer(("title", "body"), jparts, jnp.asarray(live), t_rare=32, n_hot_slots=4)
    tm = tscoring.MultiFusedScorer(("title", "body"), tparts, live, t_rare=32, n_hot_slots=4)
    return jm, tm


def multi_plans(seed, scorer):
    rng = np.random.default_rng(seed + 100)
    plans = []
    for _ in range(6):
        fields = []
        for p in scorer.parts:
            nt = int(rng.integers(1, 12))
            rt = rng.choice(int(p["doc_ids"].shape[0]), size=nt, replace=False).astype(np.int64)
            rt = np.concatenate([rt, rt[-1:]])
            rw = ((rng.random(nt + 1) * 2 + 0.1) * rng.choice([-1, 1], size=nt + 1)).astype(np.float32)
            nh = int(rng.integers(0, 3))
            hr = rng.choice(3, size=nh, replace=False).astype(np.int64)
            hw = ((rng.random(nh) * 2 + 0.1) * rng.choice([-1, 1], size=nh)).astype(np.float32)
            fields.append((rt, rw, hr, hw))
        plans.append((fields, int(rng.integers(1, 3))))
    return plans


@pytest.mark.parametrize("combine,tie", [("sum", 0.0), ("max_tie", 0.5)])
def test_fused_query_mf_bits_match_reference(combine, tie):
    jm, tm = multi_fused(21)
    plans = multi_plans(21, tm)
    js, jd, jt = jm.search(plans, 30, combine, tie, rows=8)
    ts, td, tt = tm.search(plans, 30, combine, tie, rows=8)
    np.testing.assert_array_equal(bits(ts), bits(js))
    np.testing.assert_array_equal(td, jd)
    np.testing.assert_array_equal(tt, jt)


@pytest.mark.parametrize("quantized", [False, True])
def test_impact_chunk_add_bits_match_reference(quantized):
    rng = np.random.default_rng(31 + quantized)
    n, B, TC = 800, 5, 24
    doc_ids, _ = postings(rng, n, 15, 600)
    if quantized:
        values = rng.integers(-127, 128, size=doc_ids.shape).astype(np.int8)
    else:
        values = rng.standard_normal(doc_ids.shape).astype(np.float32)
    acc0 = rng.random((B, n + 1)).astype(np.float32)
    acc0[:, n] = 0
    cnt0 = np.zeros((B, n + 1), np.int32)
    ti = rng.integers(0, len(doc_ids), size=(B, TC)).astype(np.int32)
    ti[:, 5] = ti[:, 2]
    tw = (rng.random((B, TC)) * 0.05).astype(np.float32)
    tv = rng.random((B, TC)) > 0.25
    ja, jc = jimpact._impact_chunk_add(jnp.asarray(doc_ids), jnp.asarray(values), jnp.asarray(acc0),
                                       jnp.asarray(cnt0), jnp.asarray(ti), jnp.asarray(tw), jnp.asarray(tv))
    ta, tc = timpact._impact_chunk_add(t(doc_ids), t(values), t(acc0.copy()), t(cnt0.copy()),
                                       t(ti).long(), t(tw), t(tv))
    np.testing.assert_array_equal(bits(ta.numpy()), bits(ja))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))


@pytest.mark.parametrize("T,count_signed", [(8, False), (8, True), (520, False)])
def test_bm25_into_bits_match_reference(T, count_signed):
    """parallel/sharded._bm25_into over stacked entries [E, B, T] (T past
    TCHUNK runs two chunks) against the reference's per-entry step body:
    `bm25_tile_contrib` and `.at[].add` row by row."""
    rng = np.random.default_rng(41 + T + count_signed)
    E, B, n = 3, 2, 500
    planes = [postings(rng, n, 10, 400) for _ in range(E)]
    nt = max(len(p[0]) for p in planes)
    dids = np.full((E, nt, TILE), -1, np.int32)
    tfs = np.zeros((E, nt, TILE), np.int32)
    for e, (d, f) in enumerate(planes):
        dids[e, : len(d)], tfs[e, : len(f)] = d, f
    inv = np.stack([dyadic_inv(rng, n) for _ in range(E)])
    ti = rng.integers(0, nt, size=(E, B, T)).astype(np.int32)
    ti[:, :, 1] = ti[:, :, 0]
    tw = ((rng.random((E, B, T)) * 2 + 0.1) * (rng.choice([-1, 1], size=(E, B, T)) if count_signed else 1))
    tw = tw.astype(np.float32)
    tv = rng.random((E, B, T)) > 0.2
    acc = torch.zeros(E * B, n + 1)
    cnt = torch.zeros(E * B, n + 1, dtype=torch.int32)
    tsharded._bm25_into(acc, cnt, t(dids), t(tfs), t(inv), t(ti), t(tw), t(tv), count_signed)
    for e in range(E):
        rows_d = jnp.asarray(dids[e])[jnp.clip(jnp.asarray(ti[e]), 0, nt - 1)]
        rows_t = jnp.asarray(tfs[e])[jnp.clip(jnp.asarray(ti[e]), 0, nt - 1)]
        valid = (rows_d >= 0) & jnp.asarray(tv[e])[:, :, None]
        w = (jnp.abs(tw[e]) if count_signed else jnp.asarray(tw[e]))[:, :, None]
        tgt, s = jscoring.bm25_tile_contrib(rows_d, rows_t, w, valid, jnp.asarray(inv[e]), n)
        ja = jax.vmap(lambda a, d, v: a.at[d.ravel()].add(v.ravel()))(jnp.zeros((B, n + 1), jnp.float32), tgt, s)
        counted = valid & (jnp.asarray(tw[e]) > 0)[:, :, None] if count_signed else valid
        jc = jax.vmap(lambda c, d, v: c.at[d.ravel()].add(v.ravel().astype(jnp.int32)))(
            jnp.zeros((B, n + 1), jnp.int32), tgt, counted)
        np.testing.assert_array_equal(bits(acc[e * B : (e + 1) * B].numpy()), bits(ja))
        np.testing.assert_array_equal(cnt[e * B : (e + 1) * B].numpy(), np.asarray(jc))


# ---- the mesh rescore, in the per-shard path's shapes ----

RR_MAPPING = {"properties": {"body": {"type": "text"},
                             "toks": {"type": "rank_vectors", "dims": 8, "similarity": "dot_product"}}}


@pytest.mark.parametrize("quantized", [False, True])
def test_mesh_rescore_runs_per_shard_shapes_and_bits(monkeypatch, quantized):
    """The forced mesh's fused rescore on a 4-shard index against the
    per-shard path of the same index: every maxsim product the mesh
    runs has the shapes (rows, query tokens, window bucket, gather
    width) of one the per-shard path runs, and the pages are equal bit
    for bit."""
    from elasticsearch_tpu_torch.cluster.indices import IndexService
    from elasticsearch_tpu_torch.ops import rerank as trerank

    shapes = {"mesh": set(), "shard": set()}
    real = trerank.maxsim_candidates
    path = ["mesh"]

    def spy(qtoks, qvalid, starts, counts, toks, scales, docs, tmax):
        shapes[path[0]].add((tuple(qtoks.shape), tuple(docs.shape), int(tmax)))
        return real(qtoks, qvalid, starts, counts, toks, scales, docs, tmax)

    monkeypatch.setattr(trerank, "maxsim_candidates", spy)
    settings = {"number_of_shards": 4, "search.backend": "torch"}
    if quantized:
        settings["rerank.quantization"] = "int8"
    svc = IndexService(f"osc-rr-{int(quantized)}", settings=settings, mappings_json=RR_MAPPING, device="cpu")
    words = ["alpha beta", "alpha gamma", "beta gamma", "alpha beta gamma"]
    try:
        rng = np.random.default_rng(3)
        for i in range(120):
            svc.index_doc(str(i), {"body": words[i % 4],
                                   "toks": rng.normal(size=(1 + i % 4, 8)).round(3).tolist()})
        svc.refresh()
        for s, w in enumerate(words[:3]):
            body = {"query": {"match": {"body": w.split()[0]}}, "size": 10,
                    "rescore": {"window_size": 20, "query": {
                        "rescore_query": {"rank_vectors": {
                            "field": "toks",
                            "query_vectors": np.random.default_rng(s).normal(size=(3, 8)).round(3).tolist()}},
                        "query_weight": 0.5, "rescore_query_weight": 2.0}}}
            mex = svc.mesh_executor()
            routed = mex.stats["routed"]
            path[0] = "mesh"
            monkeypatch.setenv("ES_TPU_MESH", "force")
            got = svc.search(dict(body))
            assert mex.stats["routed"] == routed + 1
            path[0] = "shard"
            monkeypatch.setenv("ES_TPU_MESH", "off")
            ref = svc.search(dict(body))
            pages = [[(h["_id"], np.float32(h["_score"]).view(np.int32)) for h in r["hits"]["hits"]]
                     for r in (got, ref)]
            assert pages[0] == pages[1] and len(pages[0]) == 10
        assert shapes["mesh"] and shapes["mesh"] <= shapes["shard"], shapes
    finally:
        svc.close()
