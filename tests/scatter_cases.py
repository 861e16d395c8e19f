"""Inputs for the ordered scatter-add's tests, on the CPU
(`test_torch_ordered_scatter.py`) and on the card (`test_torch_cuda.py`):
hard cases made with numpy from a seed at any shape, and the slots the
function applies; the BM25 and impact tile adds' passes, and the paths
they replaced (`parent_chunk_pass`, `parent_impact_pass`), which the
card's tests, `chip_smoke.py` and `scripts/torch_scatter_times.py` hold
them to. Imports numpy only; the port's ops are imported when a pass is
scored."""

import numpy as np

SCATTER_KINDS = ("sparse", "all_valid", "one_cell_every_tile", "repeat_in_tile", "out_of_range",
                 "signed_zero_subnormal")


def hard_scatter_case(kind, R, C, S, seed):
    """acc f32 [R, C], cnt int32 [R, C], tgt int32 [R, S], src f32 [R, S],
    inc int32 [R, S] as numpy arrays, made fast at any shape (the overflow
    column C-1 starts at +0.0 and count 0):
    sparse: a few valid slots a tile, the rest padding (C-1, +0.0, inc 0);
    all_valid: every slot aims at a random cell, repeats within a tile;
    one_cell_every_tile: cell (7r) mod (C-1) in every tile of row r, the
    rest sparse; repeat_in_tile: each tile draws from 5 cells;
    out_of_range: a tenth of the slots aim below 0 or at C and past it,
    with values and increments (not applied);
    signed_zero_subnormal: -0.0, +0.0, subnormals and magnitudes from
    1e-30 to 1e30 in acc and src."""
    rng = np.random.default_rng(seed)
    shape = (R, S)
    mags = 10.0 ** rng.integers(-3, 4, shape)
    src = (rng.standard_normal(shape) * mags).astype(np.float32)
    tgt = rng.integers(0, C - 1, shape).astype(np.int32)
    if kind in ("sparse", "one_cell_every_tile", "out_of_range"):
        pad = rng.random(shape) > 0.08
    else:
        pad = np.zeros(shape, bool)
    if kind == "repeat_in_tile":
        pool = rng.integers(0, C - 1, (R, S // 128, 5))
        pick = rng.integers(0, 5, (R, S // 128, 128))
        tgt = np.take_along_axis(pool, pick, 2).reshape(shape).astype(np.int32)
    if kind == "one_cell_every_tile":
        cells = (7 * np.arange(R) % (C - 1)).astype(np.int32)
        tiles = tgt.reshape(R, S // 128, 128)
        tiles[tgt.reshape(R, S // 128, 128) == cells[:, None, None]] = C - 1  # once a tile
        tiles[:, :, 5] = cells[:, None]
        pad.reshape(R, S // 128, 128)[:, :, 5] = False
    acc = (rng.standard_normal((R, C)) * 10.0 ** rng.integers(-3, 4, (R, C))).astype(np.float32)
    if kind == "signed_zero_subnormal":
        special = np.array([-0.0, 0.0, 1e-45, -1e-45, 1.1754942e-38, -3e-39, 1e-30, -1e30, 1e30],
                           np.float32)
        src = np.where(rng.random(shape) < 0.5, rng.choice(special, shape), src).astype(np.float32)
        acc = np.where(rng.random((R, C)) < 0.5, rng.choice(special, (R, C)), acc).astype(np.float32)
        tgt = rng.integers(0, min(C - 1, 64), shape).astype(np.int32)  # long runs of them
    tgt[pad] = C - 1
    src[pad] = 0.0
    inc = (tgt != C - 1).astype(np.int32) * rng.integers(1, 4, shape).astype(np.int32)
    if kind == "out_of_range":
        far = rng.random(shape) < 0.1
        tgt[far] = rng.choice(np.array([-1, -7, -(2 ** 31), C, C + 5, 2 ** 30], np.int64),
                              int(far.sum())).astype(np.int32)
        inc[far] = 1
    acc[:, C - 1] = 0.0
    cnt = rng.integers(0, 5, (R, C)).astype(np.int32)
    cnt[:, C - 1] = 0
    return acc, cnt, tgt, src, inc


def applied(tgt, src, inc, C):
    """The slots the function applies: a target outside [0, C-1) goes to
    the overflow column with +0.0 and inc 0, as padding does, so that
    `scatter_add_` (which takes no target past C-1) can hold the result."""
    off = (tgt < 0) | (tgt >= C - 1)
    return (np.where(off, C - 1, tgt).astype(np.int32), np.where(off, 0.0, src).astype(np.float32),
            np.where(off, 0, inc).astype(np.int32))


def tile_pass_case(C, lengths, seed, table=None):
    """A BM25 pass's inputs over C - 1 docs as numpy arrays: postings
    doc_ids/tfs int32 [table, 128] (a tile's docs distinct and ascending,
    a tenth of the tiles ending in padding, doc -1 and tf 0), tfs 1-40,
    inv_norm f32 of any value in [0.05, 3), and row r's list of
    `lengths[r]` tiles drawn from the table (so a tile may repeat) with a
    weight in [0.1, 8) a tile."""
    rng = np.random.default_rng(seed)
    n = C - 1
    table = table or max(max(lengths), 1) + 1000
    lane = np.arange(128)
    step = max(n // 128, 1)
    doc_ids = (lane * step)[None, :] + rng.integers(0, step, (table, 128))
    doc_ids = np.minimum(doc_ids, n - 1).astype(np.int32)
    tfs = rng.integers(1, 41, (table, 128)).astype(np.int32)
    pad = (rng.random(table) < 0.1)[:, None] & (lane[None, :] >= rng.integers(1, 128, table)[:, None])
    doc_ids[pad], tfs[pad] = -1, 0
    inv = rng.uniform(0.05, 3.0, n).astype(np.float32)
    tiles = [rng.integers(0, table, m).astype(np.int64) for m in lengths]
    weights = [rng.uniform(0.1, 8.0, m).astype(np.float32) for m in lengths]
    return doc_ids, tfs, inv, tiles, weights


def parent_chunks(rows, tiles, weights, width):
    """A pass's lists as the replaced path took them, in order: the
    [rows, width] tile ids (int32), weights and validity of each `width`
    tiles of the lists; rows past the lists and slots past a row's list
    are invalid."""
    for c0 in range(0, max((len(x) for x in tiles), default=0), width):
        ti = np.zeros((rows, width), np.int32)
        tw = np.zeros((rows, width), np.float32)
        tv = np.zeros((rows, width), bool)
        for j, (tl, wl) in enumerate(zip(tiles, weights)):
            m = len(tl[c0 : c0 + width])
            ti[j, :m], tw[j, :m], tv[j, :m] = tl[c0 : c0 + m], wl[c0 : c0 + m], True
        yield ti, tw, tv


def parent_chunk_pass(acc, cnt, doc_ids, tfs, inv_norm, tiles, weights):
    """One pass into acc [rows, C] (and cnt) as the port scored it before
    the BM25 tile add: a host step a TCHUNK-tile chunk (`parent_chunks`),
    each one packed upload, PyTorch's gathers and BM25 formula
    (`_chunk_scores`) and the ordered scatter-add."""
    import torch

    from elasticsearch_tpu_torch.ops import ordered_scatter, scoring

    for ti, tw, tv in parent_chunks(acc.shape[0], tiles, weights, scoring.TCHUNK):
        dev = scoring.upload(np.stack([ti, tw.view(np.int32), tv.astype(np.int32)]), acc.device)
        tgt, s, valid = scoring._chunk_scores(doc_ids, tfs, inv_norm, dev[0].long(), dev[1].view(torch.float32),
                                              dev[2] != 0)
        ordered_scatter.ordered_scatter_add(acc, tgt, s, cnt, None if cnt is None else valid.to(torch.int32))


def impact_pass_case(C, lengths, seed, quantized):
    """A learned-sparse pass's inputs over C - 1 docs as numpy arrays: the
    impact column's doc_ids int32 [table, 128] (as `tile_pass_case` draws
    them) and its stored impacts [table, 128], f32 in (0, 4] or int8 in
    [1, 127] (padding slots keep a value, which is not applied), and row
    r's list of `lengths[r]` tiles drawn from the table with a weight a
    tile (for int8, a query weight times a dequant scale)."""
    rng = np.random.default_rng(seed)
    doc_ids, _, _, tiles, _ = tile_pass_case(C, lengths, seed)
    shape = doc_ids.shape
    if quantized:
        values = rng.integers(1, 128, shape).astype(np.int8)
        weights = [(rng.uniform(0.1, 4.0, len(t)) * rng.uniform(0.001, 0.04, len(t))).astype(np.float32)
                   for t in tiles]
    else:
        values = np.minimum(np.exp(np.log(0.4) + 0.7 * rng.standard_normal(shape)), 4.0).astype(np.float32)
        weights = [rng.uniform(0.1, 4.0, len(t)).astype(np.float32) for t in tiles]
    return doc_ids, values, tiles, weights


def parent_impact_pass(acc, cnt, doc_ids, values, tiles, weights):
    """One pass into acc [rows, C] and cnt as the port scored it before the
    impact tile add (`ImpactScorer.score_pass`'s loop): a host step a
    TCHUNK-tile chunk (`parent_chunks`), each one packed upload, then
    PyTorch's gathers and product (`_impact_chunk_add`) and the ordered
    scatter-add."""
    import torch

    from elasticsearch_tpu_torch.ops import impact, scoring

    for ti, tw, tv in parent_chunks(acc.shape[0], tiles, weights, scoring.TCHUNK):
        dev = scoring.upload(np.stack([ti, tw.view(np.int32), tv.astype(np.int32)]), acc.device)
        impact._impact_chunk_add(doc_ids, values, acc, cnt, dev[0].long(), dev[1].view(torch.float32), dev[2] != 0)
