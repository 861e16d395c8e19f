"""Inputs for the ordered scatter-add's tests, on the CPU
(`test_torch_ordered_scatter.py`) and on the card (`test_torch_cuda.py`):
hard cases made with numpy from a seed at any shape, and the slots the
function applies. Imports numpy only."""

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
