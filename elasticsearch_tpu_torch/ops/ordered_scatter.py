"""The port's float accumulator: an ordered tile scatter-add, a CUDA
kernel and its plain PyTorch version.

Every BM25 and sparse score the port serves is summed term-at-a-time
into a dense per-doc accumulator, `acc[r, tgt[r, s]] += src[r, s]`.
The JAX package does this with `.at[].add`, which on the CPU adds a
cell's contributions one after another in slot order, as the numpy
oracle's `np.add.at` does. `scatter_add_`/`index_add_` keep that order
on the CPU but add with float atomics on the card, so a doc's last ulp
(and with it the order of two docs within an ulp) changed from run to
run there. `csrc/ordered_scatter.cu`, built with `nvcc` for sm_90a into
`_build/` at first use and bound through `ctypes`, adds in slot order
on the card: the same bits as the plain version on the CPU, every run.

`ordered_scatter_add` launches that kernel for CUDA tensors and raises
if the build or the launch fails; it takes the plain version
`ordered_scatter_add_plain` only for CPU tensors. Each launch adds one
to `ordered_scatter_add.launches`.

Inputs: `acc` f32 [R, C] (or [C], one row), contiguous, whose last
column C-1 is the overflow column; `tgt` int32 [R, S] with S a multiple
of TILE_WIDTH; `src` f32 [R, S]; optionally an int32 plane `cnt`
[R, C] with its increments `inc` int32 [R, S], added in the same pass
(integer sums are exact in any order). Invalid slots target C-1 with
+0.0 and inc 0; the kernel applies no slot whose target lies outside
[0, C-1). A target may repeat within a tile (the served paths never
repeat one: a doc occurs at most once in a term's postings).

The kernel groups the valid slots by cell range in scratch memory that
the wrapper allocates on the current stream; `layout` sizes it, and
the grids, from the shapes alone (every slot valid at worst), so a
launch never waits for the card. Rows of at most CHUNK slots take one
launch and no scratch; rows of more than MAX_CHUNKS chunks are taken in
windows, one after another. This module owns the layout: its constants
reach the CUDA source as `-D` flags at build time (`DEFINES`).

The same source holds the ordered tile adds of one scoring pass, BM25
(`es_bm25_tile_add`) and learned-sparse impacts (`es_impact_tile_add`):
the kernels compute each slot's target and contribution from the
postings themselves, row r's tiles in list order.
`ops/scoring.py:bm25_tile_add` and `ops/impact.py:impact_tile_add` are
their entries and their plain versions; here are their layout
(`tile_layout`), their packed plan (`pack_tiles`) and their launches
(`launch_tile_add`, `launch_impact_add`).
"""

from __future__ import annotations

import ctypes
import functools
from pathlib import Path
from typing import NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from . import nvcc

TILE_WIDTH = 128
SOURCE = nvcc.CSRC / "ordered_scatter.cu"
CHUNK = 2048  # slots a chunk, slots a piece (256 threads x 8 keys)
MAX_BUCKETS = 1024  # buckets a row
MAX_WIDTH_BITS = 20
MAX_WIDTH = 1 << MAX_WIDTH_BITS  # cells a bucket
MAX_CHUNKS = 16_384  # chunks a window (their offsets sit in one apply block's shared memory)
BUCKETS = 1024  # buckets a call aims at over all its rows: blocks for 132 SMs
SLOTS_PER_BUCKET = 64  # ... but no more than one per this many slots
DEFINES = {"ES_TILE": TILE_WIDTH, "ES_CHUNK": CHUNK, "ES_MAX_BUCKETS": MAX_BUCKETS,
           "ES_MAX_WIDTH_BITS": MAX_WIDTH_BITS, "ES_MAX_CHUNKS": MAX_CHUNKS}


class Layout(NamedTuple):
    """The kernels' scratch for R rows of C cells and S slots. With
    chunks 0, rows of at most CHUNK slots take one launch, grid (buckets,
    R), and no scratch; else each window of `chunks` chunks takes two,
    grids (chunks, R) blocks, then R x buckets, over the same scratch."""

    chunks: int  # CHUNK-slot chunks a window (0: one launch)
    windows: int  # windows a row, launched one after another
    buckets: int  # cell ranges a row
    width: int  # cells a bucket
    count_words: int  # (start, count) words: R x buckets x chunks
    stage_slots: int  # staged slots a plane: R x chunks x CHUNK
    scratch_words: int  # int32 words of scratch in all


@functools.lru_cache(maxsize=1024)
def layout(R: int, C: int, S: int, with_cnt: bool) -> Layout:
    """Sizes every scratch buffer and grid from the shapes alone, for the
    worst case of all R x S slots valid: each chunk of a window stages its
    slots at a fixed place, and a call has about BUCKETS buckets over its
    rows, so that one row fills the card as 32 rows do, or one per
    SLOTS_PER_BUCKET slots where that is fewer."""
    if C - 1 < 1 or R < 1 or S < 1:
        raise ValueError(f"ordered_scatter_add: no layout for R={R}, C={C}, S={S}")
    buckets, width = _buckets(C - 1, R * S, R)
    if S <= CHUNK:
        return Layout(0, 1, buckets, width, 0, 0, 0)
    chunks = min(-(-S // CHUNK), MAX_CHUNKS)
    windows = -(-S // (chunks * CHUNK))
    count_words = R * buckets * chunks
    stage_slots = R * chunks * CHUNK
    planes = 3 if with_cnt else 2
    return Layout(chunks, windows, buckets, width, count_words, stage_slots,
                  count_words + planes * stage_slots)


def _buckets(cells: int, slots: int, rows: int) -> Tuple[int, int]:
    """(buckets a row, cells a bucket): about BUCKETS buckets over the
    `rows` rows that hold `slots` slots in all, or one per
    SLOTS_PER_BUCKET slots where that is fewer; none past the last cell."""
    if cells > MAX_BUCKETS * MAX_WIDTH:
        raise ValueError(f"ordered_scatter_add: {cells} cells a row exceed {MAX_BUCKETS * MAX_WIDTH}")
    aim = min(BUCKETS, -(-slots // SLOTS_PER_BUCKET))
    buckets = max(min(MAX_BUCKETS, cells, -(-aim // rows)), -(-cells // MAX_WIDTH))
    width = -(-cells // buckets)
    return -(-cells // width), width


TILES_A_CHUNK = CHUNK // TILE_WIDTH


class TileLayout(NamedTuple):
    """A tile add's grids and scratch for one pass of R rows of C
    cells. The rows' lists lie end to end, CHUNK slots (16 tiles) a
    chunk; with window 0 every row holds at most one chunk and the pass
    takes one launch, grid (buckets, R), and no scratch; else the pass's
    chunks are taken `window` at a time, each window two launches, grids
    (chunks of the window) blocks, then R x buckets, over one scratch."""

    tiles: int  # tiles in all rows
    chunks: int  # chunks in all rows (0: one launch)
    window: int  # chunks a window (0: one launch)
    windows: int  # windows, launched one after another
    buckets: int  # cell ranges a row
    width: int  # cells a bucket
    scratch_words: int  # int32 words: buckets count words and 2 x CHUNK staged slots a chunk of a window


def tile_layout(C: int, row_tiles: Sequence[int]) -> TileLayout:
    """Sizes the pass's grids and scratch from its rows' tile counts alone.
    A window stages at most MAX_CHUNKS chunks (the apply block's shared
    memory) and at most the accumulator's R x C words, but at least one
    chunk: the scratch follows the tiles the pass has, not R times its
    longest row."""
    R = len(row_tiles)
    tiles = int(sum(row_tiles))
    if C - 1 < 1 or R < 1 or tiles < 1:
        raise ValueError(f"tile_layout: no layout for R={R}, C={C}, {tiles} tiles")
    if max(row_tiles) * TILE_WIDTH > 2**31 - 1:
        raise ValueError(f"tile_layout: a row of {max(row_tiles)} tiles exceeds 2^31 slots")
    buckets, width = _buckets(C - 1, tiles * TILE_WIDTH, sum(1 for n in row_tiles if n))
    if max(row_tiles) <= TILES_A_CHUNK:
        return TileLayout(tiles, 0, 0, 1, buckets, width, 0)
    chunks = int(sum(-(-n // TILES_A_CHUNK) for n in row_tiles))
    per_chunk = buckets + 2 * CHUNK
    window = min(MAX_CHUNKS, chunks, max(1, R * C // per_chunk))
    return TileLayout(tiles, chunks, window, -(-chunks // window), buckets, width, window * per_chunk)


def pack_tiles(tile_lists, weight_lists, rows: int) -> np.ndarray:
    """One pass as the kernel reads it, one int32 array for one upload:
    each row's first tile (R+1 words), each row's first chunk (R+1), the
    tile ids of every row end to end (T), then their float32 weights
    (T, bitcast). Rows past the lists are empty."""
    lens = np.zeros(rows, np.int64)
    lens[: len(tile_lists)] = [len(t) for t in tile_lists]
    T = int(lens.sum())
    buf = np.empty(2 * (rows + 1) + 2 * T, np.int32)
    buf[0] = buf[rows + 1] = 0
    np.cumsum(lens, out=buf[1 : rows + 1])
    np.cumsum(-(-lens // TILES_A_CHUNK), out=buf[rows + 2 : 2 * rows + 2])
    at = 2 * (rows + 1)
    if T:
        np.concatenate(tile_lists, out=buf[at : at + T], casting="unsafe")
        np.concatenate(weight_lists, out=buf[at + T :].view(np.float32), casting="same_kind")
    return buf


def _launch_pass(name, entry, acc, cnt, doc_ids, planes, plan, lay: TileLayout, flags=()) -> None:
    """Checks what both tile adds take of one pass (one CUDA device, f32
    acc, int32 cnt, postings and plan, [n_tiles, 128] planes, contiguity),
    then calls the C entry `entry` with its scratch on the current stream,
    or raises. `planes` are the source's planes after the doc ids, and
    `flags` its int arguments before the shapes, in the entry's order."""
    tensors = [x for x in (acc, cnt, doc_ids, *planes, plan) if x is not None]
    devices = {x.device for x in tensors}
    if len(devices) != 1 or next(iter(devices)).type != "cuda":
        raise ValueError(f"{name}: the kernel takes tensors on one CUDA device, got {devices}")
    ints = [x for x in (cnt, doc_ids, plan) if x is not None]
    if acc.dtype != torch.float32 or any(x.dtype != torch.int32 for x in ints):
        raise TypeError(f"{name}: f32 acc, int32 cnt, doc ids and plan; got {acc.dtype}, "
                        f"{[x.dtype for x in ints]}")
    if acc.dim() != 2 or (cnt is not None and cnt.shape != acc.shape):
        raise ValueError(f"{name}: acc [R, C] (and cnt alike), got {tuple(acc.shape)}")
    if doc_ids.dim() != 2 or doc_ids.shape[1] != TILE_WIDTH or planes[0].shape != doc_ids.shape:
        raise ValueError(f"{name}: postings [n_tiles, {TILE_WIDTH}], got {tuple(doc_ids.shape)} "
                         f"and {tuple(planes[0].shape)}")
    R, C = acc.shape
    if plan.shape != (2 * (R + 1) + 2 * lay.tiles,):
        raise ValueError(f"{name}: plan {tuple(plan.shape)} does not match {R} rows and {lay.tiles} tiles")
    if not all(x.is_contiguous() for x in tensors):
        raise ValueError(f"{name}: tensors must be contiguous")
    (device,) = devices
    lib = _library()
    with torch.cuda.device(device):
        scratch = torch.empty(lay.scratch_words, dtype=torch.int32, device=device) if lay.window else None
        rc = getattr(lib, entry)(
            *(None if x is None else x.data_ptr() for x in (acc, cnt, doc_ids, *planes, plan, scratch)),
            *flags, R, C, lay.tiles, lay.chunks, lay.window, lay.buckets, lay.width,
            torch.cuda.current_stream(device).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"{name}: kernel launch failed (cudaError {rc})")


def launch_tile_add(acc, cnt, doc_ids, tfs, inv_norm, plan, lay: TileLayout) -> None:
    """Launches the BM25 tile add of one pass (`plan`, `pack_tiles` on the
    card) into acc (and cnt) on the current stream, or raises. Nothing is
    read back. Each window's launches add one to `launch_tile_add.launches`."""
    if tfs.dtype != torch.int32 or inv_norm.dtype != torch.float32:
        raise TypeError(f"bm25_tile_add: int32 tfs and f32 inv_norm, got {tfs.dtype}, {inv_norm.dtype}")
    if inv_norm.shape != (acc.shape[-1] - 1,):
        raise ValueError(f"bm25_tile_add: inv_norm {tuple(inv_norm.shape)} does not match {acc.shape[-1]} cells")
    _launch_pass("bm25_tile_add", "es_bm25_tile_add", acc, cnt, doc_ids, (tfs, inv_norm), plan, lay)
    launch_tile_add.launches += lay.windows


launch_tile_add.launches = 0


def launch_impact_add(acc, cnt, doc_ids, impacts, plan, lay: TileLayout) -> None:
    """Launches the impact tile add of one learned-sparse pass (`plan`,
    `pack_tiles` on the card, whose weights carry the dequant scale for an
    int8 column) into acc (and cnt) on the current stream, or raises.
    `impacts` is the stored plane, f32 or int8. Nothing is read back. Each
    window's launches add one to `launch_impact_add.launches`."""
    if impacts.dtype not in (torch.float32, torch.int8):
        raise TypeError(f"impact_tile_add: f32 or int8 impacts, got {impacts.dtype}")
    _launch_pass("impact_tile_add", "es_impact_tile_add", acc, cnt, doc_ids, (impacts,), plan, lay,
                 flags=(int(impacts.dtype == torch.int8),))
    launch_impact_add.launches += lay.windows


launch_impact_add.launches = 0


def build() -> Tuple[Path, str]:
    """Compiles csrc/ordered_scatter.cu with this module's layout constants
    into _build/ unless a library built from the same source and flags is
    already there."""
    return nvcc.build(SOURCE, DEFINES)


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    path, _ = build()
    lib = ctypes.CDLL(str(path))
    fn = lib.es_ordered_scatter_add
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    fn = lib.es_bm25_tile_add
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    fn = lib.es_impact_tile_add
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib


def ordered_scatter_add_plain(acc, tgt, src, cnt=None, inc=None):
    """The same function in plain PyTorch: `scatter_add_` along each row,
    which on the CPU adds a cell's contributions in slot order."""
    acc2 = acc.view(1, -1) if acc.dim() == 1 else acc
    idx = tgt.reshape(acc2.shape[0], -1).long()
    acc2.scatter_add_(1, idx, src.reshape(idx.shape))
    if cnt is not None:
        cnt2 = cnt.view(1, -1) if cnt.dim() == 1 else cnt
        cnt2.scatter_add_(1, idx, inc.reshape(idx.shape))
    return acc, cnt


def ordered_scatter_add(
    acc: torch.Tensor,
    tgt: torch.Tensor,
    src: torch.Tensor,
    cnt: Optional[torch.Tensor] = None,
    inc: Optional[torch.Tensor] = None,
):
    """acc (and cnt) += src (and inc) at tgt, each cell's additions in
    slot order, in place; returns (acc, cnt). CUDA tensors launch the
    hand-written kernel (or raise); CPU tensors take the plain version."""
    if (cnt is None) != (inc is None):
        raise ValueError("ordered_scatter_add: cnt and inc go together")
    tensors = [x for x in (acc, tgt, src, cnt, inc) if x is not None]
    devices = {x.device for x in tensors}
    if len(devices) != 1:
        raise ValueError(f"ordered_scatter_add: tensors on several devices {devices}")
    (device,) = devices
    if device.type == "cpu":
        return ordered_scatter_add_plain(acc, tgt, src, cnt, inc)
    if device.type != "cuda":
        raise ValueError(f"ordered_scatter_add: no kernel for device {device}")
    if acc.dtype != torch.float32 or src.dtype != torch.float32 or tgt.dtype != torch.int32:
        raise TypeError(
            "ordered_scatter_add takes f32 acc and src and int32 targets, "
            f"got {acc.dtype}, {src.dtype}, {tgt.dtype}"
        )
    if cnt is not None and (cnt.dtype != torch.int32 or inc.dtype != torch.int32):
        raise TypeError(f"ordered_scatter_add: int32 cnt and inc, got {cnt.dtype}, {inc.dtype}")
    if acc.dim() not in (1, 2):
        raise ValueError(f"ordered_scatter_add: acc [R, C] or [C], got {tuple(acc.shape)}")
    R, C = (1, acc.shape[0]) if acc.dim() == 1 else acc.shape
    S = tgt.numel() // R if R else 0
    if tgt.numel() != R * S or src.numel() != R * S or S % TILE_WIDTH:
        raise ValueError(
            f"ordered_scatter_add: targets {tuple(tgt.shape)} and values "
            f"{tuple(src.shape)} are not {R} rows of whole {TILE_WIDTH}-slot tiles"
        )
    if cnt is not None and (cnt.shape != acc.shape or inc.numel() != R * S):
        raise ValueError(
            f"ordered_scatter_add: cnt {tuple(cnt.shape)} / inc {tuple(inc.shape)} "
            f"do not match acc {tuple(acc.shape)} / targets {tuple(tgt.shape)}"
        )
    if not all(x.is_contiguous() for x in tensors):
        raise ValueError("ordered_scatter_add: tensors must be contiguous")
    if R == 0 or C <= 1 or S == 0:
        return acc, cnt
    lay = layout(R, C, S, cnt is not None)
    lib = _library()
    with torch.cuda.device(device):
        scratch = torch.empty(lay.scratch_words, dtype=torch.int32, device=device) if lay.chunks else None
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = lib.es_ordered_scatter_add(
            acc.data_ptr(), None if cnt is None else cnt.data_ptr(),
            tgt.data_ptr(), src.data_ptr(), None if inc is None else inc.data_ptr(),
            None if scratch is None else scratch.data_ptr(), R, C, S, lay.chunks, lay.buckets,
            lay.width, stream,
        )
    if rc != 0:
        raise RuntimeError(f"ordered_scatter_add: kernel launch failed (cudaError {rc})")
    ordered_scatter_add.launches += 1
    return acc, cnt


ordered_scatter_add.launches = 0
