"""Impact-tile scoring for learned sparse retrieval, in PyTorch.

Counterpart of `elasticsearch_tpu/ops/impact.py` (the JAX package): the
query side of the `sparse_vector` path. With impacts precomputed at
index time (index/segment.SparseField), query-time scoring is a gather
and a weighted sum:

  gather impact tiles for the query's terms from the resident
  [n_tiles, 128] planes, int8 or f32 (the cast to f32 comes AFTER the
  gather, so the int8 column keeps its 4x memory saving)
  → contribution = query_weight * impact
  → an ordered add into a dense per-doc accumulator (term-at-a-time)
  → ops/scoring.topk_desc (doc asc among equal scores).

`ImpactScorer` is ops/scoring's `TileScorer`, as `ChunkedScorer` is,
with the impact source: each scoring pass of per-row tile lists, of any
length, is one `impact_tile_add` call into accumulators updated in
place (where the reference donates its JAX buffers): on the card one
packed upload and one call of `csrc/ordered_scatter.cu`'s impact tile
add, which gathers, multiplies and adds the whole pass in list order;
on the CPU the plain version. The reference streams a pass through
[rows, TCHUNK] chunks of `_impact_chunk_add`; the contributions and
their order are the same, so the bits are. finalize is the ONE
`_finalize` of ops/scoring, so its device triples feed
`merge_segment_topk` unchanged.

`SparseBlockMax` is the ops/wand.py analog for impact-ordered tiles.
Every term's postings are sorted by impact desc, so the per-tile
`tile_max` sidecar is non-increasing within a term and the term's
maximum lives in its FIRST tile. Phase A scores exactly those first
tiles → theta = kth best partial score; a tail tile of term t is
dropped iff

    qw_t * tile_bound[tile] + sum_{t' != t} qw_t' * term_max_t' < theta

A doc occurs at most once in a term's postings, so that bound caps the
doc's TOTAL score: dropped docs score strictly below theta and cannot
displace the top-k (totals become lower bounds when tiles were
dropped, and callers report relation "gte").

The f32 path sums each doc's contributions in query-term order and
matches the numpy oracle bit for bit, on the CPU and on the card alike,
run after run (ops/ordered_scatter.py).
"""

from __future__ import annotations

import functools
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from . import ordered_scatter
from .ordered_scatter import ordered_scatter_add
from .scoring import BPAD, TileScorer, TileSource, _resident, tile_pass, tile_pass_plain

TILE_WIDTH = 128

# Per posting slot the impact scorer does ~4 flops (int8→f32 cast,
# weight multiply, validity select, scatter add); ops/scoring counts 6
# for the text scorer because of the norm math this layout folded into
# the index.
FLOPS_PER_IMPACT_SLOT = 4


def sparse_flops(n_tile_slots: int) -> int:
    """Estimated useful flops of one sparse job's plan on one segment."""
    return n_tile_slots * TILE_WIDTH * FLOPS_PER_IMPACT_SLOT


def impact_tile_contrib(rows_d, rows_v, tw, valid, n_docs):
    """The sparse tile-contribution formula: per posting slot,
    contribution = tw * f32(value). `tw` carries the query-term weight
    (with the per-term dequant scale folded in ON THE HOST for int8
    columns, so the same code serves both storage modes); invalid slots
    score exactly 0 and target the n_docs overflow column (int32)."""
    tgt = torch.where(valid, rows_d, n_docs).int()
    s = tw * rows_v.to(torch.float32)
    return tgt, torch.where(valid, s, 0.0)


def _impact_chunk_add(doc_ids, values, acc, cnt, ti, tw, tv):
    """acc[B, n+1] += impact contributions of [B, TC] tiles `ti` (weights
    `tw`, validity `tv`), in place; cnt counts matching postings per doc
    (one per term — the sparse match mask is cnt > 0)."""
    n_docs = acc.shape[1] - 1
    rows_d = doc_ids[ti]  # [B, TC, 128]
    rows_v = values[ti]  # stored dtype; cast after the gather
    valid = (rows_d >= 0) & tv[:, :, None]
    tgt, s = impact_tile_contrib(rows_d, rows_v, tw[:, :, None], valid, n_docs)
    return ordered_scatter_add(acc, tgt, s, cnt, valid.to(torch.int32))


def impact_tile_add_plain(acc, cnt, doc_ids, values, tile_lists, weight_lists):
    """The same function in plain PyTorch: row by row, the row's whole
    list through `_impact_chunk_add` (on the CPU, `ordered_scatter_add`'s
    plain version adds a cell's contributions in slot order)."""
    return tile_pass_plain(acc, cnt, tile_lists, weight_lists, functools.partial(_impact_chunk_add, doc_ids, values))


IMPACT_TILES = TileSource("impact_tile_add", impact_tile_add_plain, ordered_scatter.launch_impact_add)


def impact_tile_add(acc, cnt, doc_ids, values, tile_lists, weight_lists) -> int:
    """One learned-sparse scoring pass (`tile_pass`): acc[r, doc] += w *
    f32(v) and cnt[r, doc] += 1 for every posting (doc, v) of every tile
    of row r's list (weight w a tile, the dequant scale folded in for an
    int8 column). acc and cnt [rows, n_docs + 1]. The kernel is
    `csrc/ordered_scatter.cu`'s impact tile add, counted by
    `ordered_scatter.launch_impact_add.launches`."""
    return tile_pass(IMPACT_TILES, acc, cnt, (doc_ids, values), tile_lists, weight_lists)


class ImpactScorer(TileScorer):
    """Learned-sparse scoring over one segment's impact-ordered tiled
    postings (`impact_tile_add`; the stored plane int8 or f32, cast after
    the gather). The count plane is always there, and a doc matches
    where its count is positive: every query term is optional."""

    source = IMPACT_TILES
    sites = ("sparse_threshold", "sparse_finalize")

    def __init__(self, doc_ids, values, n_docs: int, live=None,
                 block_size: int = 4096, device="cuda"):
        device = torch.device(device)
        self.doc_ids = _resident(doc_ids, device)
        self.values = _resident(values, device)
        super().__init__((self.doc_ids, self.values), n_docs, live, block_size, device)

    def new_acc(self, rows: int = BPAD):
        """Zeroed accumulators at one query-row bucket of the ladder."""
        return self._zeroed(rows, True)

    def finalize(self, acc, cnt, k: int, live=None):
        return self._final(acc, cnt, None, k, live, host=True)

    def finalize_device(self, acc, cnt, k: int, live=None):
        """(scores[B,k], docs[B,k], totals[B]) STAYING on the device, in
        the merge_segment_topk triple shape."""
        return self._final(acc, cnt, None, k, live)


class SparseBlockMax:
    """Two-phase impact-ordered block-max pruning plan for ONE query row
    over one SparseField (see the module comment for the soundness
    argument). All arrays are host numpy — the plan is layout work; the
    scoring launches stay on the device."""

    def __init__(
        self,
        term_tile_start: np.ndarray,
        term_tile_count: np.ndarray,
        tile_bound: np.ndarray,  # tile_qmax (int8 mode) or tile_max
        tids: Sequence[int],  # query term ids present in the dictionary
        tws: Sequence[float],  # tile weights (scale folded)
        bws: Optional[Sequence[float]] = None,  # bound weights (RAW)
    ):
        """`tws` multiplies the STORED plane, so for the int8 column it
        carries the dequant scale. The bound sidecar (`tile_qmax`) is
        already DEQUANTIZED — bounding with the folded weight would scale
        twice and prune tiles that still hold competitive mass — so the
        bound math uses `bws`, the raw query weights (equal to `tws` for
        the fp32 column)."""
        self.starts = term_tile_start[np.asarray(tids, np.int64)].astype(np.int64)
        self.counts = term_tile_count[np.asarray(tids, np.int64)].astype(np.int64)
        self.tws = np.asarray(tws, np.float32)
        self.bws = np.asarray(bws, np.float32) if bws is not None else self.tws
        self.tile_bound = tile_bound
        # impact ordering ⇒ a term's global max bound is its first tile's
        self.term_max = (
            tile_bound[self.starts].astype(np.float32)
            if len(self.starts)
            else np.zeros(0, np.float32)
        )
        self.sum_bound = float((self.bws * self.term_max).sum())

    def phase_a(self) -> Tuple[np.ndarray, np.ndarray]:
        """(tiles, weights): every query term's FIRST tile — the tiles
        holding each term's maximum impacts, the cheapest set that makes
        theta meaningful."""
        return self.starts.copy(), self.tws.copy()

    def kept(self, theta: float) -> Tuple[np.ndarray, np.ndarray, int]:
        """(tiles, weights, dropped): the FULL surviving tile list —
        first tiles always, tail tiles filtered against `theta` — laid
        out per term in term order. Callers score this list into a FRESH
        accumulator (phase A tiles are rescored; one tile per term,
        cheap) so per-doc accumulation runs in pure query-term order
        whether or not pruning dropped anything."""
        tiles: List[np.ndarray] = []
        weights: List[np.ndarray] = []
        dropped = 0
        for i in range(len(self.starts)):
            c = int(self.counts[i])
            rng = np.arange(self.starts[i], self.starts[i] + c, dtype=np.int64)
            if c > 1 and np.isfinite(theta):
                others = self.sum_bound - float(self.bws[i] * self.term_max[i])
                bound = (
                    self.bws[i] * self.tile_bound[rng].astype(np.float32)
                    + np.float32(others)
                )
                keep = bound >= theta
                keep[0] = True  # first tile anchors theta; never drop
                dropped += int((~keep).sum())
                rng = rng[keep]
            if len(rng):
                tiles.append(rng)
                weights.append(np.full(len(rng), self.tws[i], np.float32))
        return (
            np.concatenate(tiles) if tiles else np.zeros(0, np.int64),
            np.concatenate(weights) if weights else np.zeros(0, np.float32),
            dropped,
        )

    @property
    def n_tail_tiles(self) -> int:
        """Tiles beyond each term's first — zero means phase A already
        scored everything and the threshold pass can be skipped."""
        return int(np.maximum(self.counts - 1, 0).sum())


def impact_tile_lists(
    sf, terms: Sequence[str], weights: Sequence[float], quantized: bool
) -> Tuple[List[int], np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Resolve a query's term→weight map against one SparseField: (term
    ids present, folded tile weights f32, raw bound weights f32,
    term_tile_start slice, term_tile_count slice). For the int8 column
    the per-term dequant scale folds into the tile weight HERE (one host
    multiply per query term), so the device code is identical in both
    storage modes; the RAW weights ride along for SparseBlockMax, whose
    tile_qmax sidecar is already dequantized."""
    tids: List[int] = []
    tws: List[float] = []
    bws: List[float] = []
    for t, w in zip(terms, weights):
        tid = sf.term_id(t)
        if tid < 0:
            continue
        bw = np.float32(w)
        tw = bw
        if quantized:
            tw = np.float32(tw * sf.scales[tid])
        tids.append(tid)
        tws.append(float(tw))
        bws.append(float(bw))
    return (
        tids,
        np.asarray(tws, np.float32),
        np.asarray(bws, np.float32),
        sf.term_tile_start[np.asarray(tids, np.int64)] if tids else np.zeros(0, np.int32),
        sf.term_tile_count[np.asarray(tids, np.int64)] if tids else np.zeros(0, np.int32),
    )
