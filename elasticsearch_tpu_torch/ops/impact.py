"""Impact-tile scoring for learned sparse retrieval, in PyTorch.

Counterpart of `elasticsearch_tpu/ops/impact.py` (the JAX package): the
query side of the `sparse_vector` path. With impacts precomputed at
index time (index/segment.SparseField), query-time scoring is a gather
and a weighted sum:

  gather impact tiles for the query's terms from the resident
  [n_tiles, 128] planes, int8 or f32 (the cast to f32 comes AFTER the
  gather, so the int8 column keeps its 4x memory saving)
  → contribution = query_weight * impact
  → ops/ordered_scatter.ordered_scatter_add into a dense per-doc
    accumulator (term-at-a-time)
  → ops/scoring.topk_desc (doc asc among equal scores).

`ImpactScorer` mirrors ops/scoring.ChunkedScorer: tile lists of any
length stream through [rows, TCHUNK] launches into accumulators updated
in place (where the reference donates its JAX buffers), and finalize is
the ONE `_finalize` of ops/scoring, so its device triples feed
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

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from .ordered_scatter import ordered_scatter_add
from .scoring import BPAD, TCHUNK, _finalize, _threshold, upload

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


def _resident(x, device) -> torch.Tensor:
    """A plane already on the device as it is; a host array through
    ops/scoring.upload (pinned, asynchronous)."""
    if isinstance(x, torch.Tensor):
        return x.to(device)
    return upload(np.asarray(x), device)


def _impact_chunk_add(doc_ids, values, acc, cnt, ti, tw, tv):
    """acc[B, n+1] += impact contributions of one [B, TCHUNK] chunk, in
    place; cnt counts matching postings per doc (one per term — the
    sparse match mask is cnt > 0)."""
    n_docs = acc.shape[1] - 1
    rows_d = doc_ids[ti]  # [B, TC, 128]
    rows_v = values[ti]  # stored dtype; cast after the gather
    valid = (rows_d >= 0) & tv[:, :, None]
    tgt, s = impact_tile_contrib(rows_d, rows_v, tw[:, :, None], valid, n_docs)
    return ordered_scatter_add(acc, tgt, s, cnt, valid.to(torch.int32))


class ImpactScorer:
    """Batched learned-sparse scoring over one segment's impact-ordered
    tiled postings with fixed launch shapes (ChunkedScorer's serving
    recipe applied to the sparse column — see the module comment). All
    tensors live on `device`."""

    def __init__(self, doc_ids, values, n_docs: int, live=None,
                 block_size: int = 4096, device="cuda"):
        self.device = torch.device(device)
        self.doc_ids = _resident(doc_ids, self.device)
        # stored dtype (int8 qweights or f32 weights): the cast happens
        # after the gather
        self.values = _resident(values, self.device)
        self.n_docs = int(n_docs)
        self.live = None if live is None else _resident(live, self.device).to(torch.bool)
        self.block_size = block_size

    def new_acc(self, rows: int = BPAD):
        """Zeroed accumulators at one query-row bucket of the ladder."""
        acc = torch.zeros(rows, self.n_docs + 1, dtype=torch.float32, device=self.device)
        cnt = torch.zeros(rows, self.n_docs + 1, dtype=torch.int32, device=self.device)
        return acc, cnt

    def score_into(self, acc, cnt, tile_lists, weight_lists):
        """Streams per-row tile/weight lists (<= acc rows, any length)
        through TCHUNK-wide launches into the accumulators, in place.
        Each chunk is one packed int32 upload (tile ids, weights bitcast,
        validity) that does not wait for the device."""
        rows = int(acc.shape[0])
        t_max = max((len(t) for t in tile_lists), default=0)
        for c0 in range(0, t_max, TCHUNK):
            plan = np.zeros((3, rows, TCHUNK), np.int32)
            ti, tw, tv = plan[0], plan[1].view(np.float32), plan[2]
            for j, (tl, wl) in enumerate(zip(tile_lists, weight_lists)):
                sl = tl[c0 : c0 + TCHUNK]
                m = len(sl)
                if m:
                    ti[j, :m] = sl
                    tw[j, :m] = wl[c0 : c0 + TCHUNK]
                    tv[j, :m] = 1
            dev = upload(plan, self.device)
            acc, cnt = _impact_chunk_add(
                self.doc_ids, self.values, acc, cnt,
                dev[0].long(), dev[1].view(torch.float32), dev[2] != 0,
            )
        return acc, cnt

    def threshold(self, acc, k: int, live=None):
        """Host (theta[B], accmax[B, n_blocks]) after phase A — the kth
        best partial score per row (a sound lower bound on the final kth
        best, so pruning against it stays exact). The one download of
        the two-phase plan."""
        theta, accmax = _threshold(
            acc,
            live if live is not None else self.live,
            k=min(k, self.n_docs),
            block_size=self.block_size,
        )
        return theta.cpu().numpy(), accmax.cpu().numpy()

    def finalize(self, acc, cnt, k: int, live=None):
        s, d, tot = self.finalize_device(acc, cnt, k, live=live)
        return s.cpu().numpy(), d.cpu().numpy(), tot.cpu().numpy()

    def finalize_device(self, acc, cnt, k: int, live=None):
        """(scores[B,k], docs[B,k], totals[B]) STAYING on the device, in
        the merge_segment_topk triple shape. The sparse match mask is
        cnt > 0 (every query term is optional): `_finalize` at msm=1."""
        rows = int(acc.shape[0])
        return _finalize(
            acc,
            cnt,
            live if live is not None else self.live,
            torch.ones(rows, dtype=torch.int32, device=self.device),
            k=min(k, self.n_docs),
        )


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
