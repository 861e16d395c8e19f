"""Block-max pruning structures — the TPU formulation of WAND/MaxScore.

Reference analog: org.apache.lucene.search.WANDScorer + MaxScoreCache +
BlockMaxConjunctionScorer (SURVEY.md §2.5, §5): skip whole postings
blocks whose score upper bound cannot reach the current top-k floor —
"the single most important algorithmic optimization in the scoring
loop". Lucene's version is a sequential pointer-chasing loop; that shape
is TPU-hostile, so the algorithm is restructured (same bound math,
different control flow) into two dense passes with one threshold
broadcast between them, exactly the mapping SURVEY.md §5 prescribes:

  1. tiles are DOC-BLOCK ALIGNED for frequent ("hot") terms: a tile
     never crosses a global doc-range boundary of ``block_size`` docs,
     so every hot tile has a doc-block id and a static score upper
     bound (monotone BM25: max_tf with the min norm byte of the tile);
  2. PHASE A scores all rare-term tiles (rare terms have the highest
     impact-per-posting — MaxScore's "essential terms") through the
     fixed-shape ChunkedScorer → per-query threshold θ = kth score;
  3. the survival test is pure arithmetic: a hot tile is skippable iff
     accmax[block] + Σ_t B_t[block] < θ, where accmax is the per-block
     max of the phase-A accumulator and B_t[block] is term t's max tile
     bound in that block (one posting per term per doc per block, so
     the sum is a sound per-doc upper bound);
  4. PHASE B streams only surviving tiles into the same accumulator;
     final exact top-k. Results are EXACT, not approximate.

Split of responsibilities (the round-3 redesign):

  * ``BlockMaxTiling`` — the retiled postings + sidecars. Pure
    structure, independent of collection statistics, built ONCE per
    immutable segment (vectorized NumPy, no per-posting Python loop)
    and cached on the PostingsField, so refresh generations don't
    re-upload or re-tile.
  * ``BlockMaxIndex`` — per reader generation: SHARD-level BM25 weights
    and norm cache (Lucene CollectionStatistics — segment-level stats
    here would make pruned and unpruned scores diverge in multi-segment
    shards) applied to the tiling to get per-tile bounds and the
    per-(hot term, block) MaxScoreCache table.

Deletions do NOT disable pruning: bounds computed without liveDocs only
overestimate (a deleted doc can only remove a candidate), so the skip
test stays sound; the scorer masks deleted docs in θ and in the final
collection (ops/scoring.py ChunkedScorer).

PyTorch port: the host NumPy is unchanged; the retiled doc/tf planes
are torch tensors on the scorer's device, cached on the immutable
PostingsField under the port's own attribute (`_bmx_tiling_torch`,
keyed by device too), so a field seen by the JAX package in the same
process never hands a jax array to torch or the other way round.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np
import torch

from ..index.segment import INVALID_DOC, TILE, PostingsField

_TILING_ATTR = "_bmx_tiling_torch"


@dataclass
class TermPlan:
    term_id: int
    weight: float  # boost * shard-level idf
    tile_start: int
    tile_count: int
    hot: bool


@dataclass
class BlockMaxTiling:
    """Doc-block-aligned tiled postings for one field of one segment
    (structure only — see module docstring)."""

    doc_ids: torch.Tensor  # int32[n_tiles, TILE] (device)
    tfs: torch.Tensor  # int32[n_tiles, TILE] (device)
    tile_term: np.ndarray  # int32[n_tiles] local term id
    tile_block: np.ndarray  # int32[n_tiles] doc block (hot tiles only)
    tile_max_tf: np.ndarray  # int32[n_tiles]
    tile_min_norm: np.ndarray  # uint8[n_tiles]
    term_tile_start: np.ndarray  # int32[n_terms]
    term_tile_count: np.ndarray  # int32[n_terms]
    term_hot: np.ndarray  # bool[n_terms]
    terms: List[str]  # reference to the segment's term dictionary
    n_docs: int
    block_size: int
    n_blocks: int


def get_tiling(
    pf: PostingsField,
    n_docs: int,
    block_size: int = 4096,
    hot_min_postings_per_block: int = 32,
    device="cuda",
) -> BlockMaxTiling:
    """Cached block-aligned retiling of one PostingsField (immutable),
    its doc/tf planes on `device`."""
    device = torch.device(device)
    key = (block_size, hot_min_postings_per_block, str(device))
    cache = getattr(pf, _TILING_ATTR, None)
    if cache is None:
        cache = {}
        setattr(pf, _TILING_ATTR, cache)
    tiling = cache.get(key)
    if tiling is None:
        tiling = _build_tiling(
            pf, n_docs, block_size, hot_min_postings_per_block, device
        )
        cache[key] = tiling
        # charge the HBM ledger for the device-resident retiled postings;
        # the tiling lives as long as its (immutable) PostingsField, so
        # the release is tied to the tiling's own GC
        import weakref

        from ..common.memory import hbm_ledger

        nbytes = (tiling.doc_ids.numel() + tiling.tfs.numel()) * 4
        hbm_ledger.add("postings_tiles", nbytes, breaker=False)
        weakref.finalize(
            tiling, hbm_ledger.release, "postings_tiles", nbytes
        )
    return tiling


def _build_tiling(
    pf: PostingsField, n_docs: int, block_size: int, hot_min: int, device
) -> BlockMaxTiling:
    n_terms = len(pf.terms)
    n_blocks = max(1, -(-n_docs // block_size))
    starts = pf.term_tile_start.astype(np.int64)
    counts = pf.term_tile_count.astype(np.int64)

    # flat posting stream in (term, doc) order (fully vectorized)
    tile_order = (
        np.arange(int(counts.sum()), dtype=np.int64)
        - np.repeat(np.cumsum(counts) - counts, counts)
        + np.repeat(starts, counts)
    )
    rows_d = pf.doc_ids[tile_order].ravel()
    rows_t = pf.tfs[tile_order].ravel()
    term_of_post = np.repeat(np.arange(n_terms, dtype=np.int64), counts * TILE)
    valid = rows_d >= 0
    docs = rows_d[valid].astype(np.int64)
    tfs_flat = rows_t[valid]
    term_of = term_of_post[valid]

    term_df = pf.term_df.astype(np.int64)
    term_hot = term_df >= hot_min * n_blocks

    if len(docs) == 0:
        return BlockMaxTiling(
            doc_ids=torch.full(
                (1, TILE), INVALID_DOC, dtype=torch.int32, device=device
            ),
            tfs=torch.zeros((1, TILE), dtype=torch.int32, device=device),
            tile_term=np.zeros(1, np.int32),
            tile_block=np.full(1, -1, np.int32),
            tile_max_tf=np.zeros(1, np.int32),
            tile_min_norm=np.full(1, 255, np.uint8),
            term_tile_start=np.zeros(n_terms, np.int32),
            term_tile_count=np.zeros(n_terms, np.int32),
            term_hot=term_hot,
            terms=pf.terms,
            n_docs=n_docs,
            block_size=block_size,
            n_blocks=n_blocks,
        )

    # group = (term,) for rare terms, (term, doc block) for hot terms;
    # keys are monotone because docs ascend within each term
    blk = docs // block_size
    key = term_of * n_blocks + np.where(term_hot[term_of], blk, 0)
    newgrp = np.r_[True, key[1:] != key[:-1]]
    group_id = np.cumsum(newgrp) - 1
    group_start = np.nonzero(newgrp)[0]
    group_size = np.diff(np.r_[group_start, len(docs)])
    rank = np.arange(len(docs), dtype=np.int64) - group_start[group_id]
    tiles_per_group = -(-group_size // TILE)
    group_tile_off = np.cumsum(tiles_per_group) - tiles_per_group
    tile_of_post = group_tile_off[group_id] + rank // TILE
    slot = tile_of_post * TILE + rank % TILE
    n_tiles = int(tiles_per_group.sum())

    new_docs = np.full(n_tiles * TILE, INVALID_DOC, np.int32)
    new_tfs = np.zeros(n_tiles * TILE, np.int32)
    new_docs[slot] = docs
    new_tfs[slot] = tfs_flat

    tile_term = np.zeros(n_tiles, np.int32)
    tile_block = np.full(n_tiles, -1, np.int32)
    tile_term[tile_of_post] = term_of
    hot_posts = term_hot[term_of]
    tile_block[tile_of_post[hot_posts]] = blk[hot_posts]
    tile_max_tf = np.zeros(n_tiles, np.int32)
    np.maximum.at(tile_max_tf, tile_of_post, tfs_flat)
    tile_min_norm = np.full(n_tiles, 255, np.uint8)
    np.minimum.at(tile_min_norm, tile_of_post, pf.norms[docs])

    term_tile_count = np.bincount(tile_term, minlength=n_terms).astype(np.int32)
    term_tile_start = (np.cumsum(term_tile_count) - term_tile_count).astype(np.int32)

    return BlockMaxTiling(
        doc_ids=torch.from_numpy(new_docs.reshape(n_tiles, TILE)).to(device),
        tfs=torch.from_numpy(new_tfs.reshape(n_tiles, TILE)).to(device),
        tile_term=tile_term,
        tile_block=tile_block,
        tile_max_tf=tile_max_tf,
        tile_min_norm=tile_min_norm,
        term_tile_start=term_tile_start,
        term_tile_count=term_tile_count,
        term_hot=term_hot,
        terms=pf.terms,
        n_docs=n_docs,
        block_size=block_size,
        n_blocks=n_blocks,
    )


class BlockMaxIndex:
    """Per-generation bound tables over a BlockMaxTiling.

    ``weights`` must be SHARD-level BM25 idf per local term id and
    ``norm_cache`` the shard-level 256-entry inverse-norm cache
    (IndexSearcher.collectionStatistics — NOT per-segment stats), so
    pruned scores are identical to the unpruned executor path.
    """

    def __init__(
        self, tiling: BlockMaxTiling, weights: np.ndarray, norm_cache: np.ndarray
    ):
        self.tiling = tiling
        self.weights = np.asarray(weights, np.float32)
        # LENGTH_TABLE is strictly increasing, so the cache is monotone
        # decreasing in the norm byte: max inv-norm of a tile = cache at
        # the tile's min norm byte. Bound per tile:
        #   w * (1 - 1/(1 + max_tf * max_inv))   (monotone BM25)
        max_inv = norm_cache[tiling.tile_min_norm.astype(np.int64)].astype(np.float32)
        factor = 1.0 - 1.0 / (1.0 + tiling.tile_max_tf.astype(np.float32) * max_inv)
        self.tile_bounds = self.weights[tiling.tile_term] * factor
        # MaxScoreCache analog: per (hot term, block) max tile bound
        hot_ids = np.nonzero(tiling.term_hot)[0]
        self._hot_rank = {int(t): r for r, t in enumerate(hot_ids)}
        self.term_block_bounds = np.zeros(
            (len(hot_ids), tiling.n_blocks), np.float32
        )
        for r, tid in enumerate(hot_ids):
            s0 = int(tiling.term_tile_start[tid])
            c = int(tiling.term_tile_count[tid])
            sl = slice(s0, s0 + c)
            np.maximum.at(
                self.term_block_bounds[r], tiling.tile_block[sl], self.tile_bounds[sl]
            )
        self._term_index = {t: i for i, t in enumerate(tiling.terms)}

    def plan(self, terms: List[str], boost: float = 1.0) -> List[TermPlan]:
        out = []
        for t in terms:
            tid = self._term_index.get(t)
            if tid is None or int(self.tiling.term_tile_count[tid]) == 0:
                continue
            out.append(
                TermPlan(
                    term_id=tid,
                    weight=float(self.weights[tid]) * boost,
                    tile_start=int(self.tiling.term_tile_start[tid]),
                    tile_count=int(self.tiling.term_tile_count[tid]),
                    hot=bool(self.tiling.term_hot[tid]),
                )
            )
        return out

    def block_bounds(self, p: TermPlan) -> np.ndarray:
        """Σ-able per-block upper bound for one hot term (boost folded)."""
        base = self.term_block_bounds[self._hot_rank[p.term_id]]
        w = float(self.weights[p.term_id])
        scale = p.weight / w if w else 0.0
        return base if scale == 1.0 else base * np.float32(scale)

    def surviving_tiles(
        self,
        p: TermPlan,
        potential: np.ndarray,
        theta: float,
        block_live: Optional[np.ndarray] = None,
    ) -> np.ndarray:
        """Tile ids of one hot term whose block could still beat theta.
        ``potential`` is accmax_row + Σ_t block_bounds per block.
        ``block_live`` (bool[n_blocks]) additionally skips blocks with
        no live/filter-passing doc at all — a cached filter bitset
        reduced per block (a block the filter empties can never yield a
        candidate, so skipping it is sound regardless of θ)."""
        sl = slice(p.tile_start, p.tile_start + p.tile_count)
        blocks = self.tiling.tile_block[sl]
        keep = potential[blocks] >= theta
        if block_live is not None:
            keep = keep & block_live[blocks]
        return np.arange(sl.start, sl.stop, dtype=np.int64)[keep]
