"""Whole-index search steps over a stack of shards, in PyTorch.

Counterpart of `elasticsearch_tpu/parallel/sharded.py` (the JAX
package). The coordinator's scatter/gather (per-shard query phase, then
the reduce that merges shard responses) collapses into ONE program over
a stack of every shard, spread over a mesh's grid of slots
(parallel/mesh.py):

  - every entry's tiled postings live stacked along a leading entry
    axis (`doc_ids[E, T, 128]`), padded to ``shards * fold`` entries;
    slot (r, c) holds fold c of each stack on its device (`Stacked`),
    and every ``data`` row r holds its own copy of the stack;
  - a step splits the query rows over the ``data`` axis and launches
    each slot's part — per-entry scoring and the local top-k, batched
    over the slot's fold (the reference's `vmap` inside `shard_map`) —
    on that slot's device;
  - the slots' pages `[fold, Bd, kk]` then come to the coordinating
    device (the first slot's, the index's own) with asynchronous
    stream-ordered copies and are laid out entry-major there (the
    reference's `all_gather` over ``shards``), where the merge runs;
    totals and agg columns combine with `sum`/`amin`/`amax` over the
    slots (its `psum`/`pmin`/`pmax`);
  - every `lax.top_k` is `ops/scoring.topk_desc`, which keeps the lowest
    index among equal scores, so the merge's (score desc, slot asc)
    order is the coordinator's (score desc, shard asc, segment asc, doc
    asc) order.

Per-entry arithmetic is the same whatever the grid: a slot computes its
entries' rows exactly as a one-slot mesh computes them, and the merge
sees the same [E, B, kk] pages. A step takes host numpy plans (each
slot's share uploaded in one asynchronous pinned copy) and returns
device tensors on the coordinating device; nothing here waits for a
device.

Two families of step builders live here:

  * ``build_sharded_bm25_step`` / ``build_sharded_knn_step`` — the
    ShardedIndex steps (whole shards, one segment each);
  * ``build_mesh_*_step`` — the SERVING steps behind
    `parallel/mesh_executor.MeshExecutor`: stacked entries are (shard,
    segment) pairs so per-entry scoring is the same computation as the
    per-segment serving scorers (same tile plans in the same scatter
    order, the same `w - w/(1 + tf·inv)` formula, the same live and
    count masks), and only the merge moves from the host into the step.

Every float accumulation is ops/ordered_scatter.ordered_scatter_add,
which adds in slot order on the CPU and on the card alike, so the pages
are bit for bit the per-shard path's, run after run; the rescore
multiplies each entry in the per-shard path's shapes (see
build_mesh_rerank_step). A dense product (`q @ v.T`) is the exception
on a ``data`` axis of 2+: a slot multiplies its share of the query
rows, and the BLAS picks its kernel by the row count (one row takes a
matrix-vector kernel), so a kNN score may move in its last ulp.
"""

from __future__ import annotations

import threading
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from ..index.segment import INVALID_DOC, TILE, Segment
from ..models import bm25
from ..ops.ordered_scatter import ordered_scatter_add
from ..ops.scoring import TCHUNK, download, next_bucket, topk_desc, upload
from .mesh import SHARD_AXIS, Mesh, coord_device, fold_factor


class ShardedTopK(NamedTuple):
    scores: torch.Tensor  # float32[B, k] merged, score desc
    global_docs: torch.Tensor  # int32[B, k] doc_base[shard] + local doc (-1 pad)
    totals: torch.Tensor  # int32[B] total matching docs across shards


def _up(device, a, dtype=None) -> torch.Tensor:
    """A host array (or a tensor already there) on `device`."""
    if isinstance(a, torch.Tensor):
        return a.to(device=device, dtype=dtype)
    t = upload(np.ascontiguousarray(a), device)
    return t if dtype is None else t.to(dtype)


def _up_plan(device, ti, tw, tv):
    """(ti int64, tw f32, tv bool) device tensors of one [E, B, T] tile
    plan, uploaded as ONE packed int32 buffer."""
    ti = np.asarray(ti)
    packed = np.empty((3,) + ti.shape, np.int32)
    packed[0] = ti
    packed[1] = np.asarray(tw, np.float32).view(np.int32)
    packed[2] = np.asarray(tv, bool)
    dev = upload(packed, device)
    return dev[0].long(), dev[1].view(torch.float32), dev[2] != 0


class Stacked:
    """One stacked [E_pad, ...] array as a mesh's grid holds it:
    `parts[r][c]` is fold c (entries [c·fold, (c+1)·fold)) on slot (r,
    c)'s device. Every ``data`` row holds its own copy. Writes go to row
    0 (`stacked[e, ...]` is entry e's rows there) and `replicate` copies
    row 0 to the other rows, device to device."""

    def __init__(self, parts: List[List[torch.Tensor]], fold: int):
        self.parts = parts
        self.fold = fold

    @classmethod
    def full(cls, mesh: Mesh, fold: int, tail, dtype, fill=0) -> "Stacked":
        return cls(
            [[torch.full((fold,) + tuple(tail), fill, dtype=dtype, device=d) for d in row]
             for row in mesh.devices],
            fold,
        )

    @classmethod
    def put(cls, mesh: Mesh, fold: int, host) -> "Stacked":
        """A host [E_pad, ...] array, each slot's fold uploaded to it."""
        host = np.asarray(host)
        return cls(
            [[upload(host[c * fold : (c + 1) * fold], d) for c, d in enumerate(row)]
             for row in mesh.devices],
            fold,
        )

    @property
    def shape(self) -> tuple:
        p = self.parts[0][0]
        return (self.fold * len(self.parts[0]),) + tuple(p.shape[1:])

    @property
    def dtype(self) -> torch.dtype:
        return self.parts[0][0].dtype

    def at(self, r: int, c: int) -> torch.Tensor:
        return self.parts[r][c]

    def entry(self, e: int, r: int = 0) -> torch.Tensor:
        return self.parts[r][e // self.fold][e % self.fold]

    def __getitem__(self, key):
        if isinstance(key, tuple):
            return self.entry(key[0])[key[1:]]
        return self.entry(key)

    def replicate(self) -> None:
        for row in self.parts[1:]:
            for c, p in enumerate(row):
                p.copy_(self.parts[0][c])


_GATHER_LOCK = threading.Lock()
_GATHER = {"pages": 0, "slot_bytes": 0, "peer_bytes": 0}


def gather_stats() -> dict:
    """Process-wide page traffic into the coordinating device:
    `slot_bytes` gathered from slots other than the first, `peer_bytes`
    of those that crossed from another device."""
    with _GATHER_LOCK:
        return dict(_GATHER)


def _bring(x: torch.Tensor, coord, first: bool, tally: list) -> torch.Tensor:
    if not first:
        n = x.numel() * x.element_size()
        tally[0] += n
        if x.device != torch.device(coord):
            tally[1] += n
    return x.to(coord, non_blocking=True)


def _note_gather(tally: list) -> None:
    with _GATHER_LOCK:
        _GATHER["pages"] += 1
        _GATHER["slot_bytes"] += tally[0]
        _GATHER["peer_bytes"] += tally[1]


def _launch_slots(mesh: Mesh, fold: int, n_rows: int, part) -> list:
    """outs[r][c] = part(r, c, ents, rows): slot (r, c)'s part launched
    on its device for the entries `ents` (its fold) and the query rows
    `rows` (its ``data`` row's share), slices of the host plans."""
    n_data, g = mesh.devices.shape
    bd = n_rows // n_data
    return [
        [part(r, c, slice(c * fold, (c + 1) * fold), slice(r * bd, (r + 1) * bd))
         for c in range(g)]
        for r in range(n_data)
    ]


def _run_slots(mesh: Mesh, fold: int, n_rows: int, part):
    """Each slot's `part` (`_launch_slots`) returns a tuple of [fold, Bd,
    ...] tensors; returns the tuple laid out as [E_pad, B, ...] tensors
    on the coordinating device: entry-major over the ``shards`` axis
    (the reference's all_gather), row-major over ``data`` (its
    data-sharded out_specs)."""
    outs = _launch_slots(mesh, fold, n_rows, part)
    if len(outs) * len(outs[0]) == 1:
        return outs[0][0]
    coord = coord_device(mesh)
    tally = [0, 0]
    res = []
    for i in range(len(outs[0][0])):
        rows = [
            torch.cat([_bring(o[i], coord, r == c == 0, tally) for c, o in enumerate(row)], 0)
            for r, row in enumerate(outs)
        ]
        res.append(torch.cat(rows, 1))
    _note_gather(tally)
    return tuple(res)


_REDUCE = {
    "sum": lambda x: x.sum(dim=0, dtype=x.dtype),
    "min": lambda x: x.amin(dim=0),
    "max": lambda x: x.amax(dim=0),
}


def _combine_slots(mesh: Mesh, fold: int, n_rows: int, part, ops: Sequence[str]):
    """Each slot's `part` (`_launch_slots`) returns a list of [Bd, ...]
    partials already reduced over its fold; returns each partial
    combined over the ``shards`` slots with its op in `ops`
    ("sum"/"min"/"max": the reference's psum/pmin/pmax) on the
    coordinating device, rows concatenated over ``data``."""
    outs = _launch_slots(mesh, fold, n_rows, part)
    if len(outs) * len(outs[0]) == 1:
        return outs[0][0]
    coord = coord_device(mesh)
    tally = [0, 0]
    res = []
    for i, op in enumerate(ops):
        rows = []
        for r, row in enumerate(outs):
            xs = [_bring(o[i], coord, r == c == 0, tally) for c, o in enumerate(row)]
            rows.append(xs[0] if len(xs) == 1 else _REDUCE[op](torch.stack(xs)))
        res.append(torch.cat(rows, 0))
    _note_gather(tally)
    return res


class ShardedIndex:
    """Stacks S single-shard segments over a mesh's slots.

    The ES analog of an index with `number_of_shards: S` (each shard an
    independent Segment with its own term dictionary, norms and stats,
    exactly like an ES shard is a full Lucene index); this class pads
    them to a common dense shape along the leading entry axis and lays
    the stack out over the ``shards`` slots (`Stacked`). The stack is
    padded to ``axis * fold`` rows (mesh.py fold_factor)."""

    def __init__(
        self,
        mesh: Mesh,
        segments: Sequence[Segment],
        field: str,
        k1: float = bm25.DEFAULT_K1,
        b: float = bm25.DEFAULT_B,
        vector_field: Optional[str] = None,
    ):
        g = mesh.shape[SHARD_AXIS]
        self.fold = fold_factor(mesh, len(segments))
        if g * self.fold < len(segments):
            raise ValueError(
                f"{len(segments)} shards but mesh '{SHARD_AXIS}' axis is "
                f"{g} (fold {self.fold})"
            )
        self.mesh = mesh
        self.device = coord_device(mesh)
        self.segments = list(segments)
        self.field = field
        self.n_shards = len(segments)
        # stacked rows: shards padded to an equal fold per device
        self.n_stack = g * self.fold
        self.k1 = k1
        self.b = b

        # ---- per-shard BM25 term weights (each shard uses ITS OWN stats,
        # like per-shard IDF without the optional DFS phase) ----
        self._weights: List[Dict[str, float]] = []
        self._inv_norms: List[np.ndarray] = []
        n_tiles_max = 1
        n_docs_max = 1
        for seg in self.segments:
            pf = seg.postings.get(field)
            if pf is None or pf.n_tiles == 0:
                self._weights.append({})
                self._inv_norms.append(np.zeros(max(seg.num_docs, 1), np.float32))
                n_docs_max = max(n_docs_max, max(seg.num_docs, 1))
                continue
            st = pf.stats
            doc_count = st.doc_count or 1
            avgdl = bm25.avg_field_length(st.sum_total_term_freq, doc_count)
            cache = bm25.norm_inverse_cache(avgdl, k1, b)
            self._weights.append(
                {
                    t: float(bm25.idf(doc_count, int(pf.term_df[i])))
                    for i, t in enumerate(pf.terms)
                }
            )
            self._inv_norms.append(cache[pf.norms.astype(np.int64)])
            n_tiles_max = max(n_tiles_max, pf.n_tiles)
            n_docs_max = max(n_docs_max, seg.num_docs)
        self.n_docs_max = n_docs_max
        self.n_tiles_max = n_tiles_max

        # ---- stacked, padded device arrays ----
        S = self.n_stack
        doc_ids = np.full((S, n_tiles_max, TILE), INVALID_DOC, np.int32)
        tfs = np.zeros((S, n_tiles_max, TILE), np.int32)
        inv_norm = np.zeros((S, n_docs_max), np.float32)
        doc_base = np.zeros(S, np.int32)
        base = 0
        for si, seg in enumerate(self.segments):
            pf = seg.postings.get(field)
            if pf is not None and pf.n_tiles:
                doc_ids[si, : pf.n_tiles] = pf.doc_ids
                tfs[si, : pf.n_tiles] = pf.tfs
            inv_norm[si, : len(self._inv_norms[si])] = self._inv_norms[si]
            doc_base[si] = base
            base += seg.num_docs
        self.total_docs = base
        put = lambda a: Stacked.put(mesh, self.fold, a)  # noqa: E731
        self.doc_ids = put(doc_ids)
        self.tfs = put(tfs)
        self.inv_norm = put(inv_norm)
        self.doc_base = put(doc_base)
        # every slot below a shard's num_docs is a real doc (no deletes)
        live = np.zeros((S, n_docs_max), bool)
        for si, seg in enumerate(self.segments):
            live[si, : seg.num_docs] = True
        self.live = put(live)

        # ---- optional dense-vector shard stack ----
        self.vector_field = vector_field
        self.vectors = None
        self.vec_exists = None
        if vector_field is not None:
            dims = None
            for seg in self.segments:
                vf = seg.vectors.get(vector_field)
                if vf is not None:
                    dims = vf.vectors.shape[1]
                    break
            if dims is not None:
                vecs = np.zeros((S, n_docs_max, dims), np.float32)
                exists = np.zeros((S, n_docs_max), bool)
                for si, seg in enumerate(self.segments):
                    vf = seg.vectors.get(vector_field)
                    if vf is None:
                        continue
                    mat = (
                        vf.unit_vectors
                        if vf.similarity == "cosine" and vf.unit_vectors is not None
                        else vf.vectors
                    )
                    vecs[si, : seg.num_docs] = mat
                    exists[si, : seg.num_docs] = vf.exists
                self.vectors = put(vecs)
                self.vec_exists = put(exists)

    # ---- host-side query compilation (the per-shard Weight creation) ----

    def compile_queries(
        self,
        term_lists: Sequence[Sequence[str]],
        operators: Optional[Sequence[str]] = None,
        bucket: Optional[int] = None,
    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
        """Queries → per-(shard, query) padded tile plans.

        Returns (tile_idx[S,B,T], tile_w[S,B,T], tile_v[S,B,T], msm[B]).
        Each shard resolves the same terms against its own dictionary and
        stats — the analog of per-shard `Weight` creation in
        `SearchService.executeQueryPhase`. S is the padded stack size
        (padding rows score all-invalid to -inf).
        """
        B = len(term_lists)
        plans: List[List[Tuple[List[int], List[float]]]] = []
        t_max = 1
        for si, seg in enumerate(self.segments):
            pf = seg.postings.get(self.field)
            shard_plans: List[Tuple[List[int], List[float]]] = []
            for terms in term_lists:
                idxs: List[int] = []
                ws: List[float] = []
                if pf is not None:
                    for t in terms:
                        tid = pf.term_id(t)
                        if tid < 0:
                            continue
                        start = int(pf.term_tile_start[tid])
                        cnt = int(pf.term_tile_count[tid])
                        w = self._weights[si].get(t, 0.0)
                        idxs.extend(range(start, start + cnt))
                        ws.extend([w] * cnt)
                t_max = max(t_max, len(idxs))
                shard_plans.append((idxs, ws))
            plans.append(shard_plans)
        T = bucket or next_bucket(t_max)
        S = self.n_stack
        tile_idx = np.zeros((S, B, T), np.int32)
        tile_w = np.zeros((S, B, T), np.float32)
        tile_v = np.zeros((S, B, T), bool)
        for si in range(self.n_shards):
            for bi, (idxs, ws) in enumerate(plans[si]):
                t = len(idxs)
                tile_idx[si, bi, :t] = idxs
                tile_w[si, bi, :t] = ws
                tile_v[si, bi, :t] = True
        msm = np.ones(B, np.int32)
        if operators is not None:
            for bi, op in enumerate(operators):
                if op == "and":
                    msm[bi] = len(term_lists[bi])
        return tile_idx, tile_w, tile_v, msm


# ---------------------------------------------------------------------------
# Per-entry scoring primitives, batched over the leading entry axis.
# ---------------------------------------------------------------------------


def _entry_offsets(n_entries: int, width: int, device) -> torch.Tensor:
    """int64[E, 1, 1, 1]: the flat offset of each entry's row block."""
    return (torch.arange(n_entries, dtype=torch.int64, device=device) * width).view(
        -1, 1, 1, 1
    )


def _gather_tiles(planes, ti, nt: int):
    """[E, B, TC, 128] rows of each stacked [E, nt, 128] plane at the
    per-entry tile ids `ti` [E, B, TC] (clipped into range, as the
    reference's `clip` does; invalid slots are masked by the caller)."""
    E = ti.shape[0]
    flat = (ti.clamp(0, nt - 1) + _entry_offsets(E, nt, ti.device)[:, :, :, 0])
    return [p.reshape(E * nt, TILE)[flat] for p in planes]


def _bm25_into(acc, cnt, dids, tfs, inv, ti, tw, tv, count_signed: bool):
    """acc[E*B, n+1] (+ cnt) += the BM25 contributions of one field's
    [E, B, T] tile plan, TCHUNK tiles per row at a time, in place. Per
    posting: w - w / (1 + tf * inv_norm[doc]) (ops/scoring._chunk_scores
    term for term); invalid slots add exactly 0 to the overflow column
    n. `count_signed` (the ServePlan families): |w| scores and only
    w > 0 counts toward msm (the MultiFusedScorer convention)."""
    E, B, T = ti.shape
    n_docs = inv.shape[1]
    nt = dids.shape[1]
    inv_flat = inv.reshape(-1)
    doc_off = _entry_offsets(E, n_docs, ti.device)
    for c0 in range(0, T, TCHUNK):
        tic = ti[:, :, c0 : c0 + TCHUNK]
        twc = tw[:, :, c0 : c0 + TCHUNK]
        rows_d, rows_t = _gather_tiles((dids, tfs), tic, nt)
        valid = (rows_d >= 0) & tv[:, :, c0 : c0 + TCHUNK, None]
        tgt = torch.where(valid, rows_d, n_docs).int()
        invg = inv_flat[rows_d.clamp(0, max(n_docs - 1, 0)).long() + doc_off]
        w = (twc.abs() if count_signed else twc)[:, :, :, None]
        s = w - w / (1.0 + rows_t.to(torch.float32) * invg)
        s = torch.where(valid, s, 0.0)
        counted = None
        if cnt is not None:
            counted = (valid & (twc > 0)[:, :, :, None] if count_signed else valid).to(torch.int32)
        ordered_scatter_add(acc, tgt, s, cnt, counted)


def _match_mask(acc, cnt, live, msm):
    """bool [E, B, n]: the finalize mask of ops/scoring._finalize per
    entry (count >= msm, or acc > 0 without counts), AND live ∧
    in-range."""
    E, n = live.shape
    if cnt is None:
        mask = acc.view(E, -1, n + 1)[:, :, :n] > 0
    else:
        mask = cnt.view(E, -1, n + 1)[:, :, :n] >= torch.clamp(msm, min=1)[None, :, None]
    return mask & live[:, None, :]


def _entry_topk(scores, mask, k: int):
    """Per-(entry, row) top-k: (s [E, B, k], d [E, B, k] int64, totals
    [E, B] int32)."""
    E, B, n = mask.shape
    masked = torch.where(mask, scores, -torch.inf)
    s, d = topk_desc(masked.reshape(E * B, n), min(k, n))
    return (
        s.view(E, B, -1),
        d.view(E, B, -1),
        mask.sum(dim=2, dtype=torch.int32),
    )


def _gather_slots(s, d):
    """[E, B, kk] per-entry pages → entry-major [B, E*kk] slots (the
    reference's all_gather + transpose)."""
    E, B, kk = s.shape
    return (
        s.permute(1, 0, 2).reshape(B, E * kk),
        d.permute(1, 0, 2).reshape(B, E * kk),
    )


def _merge_gathered(s, d, k: int):
    """Merge epilogue of the steps that cut at k: per-entry pages [E, B,
    kk] → (scores[B, K], entry[B, K], doc[B, K]) with K = min(k, E·kk).
    Slots are laid out entry-major (shard/segment asc) with per-entry
    ranks already doc-ascending among ties, and topk_desc keeps the
    lowest slot among equals — the coordinator's (score desc, shard
    asc, rank asc) merge order."""
    kk = s.shape[2]
    gs, gd = _gather_slots(s, d)
    K = min(k, gs.shape[1])
    ms, mi = topk_desc(gs, K)
    me = (mi // kk).to(torch.int32)
    md = torch.gather(gd, 1, mi).to(torch.int32)
    return ms, me, md


def pack_page(ms, me, md, tail):
    """One int32 [B, 3K + w] buffer (scores' bits, entries, docs, then
    the step's per-row tail: totals [B] or counts [B, E]) for the ONE
    packed download."""
    tail = tail.to(torch.int32)
    if tail.dim() == 1:
        tail = tail[:, None]
    return torch.cat([ms.contiguous().view(torch.int32), me, md, tail], dim=1)


def unpack_page(packed: torch.Tensor, k: int):
    """The ONE download: (scores f32[B, k], entries i32, docs i32, tail
    i32[B, w])."""
    (out,) = download(packed, site="mesh_page")
    return (
        out[:, :k].copy().view(np.float32),
        out[:, k : 2 * k],
        out[:, 2 * k : 3 * k],
        out[:, 3 * k :],
    )


def _entry_dots(q, mats, rows=None):
    """[E, B, N] products of q [B, d] with every entry's rows mats
    [E, N, d]. With `rows` (each entry's real row count) entry e's block
    is q @ mats[e, :rows[e]].T — the very [B, d] x [d, n] product the
    per-segment path computes, so on the CPU its bits are that path's (a
    batched or wider product reduces in another order); the padded
    columns are 0."""
    E, N, d = mats.shape
    if rows is None:
        rows = [N] * E
    out = torch.zeros((E, q.shape[0], N), dtype=torch.float32, device=q.device)
    for e in range(E):
        n = int(rows[e])
        if n:
            out[e, :, :n] = q @ mats[e, :n].T
    return out


def _similarity_scores(q, vectors, similarity: str, rows=None):
    """Dense [E, B, N] scores of queries q [B, d] (already unit rows for
    cosine) against stacked vectors [E, N, d]: ops/scoring.knn_scores'
    matmul and Lucene transform, the transform batched over the
    entries."""
    vectors = vectors.to(torch.float32)
    dots = _entry_dots(q, vectors, rows)
    if similarity in ("cosine", "dot_product"):
        return (1.0 + dots) / 2.0
    if similarity == "l2_norm":
        q2 = torch.sum(q * q, dim=1, keepdim=True)[None, :, :]
        v2 = torch.sum(vectors * vectors, dim=2)[:, None, :]
        return 1.0 / (1.0 + torch.clamp(q2 + v2 - 2.0 * dots, min=0.0))
    if similarity == "max_inner_product":
        return torch.where(dots < 0, 1.0 / (1.0 - dots), dots + 1.0)
    raise ValueError(f"unknown similarity [{similarity}]")


def _unit_rows(q):
    qn = torch.linalg.norm(q, dim=1, keepdim=True)
    return q / torch.where(qn == 0, 1.0, qn)


def _nc_cut_merge(s, d, nc):
    """The kNN merge: per-entry pages [E, B, kk], per-(entry, job)
    num_candidates caps nc [E, B] → the FULLY ordered stream (scores
    [B, slots], entry, doc) plus surviving candidates per entry counts
    [B, E]. A slot survives when its within-entry rank is below the
    cap and it scored a real candidate."""
    E, B, kk = s.shape
    gs, gd = _gather_slots(s, d)
    slots = E * kk
    dev = s.device
    entry_of_slot = torch.arange(slots, dtype=torch.int64, device=dev) // kk
    rank_of_slot = torch.arange(slots, dtype=torch.int64, device=dev) % kk
    nc_slot = nc.t()[:, entry_of_slot]  # [B, slots]
    valid = torch.isfinite(gs) & (rank_of_slot[None, :] < nc_slot)
    masked = torch.where(valid, gs, -torch.inf)
    ms, mi = topk_desc(masked, slots)
    me = entry_of_slot[mi].to(torch.int32)
    md = torch.gather(gd, 1, mi).to(torch.int32)
    counts = valid.view(B, E, kk).sum(dim=2, dtype=torch.int32)
    return ms, me, md, counts


# ---------------------------------------------------------------------------
# ShardedIndex steps
# ---------------------------------------------------------------------------


def build_sharded_bm25_step(index: ShardedIndex, k: int):
    """Search step over a ShardedIndex: per-shard score + top-k on each
    slot, then the merge. fn(tile_idx[S,B,T], tile_w, tile_v, msm[B]) ->
    ShardedTopK (device tensors) with global docs doc_base[shard] +
    local doc (-1 past the real hits)."""
    n_docs = index.n_docs_max

    def part(r, c, ti_h, tw_h, tv_h, msm):
        dev = index.live.at(r, c).device
        ti, tw, tv = _up_plan(dev, ti_h, tw_h, tv_h)
        E, B, _ = ti.shape
        acc = torch.zeros(E * B, n_docs + 1, dtype=torch.float32, device=dev)
        cnt = torch.zeros(E * B, n_docs + 1, dtype=torch.int32, device=dev)
        _bm25_into(acc, cnt, index.doc_ids.at(r, c), index.tfs.at(r, c),
                   index.inv_norm.at(r, c), ti, tw, tv, False)
        mask = _match_mask(acc, cnt, index.live.at(r, c), _up(dev, msm, torch.int32))
        s, d, t = _entry_topk(acc.view(E, B, -1)[:, :, :n_docs], mask, k)
        gdoc = torch.where(s > -torch.inf, d + index.doc_base.at(r, c)[:, None, None], -1)
        return s, gdoc, t

    def step(tile_idx, tile_w, tile_v, msm):
        msm = np.asarray(msm)
        s, gdoc, t = _run_slots(
            index.mesh, index.fold, len(msm),
            lambda r, c, ents, rows: part(
                r, c, tile_idx[ents, rows], tile_w[ents, rows], tile_v[ents, rows], msm[rows]
            ),
        )
        ms, _, md = _merge_gathered(s, gdoc, k)
        return ShardedTopK(ms, md, t.sum(dim=0, dtype=torch.int32))

    return step


def build_sharded_knn_step(index: ShardedIndex, k: int, similarity: str = "cosine"):
    """Brute-force kNN over a ShardedIndex: one batched matmul + top-k
    per shard on each slot, then the merge. fn(queries[B, d]) ->
    ShardedTopK."""
    if index.vectors is None:
        raise ValueError(f"index has no vector field [{index.vector_field}]")

    def part(r, c, queries):
        dev = index.live.at(r, c).device
        q = _up(dev, queries)
        if similarity == "cosine":
            q = _unit_rows(q)
        scores = _similarity_scores(q, index.vectors.at(r, c), similarity)
        mask = index.vec_exists.at(r, c)[:, None, :].expand_as(scores)
        s, d, t = _entry_topk(scores.to(torch.float32), mask, k)
        gdoc = torch.where(s > -torch.inf, d + index.doc_base.at(r, c)[:, None, None], -1)
        return s, gdoc, t

    def step(queries):
        queries = np.asarray(queries, np.float32)
        s, gdoc, t = _run_slots(
            index.mesh, index.fold, len(queries),
            lambda r, c, ents, rows: part(r, c, queries[rows]),
        )
        ms, _, md = _merge_gathered(s, gdoc, k)
        return ShardedTopK(ms, md, t.sum(dim=0, dtype=torch.int32))

    return step


# ---------------------------------------------------------------------------
# Serving steps — the production mesh path (MeshExecutor).
#
# The stacked axis carries (shard, segment) ENTRIES, not whole shards:
# the per-shard serving path scores per segment, so keeping the
# per-entry granularity makes the step reproduce the per-segment
# scorers value for value, and only the cross-segment + cross-shard
# merge moves from S host round trips into the step. Entry order is
# (shard asc, segment asc).
# ---------------------------------------------------------------------------


def build_mesh_text_step(
    mesh: Mesh,
    doc_ids_f: Sequence[Stacked],  # per field: [E, Tmax_f, TILE] stacked
    tfs_f: Sequence[Stacked],
    inv_norm_f: Sequence[Stacked],  # per field: [E, Nmax]
    live: Stacked,  # bool[E, Nmax] (live docs ∧ in-range padding mask)
    k: int,
    *,
    with_cnt: bool,
    count_signed: bool,
    combine: str = "sum",
    tie: float = 0.0,
):
    """One text-scoring step over stacked (shard, segment) entries.

    fn(ti_f, tw_f, tv_f, msm[B]) → packed int32 [B, 3K + 1] (scores,
    entries, docs, totals; `unpack_page`) with per-field plans ti/tw/tv
    of shape [E, B, T_f].

    * ``count_signed`` (the ServePlan families): |w| scores, w > 0
      counts toward msm — the MultiFusedScorer weight-sign convention.
    * ``with_cnt`` False (pure-disjunction match groups): the match mask
      is ``acc > 0`` exactly like ops/scoring._finalize with cnt=None.
    * ``combine``: "sum" (bool / most_fields) or "max_tie"
      (best_fields: max + tie·(sum − max)).
    """
    n_docs = int(inv_norm_f[0].shape[1])

    def part(r, c, ti_f, tw_f, tv_f, msm):
        lv = live.at(r, c)
        dev = lv.device
        E = int(lv.shape[0])
        cnt = None
        accs = []
        for fi in range(len(doc_ids_f)):
            ti, tw, tv = _up_plan(dev, ti_f[fi], tw_f[fi], tv_f[fi])
            B = ti.shape[1]
            if with_cnt and cnt is None:
                cnt = torch.zeros(E * B, n_docs + 1, dtype=torch.int32, device=dev)
            acc = torch.zeros(E * B, n_docs + 1, dtype=torch.float32, device=dev)
            _bm25_into(acc, cnt, doc_ids_f[fi].at(r, c), tfs_f[fi].at(r, c),
                       inv_norm_f[fi].at(r, c), ti, tw, tv, count_signed)
            accs.append(acc.view(E, B, -1)[:, :, :n_docs])
        if len(accs) == 1:
            combined = accs[0]
        elif combine == "sum":
            combined = accs[0]
            for a in accs[1:]:
                combined = combined + a
        else:  # max_tie (DisjunctionMaxQuery)
            stack = torch.stack(accs)
            best = stack.amax(dim=0)
            combined = best + tie * (stack.sum(dim=0) - best)
        if cnt is None:
            mask = (combined > 0) & lv[:, None, :]
        else:
            mask = _match_mask(None, cnt, lv, _up(dev, msm))
        return _entry_topk(combined, mask, k)

    def step(ti_f, tw_f, tv_f, msm):
        msm = np.asarray(msm, np.int32)
        s, d, t = _run_slots(
            mesh, live.fold, len(msm),
            lambda r, c, ents, rows: part(
                r, c,
                [a[ents, rows] for a in ti_f], [a[ents, rows] for a in tw_f],
                [a[ents, rows] for a in tv_f], msm[rows],
            ),
        )
        ms, me, md = _merge_gathered(s, d, k)
        return pack_page(ms, me, md, t.sum(dim=0, dtype=torch.int32))

    return step


def build_mesh_sparse_step(
    mesh: Mesh,
    doc_ids: Stacked,  # [E, Tmax, TILE] stacked impact-ordered tiles
    values: Stacked,  # [E, Tmax, TILE] stored dtype (int8 or f32)
    live: Stacked,  # bool[E, Nmax] (live docs ∧ in-range padding mask)
    k: int,
):
    """One learned-sparse scoring step over stacked (shard, segment)
    entries.

    fn(ti, tw, tv) → packed int32 [B, 3K + 1] (`unpack_page`) with the
    per-(entry, job) tile plan ti/tw/tv of shape [E, B, T].

    The contribution is ops/impact.impact_tile_contrib — the expression
    the per-segment ImpactScorer runs — and the tile lists arrive
    term-ordered with every tile present (no pruning on the mesh path,
    which keeps the totals exact). `tw` carries the query weight with
    each ENTRY's per-term dequant scale pre-folded, so one step serves
    int8 and fp32 columns alike."""
    from ..ops.impact import impact_tile_contrib

    n_docs = int(live.shape[1])
    nt = int(doc_ids.shape[1])

    def part(r, c, ti_h, tw_h, tv_h):
        lv = live.at(r, c)
        dev = lv.device
        E = int(lv.shape[0])
        ti, tw, tv = _up_plan(dev, ti_h, tw_h, tv_h)
        B, T = ti.shape[1], ti.shape[2]
        rows = E * B
        acc = torch.zeros(rows, n_docs + 1, dtype=torch.float32, device=dev)
        cnt = torch.zeros(rows, n_docs + 1, dtype=torch.int32, device=dev)
        for c0 in range(0, T, TCHUNK):
            tic = ti[:, :, c0 : c0 + TCHUNK]
            rows_d, rows_v = _gather_tiles((doc_ids.at(r, c), values.at(r, c)), tic, nt)
            valid = (rows_d >= 0) & tv[:, :, c0 : c0 + TCHUNK, None]
            tgt, s = impact_tile_contrib(
                rows_d, rows_v, tw[:, :, c0 : c0 + TCHUNK, None], valid, n_docs
            )
            ordered_scatter_add(acc, tgt, s, cnt, valid.to(torch.int32))
        acc = acc.view(E, B, n_docs + 1)[:, :, :n_docs]
        # every query term is optional: the sparse match mask is
        # cnt > 0, exactly ops/scoring._finalize at msm=1
        mask = (cnt.view(E, B, n_docs + 1)[:, :, :n_docs] >= 1) & lv[:, None, :]
        return _entry_topk(acc, mask, k)

    def step(ti_h, tw_h, tv_h):
        s, d, t = _run_slots(
            mesh, live.fold, int(np.asarray(ti_h).shape[1]),
            lambda r, c, ents, rows: part(
                r, c, ti_h[ents, rows], tw_h[ents, rows], tv_h[ents, rows]
            ),
        )
        ms, me, md = _merge_gathered(s, d, k)
        return pack_page(ms, me, md, t.sum(dim=0, dtype=torch.int32))

    return step


def build_mesh_rerank_step(
    mesh: Mesh,
    doc_ids: Stacked,  # [E, Tmax, TILE] stacked postings tiles
    tfs: Stacked,
    inv_norm: Stacked,  # [E, Nmax]
    live: Stacked,  # bool[E, Nmax]
    rr_starts: Stacked,  # i32 [E, Nmax] local doc → flat token row
    rr_counts: Stacked,  # i32 [E, Nmax]
    rr_toks: Stacked,  # [E, Fmax, d] f32 (or int8 with scales)
    rr_scales: Optional[Stacked],  # f32 [E, Fmax] or None
    kb: int,  # local candidate page (compile bucket >= k_req)
    k_req: int,  # the request page (from + size): per-entry page cut
    window: int,  # rescore window, already clamped to k_req
    tmax: Sequence[int],  # per entry: max tokens per doc (its gather width)
    *,
    with_cnt: bool,
):
    """One first-stage + RERANK step: per-entry BM25 scoring and local
    top-k exactly like build_mesh_text_step (single field), then the
    maxsim rescore runs per entry over that entry's own rank_vectors
    tokens (on the entry's slot), so the merge sees already-reranked
    candidates. With one live segment per shard (the routing
    precondition), each entry's local stream equals the per-shard
    path's post-rescore page: positions < window are re-sorted by
    blended score, positions [window, k_req) keep first stage, positions
    >= k_req are dropped (the shard page cut). Each entry's maxsim runs
    in the shapes of the per-shard path's rerank group (B rows, the
    window bucket `wb` of a full page, the entry's own `tmax`): the
    product's reduction order on the card follows its shapes, so the
    scores are bit for bit the per-shard path's.

    fn(ti, tw, tv, msm[B], qtoks[B, Qt, d], qvalid[B, Qt], weights[2])
    → packed int32 [B, 3·slots + 1]: the merged stream FULLY ordered
    (score desc, slot asc = (entry, post-rescore rank) asc — the
    coordinator's (-score, shard, rank) tie-break) rather than cut at a
    global k, mirroring build_mesh_knn_step."""
    from ..ops.rerank import blend_and_sort, maxsim_candidates

    n_docs = int(inv_norm.shape[1])
    kk = min(kb, n_docs)
    wc = min(window, k_req, kk)
    # search/rescorer.RerankPlan.wb of a full per-shard page
    wb = max(16, next_bucket(min(k_req, kk), 16))
    fmax = int(rr_toks.shape[1])
    fold = live.fold

    def flat_csr(r, c):
        # the slot's CSR bounds as one flat column over its [fold * Fmax]
        # token rows: local entry i's doc starts at i * Fmax + starts[i]
        dev = live.at(r, c).device
        starts = (
            rr_starts.at(r, c).to(torch.int64)
            + (torch.arange(fold, dtype=torch.int64, device=dev) * fmax)[:, None]
        ).reshape(-1)
        return (
            starts,
            rr_counts.at(r, c).reshape(-1),
            rr_toks.at(r, c).reshape(fold * fmax, -1),
            None if rr_scales is None else rr_scales.at(r, c).reshape(-1),
        )

    csr = [[flat_csr(r, c) for c in range(len(row))] for r, row in enumerate(mesh.devices)]

    def part(r, c, ti_h, tw_h, tv_h, msm, qtoks, qvalid, weights):
        lv = live.at(r, c)
        dev = lv.device
        E = fold
        ti, tw, tv = _up_plan(dev, ti_h, tw_h, tv_h)
        B = ti.shape[1]
        acc = torch.zeros(E * B, n_docs + 1, dtype=torch.float32, device=dev)
        cnt = (
            torch.zeros(E * B, n_docs + 1, dtype=torch.int32, device=dev)
            if with_cnt else None
        )
        _bm25_into(acc, cnt, doc_ids.at(r, c), tfs.at(r, c), inv_norm.at(r, c),
                   ti, tw, tv, False)
        mask = _match_mask(acc, cnt, lv, _up(dev, msm))
        s_e, d_e, t = _entry_topk(acc.view(E, B, -1)[:, :, :n_docs], mask, kk)
        # ---- local rescore, before the merge: page cut at k_req,
        # maxsim over this entry's token block, window re-sort ----
        pos = torch.arange(kk, dtype=torch.int64, device=dev)
        keep = torch.isfinite(s_e) & (pos[None, None, :] < k_req)  # [E, B, kk]
        docs = torch.where(keep, d_e, 0) + (
            torch.arange(E, dtype=torch.int64, device=dev) * n_docs
        )[:, None, None]
        qt = _up(dev, qtoks)
        qv = _up(dev, qvalid)
        flat_starts, flat_counts, flat_toks, flat_scales = csr[r][c]
        msim = []
        for e in range(E):
            # [B, wb] candidates, padded with the entry's doc 0 as the
            # per-shard group pads with the shard's
            de = torch.nn.functional.pad(docs[e, :, :wb], (0, max(wb - kk, 0)), value=e * n_docs)
            m = maxsim_candidates(
                qt, qv, flat_starts, flat_counts, flat_toks, flat_scales, de, tmax[c * fold + e]
            )
            msim.append(torch.nn.functional.pad(m[:, :kk], (0, max(kk - wb, 0))))
        msim = torch.stack(msim).reshape(E * B, kk)
        first = torch.where(keep, s_e, -torch.inf)
        scores, perm = blend_and_sort(
            msim, first.reshape(E * B, kk), keep.reshape(E * B, kk),
            _up(dev, weights), wc,
        )
        d_sorted = torch.gather(d_e.reshape(E * B, kk), 1, perm.long())
        return scores.view(E, B, kk), d_sorted.view(E, B, kk), t

    def step(ti_h, tw_h, tv_h, msm, qtoks, qvalid, weights):
        msm = np.asarray(msm, np.int32)
        qtoks = np.asarray(qtoks, np.float32)
        qvalid = np.asarray(qvalid, bool)
        weights = np.asarray(weights, np.float32)
        s, d, t = _run_slots(
            mesh, fold, len(msm),
            lambda r, c, ents, rows: part(
                r, c, ti_h[ents, rows], tw_h[ents, rows], tv_h[ents, rows],
                msm[rows], qtoks[rows], qvalid[rows], weights,
            ),
        )
        gs, gd = _gather_slots(s, d)
        slots = gs.shape[1]
        ms, mi = topk_desc(gs, slots)
        me = (mi // kk).to(torch.int32)
        md = torch.gather(gd, 1, mi).to(torch.int32)
        return pack_page(ms, me, md, t.sum(dim=0, dtype=torch.int32))

    return step


def build_mesh_knn_step(
    mesh: Mesh,
    vectors: Stacked,  # [E, Nmax, dims] stacked (original dtype)
    cand: Stacked,  # bool[E, Nmax] exists ∧ live ∧ in-range
    similarity: str,
    kc: int,  # per-entry candidate page (≥ every job's num_candidates)
    n_per_entry: Optional[Sequence[int]] = None,  # real rows per entry
):
    """One brute-force kNN step over stacked (shard, segment) entries
    with the per-shard path's per-(job, entry) num_candidates rank cut
    applied on the coordinating device.

    fn(queries[B, d], nc[E, B]) → packed int32 [B, 3·slots + E]
    (scores, entries, docs, then counts [B, E]; `unpack_page`).
    The merged stream comes back FULLY ordered (score desc, slot asc —
    slots = E · kk) rather than cut at a global k, because the per-shard
    coordinator's knn semantics cut at k PER SHARD before the global
    page: the collector walks the ordered stream applying per-shard rank
    caps, which a global top-k could starve (one dominant shard would
    evict other shards' in-page ranks). counts = surviving candidates
    PER ENTRY, for the per-shard totals."""
    coord = coord_device(mesh)
    n_docs = int(vectors.shape[1])
    kk = min(kc, n_docs)

    def part(r, c, ents, queries):
        vecs = vectors.at(r, c)
        q = _up(vecs.device, queries)
        if similarity == "cosine":
            q = _unit_rows(q)
        rows = None if n_per_entry is None else n_per_entry[ents]
        scores = _similarity_scores(q, vecs, similarity, rows).to(torch.float32)
        s, d, _ = _entry_topk(scores, cand.at(r, c)[:, None, :].expand_as(scores), kk)
        return s, d

    def step(queries, nc):
        queries = np.asarray(queries, np.float32)
        s, d = _run_slots(
            mesh, vectors.fold, len(queries),
            lambda r, c, ents, rows: part(r, c, ents, queries[rows]),
        )
        ms, me, md, counts = _nc_cut_merge(s, d, _up(coord, np.asarray(nc, np.int64)))
        return pack_page(ms, me, md, counts)

    return step


def build_mesh_ann_step(
    mesh: Mesh,
    centroids: Stacked,  # f32 [E, nlist_max, d] (zero-padded entries)
    starts: Stacked,  # i32 [E, nlist_max]
    counts: Stacked,  # i32 [E, nlist_max]
    perm: Stacked,  # i32 [E, Fmax] flat cluster-major slot → doc
    vecs: Stacked,  # [E, Fmax, d] permuted block (f32/f16, or int8)
    scales: Optional[Stacked],  # f32 [E, Fmax] int8 twin, or None
    v2: Optional[Stacked],  # f32 [E, Fmax] (l2 only), or None
    cand: Stacked,  # bool [E, Nmax] exists ∧ live in DOC order
    similarity: str,
    nprobe: int,
    kc: int,
    layout: Sequence[Tuple[int, int, int, int]],  # per entry (n, nlist, F, cmax)
):
    """One IVF-probed kNN step over the stacked cluster-major blocks.
    Each entry probes its own slice of the stack, on its slot, through
    ops/ivf.ann_topk_batch — the centroid scan, the cluster gather, the
    product, the int8 scale and the transform of the per-segment probe,
    at that entry's own nlist and cmax, so the per-entry pages are the
    per-shard path's — and the merge is the SAME per-(job, entry)
    num_candidates rank cut as build_mesh_knn_step, so the collector
    (MeshExecutor.collect_knn) is shared verbatim. A slot probes its
    entries one after the other (the reference's vmap over entries of
    unequal cluster layouts): a batched probe reduces in another order
    on the CPU.

    fn(queries[B, d], nc[E, B]) → packed int32 [B, 3·slots + E]."""
    from types import SimpleNamespace

    from ..ops.ivf import ann_topk_batch

    coord = coord_device(mesh)
    quant = scales is not None
    fold = cand.fold

    def entry_index(e, r):
        n, nl, F, cm = layout[e]
        return SimpleNamespace(
            similarity=similarity, n=n, nlist=nl, cmax=cm,
            centroids=centroids.entry(e, r)[:nl], starts=starts.entry(e, r)[:nl],
            counts=counts.entry(e, r)[:nl], perm=perm.entry(e, r)[:F],
            vecs_flat=None if quant else vecs.entry(e, r)[:F],
            qvecs_flat=vecs.entry(e, r)[:F] if quant else None,
            scales_flat=scales.entry(e, r)[:F] if quant else None,
            v2_flat=None if v2 is None else v2.entry(e, r)[:F],
        )

    # per data row: each real entry's probe handle over that row's copy
    entries = [
        [entry_index(e, r) for e in range(len(layout))]
        for r in range(mesh.devices.shape[0])
    ]
    kk = max(min(kc, min(nprobe, x.nlist) * x.cmax) for x in entries[0])

    def part(r, c, ents, queries):
        dev = cand.at(r, c).device
        q = _up(dev, queries)
        B = q.shape[0]
        valid = torch.ones(B, dtype=torch.bool, device=dev)
        sk = torch.full((fold, B, kk), -torch.inf, device=dev)
        dk = torch.zeros((fold, B, kk), dtype=torch.int64, device=dev)
        for i, e in enumerate(range(ents.start, min(ents.stop, len(layout)))):
            idx = entries[r][e]
            s, d = ann_topk_batch(
                idx, q, valid, cand.entry(e, r)[: idx.n], nprobe, kc, quantized=quant,
            )
            sk[i, :, : s.shape[1]] = s
            dk[i, :, : d.shape[1]] = d
        return sk, dk

    def step(queries, nc):
        queries = np.asarray(queries, np.float32)
        sk, dk = _run_slots(
            mesh, fold, len(queries),
            lambda r, c, ents, rows: part(r, c, ents, queries[rows]),
        )
        ms, me, md, cnts = _nc_cut_merge(sk, dk, _up(coord, np.asarray(nc, np.int64)))
        return pack_page(ms, me, md, cnts)

    return step


def build_mesh_agg_step(
    mesh: Mesh,
    live: Stacked,  # bool[E, Nmax] (live docs ∧ in-range padding mask)
    node_descs: Sequence[tuple],
    text: Optional[tuple],  # None | (doc_ids[E,T,128], tfs, inv[E,Nmax])
    with_cnt: bool,
):
    """One aggregation step over stacked (shard, segment) entries: each
    slot's bucket accumulators (segment-sum scatters over its fold of
    the stacked doc-value / ordinal columns) reduce across its entries,
    then across the slots with ``sum`` (counts, sums) / ``amin`` /
    ``amax`` — the coordinator's agg reduce collapsed into the step (the
    reference's psum/pmin/pmax), one launch per slot for the whole
    index.

    ``node_descs`` (`Stacked` arrays [E, …]): ("metric", values,
    ivalues, exists) → per-row (count, sum, min, max): float64 values
    for min/max (the doc-value dtype the per-shard engine keeps), the
    exact int32 copy for sums; ("counts_doc", ids, exists, nbpad) →
    per-row int32[nbpad] bucket counts (histogram family — ids are host-
    precomputed exact relative bucket ids); ("counts_entry", gords,
    edocs, evalid, nbpad) → the same over the multi-value ordinal CSR
    mapped to a GLOBAL ordinal table (keyword terms).

    ``text`` carries one match-plan field's stacked postings (the query
    mask is the same per-entry BM25 accumulation the serving text step
    runs); None serves match_all (mask = live).

    fn(ti[E,B,T], tw, tv, msm[B]) → float64 [B, width]: totals,
    max_scores, then each node's columns (4 for a metric, nbpad for a
    bucket node), packed for one download."""
    n_docs = int(live.shape[1])
    ops = ["sum", "max"]
    for desc in node_descs:
        ops.extend(["sum", "sum", "min", "max"] if desc[0] == "metric" else ["sum"])

    def scatter_rows(ids_e, sel, nbpad):
        # [E, B, L] selection of [E, L] ids → [E, B, nbpad] counts;
        # unselected slots land in a trash bucket that is cut off
        E, B = sel.shape[:2]
        safe = torch.where(sel, ids_e[:, None, :].long(), nbpad)
        out = torch.zeros(E, B, nbpad + 1, dtype=torch.int32, device=sel.device)
        out.scatter_add_(2, safe, torch.ones_like(safe, dtype=torch.int32))
        return out[:, :, :nbpad]

    def part(r, c, ti_h, tw_h, tv_h, msm):
        lv = live.at(r, c)
        dev = lv.device
        E = int(lv.shape[0])
        B = int(msm.shape[0])
        if text is not None:
            dids, tfs_, inv = text
            ti, tw, tv = _up_plan(dev, ti_h, tw_h, tv_h)
            acc = torch.zeros(E * B, n_docs + 1, dtype=torch.float32, device=dev)
            cnt = (
                torch.zeros(E * B, n_docs + 1, dtype=torch.int32, device=dev)
                if with_cnt else None
            )
            _bm25_into(acc, cnt, dids.at(r, c), tfs_.at(r, c), inv.at(r, c),
                       ti, tw, tv, False)
            scores = acc.view(E, B, -1)[:, :, :n_docs]
            mask = _match_mask(acc, cnt, lv, _up(dev, msm))
        else:
            scores = torch.ones(E, B, n_docs, dtype=torch.float32, device=dev)
            mask = lv[:, None, :].expand(E, B, n_docs)
        totals = mask.sum(dim=2, dtype=torch.int32).sum(dim=0, dtype=torch.int32)
        maxs = torch.where(mask, scores, -torch.inf).amax(dim=2).amax(dim=0)
        outs: list = [totals, maxs]
        for desc in node_descs:
            kind = desc[0]
            if kind == "metric":
                _, vals, ivals, exists = desc
                sel = mask & exists.at(r, c)[:, None, :]
                v = vals.at(r, c)[:, None, :]
                outs.extend([
                    sel.sum(dim=2, dtype=torch.int32).sum(dim=0, dtype=torch.int32),
                    torch.where(sel, ivals.at(r, c)[:, None, :], 0)
                    .sum(dim=2, dtype=torch.int32).sum(dim=0, dtype=torch.int32),
                    torch.where(sel, v, torch.inf).amin(dim=2).amin(dim=0),
                    torch.where(sel, v, -torch.inf).amax(dim=2).amax(dim=0),
                ])
            elif kind == "counts_doc":
                _, ids, exists, nbpad = desc
                sel = mask & exists.at(r, c)[:, None, :]
                outs.append(scatter_rows(ids.at(r, c), sel, nbpad).sum(dim=0, dtype=torch.int32))
            else:  # counts_entry
                _, gords, edocs, evalid, nbpad = desc
                ed = edocs.at(r, c)
                sel = torch.gather(
                    mask, 2, ed.long()[:, None, :].expand(E, B, ed.shape[1])
                ) & evalid.at(r, c)[:, None, :]
                outs.append(scatter_rows(gords.at(r, c), sel, nbpad).sum(dim=0, dtype=torch.int32))
        return outs

    def step(ti_h, tw_h, tv_h, msm):
        msm = np.asarray(msm, np.int32)
        B = int(msm.shape[0])
        outs = _combine_slots(
            mesh, live.fold, B,
            lambda r, c, ents, rows: part(
                r, c, ti_h[ents, rows], tw_h[ents, rows], tv_h[ents, rows], msm[rows]
            ),
            ops,
        )
        # one float64 [B, width] buffer for the ONE download: int32
        # counts and sums, float32 maxima and float64 extrema all keep
        # their values exactly in float64
        return torch.cat([o.reshape(B, -1).to(torch.float64) for o in outs], dim=1)

    return step


def rrf_fuse(
    lex: ShardedTopK, vec: ShardedTopK, k: int, rank_constant: int = 60
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Reciprocal-rank fusion of two ranked lists (x-pack rank-rrf:
    score = Σ 1/(rank_constant + rank)) through the serving path's fuser
    (ops/fusion.py): exact-doc dedup over the union of both lists, top-k
    with ascending-global-doc tie-break. Returns device tensors
    (scores[B,k], global_docs[B,k])."""
    from ..ops.fusion import rrf_fuse_device

    return rrf_fuse_device(
        (lex.global_docs.cpu().numpy(), vec.global_docs.cpu().numpy()),
        k, rank_constant, device=lex.global_docs.device,
    )
