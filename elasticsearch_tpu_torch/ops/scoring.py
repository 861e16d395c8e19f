"""Device scoring over tiled postings, in PyTorch.

Counterpart of `elasticsearch_tpu/ops/scoring.py` (the JAX package),
reduced to what serving `match`, `bool`, `multi_match` and exact kNN
runs (the single- and multi-field fused scorers for large segments, the
chunked scorer for small ones, the cross-segment merges):

  gather tile rows ([n_tiles, 128] int32 tensors on the device)
  → elementwise BM25
  → ordered scatter-add into a dense per-doc accumulator
    (term-at-a-time; ops/ordered_scatter.py)
  → a top-k that keeps the lowest index among equal scores (doc asc,
    matching Lucene and `lax.top_k`).

The reference left all of this to XLA; here it is plain PyTorch on
tensors, on whatever device the tensors live on. Shapes, constants and
the packed int32 plan/result layouts of `FusedScorer` are unchanged, so
a plan packed for one package is a plan for the other.

Scores are float32 end to end. Every float accumulation goes through
ops/ordered_scatter.ordered_scatter_add, or for a chunked pass through
`bm25_tile_add` (the same kernel's passes over slots it computes from
the postings), which add a doc's contributions in tile order on the CPU
and on the card alike (the order of the reference's `.at[].add`), so a
score's bits do not change from run to run. The parity tests against
the JAX package state rtol 1e-5: XLA on the CPU contracts `1 + tf *
inv_norm` into one fused multiply-add, PyTorch rounds the product first.
"""

from __future__ import annotations

import threading
from typing import Optional, Tuple

import numpy as np
import torch

from ..common.tracing import now_ns
from . import ordered_scatter
from .ordered_scatter import ordered_scatter_add, ordered_scatter_add_plain


def next_bucket(n: int, minimum: int = 8) -> int:
    """Round up to a power of two for shape-stable launches."""
    b = minimum
    while b < n:
        b *= 2
    return b


def pad_tiles(
    tile_idx: np.ndarray, tile_weights: np.ndarray, bucket: Optional[int] = None
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Pads per-query tile index/weight lists to a bucket size.

    Returns (tile_idx[T], tile_weights[T], tile_valid[T]) with T a power
    of two. Padded entries point at tile 0 with weight 0 and valid=False.
    """
    t = len(tile_idx)
    bucket = bucket or next_bucket(t)
    idx = np.zeros(bucket, np.int32)
    w = np.zeros(bucket, np.float32)
    v = np.zeros(bucket, bool)
    idx[:t] = tile_idx
    w[:t] = tile_weights
    v[:t] = True
    return idx, w, v


def topk_desc(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(values, indices) of the k largest float32 entries along the last
    axis in `lax.top_k`'s order: the IEEE total order (a NaN without its
    sign bit above +inf, one with it below -inf, +0.0 above -0.0), the
    LOWEST index first among equal bits — the doc-asc tie-break the
    reference relies on.

    One `torch.topk` over one int64 key per entry: the high word maps
    the float's bits onto int32 in that order, the low word is the
    inverted index. Every key is distinct, so the selection and its
    order are exact whatever order `torch.topk` keeps among ties. No
    host synchronisation happens here."""
    n = x.shape[-1]
    if k <= 0:
        shape = x.shape[:-1] + (0,)
        return x.new_empty(shape), torch.empty(shape, dtype=torch.int64, device=x.device)
    rows = x.reshape(-1, n)
    b = rows.contiguous().view(torch.int32)
    key32 = b ^ ((b >> 31) & 0x7FFFFFFF)
    low = 0xFFFFFFFF - torch.arange(n, dtype=torch.int64, device=x.device)
    key = (key32.to(torch.int64) << 32) | low
    idx = 0xFFFFFFFF - (torch.topk(key, k, dim=-1, sorted=True).values & 0xFFFFFFFF)
    vals = rows.gather(1, idx)
    shape = x.shape[:-1] + (k,)
    return vals.reshape(shape), idx.reshape(shape)


def score_tiles(
    doc_rows: torch.Tensor,  # int32[T, 128] gathered doc-id tiles
    tf_rows: torch.Tensor,  # int32[T, 128]
    tile_weights: torch.Tensor,  # float32[T] boost*idf per tile
    tile_valid: torch.Tensor,  # bool[T]
    inv_norm: torch.Tensor,  # float32[n_docs] cache[norm_byte] per doc
    n_docs: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (scores[float32, n_docs], match_counts[int32, n_docs]).

    score contribution per posting: w - w / (1 + tf * inv_norm[doc])
    (BM25Similarity.score with the 256-entry norm-inverse cache folded
    into a dense per-doc array).
    """
    valid = (doc_rows >= 0) & tile_valid[:, None]
    docs = torch.where(valid, doc_rows, n_docs).int()
    safe = doc_rows.clamp(0, max(n_docs - 1, 0)).long()
    inv = inv_norm[safe]
    tf = tf_rows.to(torch.float32)
    w = tile_weights[:, None]
    s = w - w / (1.0 + tf * inv)
    s = torch.where(valid, s, 0.0)
    dev = inv_norm.device
    acc = torch.zeros(n_docs + 1, dtype=torch.float32, device=dev)
    cnt = torch.zeros(n_docs + 1, dtype=torch.int32, device=dev)
    ordered_scatter_add(acc, docs, s, cnt, valid.to(torch.int32))
    return acc[:n_docs], cnt[:n_docs]


def topk_hits(
    scores: torch.Tensor, mask: torch.Tensor, k: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(top scores, top doc ids), score desc / doc asc. Masked-out docs
    get -inf and surface as doc id entries with -inf score; callers trim
    by count."""
    masked = torch.where(mask, scores, -torch.inf)
    return topk_desc(masked, k)


BPAD = 32  # max query rows per launch (top of the reference's bucket ladder)

# ---- FLOP estimates for MFU/roofline accounting -------------------------
# Useful (non-padding) work per scored element. Per posting slot the BM25
# formula does ~6 flops (tf·inv_norm multiply, 1+x add, divide, w−x
# subtract, validity select, scatter add); a dense hot-term row does ~4
# per doc (no gather/scatter). top-k selection is not counted.

FLOPS_PER_POSTING_SLOT = 6
FLOPS_PER_DENSE_SLOT = 4
TILE_WIDTH = 128


def text_plan_flops(n_tile_slots: int, n_hot_rows: int, n_docs: int) -> int:
    """Estimated flops of one job's text-scoring plan on one segment."""
    return (
        n_tile_slots * TILE_WIDTH * FLOPS_PER_POSTING_SLOT
        + n_hot_rows * n_docs * FLOPS_PER_DENSE_SLOT
    )


def knn_flops(n_queries: int, n_docs: int, dims: int) -> int:
    """Flops of the brute-force similarity matmul (2·B·N·d)."""
    return 2 * n_queries * n_docs * dims


# ---------------------------------------------------------------------------
# Chunked batched scorer — the path for small segments (every segment a
# `_bulk` + refresh makes) and for fused-slot overflow. Each row's tile
# list, of any length, is one scoring pass into a dense [rows, n_docs + 1]
# accumulator (the extra column takes padding), updated in place, as the
# reference donates it: one packed upload and one call of the ordered
# BM25 tile add (`bm25_tile_add`) a pass.
# ---------------------------------------------------------------------------

TCHUNK = 512  # tiles per query row per launch (the sparse and mesh loops)


def _chunk_scores(doc_ids, tfs, inv_norm, ti, tw, tv):
    """(scatter targets int32 [B, TC, 128], BM25 contributions, valid mask)
    for one [B, TC] chunk of tile ids `ti` with weights `tw`; invalid
    slots score exactly 0 and target the overflow column n_docs."""
    n_docs = inv_norm.shape[0]
    rows_d = doc_ids[ti]  # [B, TC, 128]
    rows_t = tfs[ti]
    valid = (rows_d >= 0) & tv[:, :, None]
    tgt = torch.where(valid, rows_d, n_docs).int()
    inv = inv_norm[rows_d.clamp(0, max(n_docs - 1, 0)).long()]
    w = tw[:, :, None]
    s = w - w / (1.0 + rows_t.to(torch.float32) * inv)
    return tgt, torch.where(valid, s, 0.0), valid


def bm25_tile_add_plain(acc, cnt, doc_ids, tfs, inv_norm, tile_lists, weight_lists):
    """The same function in plain PyTorch: row by row, `_chunk_scores`
    over the row's whole list and `ordered_scatter_add_plain` into the
    row, which on the CPU adds a cell's contributions in slot order."""
    for r, (tl, wl) in enumerate(zip(tile_lists, weight_lists)):
        if not len(tl):
            continue
        ti = torch.as_tensor(np.asarray(tl, np.int64), device=acc.device)[None]
        tw = torch.as_tensor(np.asarray(wl, np.float32), device=acc.device)[None]
        tgt, s, valid = _chunk_scores(doc_ids, tfs, inv_norm, ti, tw, torch.ones_like(ti, dtype=torch.bool))
        if cnt is None:
            ordered_scatter_add_plain(acc[r], tgt, s)
        else:
            ordered_scatter_add_plain(acc[r], tgt, s, cnt[r], valid.to(torch.int32))
    return acc, cnt


def bm25_tile_add(acc, cnt, doc_ids, tfs, inv_norm, tile_lists, weight_lists) -> int:
    """One scoring pass, in place: acc[r, doc] += w - w / (1 + tf *
    inv_norm[doc]) (and cnt[r, doc] += 1) for every posting (doc, tf) of
    every tile of row r's list (weight w a tile), each cell's additions
    in list order. acc (and cnt) [rows, n_docs + 1]; rows past the lists
    add nothing. CUDA tensors take `csrc/ordered_scatter.cu`'s BM25 tile
    add (or raise): one packed upload and one call, whatever the pass's
    length, and no wait for the card; CPU tensors the plain version.
    Returns the launches made (the kernel's windows, which
    `ordered_scatter.launch_tile_add.launches` counts; on the CPU the
    plain version's one pass)."""
    if len(tile_lists) > acc.shape[0] or len(weight_lists) != len(tile_lists):
        raise ValueError(f"bm25_tile_add: {len(tile_lists)} lists for {acc.shape[0]} rows")
    if not any(len(t) for t in tile_lists):
        return 0
    if acc.device.type == "cpu":
        bm25_tile_add_plain(acc, cnt, doc_ids, tfs, inv_norm, tile_lists, weight_lists)
        return 1
    rows = int(acc.shape[0])
    lens = [len(t) for t in tile_lists] + [0] * (rows - len(tile_lists))
    lay = ordered_scatter.tile_layout(int(acc.shape[-1]), lens)
    plan = upload(ordered_scatter.pack_tiles(tile_lists, weight_lists, rows), acc.device)
    ordered_scatter.launch_tile_add(acc, cnt, doc_ids, tfs, inv_norm, plan, lay)
    return lay.windows


def _threshold(acc, live, k: int, block_size: int):
    """(theta[B], accmax[B, n_blocks]) after the essential-terms pass.

    theta = kth best accumulated score over matching LIVE docs (the
    top-k floor the pruning bound must beat); accmax keeps deleted docs
    in — an overestimate is a sound upper bound."""
    a = acc[:, :-1]
    n = a.shape[1]
    masked = torch.where(a > 0, a, -torch.inf)
    if live is not None:
        masked = torch.where(live[None, :], masked, -torch.inf)
    # the k-th VALUE does not depend on how ties are ordered
    theta = torch.topk(masked, min(k, n), dim=1).values[:, -1]
    n_blocks = -(-n // block_size)
    pad = n_blocks * block_size - n
    ap = torch.nn.functional.pad(a, (0, pad))
    accmax = ap.reshape(a.shape[0], n_blocks, block_size).amax(dim=2)
    return theta, accmax


def _finalize(acc, cnt, live, msm, k: int):
    """(scores[B,k], docs[B,k], totals[B]); score desc / doc asc."""
    a = acc[:, :-1]
    n = a.shape[1]
    if cnt is None:
        mask = a > 0
    else:
        mask = cnt[:, :-1] >= torch.clamp(msm, min=1)[:, None]
    if live is not None:
        mask = mask & live[None, :]
    masked = torch.where(mask, a, -torch.inf)
    s, d = topk_desc(masked, min(k, n))
    return s, d.to(torch.int32), mask.sum(dim=1, dtype=torch.int32)


class ChunkedScorer:
    """Batched BM25 scoring over one segment's tiled postings with fixed
    launch shapes (see the section comment above).

    Reference analog: the per-leaf BM25 scoring loop
    (BM25Similarity.score inside Weight.scorer iteration); the dense
    [rows, n_docs] accumulator replaces the doc-at-a-time heap, and the
    threshold/finalize split is the WAND phase boundary. All tensors
    live on the device of `doc_ids`."""

    def __init__(self, doc_ids, tfs, inv_norm, live=None, block_size: int = 4096):
        self.device = doc_ids.device
        self.doc_ids = doc_ids
        self.tfs = tfs
        self.inv_norm = _as_device(inv_norm, self.device, torch.float32)
        self.live = _as_device(live, self.device, torch.bool)
        self.n_docs = int(self.inv_norm.shape[0])
        self.block_size = block_size

    def new_acc(self, with_cnt: bool, rows: int = BPAD):
        """Zeroed accumulators for one launch of `rows` query rows (the
        group's ladder bucket)."""
        acc = torch.zeros(rows, self.n_docs + 1, dtype=torch.float32, device=self.device)
        cnt = (
            torch.zeros(rows, self.n_docs + 1, dtype=torch.int32, device=self.device)
            if with_cnt
            else None
        )
        return acc, cnt

    def score_pass(self, acc, cnt, tile_lists, weight_lists) -> int:
        """Adds one pass of per-row tile/weight lists (<= acc rows, any
        length) into the accumulators, in place: one packed upload and one
        `bm25_tile_add` call that does not wait for the device. Returns
        the launches it made."""
        return bm25_tile_add(acc, cnt, self.doc_ids, self.tfs, self.inv_norm, tile_lists, weight_lists)

    def score_into(self, acc, cnt, tile_lists, weight_lists):
        """`score_pass`, returning the accumulators as the reference does."""
        self.score_pass(acc, cnt, tile_lists, weight_lists)
        return acc, cnt

    def threshold(self, acc, k: int, live=None):
        """Host (theta[B], accmax[B, n_blocks]) — the one host-dependent
        round of block-max pruning. `live` optionally overrides the
        constructor's live-docs mask."""
        theta, accmax = _threshold(
            acc,
            live if live is not None else self.live,
            k=min(k, self.n_docs),
            block_size=self.block_size,
        )
        return download(theta, accmax, site="threshold")

    def finalize(self, acc, cnt, msm: np.ndarray, k: int, live=None):
        s, d, tot = self.finalize_device(acc, cnt, msm, k, live=live)
        return download(s, d, tot, site="finalize")

    def finalize_device(self, acc, cnt, msm: np.ndarray, k: int, live=None):
        """Like finalize() but the (scores, docs, totals) triple STAYS on
        the device, so the cross-segment merge consumes it with no
        per-segment host sync."""
        return _finalize(
            acc,
            cnt,
            live if live is not None else self.live,
            upload(np.asarray(msm, np.int32), self.device),
            k=min(k, self.n_docs),
        )


# ---------------------------------------------------------------------------
# Fused single-round-trip scorer: the whole query phase of one large
# segment for up to BPAD queries, fed by ONE packed int32 plan upload and
# returning ONE packed int32 download. Rare terms go through the tile
# gather + scatter-add; hot terms (high doc_freq) are scored from dense
# per-doc uint8 tf rows built once on the device, a pure vector add.
# ---------------------------------------------------------------------------

FUSED_T_RARE = 256  # rare tile slots per query (fixed launch shape)
FUSED_H = 4  # dense hot-term slots per query (fixed launch shape)
DENSE_TF_MAX = 255  # uint8 dense rows; overflowing postings go sparse


def build_dense_rows(doc_ids, tfs, hot_tiles, hot_rank_of_tile, n_hot, n_docs):
    """uint8[n_hot, n_docs] per-doc tf rows for hot terms, built ON
    DEVICE from the already-resident postings tiles. Postings with
    tf > DENSE_TF_MAX are stored as 0 here and must be scored through
    sparse overflow tiles (exactness)."""
    hot_tiles = hot_tiles.long()
    rows_d = doc_ids[hot_tiles]  # [T_hot, 128]
    rows_t = tfs[hot_tiles]
    valid = (rows_d >= 0) & (rows_t <= DENSE_TF_MAX)
    docs = torch.where(valid, rows_d, n_docs).long()
    flat = hot_rank_of_tile.long()[:, None] * (n_docs + 1) + docs
    tf8 = torch.where(valid, rows_t, 0).to(torch.uint8)
    dense = torch.zeros(n_hot * (n_docs + 1), dtype=torch.uint8, device=doc_ids.device)
    # every (rank, doc) slot is written once, except the overflow column
    # n_docs, which only ever receives 0
    dense[flat.reshape(-1)] = tf8.reshape(-1)
    return dense.reshape(n_hot, n_docs + 1)[:, :n_docs]


def _as_device(x, device, dtype=None):
    if x is None:
        return None
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=dtype)
    return torch.as_tensor(np.asarray(x), dtype=dtype, device=device)


# who listens to this thread's downloads: the batcher sets `sink` to the
# group it serves (an object with `wait(site, nbytes, t0_ns, t1_ns)`)
WAITS = threading.local()


def download(*tensors: torch.Tensor, site: str) -> Tuple[np.ndarray, ...]:
    """Device tensors as host arrays: the one way a serving path reads a
    result back, and so the one place where its host thread waits for
    the stream (the first `.cpu()` blocks until every kernel queued
    before it has run). One call is one wait, timed on the span clock
    and reported with its `site` and bytes to this thread's listener
    (`WAITS.sink`), which counts it and records a `device.wait` span.
    On the CPU it is the tensors' own memory, counted the same way."""
    t0 = now_ns()
    out = tuple(t.cpu().numpy() for t in tensors)
    sink = getattr(WAITS, "sink", None)
    if sink is not None:
        sink.wait(site, sum(a.nbytes for a in out), t0, now_ns())
    return out


def upload(host: np.ndarray, device) -> torch.Tensor:
    """A host array as a tensor on `device` WITHOUT waiting for the
    device: on a card the array goes through pinned memory and an
    asynchronous copy on the current stream (a pageable copy would wait
    for every kernel queued before it, which collapses the batcher's
    dispatch/collect pipeline). On the CPU it is the array itself."""
    t = torch.from_numpy(np.ascontiguousarray(host))
    if torch.device(device).type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t


class FusedScorer:
    """One-call batched BM25 query phase over one segment.

    Plan packing (int32[B, 2*T_RARE + 2*H + 1]):
      [0:T)          rare tile ids into the postings arrays (-1 = pad)
      [T:2T)         float32 tile weights, bitcast
      [2T:2T+H)      dense hot rows (-1 = pad)
      [2T+H:2T+2H)   float32 hot weights, bitcast
      [2T+2H]        minimum_should_match

    Result packing (int32[B, 2k + 1]):
      [0:k) float32 scores bitcast · [k:2k) doc ids · [2k] total
    """

    def __init__(
        self,
        doc_ids: torch.Tensor,
        tfs: torch.Tensor,
        inv_norm,
        live,
        dense_rows: Optional[torch.Tensor],  # uint8[n_hot, n_docs]
        t_rare: int = FUSED_T_RARE,
        n_hot_slots: int = FUSED_H,
    ):
        self.device = doc_ids.device
        self.doc_ids = doc_ids
        self.tfs = tfs
        self.inv_norm = _as_device(inv_norm, self.device, torch.float32)
        self.live = _as_device(live, self.device, torch.bool)
        self.dense = dense_rows
        self.n_docs = int(self.inv_norm.shape[0])
        self.t_rare = t_rare
        self.n_hot_slots = n_hot_slots

    def plan_shape(self, rows: int = BPAD):
        """Plan shape at one query-row bucket."""
        return (rows, 2 * self.t_rare + 2 * self.n_hot_slots + 1)

    def pack_plans(self, plans, rows: int = BPAD) -> np.ndarray:
        """plans: per job (rare_tiles i64[], rare_w f32[], hot_ranks
        i64[], hot_w f32[], msm int). Jobs beyond the row bucket `rows`
        are an error; overflowing a slot budget must be handled by the
        caller."""
        T, H = self.t_rare, self.n_hot_slots
        out = np.empty(self.plan_shape(rows), np.int32)
        out[:, :T] = -1
        out[:, T : 2 * T] = 0
        out[:, 2 * T : 2 * T + H] = -1
        out[:, 2 * T + H :] = 0
        fout = out.view(np.float32)
        for j, (rt, rw, hr, hw, msm) in enumerate(plans):
            nt, nh = len(rt), len(hr)
            out[j, :nt] = rt
            fout[j, T : T + nt] = rw
            out[j, 2 * T : 2 * T + nh] = hr
            fout[j, 2 * T + H : 2 * T + H + nh] = hw
            out[j, 2 * T + 2 * H] = msm
        return out

    def search_async(self, plans, k: int, with_cnt: bool, live=None,
                     rows: int = BPAD):
        """Launches the fused query phase WITHOUT waiting for the result:
        returns (device_out, k) for decode_result(). The one host→device
        copy is the packed plan; nothing is read back here. `live`
        optionally overrides the constructor's live-docs mask; `rows` is
        the launch's query-row bucket."""
        k = min(k, self.n_docs)
        packed = self.pack_plans(plans, rows=rows)
        out = _fused_query(
            self.doc_ids,
            self.tfs,
            self.inv_norm,
            _as_device(live, self.device, torch.bool) if live is not None else self.live,
            self.dense,
            upload(packed, self.device),
            t_rare=self.t_rare,
            n_hot=self.n_hot_slots,
            k=k,
            with_cnt=with_cnt,
        )
        return out, k

    @staticmethod
    def decode_result(pending):
        """Blocks on the device transfer and unpacks to
        (scores f32[B,k], docs i32[B,k], totals i64[B])."""
        out, k = pending
        (out,) = download(out, site="fused_result")
        scores = out[:, :k].copy().view(np.float32)
        docs = out[:, k : 2 * k]
        totals = out[:, 2 * k].astype(np.int64)
        return scores, docs, totals

    @staticmethod
    def device_result(pending):
        """Unpacks a pending launch WITHOUT leaving the device: returns
        (scores f32[B,k], docs i32[B,k], totals i32[B]) device tensors
        for the cross-segment merge (merge_segment_topk)."""
        out, k = pending
        return out[:, :k].view(torch.float32), out[:, k : 2 * k], out[:, 2 * k]

    def search(self, plans, k: int, with_cnt: bool, live=None, rows: int = BPAD):
        """One device round trip for up to BPAD jobs. Returns
        (scores f32[B,k], docs i32[B,k], totals i64[B])."""
        return self.decode_result(
            self.search_async(plans, k, with_cnt, live=live, rows=rows)
        )


def _fused_query(doc_ids, tfs, inv_norm, live, dense, plan, t_rare, n_hot, k, with_cnt):
    n = inv_norm.shape[0]
    T, H = t_rare, n_hot
    B = plan.shape[0]
    rare_ti = plan[:, :T]
    rare_tw = plan[:, T : 2 * T].view(torch.float32)
    hot_ids = plan[:, 2 * T : 2 * T + H]
    hot_w = plan[:, 2 * T + H : 2 * T + 2 * H].view(torch.float32)
    msm = plan[:, 2 * T + 2 * H]

    # ---- rare terms: tile gather + scatter-add ----
    tile_ok = rare_ti >= 0
    ti = rare_ti.clamp(0, doc_ids.shape[0] - 1).long()
    rows_d = doc_ids[ti]  # [B,T,128]
    rows_t = tfs[ti]
    valid = (rows_d >= 0) & tile_ok[:, :, None]
    tgt = torch.where(valid, rows_d, n).int()
    inv = inv_norm[rows_d.clamp(0, n - 1).long()]
    w = rare_tw[:, :, None]
    s = w - w / (1.0 + rows_t.to(torch.float32) * inv)
    s = torch.where(valid, s, 0.0)
    acc = torch.zeros(B, n + 1, dtype=torch.float32, device=plan.device)
    cnt = torch.zeros(B, n + 1, dtype=torch.int32, device=plan.device) if with_cnt else None
    ordered_scatter_add(acc, tgt, s, cnt, valid.to(torch.int32) if with_cnt else None)
    acc = acc[:, :n]
    if with_cnt:
        cnt = cnt[:, :n]

    # ---- hot terms: dense per-doc tf rows, pure vector math ----
    if dense is not None and dense.shape[0] > 0:
        for h in range(H):
            hid = hot_ids[:, h]
            ok = hid >= 0
            row_tf = dense[hid.clamp(0, dense.shape[0] - 1).long()].to(torch.float32)
            wh = torch.where(ok, hot_w[:, h], 0.0)[:, None]
            contrib = wh - wh / (1.0 + row_tf * inv_norm[None, :])
            match = (row_tf > 0) & ok[:, None]
            acc = acc + torch.where(match, contrib, 0.0)
            if with_cnt:
                cnt = cnt + match.to(torch.int32)

    # ---- collection ----
    if with_cnt:
        mask = cnt >= torch.clamp(msm, min=1)[:, None]
    else:
        mask = acc > 0
    if live is not None:
        mask = mask & live[None, :]
    masked = torch.where(mask, acc, -torch.inf)
    top_s, top_d = topk_desc(masked, k)
    totals = mask.sum(dim=1, dtype=torch.int32)
    return torch.cat(
        [top_s.view(torch.int32), top_d.to(torch.int32), totals[:, None]],
        dim=1,
    )


# ---------------------------------------------------------------------------
# Multi-field fused scorer: the single-launch design above extended to
# bool must/should and multi_match:
#
#   * per-slot COUNTED flags ride the SIGN of the packed weight: w > 0
#     scores |w| and counts toward minimum_should_match (bool MUST terms,
#     or every term of a should-only bool), w < 0 scores |w| only (SHOULD
#     next to a must) — BooleanQuery's required vs optional scorers;
#   * F fields (each with its own postings, norms and dense rows) score
#     into per-field accumulators combined as "sum" (most_fields, bool)
#     or "max_tie" = max + tie·(sum − max) (best_fields, dis_max).
#
# One packed int32 plan upload, the whole query phase on the device, one
# packed result (FusedScorer's layout).
# ---------------------------------------------------------------------------


class MultiFusedScorer:
    """One-call batched BM25 query phase over one segment and F fields.

    Per-field plan section (int32[2*T + 2*H]): rare tile ids + signed
    float32 weights (bitcast) + dense hot row ids + signed hot weights.
    Trailing int32: msm (count threshold over POSITIVE-weight slots).
    """

    def __init__(self, fields, parts, live, t_rare: int = FUSED_T_RARE,
                 n_hot_slots: int = FUSED_H):
        # parts: per field dict(doc_ids, tfs, inv_norm, dense, hot_rank)
        self.fields = tuple(fields)
        self.parts = parts
        self.device = parts[0]["doc_ids"].device
        self.live = _as_device(live, self.device, torch.bool)
        self.n_docs = int(parts[0]["inv_norm"].shape[0])
        self.t_rare = t_rare
        self.n_hot_slots = n_hot_slots

    def plan_shape(self, rows: int = BPAD):
        """Plan shape at one query-row bucket."""
        sec = 2 * self.t_rare + 2 * self.n_hot_slots
        return (rows, len(self.fields) * sec + 1)

    def pack_plans(self, plans, rows: int = BPAD) -> np.ndarray:
        """plans: per job ([F per-field (rare_tiles i64[], rare_w_signed
        f32[], hot_ranks i64[], hot_w_signed f32[])], msm int)."""
        T, H = self.t_rare, self.n_hot_slots
        F = len(self.fields)
        sec = 2 * T + 2 * H
        out = np.empty(self.plan_shape(rows), np.int32)
        out[:] = -1
        for f in range(F):
            base = f * sec
            out[:, base + T : base + 2 * T] = 0
            out[:, base + 2 * T + H : base + sec] = 0
        out[:, F * sec] = 0
        fout = out.view(np.float32)
        for j, (field_plans, msm) in enumerate(plans):
            for f, (rt, rw, hr, hw) in enumerate(field_plans):
                base = f * sec
                nt, nh = len(rt), len(hr)
                out[j, base : base + nt] = rt
                fout[j, base + T : base + T + nt] = rw
                out[j, base + 2 * T : base + 2 * T + nh] = hr
                fout[j, base + 2 * T + H : base + 2 * T + H + nh] = hw
            out[j, F * sec] = msm
        return out

    def search_async(self, plans, k: int, combine: str, tie: float,
                     live=None, rows: int = BPAD):
        """Launches the query phase WITHOUT waiting (see
        FusedScorer.search_async): returns (device_out, k). `live`
        optionally overrides the live-docs mask (cached filter bitsets
        ride here); `rows` is the launch's query-row bucket."""
        k = min(k, self.n_docs)
        packed = self.pack_plans(plans, rows=rows)
        out = _fused_query_mf(
            tuple(p["doc_ids"] for p in self.parts),
            tuple(p["tfs"] for p in self.parts),
            tuple(p["inv_norm"] for p in self.parts),
            tuple(p["dense"] for p in self.parts),
            _as_device(live, self.device, torch.bool) if live is not None else self.live,
            upload(packed, self.device),
            float(np.float32(tie)),
            t_rare=self.t_rare,
            n_hot=self.n_hot_slots,
            k=k,
            combine=combine,
        )
        return out, k

    decode_result = staticmethod(FusedScorer.decode_result)
    device_result = staticmethod(FusedScorer.device_result)

    def search(self, plans, k: int, combine: str, tie: float, live=None,
               rows: int = BPAD):
        return self.decode_result(
            self.search_async(plans, k, combine, tie, live=live, rows=rows)
        )


def _fused_query_mf(doc_ids_f, tfs_f, inv_norm_f, dense_f, live, plan, tie,
                    t_rare, n_hot, k, combine):
    F = len(doc_ids_f)
    n = inv_norm_f[0].shape[0]
    T, H = t_rare, n_hot
    sec = 2 * T + 2 * H
    B = plan.shape[0]
    dev = plan.device
    msm = plan[:, F * sec]
    cnt = torch.zeros(B, n + 1, dtype=torch.int32, device=dev)
    accs = []
    for f in range(F):
        base = f * sec
        rare_ti = plan[:, base : base + T]
        rare_tw = plan[:, base + T : base + 2 * T].view(torch.float32)
        hot_ids = plan[:, base + 2 * T : base + 2 * T + H]
        hot_w = plan[:, base + 2 * T + H : base + sec].view(torch.float32)
        doc_ids, tfs, inv_norm, dense = doc_ids_f[f], tfs_f[f], inv_norm_f[f], dense_f[f]
        # rare terms: tile gather + scatter-add; |w| scores, w > 0 counts
        tile_ok = rare_ti >= 0
        ti = rare_ti.clamp(0, doc_ids.shape[0] - 1).long()
        rows_d = doc_ids[ti]  # [B,T,128]
        rows_t = tfs[ti]
        valid = (rows_d >= 0) & tile_ok[:, :, None]
        tgt = torch.where(valid, rows_d, n).int()
        inv = inv_norm[rows_d.clamp(0, n - 1).long()]
        w = rare_tw.abs()[:, :, None]
        s = w - w / (1.0 + rows_t.to(torch.float32) * inv)
        s = torch.where(valid, s, 0.0)
        acc = torch.zeros(B, n + 1, dtype=torch.float32, device=dev)
        counted = valid & (rare_tw > 0)[:, :, None]
        ordered_scatter_add(acc, tgt, s, cnt, counted.to(torch.int32))
        acc = acc[:, :n]
        # hot terms: dense rows
        if dense is not None and dense.shape[0] > 0:
            for h in range(H):
                hid = hot_ids[:, h]
                ok = hid >= 0
                row_tf = dense[hid.clamp(0, dense.shape[0] - 1).long()].to(torch.float32)
                wa = torch.where(ok, hot_w[:, h].abs(), 0.0)[:, None]
                contrib = wa - wa / (1.0 + row_tf * inv_norm[None, :])
                match = (row_tf > 0) & ok[:, None]
                acc = acc + torch.where(match, contrib, 0.0)
                counted_h = match & (hot_w[:, h] > 0)[:, None]
                cnt[:, :n] += counted_h.to(torch.int32)
        accs.append(acc)
    cnt = cnt[:, :n]
    if F == 1:
        combined = accs[0]
    elif combine == "sum":
        combined = accs[0]
        for a in accs[1:]:
            combined = combined + a
    else:  # max_tie (DisjunctionMaxQuery)
        stack = torch.stack(accs)
        best = stack.amax(dim=0)
        combined = best + tie * (stack.sum(dim=0) - best)
    mask = cnt >= torch.clamp(msm, min=1)[:, None]
    if live is not None:
        mask = mask & live[None, :]
    masked = torch.where(mask, combined, -torch.inf)
    top_s, top_d = topk_desc(masked, k)
    totals = mask.sum(dim=1, dtype=torch.int32)
    return torch.cat(
        [top_s.view(torch.int32), top_d.to(torch.int32), totals[:, None]],
        dim=1,
    )


# ---------------------------------------------------------------------------
# Device-side cross-segment top-k merge: per-segment candidate buffers
# stay on the device and one selection picks the group-wide winners, so
# a group costs ONE packed download whatever its segment count.
#
# Ordering parity with the host merge (score desc, (segment, doc) asc):
# slots are concatenated (segment asc, per-segment rank asc) and
# topk_desc keeps the LOWEST slot among equal scores; per-segment ranks
# already break equal scores doc-asc, so the merged order is identical to
# the host sort — selection only, scores untouched → float-exact.
# ---------------------------------------------------------------------------


def _merge_segments(s_list, d_list, t_list, seg_of_slot, k):
    scores = torch.cat(s_list, dim=1)  # [B, total_slots]
    docs = torch.cat(d_list, dim=1)
    s, idx = topk_desc(scores, k)
    seg = seg_of_slot[idx]
    doc = torch.gather(docs.to(torch.int32), 1, idx)
    totals = torch.stack([t.to(torch.int32) for t in t_list], dim=1)
    return torch.cat([s.view(torch.int32), seg, doc, totals], dim=1)


def merge_segment_topk(items, k: int):
    """items: [(si, scores f32[B,ki], docs i32[B,ki], totals i32[B])]
    device triples in ascending segment order. Returns host arrays
    (scores f32[B,k], segments i32[B,k], docs i32[B,k], totals
    i64[B, n_segments]) via ONE selection and ONE device→host transfer.
    Rows are ordered score desc / (segment, doc) asc; -inf entries pad
    past the real candidates."""
    widths = [int(s.shape[1]) for _, s, _, _ in items]
    k = min(k, sum(widths))
    device = items[0][1].device
    seg_of_slot = upload(
        np.repeat(np.asarray([si for si, *_ in items], np.int32), widths), device
    )
    (out,) = download(
        _merge_segments(
            tuple(s for _, s, _, _ in items),
            tuple(d for _, _, d, _ in items),
            tuple(t for _, _, _, t in items),
            seg_of_slot,
            k=k,
        ),
        site="merge_topk",
    )
    scores = out[:, :k].copy().view(np.float32)
    segs = out[:, k : 2 * k]
    docs = out[:, 2 * k : 3 * k]
    totals = out[:, 3 * k :].astype(np.int64)
    return scores, segs, docs, totals


def _knn_merge_segments(s_list, d_list, seg_of_slot, nc_cat, k):
    scores = torch.cat(s_list, dim=1)  # [B, total_slots]
    docs = torch.cat(d_list, dim=1)
    # per-(job, segment) num_candidates rank cut, applied on the device:
    # a slot survives when its within-segment rank is below the job's
    # candidate budget for that segment AND it scored a real candidate
    valid = torch.isfinite(scores) & nc_cat
    masked = torch.where(valid, scores, -torch.inf)
    s, idx = topk_desc(masked, k)
    seg = seg_of_slot[idx]
    doc = torch.gather(docs.to(torch.int32), 1, idx)
    counts = valid.sum(dim=1, dtype=torch.int32)
    return torch.cat([s.view(torch.int32), seg, doc, counts[:, None]], dim=1)


def knn_merge_segment_topk(items, nc_rows: np.ndarray, k: int):
    """kNN variant of merge_segment_topk. items: [(si, scores f32[B,ki],
    docs i32[B,ki])] device pairs (segment asc); nc_rows: host int32
    [B, n_segments] per-(job, segment) num_candidates cut (the
    coordinator's per-segment candidate budget). Returns (scores,
    segments, docs, counts i64[B]) — counts is the number of surviving
    candidates across segments (before the final k cut), in ONE
    device→host transfer."""
    widths = [int(s.shape[1]) for _, s, _ in items]
    k = min(k, sum(widths))
    device = items[0][1].device
    seg_of_slot = upload(
        np.repeat(np.asarray([si for si, *_ in items], np.int32), widths), device
    )
    rank_of_slot = np.concatenate([np.arange(w, dtype=np.int32) for w in widths])
    # bool [B, total_slots]: slot rank < that (job, segment)'s budget
    nc_cat = upload(
        rank_of_slot[None, :] < np.repeat(nc_rows.astype(np.int32), widths, axis=1),
        device,
    )
    (out,) = download(
        _knn_merge_segments(
            tuple(s for _, s, _ in items),
            tuple(d for _, _, d in items),
            seg_of_slot,
            nc_cat,
            k=k,
        ),
        site="knn_merge_topk",
    )
    scores = out[:, :k].copy().view(np.float32)
    segs = out[:, k : 2 * k]
    docs = out[:, 2 * k : 3 * k]
    counts = out[:, 3 * k].astype(np.int64)
    return scores, segs, docs, counts


# ---------------- kNN ----------------
#
# The f32 matmul is a plain product that the reference left to XLA; here
# it is `torch.matmul`. On a CUDA device it runs in full float32 as long
# as `torch.backends.cuda.matmul.allow_tf32` stays False (PyTorch's
# default); a caller that enables TF32 gets ~3 significant digits.


def knn_scores(
    queries: torch.Tensor,  # float32[B, d]
    vectors: torch.Tensor,  # float32[N, d] (unit-normalized for cosine)
    similarity: str,
) -> torch.Tensor:
    """Dense [B, N] similarity scores: one matmul + the Lucene
    VectorSimilarityFunction transform (see models/similarity.py)."""
    vectors = vectors.to(torch.float32)
    if similarity == "l2_norm":
        # ||q - v||² = |q|² + |v|² - 2 q·v — matmul-friendly
        dots = queries @ vectors.T
        q2 = torch.sum(queries * queries, dim=1, keepdim=True)
        v2 = torch.sum(vectors * vectors, dim=1)[None, :]
        d2 = torch.clamp(q2 + v2 - 2.0 * dots, min=0.0)
        scores = 1.0 / (1.0 + d2)
    else:
        if similarity == "cosine":
            qn = torch.linalg.norm(queries, dim=1, keepdim=True)
            queries = queries / torch.where(qn == 0, 1.0, qn)
        dots = queries @ vectors.T
        if similarity in ("cosine", "dot_product"):
            scores = (1.0 + dots) / 2.0
        elif similarity == "max_inner_product":
            scores = torch.where(dots < 0, 1.0 / (1.0 - dots), dots + 1.0)
        else:
            raise ValueError(f"unknown similarity [{similarity}]")
    return scores.to(torch.float32)


def knn_topk_batch(
    queries: torch.Tensor,  # float32[BPAD, d] (padded rows are zeros)
    valid: torch.Tensor,  # bool[BPAD] real rows
    vectors: torch.Tensor,  # float32[N, d]
    exists: torch.Tensor,  # bool[N]
    similarity: str,
    k: int,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Batched brute-force kNN: one matmul scores BPAD queries against a
    whole segment; returns (scores[B,k], docs[B,k], totals[B])."""
    scores = knn_scores(queries, vectors, similarity)
    mask = exists[None, :] & valid[:, None]
    masked = torch.where(mask, scores, -torch.inf)
    s, d = topk_desc(masked, k)
    totals = mask.sum(dim=1, dtype=torch.int32)
    return s, d, totals


def knn_topk(
    queries: torch.Tensor,  # float32[B, d]
    vectors: torch.Tensor,  # float32[N, d] (unit-normalized for cosine)
    exists: torch.Tensor,  # bool[N]
    similarity: str,
    k: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Brute-force kNN: one matmul + top-k per query batch."""
    scores = knn_scores(queries, vectors, similarity)
    scores = torch.where(exists[None, :], scores, -torch.inf)
    return topk_desc(scores, k)
