"""Late-interaction (maxsim) rescoring, in PyTorch.

Counterpart of `elasticsearch_tpu/ops/rerank.py` (the JAX package):
second-stage reranking on the device. The fused first-stage top-k
candidates are reranked in ONE device step per group — gather each
candidate's token-embedding block from the flat per-shard
`rank_vectors` column, contract it against the query-token matrix, take
the per-query-token max (the "late interaction"), sum, blend with the
first-stage score and re-sort the rescore window — before the one
packed download.

Layout contract (executor_torch.rerank_column): token rows are flat
`[Tflat, d]` with per-doc CSR bounds `starts[doc]`/`counts[doc]`; the
flat array carries `tmax` zero rows of tail padding so
`start + arange(tmax)` never reads out of bounds. The int8 twin stores
per-token symmetric scales (`models/rerank.quantize_tokens`); the
product is `(q · float(v_int8)) · scale` in float32, the float path the
host oracle `host_maxsim_quantized` reproduces.

Ordering contract: the rescore window is re-sorted by blended score
desc with ties broken by FIRST-STAGE rank asc (ops/scoring.topk_desc
keeps the lowest index among equal bits, as `lax.top_k` does for the
reference; candidates arrive score desc, (segment, doc) asc).
Candidates past the window keep their first-stage score and order below
the window (the QueryRescorer window contract).

The reference left all of this to XLA; here it is plain PyTorch on
tensors, on whatever device the column lives on. The gathered
[B, W, tmax, d] float32 block is built once per group, not per job.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from .scoring import download, topk_desc, upload


def rerank_flops(
    n_queries: int, n_qtoks: int, window: int, tmax: int, dims: int
) -> int:
    """Useful-flop estimate of one maxsim launch (MFU accounting)."""
    return 2 * n_queries * n_qtoks * window * tmax * dims


def maxsim_candidates(
    qtoks: torch.Tensor,  # f32 [B, Qt, d]
    qvalid: torch.Tensor,  # bool [B, Qt] (padded query-token rows)
    starts: torch.Tensor,  # i32 [N] doc → first flat token row
    counts: torch.Tensor,  # i32 [N] doc → token count
    toks: torch.Tensor,  # [Tflat, d] f32, or int8 when scales given
    scales: Optional[torch.Tensor],  # f32 [Tflat] (int8 twin) or None
    docs: torch.Tensor,  # i32 [B, W] candidate doc ids (clipped >= 0)
    tmax: int,
) -> torch.Tensor:
    """Raw maxsim per candidate, f32 [B, W]; docs without tokens score
    0.0."""
    d = docs.long().clamp(0, starts.shape[0] - 1)
    st = starts[d].long()  # [B, W]
    ct = counts[d]
    off = torch.arange(tmax, dtype=torch.int64, device=docs.device)
    slot = (st[:, :, None] + off[None, None, :]).clamp(0, toks.shape[0] - 1)  # [B, W, T]
    tok_ok = off[None, None, :] < ct[:, :, None]  # [B, W, T]
    tv = toks[slot].to(torch.float32)  # [B, W, T, d]
    dots = torch.einsum("bqd,bwtd->bqwt", qtoks, tv)
    if scales is not None:
        dots = dots * scales[slot][:, None, :, :]
    dots = torch.where(tok_ok[:, None, :, :], dots, -torch.inf)
    per_q = dots.amax(dim=3)  # [B, Qt, W] max over doc tokens
    # token-less docs: every slot masked → -inf → contribute 0.0
    per_q = torch.where(torch.isfinite(per_q), per_q, 0.0)
    per_q = torch.where(qvalid[:, :, None], per_q, 0.0)
    return per_q.sum(dim=1)  # [B, W]


def blend_and_sort(
    msim: torch.Tensor,  # f32 [B, W] raw maxsim
    first: torch.Tensor,  # f32 [B, W] first-stage scores (score desc)
    valid: torch.Tensor,  # bool [B, W] real candidates
    weights: torch.Tensor,  # f32 [2] (query_weight, rescore_query_weight)
    window: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(scores [B, W], perm [B, W] int32): positions < window re-sorted
    by blended = qw·first + rw·maxsim (desc; the first-stage rank breaks
    ties); the tail keeps first-stage scores and order."""
    b, n = first.shape
    w = min(window, int(n))
    blended = weights[0] * first + weights[1] * msim
    blended = torch.where(valid, blended, -torch.inf)
    ws, wi = topk_desc(blended[:, :w], w)
    tail_idx = torch.arange(w, n, dtype=torch.int32, device=first.device)
    perm = torch.cat([wi.to(torch.int32), tail_idx[None, :].expand(b, n - w)], dim=1)
    tail = torch.where(valid[:, w:], first[:, w:], -torch.inf)
    scores = torch.cat([ws, tail], dim=1)
    return scores, perm


def maxsim_rescore_batch(
    qtoks: np.ndarray,  # f32 [B, Qt, d] (padded rows zero)
    qvalid: np.ndarray,  # bool [B, Qt]
    starts: torch.Tensor,
    counts: torch.Tensor,
    toks: torch.Tensor,
    scales: Optional[torch.Tensor],
    docs: np.ndarray,  # i32 [B, W]
    first: np.ndarray,  # f32 [B, W]
    valid: np.ndarray,  # bool [B, W]
    query_weight: float,
    rescore_query_weight: float,
    tmax: int,
    window: int,
) -> torch.Tensor:
    """Runs maxsim + blend + sort on the column's device; returns the
    DEVICE packed [B, 2W] int32 buffer (the f32 scores' bits next to the
    permutation). The inputs go up through pinned asynchronous copies,
    so nothing here waits for the device; `unpack_rescore` makes the one
    packed download at collect time."""
    dev = starts.device
    weights = np.asarray([query_weight, rescore_query_weight], np.float32)
    msim = maxsim_candidates(
        upload(np.asarray(qtoks, np.float32), dev),
        upload(np.asarray(qvalid, bool), dev),
        starts, counts, toks, scales,
        upload(np.asarray(docs, np.int32), dev),
        int(tmax),
    )
    scores, perm = blend_and_sort(
        msim,
        upload(np.asarray(first, np.float32), dev),
        upload(np.asarray(valid, bool), dev),
        upload(weights, dev),
        int(window),
    )
    return torch.cat([scores.view(torch.int32), perm], dim=1)


def unpack_rescore(packed: torch.Tensor) -> Tuple[np.ndarray, np.ndarray]:
    """The ONE packed download: (scores f32 [B, W], perm i32 [B, W])."""
    (out,) = download(packed, site="rerank")
    w = out.shape[1] // 2
    scores = out[:, :w].copy().view(np.float32)
    perm = out[:, w:]
    return scores, perm
