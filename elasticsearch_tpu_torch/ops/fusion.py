"""Device-side reciprocal-rank fusion (RRF) of ranked retriever legs.

Counterpart of `elasticsearch_tpu/ops/fusion.py` (the JAX package), in
PyTorch. Reference analog: x-pack rank-rrf's
RRFQueryPhaseRankCoordinatorContext — score = Σ over legs of
1/(rank_constant + rank), exact-doc dedup, top-k. The legs' top-window
doc arrays go up in one pinned upload; the rank maps, the dedup compare
and the final top-k run on the device with one [B, k] download.

Used by the serving path (`IndexService._retriever_search` /
`rank: {rrf: ...}`) to fuse the concurrent BM25 + kNN batcher legs.

Ordering contract (matched by the host oracle `rrf_fuse_host`): fused
score desc, then ASCENDING doc id among ties. `topk_desc` keeps the
lowest index among equal scores, so candidates are laid out
doc-ascending (a stable sort) before the cut — the tie-break is exact,
not incidental. RRF ties are common: a doc ranked 1 by one leg only and
a doc ranked 1 by the other leg only both score 1/(c+1).
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

from .scoring import topk_desc, upload

_PAD_SORT_KEY = np.iinfo(np.int32).max


def _fuse_ranked(legs, rank_constant: int, k: int):
    """legs: tuple of int32[B, k_leg] ranked doc tensors (-1 = padding).
    Returns (scores f32[B, k'], docs i32[B, k'])."""
    docs = torch.cat(legs, dim=1)  # [B, sum(k_leg)] candidate union
    dev = docs.device
    fused = torch.zeros(docs.shape, dtype=torch.float32, device=dev)
    for ld in legs:
        ranks = torch.arange(1, ld.shape[1] + 1, dtype=torch.float32, device=dev)[None, :]
        contrib = torch.where(ld >= 0, 1.0 / (rank_constant + ranks), 0.0)
        # each candidate collects this leg's contribution where doc ids
        # match (exact-doc identity, no hashing)
        hit = (docs[:, :, None] == ld[:, None, :]) & (ld[:, None, :] >= 0)
        fused = fused + torch.where(hit, contrib[:, None, :], 0.0).sum(-1)
    fused = torch.where(docs >= 0, fused, -torch.inf)
    # dedup: a candidate with an earlier occurrence of the same doc is
    # dropped (its score is already fully accumulated on the first slot)
    pos = torch.arange(docs.shape[1], device=dev)
    dup = (docs[:, :, None] == docs[:, None, :]) & (pos[None, None, :] < pos[None, :, None])
    fused = torch.where(dup.any(-1), -torch.inf, fused)
    # doc-ascending layout so topk_desc's lowest-index tie-keep IS the
    # ascending-doc tie-break (pads sort last)
    order = torch.argsort(torch.where(docs >= 0, docs, _PAD_SORT_KEY), dim=1, stable=True)
    docs_sorted = docs.gather(1, order)
    fused_sorted = fused.gather(1, order)
    s, i = topk_desc(fused_sorted, min(k, fused_sorted.shape[1]))
    d = docs_sorted.gather(1, i)
    return s, torch.where(s > -torch.inf, d, -1)


def rrf_fuse_device(
    legs: Sequence, k: int, rank_constant: int = 60, device="cuda"
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fuses N ranked legs on `device`. Each leg is an int32[B, k_leg]
    host array of doc ids in rank order (-1 padding); all legs go up in
    one pinned upload. Returns device tensors (scores[B, k'], docs[B,
    k']) with k' = min(k, Σ k_leg); docs with no contribution come back
    as -1 with -inf score."""
    if len(legs) < 2:
        raise ValueError("rrf fusion needs at least two legs")
    host = [np.asarray(ld, np.int32) for ld in legs]
    widths = np.cumsum([0] + [h.shape[1] for h in host])
    dev = upload(np.concatenate(host, axis=1), device)
    parts = tuple(dev[:, widths[i] : widths[i + 1]] for i in range(len(host)))
    return _fuse_ranked(parts, int(rank_constant), int(k))


def rrf_fuse_host(
    legs: Sequence, k: int, rank_constant: int = 60
) -> Tuple[np.ndarray, np.ndarray]:
    """NumPy oracle with identical semantics (the parity reference):
    dict accumulation over legs, dedup by doc id, order by score desc
    then doc id asc, -1/-inf padding to k' = min(k, Σ k_leg)."""
    legs = [np.asarray(ld, np.int64) for ld in legs]
    B = legs[0].shape[0]
    width = min(int(k), int(sum(ld.shape[1] for ld in legs)))
    scores = np.full((B, width), -np.inf, np.float32)
    docs = np.full((B, width), -1, np.int32)
    for bi in range(B):
        fused: dict = {}
        for ld in legs:
            for rank, doc in enumerate(ld[bi], 1):
                if doc < 0:
                    continue
                doc = int(doc)
                # float32 accumulation in leg order — the device sum's
                # order, so the scores agree exactly
                fused[doc] = np.float32(
                    fused.get(doc, np.float32(0.0))
                    + np.float32(1.0) / np.float32(rank_constant + rank)
                )
        ordered = sorted(fused.items(), key=lambda kv: (-kv[1], kv[0]))[:width]
        for i, (doc, sc) in enumerate(ordered):
            docs[bi, i] = doc
            scores[bi, i] = sc
    return scores, docs
