"""Device-side aggregation passes over the doc-value and ordinal columns
the TorchExecutor keeps resident, in PyTorch.

Counterpart of `elasticsearch_tpu/ops/agg_kernels.py` (the JAX package).
Elasticsearch runs a doc-at-a-time Collector per bucket; here a whole
agg tree costs a handful of vectorised passes. Bucket accumulators use
the SORTED segment-sum formulation: a host-precomputed bucket-major
permutation + boundary array (cached per column, query-independent)
turns per-bucket reduction into gather → cumsum → boundary difference.

Shapes and dtypes (the exactness contract — search/aggs_device.py holds
the routing predicate that enforces it):

  * bucket COUNTS are int32 cumulative sums — always exact.
  * metric SUMS are int32 cumulative sums over a host-prepared int32
    copy of the column, routed here only when the column is
    integer-valued with Σ|v| inside the int32 window, so every partial
    sum is exact in ANY association order and equals the host oracle's
    float64 sum.
  * MIN/MAX read float32 values at exact rank positions; routed only for
    f32-exact columns.

Every cumsum names `dtype=torch.int32` (a bool cumsum promotes to int64
otherwise), and every `searchsorted` operand is a contiguous sorted
int32 row.
"""

from __future__ import annotations

import torch


def _cumsum0(x: torch.Tensor) -> torch.Tensor:
    """int32 [0, cumsum(x)...] (length n + 1)."""
    return torch.cat([
        torch.zeros(1, dtype=torch.int32, device=x.device),
        torch.cumsum(x, dim=0, dtype=torch.int32),
    ])


def sorted_bucket_counts(mask, map_perm, gate_perm, bounds):
    """int32[nb] per-bucket doc/entry counts: ``map_perm`` orders slots
    bucket-major (composed with the ordinal CSR's entry→doc map for
    keyword terms), ``gate_perm`` is the pre-permuted static inclusion
    gate (field exists), ``bounds`` the int32[nb+1] bucket boundaries in
    the sorted order. Counts are boundary differences of one cumulative
    sum."""
    selp = mask[map_perm.long()] & gate_perm
    cs = _cumsum0(selp)
    b = bounds.long()
    return cs[b[1:]] - cs[b[:-1]]


def sorted_bucket_metrics(mask, map_perm, gate_perm, v_perm, iv_perm, bounds):
    """Per-bucket (count, int32 sum, min, max) — the bucket-id × metric
    segment sum of one sub-agg level, in the sorted formulation.

    The permutation orders slots by (bucket, metric value asc), so a
    bucket's min/max are its FIRST/LAST selected slots: with the
    selection cumsum ``cs``, the k-th selected slot overall sits at
    ``searchsorted(cs[1:], k)``, giving exact per-bucket extrema without
    a scatter. Sums ride the same cumsum over the exact int32 value copy
    (callers gate on the Σ|v| window)."""
    n = map_perm.shape[0]
    selp = mask[map_perm.long()] & gate_perm
    cs = _cumsum0(selp)
    csum = _cumsum0(torch.where(selp, iv_perm, 0))
    b = bounds.long()
    cnt = cs[b[1:]] - cs[b[:-1]]
    sm = csum[b[1:]] - csum[b[:-1]]
    ranks = cs[1:].contiguous()
    fi = torch.searchsorted(ranks, (cs[b[:-1]] + 1).contiguous())
    li = torch.searchsorted(ranks, cs[b[1:]].contiguous())
    v = v_perm.to(torch.float32)
    if n == 0:  # no slot at all: every bucket is empty
        v = torch.zeros(1, dtype=torch.float32, device=v.device)
    inf = torch.tensor(float("inf"), dtype=torch.float32, device=v.device)
    mn = torch.where(cnt > 0, v[fi.clamp(0, max(n - 1, 0))], inf)
    mx = torch.where(cnt > 0, v[li.clamp(0, max(n - 1, 0))], -inf)
    return cnt, sm, mn, mx


def masked_metric(sel, values, ivalues):
    """(count, int32 sum, min, max) of one metric leaf over the selected
    docs — a bucket metric with a single implicit bucket."""
    v = values.to(torch.float32)
    return (
        sel.sum(dtype=torch.int32),
        torch.where(sel, ivalues, 0).sum(dtype=torch.int32),
        torch.where(sel, v, float("inf")).min(),
        torch.where(sel, v, float("-inf")).max(),
    )


def masked_sorted(sel, values):
    """(ascending sorted selected values padded with +inf, count) — the
    sorted-quantile operand for percentiles. The host slices the first
    ``count`` entries after download."""
    v = torch.where(sel, values.to(torch.float32), float("inf"))
    return torch.sort(v).values, sel.sum(dtype=torch.int32)


def wide_range_mask(hi_w, lo_w, exists, lhi, llo, hhi, hlo):
    """Range membership over a TWO-WORD integer column: the host splits
    value − column_min into (hi, lo) = divmod(Δ, 2**24) int32 words
    (exact for |Δ| < 2**53 — any date-millis span), and each bound into
    the same words, so [lo, hi) membership is a lexicographic int32
    compare — exact where a float32 column would mis-bucket."""
    lhi, llo, hhi, hlo = (int(x) for x in (lhi, llo, hhi, hlo))
    ge = (hi_w > lhi) | ((hi_w == lhi) & (lo_w >= llo))
    lt = (hi_w < hhi) | ((hi_w == hhi) & (lo_w < hlo))
    return exists & ge & lt


def masked_total_and_max(mask, scores):
    """(match count, max score) of one segment — the size:0 response's
    total/max_score without downloading an [n_docs] mask."""
    return (
        mask.sum(dtype=torch.int32),
        torch.where(mask, scores, float("-inf")).max(),
    )


def agg_flops(n_slots: int, n_outputs: int) -> int:
    """Rough useful-work estimate for the roofline counters: every slot
    is read once per output accumulator plus the mask combine."""
    return int(n_slots) * (2 + 3 * max(int(n_outputs), 1))
