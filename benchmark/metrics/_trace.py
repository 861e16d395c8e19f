"""What the readers of the program's own spans and sync counters share:
the span tree of each `_search` in `ctx["traces"]` (the port's
`common/tracing.py`: an `http` root, `batcher.*`, `chunked.*` and
`device.wait` spans) and `_nodes/stats` counters per search job. Each
helper returns None where the run gives it nothing to read, as a
program without those spans or counters does."""

from __future__ import annotations

from _common import node_get


def mean_per_trace(ctx, fn):
    """Mean over the ring's traces of `fn(spans)`, leaving out the
    traces where it gives None."""
    vals = []
    for tr in ctx.get("traces") or []:
        v = fn(tr.get("spans") or [])
        if v is not None:
            vals.append(v)
    return sum(vals) / len(vals) if vals else None


def total_ms(spans, names):
    """Σ duration of the spans named in `names`, in ms (None: no such
    span)."""
    ns = [s["duration_ns"] for s in spans if s["name"] in names]
    return sum(ns) * 1e-6 if ns else None


def per_job(ctx, path: str):
    """Δ`path` over the window per search job completed (Δ
    `thread_pool.search.completed`)."""
    pair = ctx.get("stats")
    if not pair:
        return None
    a, b = pair
    try:
        num = float(node_get(b, path)) - float(node_get(a, path))
        den = float(node_get(b, "thread_pool.search.completed")) - float(
            node_get(a, "thread_pool.search.completed"))
    except (KeyError, TypeError):
        return None
    return num / den if den > 0 else None
