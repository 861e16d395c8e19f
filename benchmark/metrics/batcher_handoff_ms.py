"""Batcher: the two thread handoffs of a request's job, the mean per
trace of Σ `batcher.queue` (submitted → a worker dequeues it) and
`batcher.wake` (the worker sets its event → the waiting request thread
runs again)."""

from _trace import mean_per_trace, total_ms

NAMES = {"batcher.queue", "batcher.wake"}


def read(ctx):
    return mean_per_trace(ctx, lambda spans: total_ms(spans, NAMES))
