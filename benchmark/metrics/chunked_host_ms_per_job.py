"""Executor, the chunked block-max path: the host time of its stages a
job, the mean over the traces holding a `chunked.plan` of Σ
`chunked.plan` (the host tile plans), `chunked.score` (pack, upload and
launch of each scoring pass) and `chunked.survive` (the host survival
test after the threshold)."""

from _trace import mean_per_trace, total_ms

NAMES = {"chunked.plan", "chunked.score", "chunked.survive"}


def chunked_ms(spans):
    if not any(s["name"] == "chunked.plan" for s in spans):
        return None
    return total_ms(spans, NAMES)


def read(ctx):
    return mean_per_trace(ctx, chunked_ms)
