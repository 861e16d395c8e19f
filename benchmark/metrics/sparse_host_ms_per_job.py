"""Executor, the sparse impact path: the host time of its stages a job,
the mean over the traces holding a `sparse.plan` of Σ `sparse.plan`
(the query's tile lists and the block-max plans of the group),
`sparse.score` (pack, upload and launch of each scoring pass, both
phases) and `sparse.survive` (the host survival test after the
threshold)."""

from _trace import mean_per_trace, total_ms

NAMES = {"sparse.plan", "sparse.score", "sparse.survive"}


def sparse_ms(spans):
    if not any(s["name"] == "sparse.plan" for s in spans):
        return None
    return total_ms(spans, NAMES)


def read(ctx):
    return mean_per_trace(ctx, sparse_ms)
