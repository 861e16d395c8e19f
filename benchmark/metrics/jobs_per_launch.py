"""Batcher: jobs per launch over the window, from `_nodes/stats`
`thread_pool.search` (`completed` counts jobs). Read in the kNN cells
only, where every job is one launch of one group: a chunked BM25 job
takes several launches, so there the ratio would move with the
executor's route and not with the batching."""

from _common import ratio


def read(ctx):
    return ratio(ctx["stats"], "thread_pool.search.completed", "thread_pool.search.launches")
