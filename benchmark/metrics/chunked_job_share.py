"""Executor: the share of jobs served through the chunked block-max path
rather than the fused launch, over the window."""

from _common import ratio


def read(ctx):
    return ratio(ctx["stats"], "thread_pool.search.chunked_jobs", "thread_pool.search.completed")
