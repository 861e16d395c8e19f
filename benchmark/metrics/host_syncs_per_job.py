"""Executor: the times a worker waited for the stream (a blocking
download) per search job, Δ`pipeline.host_syncs` / Δ
`thread_pool.search.completed` over the window."""

from _trace import per_job


def read(ctx):
    return per_job(ctx, "pipeline.host_syncs")
