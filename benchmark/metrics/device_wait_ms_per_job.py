"""Executor: the time workers spent blocked in downloads, waiting for
the card, per search job: Δ`pipeline.host_stall_ms` / Δ
`thread_pool.search.completed` over the window (the sum of the
`device.wait` spans)."""

from _trace import per_job


def read(ctx):
    return per_job(ctx, "pipeline.host_stall_ms")
