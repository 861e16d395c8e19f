"""Executor, the sparse impact path: launches of the scoring passes
(`ImpactScorer.score_pass`, one `ordered_scatter_add` a chunk of 512
tiles, both phases) per job, Δ`thread_pool.search.sparse_launches` /
Δ`sparse.searches` over the window."""

from _sparse import per_search


def read(ctx):
    return per_search(ctx, "thread_pool.search.sparse_launches")
