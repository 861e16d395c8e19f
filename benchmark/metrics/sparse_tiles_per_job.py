"""Executor, the sparse impact path: impact tiles scored (after block-max
pruning) per job, Δ`sparse.tiles_scored` / Δ`sparse.searches` over the
window."""

from _sparse import per_search


def read(ctx):
    return per_search(ctx, "sparse.tiles_scored")
