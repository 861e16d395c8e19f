"""Executor, the sparse impact path: the share of scorings the host
dense oracle served (an injected fault, or a column over the device
memory budget) instead of the card, Δ`sparse.fallbacks` /
Δ(`sparse.searches` + `sparse.fallbacks`) over the window: 0 where every
scoring ran on the card."""

from _sparse import per_search


def read(ctx):
    return per_search(ctx, "sparse.fallbacks", "sparse.fallbacks")
