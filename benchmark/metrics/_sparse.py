"""What the readers of the sparse family's counters share: differences
over the window of `_nodes/stats` counters, per sparse scoring."""

from _common import node_get


def per_search(ctx, num: str, extra_den: str = None):
    """Δ`num` / Δ`sparse.searches` (+ Δ`extra_den`) over the window; None
    where a counter is missing, as in a program without it, or nothing
    was scored."""
    pair = ctx.get("stats")
    if not pair:
        return None
    a, b = pair
    try:
        d = lambda path: float(node_get(b, path)) - float(node_get(a, path))  # noqa: E731
        den = d("sparse.searches") + (d(extra_den) if extra_den else 0.0)
        val = d(num)
    except (KeyError, TypeError):
        return None
    return val / den if den > 0 else None
