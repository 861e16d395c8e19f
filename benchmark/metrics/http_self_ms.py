"""REST and coordinator: the HTTP layer's own time a request, the mean
over the ring's traces of the `http` span (body read to the response's
last byte written) less its `search` child: the body's read and
`json.loads`, the response's `json.dumps` and socket writes, routing."""

from _trace import mean_per_trace


def self_ms(spans):
    for s in spans:
        if s["name"] == "http":
            child = sum(c["duration_ns"] for c in spans
                        if c.get("parent_id") == s["id"] and c["name"] == "search")
            return (s["duration_ns"] - child) * 1e-6
    return None


def read(ctx):
    return mean_per_trace(ctx, self_ms)
