"""REST and coordinator layer: the server process's CPU time per request
over the unprofiled part of the window (every thread of the process:
HTTP, coordinator, batcher)."""


def read(ctx):
    h = ctx.get("host")
    if not h or not h["requests"]:
        return None
    return h["cpu_s"] * 1e3 / h["requests"]
