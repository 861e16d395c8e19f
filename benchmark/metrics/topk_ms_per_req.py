"""`ops/scoring.py` `topk_desc`: device ms of the top-k and sort kernels
in the profiled slice per request completed there."""

from _common import device_s


def read(ctx):
    sl = ctx.get("slice")
    if not sl or not sl["requests"]:
        return None
    t = device_s(sl, "topk")
    return t * 1e3 / sl["requests"] if t > 0 else None
