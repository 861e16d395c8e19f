"""Kernel `ops/ordered_scatter.py` (`csrc/ordered_scatter.cu`): device ms
of its kernels in the profiled slice per request completed there."""

from _common import device_s


def read(ctx):
    sl = ctx.get("slice")
    if not sl or not sl["requests"]:
        return None
    t = device_s(sl, "scatter_add")
    return t * 1e3 / sl["requests"] if t > 0 else None
