"""Device: the share of the profiled slice in which no kernel, copy or
memset ran on the card."""

from _common import busy_s


def read(ctx):
    sl = ctx.get("slice")
    if not sl or sl["hi"] <= sl["lo"]:
        return None
    return 1.0 - busy_s(sl["events"], sl["lo"], sl["hi"]) / ((sl["hi"] - sl["lo"]) * 1e-6)
