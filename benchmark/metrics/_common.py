"""What the per-layer readers share: counters read as differences over
the window, the table that maps device kernels to families, and the
card's published peaks for roofline arithmetic.

A reader's `ctx` (built by run.py's traced run):
  * `stats`: (`_nodes/stats` node entry at the window's start, at its end);
  * `host`: {"cpu_s", "requests"}: the server process's CPU time over the
    unprofiled part of the window and the requests that completed there;
  * `traces`: `GET /_internal/traces` at the end of that part;
  * `slice`: {"events": [(name, kind, start_us, end_us)], "lo", "hi",
    "requests", "stats": (at its start, at its end)}: the profiled slice;
  * `config`, `traffic`: the cell's files.
"""

from __future__ import annotations

import re

# NVIDIA H100 SXM, NVIDIA's data sheet, dense, at 700 W
PEAK_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "tf32": 495e12, "bfloat16": 989e12, "float16": 989e12}

# kernel name -> family; the first pattern that matches wins
FAMILIES = (
    ("scatter_add", re.compile(r"\b(chunk_kernel|apply_kernel|row_kernel)\b")),
    ("gemm", re.compile(r"gemm|gemv|Gemm|Gemv|GEMM|cutlass|xmma|cublas", re.I)),
    ("topk", re.compile(r"topk|top_k|radix|sort|bitonic|kthvalue", re.I)),
)


def family(name: str, kind: str) -> str:
    if kind != "kernel":
        return "copies"
    for fam, pat in FAMILIES:
        if pat.search(name):
            return fam
    return "other"


def device_s(sl: dict, fam: str) -> float:
    """Seconds of device time of one family inside the slice."""
    lo, hi = sl["lo"], sl["hi"]
    t = 0.0
    for name, kind, a, b in sl["events"]:
        if family(name, kind) == fam:
            t += max(0.0, min(b, hi) - max(a, lo))
    return t * 1e-6


def node_get(node: dict, path: str):
    for k in path.split("."):
        node = node[k]
    return node


def delta(pair, path: str) -> float:
    a, b = pair
    return float(node_get(b, path)) - float(node_get(a, path))


def ratio(pair, num: str, den: str):
    if not pair:
        return None
    d = delta(pair, den)
    return delta(pair, num) / d if d > 0 else None


def busy_s(events, lo: float, hi: float) -> float:
    """Seconds of the union of the device intervals inside [lo, hi]."""
    t, end = 0.0, lo
    for _n, _k, a, b in sorted(events, key=lambda e: e[2]):
        a, b = max(a, lo, end), min(b, hi)
        if b > a:
            t += b - a
            end = b
    return t * 1e-6
