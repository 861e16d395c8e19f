"""Kernel `ops/ordered_scatter.py` (`csrc/ordered_scatter.cu`) on the
sparse impact path: device ms of its kernels (`_common.device_s`'s
`scatter_add` family) in the profiled slice per request completed
there, read as `scatter_add_ms_per_req` reads it in the BM25 cell."""

from scatter_add_ms_per_req import read  # noqa: F401
