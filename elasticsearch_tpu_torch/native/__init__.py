"""Native (C++) runtime components, loaded via ctypes.

Reference analog: the reference's load-bearing native layer —
libs/simdvec C kernels, libzstd bindings, and Lucene's ForUtil postings
block decode (SURVEY.md §2.5). The device path is PyTorch (and the
hand-written CUDA kernel under csrc/); the HOST-side hot loops that the
reference implements natively get C++ here: the postings varint/delta
codec (on-disk form of posting tiles, decoded once at index load).

The port's copy of the JAX package's `native/`: the source is
`csrc/postings_codec.cpp` (a verbatim copy of the repo-root
`native/postings_codec.cpp`), built on demand with g++ into `_build/`
under a digest of the source and the flags; hosts without a toolchain
fall back to the NumPy/Python implementation with identical bytes
(parity-tested).
"""

from .codec import (
    native_available,
    tiles_decode,
    tiles_encode,
    vb_decode,
    vb_encode,
)

__all__ = [
    "native_available",
    "tiles_encode",
    "tiles_decode",
    "vb_encode",
    "vb_decode",
]
