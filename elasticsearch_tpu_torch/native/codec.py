"""ctypes bindings + build-on-demand for csrc/postings_codec.cpp,
with a pure-NumPy fallback of identical semantics.

The library is compiled with g++ into the port's `_build/` directory
(never beside the sources), under a name that carries a digest of the
source and the flags; each builder compiles to a temporary name and
renames it into place, so concurrent processes see the old library or
the new one, never half of one."""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional

import numpy as np

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG / "csrc" / "postings_codec.cpp"
BUILD_DIR = _PKG / "_build"
GXX_FLAGS = ["-O3", "-shared", "-fPIC"]

_LOCK = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None
_TRIED = False


def _source_path() -> str:
    return str(SOURCE)


def _lib_path() -> str:
    digest = hashlib.sha256(
        SOURCE.read_bytes() + " ".join(GXX_FLAGS).encode()
    ).hexdigest()[:16]
    return str(BUILD_DIR / f"libpostings_{digest}.so")


def build() -> str:
    """Compiles csrc/postings_codec.cpp into _build/ unless a library
    built from the same source and flags is already there; returns its
    path."""
    lib = _lib_path()
    if os.path.exists(lib):
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = os.path.join(
        str(BUILD_DIR), f".{os.path.basename(lib)}.{os.getpid()}.tmp"
    )
    try:
        subprocess.run(
            ["g++", *GXX_FLAGS, _source_path(), "-o", tmp],
            check=True,
            capture_output=True,
            timeout=120,
        )
        os.replace(tmp, lib)  # atomic: a concurrent builder sees old or new
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return lib


def _load() -> Optional[ctypes.CDLL]:
    global _LIB, _TRIED
    if _LIB is not None or _TRIED:
        return _LIB
    with _LOCK:
        if _LIB is not None or _TRIED:
            return _LIB
        _TRIED = True
        try:
            if not SOURCE.exists():
                return None
            dll = ctypes.CDLL(build())
            for name, argtypes in (
                ("vb_encode", [ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p]),
                ("vb_decode", [ctypes.c_void_p, ctypes.c_int64,
                               ctypes.c_void_p, ctypes.c_int64]),
                ("tiles_encode", [ctypes.c_void_p, ctypes.c_int64,
                                  ctypes.c_int64, ctypes.c_void_p]),
                ("tiles_decode", [ctypes.c_void_p, ctypes.c_int64,
                                  ctypes.c_void_p, ctypes.c_int64,
                                  ctypes.c_int64]),
            ):
                fn = getattr(dll, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int64
            _LIB = dll
        except (OSError, subprocess.SubprocessError):
            _LIB = None
        return _LIB


def native_available() -> bool:
    return _load() is not None


# ---------------------------------------------------------------------------
# zigzag varints (LEB128)
# ---------------------------------------------------------------------------


def _zz_enc(v: np.ndarray) -> np.ndarray:
    return ((v.astype(np.int64) << 1) ^ (v.astype(np.int64) >> 31)).astype(
        np.uint64
    )


def _py_vb_encode(vals: np.ndarray) -> bytes:
    out = bytearray()
    for u in _zz_enc(vals.astype(np.int32)):
        u = int(u)
        while u >= 0x80:
            out.append((u & 0x7F) | 0x80)
            u >>= 7
        out.append(u)
    return bytes(out)


def _py_vb_decode(data: bytes, n: int) -> np.ndarray:
    out = np.empty(n, np.int32)
    p = 0
    ln = len(data)
    for i in range(n):
        u = 0
        shift = 0
        while True:
            if p >= ln or shift > 28:
                raise ValueError("corrupt varint stream")
            b = data[p]
            p += 1
            u |= (b & 0x7F) << shift
            if not b & 0x80:
                break
            shift += 7
        out[i] = np.int32((u >> 1) ^ -(u & 1))
    return out


def vb_encode(vals: np.ndarray) -> bytes:
    vals = np.ascontiguousarray(vals, np.int32)
    lib = _load()
    if lib is None:
        return _py_vb_encode(vals)
    out = np.empty(len(vals) * 5, np.uint8)
    n = lib.vb_encode(
        vals.ctypes.data, len(vals), out.ctypes.data
    )
    return out[:n].tobytes()


def vb_decode(data: bytes, n: int) -> np.ndarray:
    lib = _load()
    if lib is None:
        return _py_vb_decode(data, n)
    buf = np.frombuffer(data, np.uint8)
    out = np.empty(n, np.int32)
    used = lib.vb_decode(buf.ctypes.data, len(buf), out.ctypes.data, n)
    if used < 0:
        raise ValueError("corrupt varint stream")
    return out


# ---------------------------------------------------------------------------
# tile delta codec (doc-id rows: absolute first value, ascending deltas,
# -1 padding kept absolute)
# ---------------------------------------------------------------------------


def _py_tiles_encode(tiles: np.ndarray) -> bytes:
    out = bytearray()
    for row in tiles:
        prev = 0
        first = True
        for v in row.tolist():
            if v < 0:
                enc = -1
            elif first:
                enc = v
                prev = v
                first = False
            else:
                if v < prev:
                    # an unsorted row must fail LOUDLY: its negative
                    # delta would alias the -1 padding sentinel and
                    # round-trip silently corrupted
                    raise ValueError(
                        "tiles_encode: doc ids not ascending within row"
                    )
                enc = v - prev
                prev = v
            u = ((enc << 1) ^ (enc >> 31)) & 0xFFFFFFFF
            while u >= 0x80:
                out.append((u & 0x7F) | 0x80)
                u >>= 7
            out.append(u)
    return bytes(out)


def _py_tiles_decode(data: bytes, n_tiles: int, width: int) -> np.ndarray:
    out = np.empty((n_tiles, width), np.int32)
    p = 0
    ln = len(data)
    for t in range(n_tiles):
        prev = 0
        first = True
        for i in range(width):
            u = 0
            shift = 0
            while True:
                if p >= ln or shift > 28:
                    raise ValueError("corrupt tile stream")
                b = data[p]
                p += 1
                u |= (b & 0x7F) << shift
                if not b & 0x80:
                    break
                shift += 7
            v = int(np.int32((u >> 1) ^ -(u & 1)))
            if v == -1:
                out[t, i] = -1
            elif first:
                out[t, i] = v
                prev = v
                first = False
            else:
                prev += v
                out[t, i] = prev
    return out


def tiles_encode(tiles: np.ndarray) -> bytes:
    tiles = np.ascontiguousarray(tiles, np.int32)
    lib = _load()
    if lib is None:
        return _py_tiles_encode(tiles)
    n_tiles, width = tiles.shape
    out = np.empty(tiles.size * 5, np.uint8)
    n = lib.tiles_encode(
        tiles.ctypes.data, n_tiles, width, out.ctypes.data
    )
    if n < 0:
        raise ValueError("tiles_encode: doc ids not ascending within row")
    return out[:n].tobytes()


def tiles_decode(data: bytes, n_tiles: int, width: int) -> np.ndarray:
    lib = _load()
    if lib is None:
        return _py_tiles_decode(data, n_tiles, width)
    buf = np.frombuffer(data, np.uint8)
    out = np.empty((n_tiles, width), np.int32)
    used = lib.tiles_decode(
        buf.ctypes.data, len(buf), out.ctypes.data, n_tiles, width
    )
    if used < 0:
        raise ValueError("corrupt tile stream")
    return out
