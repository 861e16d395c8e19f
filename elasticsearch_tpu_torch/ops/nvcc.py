"""Builds the port's CUDA C++ sources (`csrc/*.cu`) with `nvcc` for
sm_90a into `_build/` (git-ignored) at first use, one shared library
with a plain C interface per source, loaded with `ctypes` by the op
that launches it. Nothing here runs when a module is imported."""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Mapping, Optional, Tuple

PKG = Path(__file__).resolve().parent.parent
CSRC = PKG / "csrc"
BUILD_DIR = PKG / "_build"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
]


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(cuda_home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError(
            "nvcc not found (PATH or $CUDA_HOME/bin): the port's kernels "
            f"are compiled from {CSRC.name}/ on the machine with the card"
        )
    return str(path)


def build(source: Path, defines: Optional[Mapping[str, int]] = None) -> Tuple[Path, str]:
    """Compiles `source` into _build/ unless a library built from the
    same source and flags is already there; `defines` become `-D` flags
    (the constants a wrapper shares with its kernel). Returns (library
    path, the compiler's output; empty when nothing was compiled)."""
    flags = NVCC_FLAGS + [f"-D{k}={v}" for k, v in sorted((defines or {}).items())]
    digest = hashlib.sha256(
        source.read_bytes() + " ".join(flags).encode()
    ).hexdigest()[:16]
    lib = BUILD_DIR / f"lib{source.stem}_{digest}.so"
    if lib.exists():
        return lib, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # a temp name of its own per thread: two threads of one process that
    # build the same library at once each finish their own file
    tmp = BUILD_DIR / f".{lib.name}.{os.getpid()}.{threading.get_ident()}.tmp"
    proc = subprocess.run(
        [nvcc(), *flags, "-o", str(tmp), str(source)],
        capture_output=True, text=True,
    )
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}) on {source}:\n"
            f"{proc.stdout}{proc.stderr}"
        )
    os.replace(tmp, lib)  # atomic: a concurrent builder sees old or new
    return lib, proc.stdout + proc.stderr
