"""int8-quantized brute-force vector scoring: a CUDA kernel and its plain
PyTorch version.

Counterpart of `elasticsearch_tpu/ops/pallas_knn.py`. The Pallas TPU
kernel there (`_score_kernel`, launched by `int8_dot_scores`) becomes a
hand-written CUDA C++ kernel for Hopper, `csrc/int8_knn.cu`, built with
`nvcc` for sm_90a into `_build/` at first use and bound through
`ctypes`. The kernel runs on the tensor cores (`mma.sync`, bf16) and
still computes the f32 function: each f32 query is split exactly into
three bf16 parts (`bf16x3_split`), and int8 values and bf16 products are
exact. The source's head comment states why, and what bounds it on an
H100.

`int8_dot_scores` launches that kernel for CUDA tensors and computes the
plain version `int8_dot_scores_plain` for CPU tensors; it never moves
work between the two. Each launch adds one to `int8_dot_scores.launches`.

Quantization: symmetric per-vector int8 (scale = max|v| / 127), the
moral equivalent of Lucene's int8_hnsw confidence-interval scheme
(Lucene99ScalarQuantizedVectorsFormat) minus the percentile clipping.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Tuple

import numpy as np
import torch

from .scoring import topk_desc

LANE = 128
DOC_BLOCK = 512  # the reference pads N to its grid block; kept for layout parity

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG / "csrc" / "int8_knn.cu"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
]
K_CHUNK = 64  # the kernel pads d to whole 64-wide chunks in shared memory
QUERY_CHUNKS = (8, 16, 32)  # queries per block: the kernel's three variants
SMEM_LIMIT = 232_448  # dynamic shared memory one Hopper block may use


def quantize_int8(vectors: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Symmetric per-vector int8: returns (q[int8, N, d_pad], scales[f32, N]).

    d is padded up to a lane multiple (128) so rows tile cleanly; the
    zero padding contributes nothing to dot products.
    """
    n, d = vectors.shape
    d_pad = -(-d // LANE) * LANE
    maxabs = np.abs(vectors).max(axis=1)
    scales = (maxabs / 127.0).astype(np.float32)
    safe = np.where(scales == 0, 1.0, scales)
    q = np.rint(vectors / safe[:, None]).clip(-127, 127).astype(np.int8)
    if d_pad != d:
        q = np.pad(q, ((0, 0), (0, d_pad - d)))
    return q, scales


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(cuda_home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError(
            "nvcc not found (PATH or $CUDA_HOME/bin): the int8 kNN kernel "
            "is compiled from csrc/int8_knn.cu on the machine with the card"
        )
    return str(path)


def build() -> Tuple[Path, str]:
    """Compiles csrc/int8_knn.cu into _build/ unless a library built from
    the same source and flags is already there. Returns (library path,
    the compiler's output; empty when nothing was compiled)."""
    digest = hashlib.sha256(
        SOURCE.read_bytes() + " ".join(NVCC_FLAGS).encode()
    ).hexdigest()[:16]
    lib = BUILD_DIR / f"libint8_knn_{digest}.so"
    if lib.exists():
        return lib, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = BUILD_DIR / f".{lib.name}.{os.getpid()}.tmp"
    proc = subprocess.run(
        [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)],
        capture_output=True, text=True,
    )
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}) on {SOURCE}:\n"
            f"{proc.stdout}{proc.stderr}"
        )
    os.replace(tmp, lib)  # atomic: a concurrent builder sees old or new
    return lib, proc.stdout + proc.stderr


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    path, _ = build()
    lib = ctypes.CDLL(str(path))
    fn = lib.es_int8_dot_scores
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=None)
def _num_sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def query_smem_bytes(qb: int, d: int) -> int:
    """Shared memory of one block: three bf16 panels of qb query rows,
    d padded to whole 64-wide chunks plus 16 bytes a row."""
    d_pad = -(-d // K_CHUNK) * K_CHUNK
    return 3 * qb * (d_pad + 8) * 2


def query_chunk(B: int, d: int) -> int:
    """Queries per block: the smallest variant that holds all B queries
    if it fits the block's shared memory, else the largest that fits."""
    fits = [qb for qb in QUERY_CHUNKS if query_smem_bytes(qb, d) <= SMEM_LIMIT]
    if not fits:
        raise ValueError(f"int8_dot_scores: d={d} too wide for the kernel's query panels")
    return next((qb for qb in fits if qb >= B), fits[-1])


def bf16x3_split(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The kernel's exact split of f32 values into bf16 parts, in plain
    PyTorch: hi = bf16(x), mid = bf16(x - hi), lo = bf16(x - hi - mid),
    each rounded to nearest, with hi + mid + lo == x for finite normal
    f32 up to bf16's largest value."""
    hi = x.to(torch.bfloat16)
    r = x - hi.to(torch.float32)
    mid = r.to(torch.bfloat16)
    lo = (r - mid.to(torch.float32)).to(torch.bfloat16)
    return hi, mid, lo


def int8_dot_scores_plain(
    queries: torch.Tensor, qvecs: torch.Tensor, scales: torch.Tensor
) -> torch.Tensor:
    """The same function in plain PyTorch: f32 queries times the int8 rows
    promoted to f32, f32 accumulation, per-vector scale afterwards."""
    return (queries @ qvecs.to(torch.float32).T) * scales[None, :]


def int8_dot_scores(
    queries: torch.Tensor,  # f32 [B, d]
    qvecs: torch.Tensor,  # int8 [N, d], d % 16 == 0, d <= 4800
    scales: torch.Tensor,  # f32 [N]
) -> torch.Tensor:
    """Dequantized dot products f32 [B, N]. CUDA tensors launch the
    hand-written kernel (or raise); CPU tensors take the plain version."""
    devices = {queries.device, qvecs.device, scales.device}
    if len(devices) != 1:
        raise ValueError(f"int8_dot_scores: tensors on several devices {devices}")
    (device,) = devices
    if device.type == "cpu":
        return int8_dot_scores_plain(queries, qvecs, scales)
    if device.type != "cuda":
        raise ValueError(f"int8_dot_scores: no kernel for device {device}")
    if queries.dtype != torch.float32 or qvecs.dtype != torch.int8 or scales.dtype != torch.float32:
        raise TypeError(
            "int8_dot_scores takes f32 queries, int8 vectors and f32 scales, "
            f"got {queries.dtype}, {qvecs.dtype}, {scales.dtype}"
        )
    if queries.dim() != 2 or qvecs.dim() != 2 or scales.dim() != 1:
        raise ValueError("int8_dot_scores: queries [B,d], qvecs [N,d], scales [N]")
    B, d = queries.shape
    N, dv = qvecs.shape
    if dv != d or scales.shape[0] != N:
        raise ValueError(
            f"int8_dot_scores: shapes {tuple(queries.shape)}, "
            f"{tuple(qvecs.shape)}, {tuple(scales.shape)} disagree"
        )
    if d % 16:
        raise ValueError(f"int8_dot_scores: d={d} must be a multiple of 16")
    if not (queries.is_contiguous() and qvecs.is_contiguous() and scales.is_contiguous()):
        raise ValueError("int8_dot_scores: tensors must be contiguous")
    if qvecs.data_ptr() % 16 or queries.data_ptr() % 16:
        raise ValueError("int8_dot_scores: queries and int8 rows must be 16-byte aligned")
    qb = query_chunk(B, d)
    out = torch.empty(B, N, dtype=torch.float32, device=device)
    if B == 0 or N == 0:
        return out
    lib = _library()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = lib.es_int8_dot_scores(
            queries.data_ptr(), qvecs.data_ptr(), scales.data_ptr(),
            out.data_ptr(), B, N, d, _num_sms(torch.cuda.current_device()),
            qb, stream,
        )
    if rc != 0:
        raise RuntimeError(f"int8_dot_scores: kernel launch failed (cudaError {rc})")
    int8_dot_scores.launches += 1
    return out


int8_dot_scores.launches = 0


class QuantizedVectors:
    """Device-resident int8 corpus + the top-k search entry point."""

    def __init__(
        self, vectors: np.ndarray, similarity: str = "cosine", device="cuda"
    ):
        self.similarity = similarity
        self.device = torch.device(device)
        self.n, self.dims = vectors.shape
        mat = vectors
        if similarity == "cosine":
            norms = np.linalg.norm(mat, axis=1, keepdims=True)
            mat = (mat / np.where(norms == 0, 1.0, norms)).astype(np.float32)
        q, scales = quantize_int8(mat)
        self.n_pad = -(-self.n // DOC_BLOCK) * DOC_BLOCK
        if self.n_pad != self.n:
            q = np.pad(q, ((0, self.n_pad - self.n), (0, 0)))
            scales = np.pad(scales, (0, self.n_pad - self.n))
        self.d_pad = q.shape[1]
        self.qvecs = torch.from_numpy(q).to(self.device)
        self.scales = torch.from_numpy(scales).to(self.device)

    @classmethod
    def from_quantized(
        cls, qvecs: np.ndarray, scales: np.ndarray, n: int, dims: int,
        similarity: str, device="cuda",
    ) -> "QuantizedVectors":
        """An instance over an already-quantized corpus (int8 [n_pad,
        d_pad] rows and f32 [n_pad] scales, padding rows included)."""
        self = cls.__new__(cls)
        self.similarity = similarity
        self.device = torch.device(device)
        self.n, self.dims = int(n), int(dims)
        self.n_pad, self.d_pad = qvecs.shape
        self.qvecs = torch.from_numpy(np.array(qvecs, np.int8, order="C")).to(self.device)
        self.scales = torch.from_numpy(np.array(scales, np.float32, order="C")).to(self.device)
        return self

    def flops(self, n_queries: int) -> int:
        """Estimated useful flops of one search over this corpus (same
        convention as ops/scoring.knn_flops): the 2·B·N·d contraction
        plus the per-element dequant scale multiply. Padding rows/lanes
        are excluded."""
        return 2 * n_queries * self.n * self.dims + n_queries * self.n

    def search(
        self, queries: np.ndarray, k: int
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(scores[B,k], docs[B,k]) with the similarity score transform
        applied (models/similarity.py mapping, same as the f32 path).
        Both stay on the device: nothing is read back here."""
        q = np.asarray(queries, np.float32)
        if self.similarity == "cosine":
            qn = np.linalg.norm(q, axis=1, keepdims=True)
            q = q / np.where(qn == 0, 1.0, qn)
        if q.shape[1] != self.d_pad:
            q = np.pad(q, ((0, 0), (0, self.d_pad - q.shape[1])))
        dots = int8_dot_scores(
            torch.from_numpy(np.ascontiguousarray(q, np.float32)).to(self.device),
            self.qvecs,
            self.scales,
        )
        if self.similarity in ("cosine", "dot_product"):
            scores = (1.0 + dots) / 2.0
        elif self.similarity == "max_inner_product":
            scores = torch.where(dots < 0, 1.0 / (1.0 - dots), dots + 1.0)
        else:
            raise ValueError(
                f"unsupported similarity for int8 [{self.similarity}]"
            )
        valid = torch.arange(self.n_pad, device=self.device) < self.n
        scores = torch.where(valid[None, :], scores, -torch.inf)
        return topk_desc(scores, min(k, self.n))
