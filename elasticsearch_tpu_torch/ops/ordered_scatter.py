"""The port's float accumulator: an ordered tile scatter-add, a CUDA
kernel and its plain PyTorch version.

Every BM25 and sparse score the port serves is summed term-at-a-time
into a dense per-doc accumulator, `acc[r, tgt[r, s]] += src[r, s]`.
The JAX package does this with `.at[].add`, which on the CPU adds a
cell's contributions one after another in slot order, as the numpy
oracle's `np.add.at` does. `scatter_add_`/`index_add_` keep that order
on the CPU but add with float atomics on the card, so a doc's last ulp
(and with it the order of two docs within an ulp) changed from run to
run there. `csrc/ordered_scatter.cu`, built with `nvcc` for sm_90a into
`_build/` at first use and bound through `ctypes`, adds in slot order
on the card: the same bits as the plain version on the CPU, every run.

`ordered_scatter_add` launches that kernel for CUDA tensors and raises
if the build or the launch fails; it takes the plain version
`ordered_scatter_add_plain` only for CPU tensors. Each launch adds one
to `ordered_scatter_add.launches`.

Inputs: `acc` f32 [R, C] (or [C], one row), contiguous, whose last
column C-1 is the overflow column; `tgt` int32 [R, S] with S a multiple
of TILE_WIDTH; `src` f32 [R, S]; optionally an int32 plane `cnt`
[R, C] with its increments `inc` int32 [R, S], added in the same pass
(integer sums are exact in any order). Within each 128-slot tile the
valid targets must be distinct (a doc occurs at most once in a term's
postings); invalid slots target C-1 with +0.0 and inc 0.
"""

from __future__ import annotations

import ctypes
import functools
from pathlib import Path
from typing import Optional, Tuple

import torch

from . import nvcc

TILE_WIDTH = 128
SOURCE = nvcc.CSRC / "ordered_scatter.cu"
SMEM_LIMIT = 232_448  # dynamic shared memory one Hopper block may use
SPAN_MAX = SMEM_LIMIT // 4 - 4  # f32 cells of one block's slice
SPAN_MIN = 1024  # cells a block owns at least when ranges are split to fill the card


def build() -> Tuple[Path, str]:
    """Compiles csrc/ordered_scatter.cu into _build/ unless a library
    built from the same source and flags is already there."""
    return nvcc.build(SOURCE)


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    path, _ = build()
    lib = ctypes.CDLL(str(path))
    fn = lib.es_ordered_scatter_add
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=None)
def _num_sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def span_for(rows: int, cells: int, num_sms: int) -> int:
    """Cells of one block's range over the `cells` docs of a row (the
    overflow column excluded): the largest slice a block's shared memory
    holds, cut smaller only while rows x ranges would leave SMs idle."""
    cells = max(cells, 1)
    ranges = -(-cells // SPAN_MAX)
    if rows * ranges < num_sms:
        ranges = max(ranges, min(-(-num_sms // rows), -(-cells // SPAN_MIN)))
    return -(-cells // ranges)


def ordered_scatter_add_plain(acc, tgt, src, cnt=None, inc=None):
    """The same function in plain PyTorch: `scatter_add_` along each row,
    which on the CPU adds a cell's contributions in slot order."""
    acc2 = acc.view(1, -1) if acc.dim() == 1 else acc
    idx = tgt.reshape(acc2.shape[0], -1).long()
    acc2.scatter_add_(1, idx, src.reshape(idx.shape))
    if cnt is not None:
        cnt2 = cnt.view(1, -1) if cnt.dim() == 1 else cnt
        cnt2.scatter_add_(1, idx, inc.reshape(idx.shape))
    return acc, cnt


def ordered_scatter_add(
    acc: torch.Tensor,
    tgt: torch.Tensor,
    src: torch.Tensor,
    cnt: Optional[torch.Tensor] = None,
    inc: Optional[torch.Tensor] = None,
):
    """acc (and cnt) += src (and inc) at tgt, each cell's additions in
    slot order, in place; returns (acc, cnt). CUDA tensors launch the
    hand-written kernel (or raise); CPU tensors take the plain version."""
    if (cnt is None) != (inc is None):
        raise ValueError("ordered_scatter_add: cnt and inc go together")
    tensors = [x for x in (acc, tgt, src, cnt, inc) if x is not None]
    devices = {x.device for x in tensors}
    if len(devices) != 1:
        raise ValueError(f"ordered_scatter_add: tensors on several devices {devices}")
    (device,) = devices
    if device.type == "cpu":
        return ordered_scatter_add_plain(acc, tgt, src, cnt, inc)
    if device.type != "cuda":
        raise ValueError(f"ordered_scatter_add: no kernel for device {device}")
    if acc.dtype != torch.float32 or src.dtype != torch.float32 or tgt.dtype != torch.int32:
        raise TypeError(
            "ordered_scatter_add takes f32 acc and src and int32 targets, "
            f"got {acc.dtype}, {src.dtype}, {tgt.dtype}"
        )
    if cnt is not None and (cnt.dtype != torch.int32 or inc.dtype != torch.int32):
        raise TypeError(f"ordered_scatter_add: int32 cnt and inc, got {cnt.dtype}, {inc.dtype}")
    if acc.dim() not in (1, 2):
        raise ValueError(f"ordered_scatter_add: acc [R, C] or [C], got {tuple(acc.shape)}")
    R, C = (1, acc.shape[0]) if acc.dim() == 1 else acc.shape
    S = tgt.numel() // R if R else 0
    if tgt.numel() != R * S or src.numel() != R * S or S % TILE_WIDTH:
        raise ValueError(
            f"ordered_scatter_add: targets {tuple(tgt.shape)} and values "
            f"{tuple(src.shape)} are not {R} rows of whole {TILE_WIDTH}-slot tiles"
        )
    if cnt is not None and (cnt.shape != acc.shape or inc.numel() != R * S):
        raise ValueError(
            f"ordered_scatter_add: cnt {tuple(cnt.shape)} / inc {tuple(inc.shape)} "
            f"do not match acc {tuple(acc.shape)} / targets {tuple(tgt.shape)}"
        )
    if not all(x.is_contiguous() for x in tensors):
        raise ValueError("ordered_scatter_add: tensors must be contiguous")
    if R == 0 or C <= 1 or S == 0:
        return acc, cnt
    lib = _library()
    with torch.cuda.device(device):
        span = span_for(R, C - 1, _num_sms(torch.cuda.current_device()))
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = lib.es_ordered_scatter_add(
            acc.data_ptr(), None if cnt is None else cnt.data_ptr(),
            tgt.data_ptr(), src.data_ptr(), None if inc is None else inc.data_ptr(),
            R, C, S, span, stream,
        )
    if rc != 0:
        raise RuntimeError(f"ordered_scatter_add: kernel launch failed (cudaError {rc})")
    ordered_scatter_add.launches += 1
    return acc, cnt


ordered_scatter_add.launches = 0
