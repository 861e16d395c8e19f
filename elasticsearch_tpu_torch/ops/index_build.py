"""Segment-build ops on the device (the streaming-ingest engine's compute
tier) in PyTorch.

Counterpart of `elasticsearch_tpu/ops/index_build.py` (the JAX package,
whose eight jitted programs these functions replace one for one). The
heavy array materialization of a segment build runs on the index's
device, so a refresh is a device pipeline instead of a host numpy pass:

  - postings tiling: the flat (term-major, doc-sorted) posting stream
    scatters into the [n_tiles, TILE] doc_id/tf planes, with the per-tile
    block-max sidecars (tile_max_tf / tile_min_norm) and the SmallFloat
    norm bytes;
  - keyword ordinals: per-doc (doc, ord) pairs dedup + sort + compact
    into the multi-value CSR on the device (a stable sort on one int64
    composite key, so the result is bit-identical to the host np path);
  - vector columns: present-row scatter into the dense [N, dims] layout
    (+ exists), and symmetric per-row int8 quantization mirroring
    models/rerank.quantize_tokens byte for byte;
  - rank_vectors CSR offsets (int cumsum);
  - sparse_vector impact planes and text BM25 impacts with their
    per-term int8 scales;
  - aggregation permutation tables: the bucket-major stable argsort +
    boundary arrays search/aggs_device.py caches per executor
    generation.

Exactness contract: every op is integer/layout work or elementwise IEEE
float work, and every float reduction is an exact max, so device-built
columns are BIT-IDENTICAL to the host `SegmentBuilder` build
(tests/test_torch_ingest.py holds every column family to it). Float
reductions that numpy associates differently (cosine unit-normalization)
stay on the host in both paths, as tokenization does.

Two things differ from the reference, both for eager PyTorch:

* Shapes are exact. The reference pads every launch to a power of two
  for XLA's jit cache and drops the out-of-range pads in the scatter; on
  CUDA an out-of-range index is a device-side assert, and eager PyTorch
  has no compile cache to bound, so every destination here is in range.
* A divide by 127 divides by a 0-d tensor on the op's device. PyTorch's
  CUDA true-divide by a host scalar multiplies by its reciprocal, which
  differs from numpy's divide in the last ulp (the reference passes 127
  as a runtime operand for the same reason).

Each function takes numpy arrays and an explicit `device`, and returns
numpy arrays; its `_timed` wall includes the upload and the download
that synchronises.
"""

from __future__ import annotations

import threading
import time
from typing import Dict

import numpy as np
import torch

from ..index.segment import INVALID_DOC, TILE
from ..utils.smallfloat import LENGTH_TABLE

# ---------------------------------------------------------------------------
# build-op observability (the `ingest.build_kernels` block)
# ---------------------------------------------------------------------------

_STATS_LOCK = threading.Lock()
KERNEL_STATS: Dict[str, dict] = {
    "kernel_ms": {},  # family -> cumulative device-build wall ms
    "launches": {},  # family -> op calls
}


def _note_kernel(family: str, ms: float) -> None:
    with _STATS_LOCK:
        km = KERNEL_STATS["kernel_ms"]
        km[family] = km.get(family, 0.0) + ms
        ln = KERNEL_STATS["launches"]
        ln[family] = ln.get(family, 0) + 1


def kernel_stats_snapshot() -> dict:
    with _STATS_LOCK:
        return {
            "kernel_ms": {
                k: round(v, 2) for k, v in KERNEL_STATS["kernel_ms"].items()
            },
            "launches": dict(KERNEL_STATS["launches"]),
        }


def reset_kernel_stats() -> None:
    with _STATS_LOCK:
        KERNEL_STATS["kernel_ms"] = {}
        KERNEL_STATS["launches"] = {}


class _timed:
    def __init__(self, family: str):
        self.family = family

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        _note_kernel(self.family, (time.perf_counter() - self.t0) * 1000.0)
        return False


def _up(host: np.ndarray, device, dtype=None) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(host, dtype=dtype)).to(device)


def _down(t: torch.Tensor) -> np.ndarray:
    return np.ascontiguousarray(t.cpu().numpy())


def _c127(device) -> torch.Tensor:
    """127 as a 0-d float32 tensor on `device` (see the module doc)."""
    return torch.tensor(127.0, dtype=torch.float32, device=device)


def _quantize_rows(x: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """clip(rint(x / scale), -127, 127) as int8, one scale per row, a zero
    scale taken as 1 (models/rerank.quantize_tokens' formulation)."""
    safe = torch.where(scales == 0, torch.ones_like(scales), scales)
    # torch.round is half-to-even, like np.rint
    return torch.clamp(torch.round(x / safe[:, None]), -127, 127).to(torch.int8)


# ---------------------------------------------------------------------------
# postings tiling + norms + block-max sidecars
# ---------------------------------------------------------------------------


def postings_tiles_device(
    tids: np.ndarray,
    docs: np.ndarray,
    tfs: np.ndarray,
    term_tile_start: np.ndarray,
    term_df: np.ndarray,
    lengths: np.ndarray,
    n_tiles: int,
    n_docs: int,
    device,
):
    """(doc_ids[n_tiles, TILE], tfs, tile_max_tf, norms[uint8 n_docs],
    tile_min_norm) from the flat posting stream. The host has already
    done the token/hash work: `tids`/`docs`/`tfs` are term-major
    doc-sorted (np.lexsort), `term_tile_start`/`term_df` are the tile
    layout plan. The device materializes the padded planes."""
    P = len(docs)
    # rank of each posting within its term → contiguous-tile destination
    flat_start = np.zeros(len(term_df), np.int64)
    if len(term_df) > 1:
        np.cumsum(term_df[:-1].astype(np.int64), out=flat_start[1:])
    rank = np.arange(P, dtype=np.int64) - flat_start[tids]
    dest = term_tile_start[tids].astype(np.int64) * TILE + rank
    n_slots = n_tiles * TILE
    with _timed("postings"):
        dest_t = _up(dest, device)
        flat_doc = torch.full((n_slots,), INVALID_DOC, dtype=torch.int32, device=device)
        flat_doc[dest_t] = _up(docs, device, np.int32)
        flat_tf = torch.zeros(n_slots, dtype=torch.int32, device=device)
        flat_tf[dest_t] = _up(tfs, device, np.int32)
        doc_ids = flat_doc.reshape(n_tiles, TILE)
        tf_tiles = flat_tf.reshape(n_tiles, TILE)
        tile_max_tf = tf_tiles.amax(dim=1)
        # SmallFloat intToByte4 via the strictly-increasing decode table
        # (the formulation of utils/smallfloat.encode_norms)
        table = _up(LENGTH_TABLE, device, np.int32)
        norms = (
            torch.searchsorted(table, _up(lengths, device, np.int32), right=True) - 1
        ).to(torch.uint8)
        valid = doc_ids >= 0
        idx = torch.clamp(doc_ids, 0, max(n_docs - 1, 0)).long()
        tile_norms = torch.where(
            valid, norms[idx].to(torch.int32), torch.full_like(doc_ids, 255)
        )
        tile_min_norm = tile_norms.amin(dim=1).to(torch.uint8)
        out = (
            _down(doc_ids),
            _down(tf_tiles),
            _down(tile_max_tf),
            _down(norms),
            _down(tile_min_norm),
        )
    return out


def estimate_postings_nbytes(P: int, n_tiles: int, n_docs: int) -> int:
    slots = n_tiles * TILE
    return int(
        P * 16  # docs/tfs (int32) + dest (int64) uploads
        + 2 * slots * 4  # doc/tf planes
        + slots * 13  # valid mask, clamped index, gathered norms
        + n_tiles * 8  # tile sidecars
        + n_docs * 5  # lengths + norms
    )


# ---------------------------------------------------------------------------
# keyword ordinals: device dedup + CSR assembly
# ---------------------------------------------------------------------------


def ordinals_device(docs: np.ndarray, ords: np.ndarray, n_docs: int, device):
    """(ords[int32 n_docs], mv_ords[int32 total], mv_offsets[int32
    n_docs+1]) from the raw per-value (doc, ord) pair stream (dups and
    arbitrary order allowed — the device dedups + sorts). The host has
    only done the string work (sorted unique term dictionary + ord id
    assignment)."""
    with _timed("ordinals"):
        d0 = _up(docs, device, np.int64)
        o0 = _up(ords, device, np.int64)
        # (doc asc, ord asc): one composite key (both are non-negative
        # int32), sorted stably like the reference's lexsort
        order = torch.sort((d0 << 31) | o0, stable=True).indices
        d = d0[order]
        o = o0[order].to(torch.int32)
        first = torch.ones_like(d, dtype=torch.bool)
        first[1:] = (d[1:] != d[:-1]) | (o[1:] != o[:-1])
        mv_ords = o[first]
        counts = torch.bincount(d[first], minlength=n_docs).to(torch.int32)
        doc_first = torch.ones_like(d, dtype=torch.bool)
        doc_first[1:] = d[1:] != d[:-1]
        ords_col = torch.full((n_docs,), -1, dtype=torch.int32, device=device)
        ords_col[d[doc_first]] = o[doc_first]
        offsets = torch.zeros(n_docs + 1, dtype=torch.int32, device=device)
        offsets[1:] = torch.cumsum(counts, 0, dtype=torch.int32)
        out = (_down(ords_col), _down(mv_ords), _down(offsets))
    return out


# ---------------------------------------------------------------------------
# vector columns: present-row scatter + symmetric int8 quantization
# ---------------------------------------------------------------------------


def scatter_rows_device(rows: np.ndarray, idx: np.ndarray, n_docs: int, device):
    """Dense [n_docs, dims] column + exists mask from the present rows
    (pure placement — bit-exact by construction)."""
    with _timed("vectors"):
        idx_t = _up(idx, device, np.int64)
        rows_t = _up(rows, device)
        mat = torch.zeros((n_docs, rows.shape[1]), dtype=rows_t.dtype, device=device)
        mat[idx_t] = rows_t
        exists = torch.zeros(n_docs, dtype=torch.bool, device=device)
        exists[idx_t] = True
        out = (_down(mat), _down(exists))
    return out


def quantize_int8_device(mat: np.ndarray, device):
    """(int8 rows, f32 per-row scales) — the device twin of
    models/rerank.quantize_tokens (same scheme as ops/ivf int8)."""
    if len(mat) == 0:
        return (
            np.zeros((0, mat.shape[1]), np.int8),
            np.zeros(0, np.float32),
        )
    with _timed("quantize"):
        vf32 = _up(mat, device, np.float32)
        scales = torch.abs(vf32).amax(dim=1) / _c127(device)
        out = (_down(_quantize_rows(vf32, scales)), _down(scales))
    return out


# ---------------------------------------------------------------------------
# rank_vectors CSR offsets
# ---------------------------------------------------------------------------


def csr_offsets_device(counts: np.ndarray, n_docs: int, device):
    """(tok_offsets[int32 n_docs+1], exists[bool n_docs]) from per-doc
    token counts — the rank_vectors flat-CSR packing plan."""
    with _timed("rank_vectors"):
        c = _up(counts[:n_docs], device, np.int32)
        offsets = torch.zeros(n_docs + 1, dtype=torch.int32, device=device)
        offsets[1:] = torch.cumsum(c, 0, dtype=torch.int32)
        out = (_down(offsets), _down(c > 0))
    return out


# ---------------------------------------------------------------------------
# sparse_vector impact planes: scatter + per-term int8 quantization
# ---------------------------------------------------------------------------


def sparse_planes_device(plan: dict, device):
    """(doc_ids, weights, qweights, scales, tile_max, tile_qmax) — the
    device materializer for one sparse_vector column, consuming the SAME
    host layout plan (index/segment.sparse_plan) as the host build. It
    only scatters, reduces with exact max, and quantizes with per-term
    symmetric scales, so every output plane is bit-identical to
    index/segment.sparse_from_plan."""
    n_tiles = int(plan["n_tiles"])
    n_slots = n_tiles * TILE
    with _timed("sparse"):
        dest = _up(plan["dest"], device, np.int64)
        flat_doc = torch.full((n_slots,), INVALID_DOC, dtype=torch.int32, device=device)
        flat_doc[dest] = _up(plan["docs"], device, np.int32)
        flat_w = torch.zeros(n_slots, dtype=torch.float32, device=device)
        flat_w[dest] = _up(plan["weights"], device, np.float32)
        doc_ids = flat_doc.reshape(n_tiles, TILE)
        w_tiles = flat_w.reshape(n_tiles, TILE)
        tile_max = w_tiles.amax(dim=1)
        # impact ordering puts every term's global max weight in its
        # FIRST tile, so the per-term quantization scale is one gather
        first = _up(plan["term_tile_start"], device, np.int64)
        scales = tile_max[first] / _c127(device)
        slot_scale = scales[_up(plan["tile_term"], device, np.int64)]
        qweights = _quantize_rows(w_tiles, slot_scale)
        tile_qmax = qweights.amax(dim=1).to(torch.float32) * slot_scale
        out = (
            _down(doc_ids),
            _down(w_tiles),
            _down(qweights),
            _down(scales),
            _down(tile_max),
            _down(tile_qmax),
        )
    return out


def estimate_sparse_nbytes(P: int, n_tiles: int, n_terms: int) -> int:
    slots = n_tiles * TILE
    return int(
        P * 16  # docs/weights (4 B) + dest (8 B) uploads
        + slots * 9  # doc/weight/qweight planes
        + n_tiles * 20  # tile sidecars + tile_term
        + n_terms * 12  # starts + scales
    )


# ---------------------------------------------------------------------------
# text-postings BM25 impact precompute (BM25S eager scoring)
# ---------------------------------------------------------------------------


def text_impacts_device(
    doc_ids: np.ndarray,
    tfs: np.ndarray,
    norms: np.ndarray,
    inv_norm_cache: np.ndarray,
    tile_term: np.ndarray,
    n_terms: int,
    n_docs: int,
    device,
):
    """(impacts[int8 n_tiles, TILE], impact_scales[f32 n_terms]) for one
    text postings column. `inv_norm_cache` is the host-computed 256-entry
    segment-local table (models/bm25.norm_inverse_cache) — shared with
    the host attach so both paths fold identical bits."""
    with _timed("impacts"):
        d = _up(doc_ids, device, np.int32)
        valid = d >= 0
        nb = _up(norms, device, np.uint8)[torch.clamp(d, 0, max(n_docs - 1, 0)).long()]
        inv = _up(inv_norm_cache, device, np.float32)[nb.long()]
        one = torch.ones((), dtype=torch.float32, device=device)
        # 1 - 1/(1 + tf*inv_norm): the tf/norm factor of the repo's one
        # BM25 contribution formula (ops/scoring.bm25_tile_contrib), as
        # separate elementwise IEEE ops — bit-identical to the host attach
        imp = one - one / (one + _up(tfs, device, np.float32) * inv)
        imp = torch.where(valid, imp, torch.zeros_like(imp))
        tile_imax = imp.amax(dim=1)
        tt = _up(tile_term, device, np.int64)
        # every term owns at least one tile, so no -inf survives
        term_max = torch.full(
            (n_terms,), float("-inf"), dtype=torch.float32, device=device
        ).scatter_reduce_(0, tt, tile_imax, "amax", include_self=False)
        scales = term_max / _c127(device)
        impacts = _quantize_rows(imp, scales[tt])
        out = (_down(impacts), _down(scales))
    return out


def estimate_impacts_nbytes(n_tiles: int, n_docs: int) -> int:
    return int(n_tiles * TILE * 22 + n_tiles * 16 + n_docs)


# ---------------------------------------------------------------------------
# aggregation permutation tables (search/aggs_device.counts_layout)
# ---------------------------------------------------------------------------


def agg_perm_tables_device(ids: np.ndarray, nb: int, device):
    """(perm[int32 n], bounds[int32 nb+1]) — the bucket-major stable
    permutation + boundary table the device agg engine caches per
    executor generation. `ids` are bucket indices in [0, nb] (the nb
    sentinel marks gated-out slots), so int32 is always exact; None is
    returned when the inputs somehow exceed int32 (the caller keeps the
    host path)."""
    n = len(ids)
    if n == 0 or nb + 1 >= 2**31 or (n and int(ids.max()) >= 2**31):
        return None
    with _timed("agg_tables"):
        ids_t = _up(ids, device, np.int32)
        # stable sort: the unique bucket-major permutation, identical to
        # np.argsort(kind="stable") by the stability contract
        sorted_ids, perm = torch.sort(ids_t, stable=True)
        bounds = torch.searchsorted(
            sorted_ids, torch.arange(nb + 1, dtype=torch.int32, device=device)
        ).to(torch.int32)
        out = (_down(perm.to(torch.int32)), _down(bounds))
    return out
