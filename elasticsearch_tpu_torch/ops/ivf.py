"""IVF (inverted-file) clustered ANN in PyTorch: seeded k-means built on
the device, and the probed search.

Counterpart of `elasticsearch_tpu/ops/ivf.py` (the JAX package), after
FAISS's IndexIVFFlat layout:

* **Build** (per segment, when the executor of a generation is built):
  a fixed number of Lloyd steps (assign → per-cluster sums → divide)
  from a seeded host init, no convergence check, then oversized
  clusters split in two on the host. The final assignment induces a
  CLUSTER-MAJOR permutation of the vector block (and of its int8 twin):
  each cluster's vectors are contiguous rows, so probing a cluster reads
  contiguous rows.
* **Search**: score the queries against the centroids (one small
  matmul), take the top-`nprobe` clusters, gather those clusters' rows
  from the permuted block, score them with the similarity transform of
  the exact path (ops/scoring.knn_scores) and take the top-k of the
  gathered candidates. Query rows go QCHUNK at a time, so the gathered
  [QCHUNK, nprobe·cmax, d] block bounds peak memory whatever the
  launch's row bucket.

Two things differ from the reference, both for the card:

* The per-cluster sums of a Lloyd step are one-hot products over fixed
  row chunks, added chunk by chunk in order. A scatter-add
  (`index_add_`, the reference's `.at[].add`) adds with float atomics
  on CUDA in an order that changes from run to run; this order does not,
  so a build from one seed is bit-identical run to run.
* The assignment runs ASSIGN_ROWS rows at a time: the [N, nlist] score
  block of a 1M-row segment would be 8 GB. A row's argmin does not
  depend on the chunking.

Top-k selections are ops/scoring.topk_desc, exact in `lax.top_k`'s
order: among tied scores the lowest index wins, which for the probe is
the lowest cluster-major SLOT (duplicate vectors tie exactly), and for
the centroid scan the lowest cluster id.

The exact brute-force path stays the oracle; the executor and the
batcher take it for small segments, a device-memory degrade or an
injected `ann.probe` fault.
"""

from __future__ import annotations

import time
from typing import Optional, Tuple

import numpy as np
import torch

from .scoring import topk_desc, upload

# queries scored per step: bounds the gathered candidate block
# ([QCHUNK, nprobe*cmax, d] floats) independently of the row bucket
QCHUNK = 8
# fixed Lloyd iteration count (no convergence check → deterministic)
KMEANS_ITERS = 8
# rows per assignment / per-cluster-sum chunk: a fixed function of N, so
# every product has the same shapes from run to run
ASSIGN_ROWS = 32768


# ---------------------------------------------------------------------------
# k-means build (device Lloyd iterations, seeded + deterministic)
# ---------------------------------------------------------------------------


def _assign(vecs: torch.Tensor, cents: torch.Tensor) -> torch.Tensor:
    """int64 [N]: the nearest centroid (squared L2) of every row, the
    lowest cluster id on a tie (torch.argmin's rule, as jnp.argmin's)."""
    # argmin_c |v|² - 2 v·c + |c|² == argmin_c |c|² - 2 v·c
    c2 = torch.sum(cents * cents, dim=1)[None, :]
    out = torch.empty(vecs.shape[0], dtype=torch.int64, device=vecs.device)
    for r0 in range(0, vecs.shape[0], ASSIGN_ROWS):
        dots = vecs[r0 : r0 + ASSIGN_ROWS] @ cents.T
        out[r0 : r0 + ASSIGN_ROWS] = torch.argmin(c2 - 2.0 * dots, dim=1)
    return out


def _lloyd_step(vecs: torch.Tensor, cents: torch.Tensor) -> torch.Tensor:
    """One Lloyd iteration: squared-L2 assignment + per-cluster mean.
    Empty clusters keep their previous centroid (deterministic, no
    re-seeding). The sums are one-hot products over ASSIGN_ROWS-row
    chunks, added in chunk order: no atomics, one order every run."""
    nlist = cents.shape[0]
    assign = _assign(vecs, cents)
    sums = torch.zeros_like(cents)
    ids = torch.arange(nlist, device=vecs.device)
    for r0 in range(0, vecs.shape[0], ASSIGN_ROWS):
        onehot = (assign[r0 : r0 + ASSIGN_ROWS, None] == ids[None, :]).to(vecs.dtype)
        sums += onehot.T @ vecs[r0 : r0 + ASSIGN_ROWS]
    # integer counts: their sum does not depend on the order
    counts = torch.bincount(assign, minlength=nlist).to(torch.float32)[:, None]
    return torch.where(counts > 0, sums / torch.clamp(counts, min=1.0), cents)


def _two_means(pts: np.ndarray, seed: int, iters: int = 6):
    """Deterministic host 2-means over one oversized cluster's members:
    (centroids f32[2, d], assign i32[m])."""
    m = len(pts)
    rng = np.random.default_rng(seed)
    i0, i1 = np.sort(rng.choice(m, size=2, replace=False))
    c = np.stack([pts[i0], pts[i1]]).astype(np.float32)
    a = np.zeros(m, np.int64)
    for _ in range(iters):
        d0 = ((pts - c[0]) ** 2).sum(axis=1)
        d1 = ((pts - c[1]) ** 2).sum(axis=1)
        a = (d1 < d0).astype(np.int64)
        for j in (0, 1):
            sel = a == j
            if sel.any():
                c[j] = pts[sel].mean(axis=0)
    return c, a


def kmeans(
    vectors: np.ndarray, nlist: int, seed: int, iters: int = KMEANS_ITERS,
    device="cuda",
) -> Tuple[np.ndarray, np.ndarray]:
    """(centroids f32[C, d], assign i32[N]) — seeded host init + `iters`
    Lloyd steps on `device`, then oversized clusters split in two
    (2-means) until the largest is within ~1.5x the mean. Deterministic
    across runs: host RNG init, fixed iteration counts and chunk shapes,
    size-ordered splits.

    The balancing matters as much as the clustering: the probe's cost is
    nprobe × cmax (every probed cluster pays the LARGEST cluster's
    padded width), so an imbalanced build would hand back the latency
    the probing saved. C can exceed the requested nlist by the number of
    splits (bounded at 2x)."""
    v = np.ascontiguousarray(vectors, dtype=np.float32)
    n = v.shape[0]
    nlist = max(1, min(int(nlist), n))
    rng = np.random.default_rng(seed)
    init = rng.choice(n, size=nlist, replace=False)
    init.sort()  # choice order is generator-dependent detail; sort it away
    dv = upload(v, device)  # the one upload of the vectors
    cents = dv[upload(init, device)]
    for _ in range(max(1, int(iters))):
        cents = _lloyd_step(dv, cents)
    assign = _assign(dv, cents).cpu().numpy()
    cents = cents.cpu().numpy()
    del dv
    if nlist > 1:
        cap = max(32, int(np.ceil(1.5 * n / nlist)))
        counts = np.bincount(assign, minlength=nlist).astype(np.int64)
        cent_list = list(cents)
        max_c = 2 * nlist
        while counts.max() > cap and len(cent_list) < max_c:
            c = int(counts.argmax())
            members = np.nonzero(assign == c)[0]
            sub_c, sub_a = _two_means(
                v[members], seed ^ (0x9E3779B9 + len(cent_list))
            )
            if not sub_a.any() or sub_a.all():
                break  # degenerate (duplicate points): give up splitting
            new_id = len(cent_list)
            cent_list[c] = sub_c[0]
            cent_list.append(sub_c[1])
            assign[members[sub_a == 1]] = new_id
            counts = np.bincount(
                assign, minlength=len(cent_list)
            ).astype(np.int64)
        cents = np.stack(cent_list).astype(np.float32)
    return cents, assign.astype(np.int32)


# ---------------------------------------------------------------------------
# the per-segment index: cluster-major layout + device tensors
# ---------------------------------------------------------------------------


class IvfSegmentIndex:
    """Device-resident IVF index over one segment's vector column.

    Flat cluster-major layout: `perm[slot] → original doc`, cluster c
    owns slots [starts[c], starts[c]+counts[c]); the flat arrays carry
    `cmax` rows of padding at the tail so `starts[c] + arange(cmax)`
    never reads out of bounds (padded slots are masked by the
    rank < counts test). The vector plane keeps its source dtype (f16
    rows stay f16 on the card; the probe casts each gathered chunk to
    f32). The int8 twin is the reference's symmetric per-vector
    quantization without lane padding, built on the host."""

    def __init__(
        self,
        vectors: np.ndarray,  # similarity-prepared (unit rows for cosine)
        similarity: str,
        nlist: int,
        seed: int,
        quantized: bool = False,
        device="cuda",
    ):
        t0 = time.perf_counter()
        cents, assign = kmeans(vectors, nlist, seed, device=device)
        nl = int(cents.shape[0])
        n = int(vectors.shape[0])
        counts = np.bincount(assign, minlength=nl).astype(np.int32)
        starts = np.zeros(nl, np.int32)
        np.cumsum(counts[:-1], out=starts[1:])
        perm = np.argsort(assign, kind="stable").astype(np.int32)
        pad = int(counts.max()) if n else 1
        perm_flat = np.concatenate([perm, np.zeros(pad, np.int32)])
        vecs_flat = np.concatenate(
            [vectors[perm], np.zeros((pad, vectors.shape[1]), vectors.dtype)]
        )
        v2 = None
        if similarity == "l2_norm":
            v2 = np.sum(
                vecs_flat.astype(np.float32) * vecs_flat.astype(np.float32),
                axis=1,
            ).astype(np.float32)
        qv = scales = None
        if quantized:
            # symmetric per-vector int8 — ops/int8_knn.quantize_int8's
            # scheme WITHOUT the lane padding (the probe is a gather and
            # a batched product, not the int8 kernel)
            vf32 = vecs_flat.astype(np.float32)
            maxabs = np.abs(vf32).max(axis=1)
            scales = (maxabs / 127.0).astype(np.float32)
            safe = np.where(scales == 0, 1.0, scales)
            qv = np.rint(vf32 / safe[:, None]).clip(-127, 127).astype(np.int8)
        self._lay_out(
            similarity, n, cents, starts, counts, perm_flat, vecs_flat, v2,
            qv, scales, device,
        )
        self.build_ms = (time.perf_counter() - t0) * 1000.0

    @classmethod
    def from_layout(
        cls, similarity: str, n: int, centroids, starts, counts, perm_flat,
        vecs_flat, v2_flat=None, qvecs_flat=None, scales_flat=None,
        device="cuda",
    ) -> "IvfSegmentIndex":
        """An index over a finished cluster-major layout (host arrays in
        the reference's shapes, tail padding included): the probe can
        then be held to the reference's on one shared index."""
        self = cls.__new__(cls)
        self._lay_out(
            similarity, int(n), np.asarray(centroids, np.float32),
            np.asarray(starts, np.int32), np.asarray(counts, np.int32),
            np.asarray(perm_flat, np.int32), np.asarray(vecs_flat),
            None if v2_flat is None else np.asarray(v2_flat, np.float32),
            None if qvecs_flat is None else np.asarray(qvecs_flat, np.int8),
            None if scales_flat is None else np.asarray(scales_flat, np.float32),
            device,
        )
        self.build_ms = 0.0
        return self

    def _lay_out(
        self, similarity, n, cents, starts, counts, perm_flat, vecs_flat, v2,
        qv, scales, device,
    ) -> None:
        self.similarity = similarity
        self.device = torch.device(device)
        self.n = int(n)
        self.dims = int(vecs_flat.shape[1])
        self.nlist = int(cents.shape[0])
        self.cmax = int(counts.max()) if self.n else 1

        def up(a):
            return None if a is None else upload(a, self.device)

        self.centroids = up(cents)
        self.starts = up(starts)
        self.counts = up(counts)
        self.perm = up(perm_flat)
        self.vecs_flat = up(vecs_flat)
        self.v2_flat = up(v2)
        self.qvecs_flat = up(qv)
        self.scales_flat = up(scales)
        self.nbytes = int(
            cents.nbytes
            + starts.nbytes
            + counts.nbytes
            + perm_flat.nbytes
            + vecs_flat.nbytes
            + (v2.nbytes if v2 is not None else 0)
            + (qv.nbytes if qv is not None else 0)
            + (scales.nbytes if scales is not None else 0)
        )

    @staticmethod
    def estimate_nbytes(
        n: int, dims: int, nlist: int, quantized: bool, itemsize: int = 4
    ) -> int:
        """Pre-build device-memory estimate for the ledger precheck."""
        flat = n + max(1, n // max(1, nlist)) * 2
        base = nlist * dims * 4 + nlist * 8 + flat * 4 + flat * dims * itemsize
        if quantized:
            base += flat * dims + flat * 4
        return base


def auto_nlist(n: int) -> int:
    """Default cluster count: ~2·sqrt(N) (the FAISS-guideline range),
    bounded so clusters average at least 16 vectors. Probe cost scales
    with nprobe × (N / nlist), so the larger default halves the scanned
    rows vs plain sqrt(N) at the same measured recall on clustered
    corpora."""
    return max(1, min(2 * int(round(np.sqrt(max(n, 1)))), max(1, n // 16)))


def ann_flops(n_queries: int, nlist: int, nprobe: int, cmax: int, dims: int) -> int:
    """Useful-flop estimate of one probed search: the centroid scan plus
    the gathered-candidate contraction."""
    scanned = nlist + nprobe * cmax
    return 2 * n_queries * scanned * dims


# ---------------------------------------------------------------------------
# probed search
# ---------------------------------------------------------------------------


def _similarity_transform(dots, similarity, q=None, v2=None):
    if similarity in ("cosine", "dot_product"):
        return (1.0 + dots) / 2.0
    if similarity == "max_inner_product":
        return torch.where(dots < 0, 1.0 / (1.0 - dots), dots + 1.0)
    if similarity == "l2_norm":
        q2 = torch.sum(q * q, dim=1, keepdim=True)
        d2 = torch.clamp(q2 + v2 - 2.0 * dots, min=0.0)
        return 1.0 / (1.0 + d2)
    raise ValueError(f"unknown similarity [{similarity}]")


def _probe_chunk(index, qc, clsc, vc, vecs, scales, cand_flat, k: int):
    """(scores[C, k'], docs[C, k']) of C query rows over their probed
    clusters `clsc` [C, p]: the cluster-major slot gather, the dot, the
    int8 scale, the transform, the masks, one top-k."""
    cmax = index.cmax
    C, p = clsc.shape
    P = p * cmax
    off = torch.arange(cmax, dtype=torch.int32, device=qc.device)
    slot = (index.starts[clsc][:, :, None] + off[None, None, :]).reshape(C, P).long()
    ok = (off[None, None, :] < index.counts[clsc][:, :, None]).reshape(C, P)
    docs = index.perm[slot]  # [C, P]
    vv = vecs[slot].to(torch.float32)  # [C, P, d]
    dots = torch.bmm(vv, qc[:, :, None])[:, :, 0]
    if scales is not None:
        dots = dots * scales[slot]
    v2 = index.v2_flat[slot] if index.similarity == "l2_norm" else None
    sc = _similarity_transform(dots, index.similarity, q=qc, v2=v2)
    mask = ok & vc[:, None]
    if cand_flat is not None:
        mask = mask & cand_flat[slot]
    masked = torch.where(mask, sc.to(torch.float32), -torch.inf)
    s, i = topk_desc(masked, min(k, P))
    d = docs.gather(1, i)
    return s, torch.where(torch.isfinite(s), d, 0)


def ann_topk_batch(
    index: IvfSegmentIndex,
    queries: torch.Tensor,  # f32 [B, d] on the index's device
    valid: torch.Tensor,  # bool [B]
    cand: Optional[torch.Tensor],  # bool [N] (exists ∧ live ∧ filter), or None
    nprobe: int,
    k: int,
    quantized: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(scores[B, k'], docs[B, k']) device tensors over the probed
    clusters, k' = min(k, nprobe·cmax); -inf scores (doc 0) pad short
    results. Nothing is read back: the buffers feed
    ops/scoring.knn_merge_segment_topk like knn_topk_batch's."""
    nprobe = max(1, min(int(nprobe), index.nlist))
    use_quant = quantized and index.qvecs_flat is not None
    vecs = index.qvecs_flat if use_quant else index.vecs_flat
    scales = index.scales_flat if use_quant else None
    q = queries.to(torch.float32)
    if index.similarity == "cosine":
        qn = torch.linalg.norm(q, dim=1, keepdim=True)
        q = q / torch.where(qn == 0, 1.0, qn)
    # centroid scan: transformed scores are monotonic in the raw metric,
    # so top-nprobe selection matches either way
    cdots = q @ index.centroids.T  # [B, nlist]
    if index.similarity == "l2_norm":
        c2 = torch.sum(index.centroids * index.centroids, dim=1)[None, :]
        csel = -(c2 - 2.0 * cdots)
    else:
        csel = cdots
    _, cls = topk_desc(csel, nprobe)  # [B, p]
    # the candidate mask permuted into cluster-major order once
    cand_flat = None
    if cand is not None:
        cand_flat = cand[torch.clamp(index.perm, 0, cand.shape[0] - 1).long()]
    B = q.shape[0]
    C = min(QCHUNK, B)
    if B % C == 0 and B > C:
        parts = [
            _probe_chunk(index, q[r0 : r0 + C], cls[r0 : r0 + C], valid[r0 : r0 + C],
                         vecs, scales, cand_flat, int(k))
            for r0 in range(0, B, C)
        ]
        return torch.cat([s for s, _ in parts]), torch.cat([d for _, d in parts])
    return _probe_chunk(index, q, cls, valid, vecs, scales, cand_flat, int(k))
