"""Plain exact kNN by cosine over the benchmark's raw vectors.

Elasticsearch's cosine score is (1 + cos(q, v)) / 2. The reference
normalises the raw rows and queries again and takes every dot product
in float64, in blocks of rows so that it fits beside nothing else.
`tf32=True` is the lower-precision control: float32 rows and queries
with TF32 tensor-core matmuls, as a later change might be tempted to
run them. Ties rank by doc id, ascending. Imports nothing of the
program.
"""

from __future__ import annotations

import torch

ROW_BLOCK = 1 << 18
QUERY_BLOCK = 64


def _scores_block(q: torch.Tensor, rows: torch.Tensor, tf32: bool) -> torch.Tensor:
    if tf32:
        prev = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = True
        try:
            r = rows / torch.linalg.vector_norm(rows, dim=1, keepdim=True)
            return (1 + q @ r.T) / 2
        finally:
            torch.backends.cuda.matmul.allow_tf32 = prev
    r = rows.to(torch.float64)
    r /= torch.linalg.vector_norm(r, dim=1, keepdim=True)
    return (1 + q @ r.T) / 2


def scores(queries: torch.Tensor, rows: torch.Tensor, tf32: bool = False) -> torch.Tensor:
    """[m, N] cosine scores of `queries` against every row."""
    dtype = torch.float32 if tf32 else torch.float64
    q = queries.to(dtype)
    q = q / torch.linalg.vector_norm(q, dim=1, keepdim=True)
    out = torch.empty(len(q), len(rows), dtype=dtype, device=rows.device)
    for lo in range(0, len(rows), ROW_BLOCK):
        out[:, lo:lo + ROW_BLOCK] = _scores_block(q, rows[lo:lo + ROW_BLOCK], tf32)
    return out


def top(s: torch.Tensor, k: int):
    """(docs, scores) of one query's k best rows, ties by doc id."""
    # the k-th best value, then every row at or above it in doc order
    kth = torch.topk(s, k).values[-1]
    docs = torch.nonzero(s >= kth).flatten()
    order = torch.sort(s[docs], descending=True, stable=True).indices[:k]
    return docs[order], s[docs[order]]
