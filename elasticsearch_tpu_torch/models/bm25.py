"""Lucene-parity BM25 scoring model.

Parity target: org.apache.lucene.search.similarities.BM25Similarity (the
default similarity wired by ES's SimilarityService, k1=1.2 b=0.75), in its
modern (Lucene 8+) form:

  idf(t)        = ln(1 + (docCount - df + 0.5) / (df + 0.5))
  avgdl         = sumTotalTermFreq / docCount
  cache[b256]   = 1 / (k1 * ((1 - b) + b * LENGTH_TABLE[b256] / avgdl))
  score(f, nb)  = w - w / (1 + f * cache[nb]),   w = boost * idf
                (algebraically w * f / (f + k1*(1-b+b*dl/avgdl)); the
                 (k1+1) numerator factor was removed in Lucene 8)

Document length is the SmallFloat byte4-quantized field length (nb), so
scores here are bit-comparable in structure to the reference. All math is
float32 to match Java float arithmetic.
"""

from __future__ import annotations

import numpy as np

from ..utils.smallfloat import LENGTH_TABLE

DEFAULT_K1 = 1.2
DEFAULT_B = 0.75


def idf(doc_count: int, doc_freq: int) -> float:
    """BM25Similarity.idfExplain; float32 result like Java."""
    return np.float32(
        np.log(1.0 + (doc_count - doc_freq + 0.5) / (doc_freq + 0.5))
    )


def avg_field_length(sum_total_term_freq: int, doc_count: int) -> float:
    if doc_count == 0:
        return 1.0
    return np.float32(sum_total_term_freq / float(doc_count))


def norm_inverse_cache(avgdl: float, k1: float = DEFAULT_K1, b: float = DEFAULT_B) -> np.ndarray:
    """The 256-entry 1/(k1*(1-b+b*dl/avgdl)) cache, float32[256]."""
    table = LENGTH_TABLE.astype(np.float32)
    return (
        1.0 / (np.float32(k1) * ((1.0 - np.float32(b)) + np.float32(b) * table / np.float32(avgdl)))
    ).astype(np.float32)


def score_freqs(
    freqs: np.ndarray,
    norm_bytes: np.ndarray,
    weight: float,
    cache: np.ndarray,
) -> np.ndarray:
    """score = w - w / (1 + freq * cache[norm]) elementwise, float32."""
    w = np.float32(weight)
    inv = cache[norm_bytes.astype(np.int64)]
    return (w - w / (np.float32(1.0) + freqs.astype(np.float32) * inv)).astype(
        np.float32
    )
