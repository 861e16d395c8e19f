"""Plain BM25 over the benchmark's token stream: Lucene's scoring, worked
out again from the raw tokens.

Lucene's BM25Similarity (k1, b) with the field length stored as one
byte (SmallFloat.intToByte4, decoded by byte4ToInt):

    idf(t)   = ln(1 + (N - df + 0.5) / (df + 0.5))
    avgdl    = total tokens / N
    score(d) = sum over query terms t in d of
               idf(t) * tf / (tf + k1 * (1 - b + b * dl(d) / avgdl))

A `match` query (operator OR) matches the docs holding any of its
terms. Ties rank by doc id, ascending. `dtype` float64 is the reference;
bfloat16 is the lower-precision control. Imports nothing of the program.
"""

from __future__ import annotations

import math

import torch


def _long_to_int4(i: int) -> int:
    n = i.bit_length()
    if n < 4:
        return i
    shift = n - 4
    return ((i >> shift) & 0x07) | ((shift + 1) << 3)


def _int4_to_long(i: int) -> int:
    bits, shift = i & 0x07, (i >> 3) - 1
    return bits if shift == -1 else (bits | 0x08) << shift


_FREE = 255 - _long_to_int4(2**31 - 1)  # bytes below this encode themselves


def byte4_to_int(b: int) -> int:
    return b if b < _FREE else _FREE + _int4_to_long(b - _FREE)


def int_to_byte4(i: int) -> int:
    return i if i < _FREE else _FREE + _long_to_int4(i - _FREE)


def decoded_lengths(lengths: torch.Tensor) -> torch.Tensor:
    """Each length as Lucene stores it: the largest byte4 value <= it."""
    table = torch.tensor([byte4_to_int(b) for b in range(256)], dtype=torch.int64,
                         device=lengths.device)
    return table[torch.searchsorted(table, lengths, right=True) - 1]


class Bm25:
    """BM25 of any query over one field of N docs."""

    def __init__(self, stream: torch.Tensor, lengths: torch.Tensor, vocab: int,
                 k1: float, b: float, dtype=torch.float64):
        dev = stream.device
        self.n = n = int(lengths.numel())
        self.dtype = dtype
        doc = torch.repeat_interleave(torch.arange(n, device=dev), lengths)
        key, tf = torch.unique(stream.to(torch.int64) * n + doc, sorted=True, return_counts=True)
        del doc
        term = key // n
        self.doc = (key % n).to(torch.int32)
        del key
        self.tf = tf.to(torch.float64)
        df = torch.bincount(term, minlength=vocab)
        self.start = (torch.cumsum(df, 0) - df).tolist()
        self.df = df.tolist()
        del term
        avgdl = float(lengths.sum()) / n
        # k1 * (1 - b + b * dl / avgdl) per doc
        self.kdl = (k1 * (1 - b + b * decoded_lengths(lengths).to(torch.float64) / avgdl)).to(dtype)

    def idf(self, t: int) -> float:
        df = self.df[t]
        return math.log(1 + (self.n - df + 0.5) / (df + 0.5))

    def scores(self, terms: list):
        """(score of every doc, which docs match)."""
        s = torch.zeros(self.n, dtype=self.dtype, device=self.doc.device)
        hit = torch.zeros(self.n, dtype=torch.bool, device=self.doc.device)
        for t in terms:
            lo, c = self.start[t], self.df[t]
            if c == 0:
                continue
            d = self.doc[lo:lo + c].long()
            tf = self.tf[lo:lo + c].to(self.dtype)
            w = torch.tensor(self.idf(t), dtype=self.dtype, device=s.device)
            # within one term a doc appears once
            s[d] += w * tf / (tf + self.kdl[d])
            hit[d] = True
        return s, hit

    def top(self, terms: list, k: int):
        """(docs, scores) of the k best matching docs, ties by doc id."""
        s, hit = self.scores(terms)
        docs = torch.nonzero(hit).flatten()
        vals = s[docs]
        order = torch.sort(vals, descending=True, stable=True).indices[:k]
        return docs[order], vals[order], int(docs.numel()), s, hit
