"""Plain `sparse_vector` scoring over the benchmark's triples: what
Elasticsearch computes for a `sparse_vector` query with a precomputed
`query_vector`, worked out again from the (passage, token, weight)
triples the corpus was drawn as, never from the program's layout.

The query is one FeatureField linear clause a token, all SHOULD, so

    score(d) = sum over the query's tokens t held by d of q_t * w(d, t)

with w(d, t) the weight as stored (the corpus already holds the
truncated value Lucene keeps), and the docs holding any query token
match. Ties rank by doc id, ascending. `dtype` float64 is the
reference: Lucene adds its clauses' float scores in float32 in an order
of its own, and the float64 sum is the value that every order
approximates. bfloat16 (the weights, the query weights and the sums) is
the lower-precision control. No kernels, no pruning, no batching: a
term-major CSR and `index_add_`, one token at a time. Imports nothing
of the program.
"""

from __future__ import annotations

import torch


class SparseRef:
    """Scores of any query over one `sparse_vector` field of N docs,
    from term-major triples: `docs` (int32) and `weights` (float32) in
    runs of `df[t]` for token t."""

    def __init__(self, docs: torch.Tensor, weights: torch.Tensor, df: torch.Tensor, n: int,
                 dtype=torch.float64):
        self.n = int(n)
        self.dtype = dtype
        self.doc = docs
        self.w = weights
        self.df = df.tolist()
        self.start = (torch.cumsum(df, 0) - df).tolist()

    def scores(self, query):
        """(score of every doc, which docs match) of `query`, a pair
        (token ids, their weights)."""
        ids, qws = query
        s = torch.zeros(self.n, dtype=self.dtype, device=self.doc.device)
        hit = torch.zeros(self.n, dtype=torch.bool, device=self.doc.device)
        for t, q in zip(ids, qws):
            lo, c = self.start[int(t)], self.df[int(t)]
            if c == 0:
                continue
            d = self.doc[lo:lo + c].long()
            qw = torch.tensor(float(q), dtype=self.dtype, device=s.device)
            s.index_add_(0, d, self.w[lo:lo + c].to(self.dtype) * qw)
            hit[d] = True
        return s, hit

    def top(self, query, k: int):
        """(docs, scores, count, every score, the match mask) of the k
        best matching docs, ties by doc id."""
        s, hit = self.scores(query)
        docs = torch.nonzero(hit).flatten()
        vals = s[docs]
        order = torch.sort(vals, descending=True, stable=True).indices[:k]
        return docs[order], vals[order], int(docs.numel()), s, hit
