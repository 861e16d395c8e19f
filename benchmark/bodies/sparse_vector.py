"""The `sparse_vector` body: `{"query": {"sparse_vector": {"field": <field>,
"query_vector": {<token>: <weight>, ...}}}, "size": n}`, the tokens
distinct within a query.

The work of a query is set by its tokens' document frequencies, which
are the same in every corpus (`kinds/sparse.py`'s `doc_freqs`), so every
seed gets the same set of queries in an order of its own: `shapes`
queries are drawn once from `SHAPE_SEED` (the number of tokens, `min +
Binomial(max - min, p)`; the tokens without replacement with probability
proportional to document frequency; their weights float32 from the
configuration's weight law, not truncated, since query weights are not
stored), and request g of a run (g = i * clients + client) takes query
`perm[g % shapes]` of a permutation drawn from the seed. NumPy only: the
client processes import it.
"""

from __future__ import annotations

import math

import numpy as np

from benchmark.harness.traffic import norm_seed, term_name
from benchmark.kinds.sparse import doc_freqs

# the seed of a mix's set of queries, the same for every run
SHAPE_SEED = 0


class Maker:
    def __init__(self, traffic: dict, config: dict, context: dict, seed: int):
        self.traffic = traffic
        self.config = config
        self.seed = norm_seed(seed)
        df = doc_freqs(config).astype(np.float64)
        p = df / df.sum()
        self.shapes = [self._shape(p, j) for j in range(int(traffic["shapes"]))]
        self.perm = np.random.default_rng([self.seed, 1]).permutation(len(self.shapes))
        self.clients = int(traffic["clients"])

    def _shape(self, p: np.ndarray, j: int):
        """(token ids, float32 weights) of query j."""
        t = self.traffic["query_tokens"]
        law = self.config["assumed"]["weight"]
        rng = np.random.default_rng([SHAPE_SEED, j])
        n = int(t["min"]) + int(rng.binomial(int(t["max"]) - int(t["min"]), float(t["p"])))
        ids = rng.choice(len(p), size=n, replace=False, p=p)
        z = rng.standard_normal(n)
        w = np.minimum(np.exp(math.log(float(law["median"])) + float(law["sigma"]) * z),
                       float(law["max"])).astype(np.float32)
        return [int(x) for x in ids], [float(x) for x in w]

    def terms(self, client: int, i: int):
        """(token ids, weights) of a request: what the reference scores."""
        g = int(i) * self.clients + int(client)
        return self.shapes[int(self.perm[g % len(self.shapes)])]

    def body(self, client: int, i: int) -> dict:
        ids, ws = self.terms(client, i)
        qv = {term_name(t): w for t, w in zip(ids, ws)}
        return {"query": {"sparse_vector": {"field": self.config["field"], "query_vector": qv}},
                "size": self.traffic["size"]}
