"""The `match` body: `{"query": {"match": {<field>: "<terms>"}}, "size": n}`,
the terms distinct within a query.

The work of a match query is set by its terms' document frequencies, and
a term's id is its Zipf rank in every corpus, so every seed gets the same
set of queries in an order of its own: `shapes` queries are drawn once
from `SHAPE_SEED` (the number of terms, `min + Binomial(max - min, p)`,
each term from the corpus's Zipf law), and request g of a run
(g = i * clients + client) takes query `perm[g % shapes]` of a
permutation drawn from the seed. The corpus, and so every answer, is the
seed's own. NumPy only: the client processes import it.
"""

from __future__ import annotations

import numpy as np

from benchmark.harness.traffic import norm_seed, term_name, zipf_cdf

# the seed of a mix's set of queries, the same for every run
SHAPE_SEED = 0


class Maker:
    def __init__(self, traffic: dict, config: dict, context: dict, seed: int):
        self.traffic = traffic
        self.config = config
        self.seed = norm_seed(seed)
        a = config["assumed"]
        self.vocab = int(a["vocab"])
        cdf = zipf_cdf(self.vocab, a["zipf_s"])
        self.shapes = [self._shape(cdf, j) for j in range(int(traffic["shapes"]))]
        self.perm = np.random.default_rng([self.seed, 1]).permutation(len(self.shapes))
        self.clients = int(traffic["clients"])

    def _shape(self, cdf: np.ndarray, j: int) -> list:
        """The distinct term ids (Zipf ranks) of query j."""
        t = self.traffic["query_terms"]
        rng = np.random.default_rng([SHAPE_SEED, j])
        n = int(t["min"]) + int(rng.binomial(int(t["max"]) - int(t["min"]), float(t["p"])))
        out: list = []
        while len(out) < n:
            r = min(int(np.searchsorted(cdf, rng.random(), side="right")), self.vocab - 1)
            if r not in out:
                out.append(r)
        return out

    def terms(self, client: int, i: int) -> list:
        """Distinct term ids of a request."""
        g = int(i) * self.clients + int(client)
        return self.shapes[int(self.perm[g % len(self.shapes)])]

    def body(self, client: int, i: int) -> dict:
        text = " ".join(term_name(t) for t in self.terms(client, i))
        return {"query": {"match": {self.config["field"]: text}}, "size": self.traffic["size"]}
