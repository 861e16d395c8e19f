"""The one general traffic generator.

A traffic mix is a JSON file of parameters under `traffic/`; this module
turns it, with the cell's configuration and the run's seed, into the
request body of any (client, request number). The client processes call
it to build what they send, and the correctness check calls it again to
know what was asked. Standard library and NumPy only: client processes
import it, and must not pay for PyTorch.

Body kinds:
  * `match`: `{"query": {"match": {<field>: "<terms>"}}, "size": n}`, the
    terms distinct within a query. The work of a match query is set by
    its terms' document frequencies, and a term's id is its Zipf rank in
    every corpus, so every seed gets the same set of queries in an order
    of its own: `shapes` queries are drawn once from `SHAPE_SEED` (the
    number of terms, `min + Binomial(max - min, p)`, each term from the
    corpus's Zipf law), and request g of a run (g = i * clients + client)
    takes query `perm[g % shapes]` of a permutation drawn from the seed.
    The corpus, and so every answer, is the seed's own.
  * `knn`: `{"knn": {"field", "query_vector", "k", "num_candidates"},
    "size": n}`, a fresh unit vector around one of the corpus's centres
    (`context["centres"]`, float32 rows) with the corpus's noise.
"""

from __future__ import annotations

import numpy as np

SEED_MOD = 2**63
# the seed of a `match` mix's set of queries, the same for every run
SHAPE_SEED = 0


def norm_seed(seed: int) -> int:
    """A non-negative seed for NumPy and torch from any whole number."""
    return int(seed) % SEED_MOD


def term_name(tid: int) -> str:
    """The term of id `tid` (zero-padded, so lexicographic order is id
    order, as the term dictionary wants)."""
    return f"w{tid:07d}"


def zipf_cdf(vocab: int, s: float) -> np.ndarray:
    """float64 CDF of P(rank r) proportional to r**-s, r = 1..vocab."""
    p = np.arange(1, vocab + 1, dtype=np.float64) ** -float(s)
    c = np.cumsum(p)
    return c / c[-1]


class QueryMaker:
    """Request bodies of one run: `body(client, i)` is the i-th request
    of client `client`, the same for the same seed in any process."""

    def __init__(self, traffic: dict, config: dict, context: dict, seed: int):
        self.traffic = traffic
        self.config = config
        self.seed = norm_seed(seed)
        self.kind = traffic["body"]
        if self.kind == "match":
            a = config["assumed"]
            self.vocab = int(a["vocab"])
            cdf = zipf_cdf(self.vocab, a["zipf_s"])
            self.shapes = [self._shape(cdf, j) for j in range(int(traffic["shapes"]))]
            self.perm = np.random.default_rng([self.seed, 1]).permutation(len(self.shapes))
            self.clients = int(traffic["clients"])
        elif self.kind == "knn":
            self.centres = np.frombuffer(context["centres"], np.float32).reshape(
                -1, config["dims"])
            self.noise = float(config["assumed"]["noise"])
        else:
            raise ValueError(f"unknown body kind {self.kind!r}")

    def _rng(self, client: int, i: int) -> np.random.Generator:
        return np.random.default_rng([self.seed, int(client), int(i)])

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
        """Distinct term ids of a `match` request."""
        g = int(i) * self.clients + int(client)
        return self.shapes[int(self.perm[g % len(self.shapes)])]

    def vector(self, client: int, i: int) -> np.ndarray:
        """The float32 unit query vector of a `knn` request."""
        rng = self._rng(client, i)
        c = int(rng.integers(0, len(self.centres)))
        v = self.centres[c] + np.float32(self.noise) * rng.standard_normal(
            self.centres.shape[1], dtype=np.float32)
        return (v / np.linalg.norm(v)).astype(np.float32)

    def body(self, client: int, i: int) -> dict:
        tr = self.traffic
        if self.kind == "match":
            text = " ".join(term_name(t) for t in self.terms(client, i))
            return {"query": {"match": {self.config["field"]: text}}, "size": tr["size"]}
        v = self.vector(client, i)
        return {"knn": {"field": self.config["field"], "query_vector": v.tolist(),
                        "k": tr["k"], "num_candidates": tr["num_candidates"]},
                "size": tr["size"]}
