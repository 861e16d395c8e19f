"""The `knn` body: `{"knn": {"field", "query_vector", "k", "num_candidates"},
"size": n}`, a fresh unit vector around one of the corpus's centres
(`context["centres"]`, float32 rows) with the corpus's noise. NumPy
only: the client processes import it.
"""

from __future__ import annotations

import numpy as np

from benchmark.harness.traffic import norm_seed


class Maker:
    def __init__(self, traffic: dict, config: dict, context: dict, seed: int):
        self.traffic = traffic
        self.config = config
        self.seed = norm_seed(seed)
        self.centres = np.frombuffer(context["centres"], np.float32).reshape(-1, config["dims"])
        self.noise = float(config["assumed"]["noise"])

    def vector(self, client: int, i: int) -> np.ndarray:
        """The float32 unit query vector of a request."""
        rng = np.random.default_rng([self.seed, int(client), int(i)])
        c = int(rng.integers(0, len(self.centres)))
        v = self.centres[c] + np.float32(self.noise) * rng.standard_normal(
            self.centres.shape[1], dtype=np.float32)
        return (v / np.linalg.norm(v)).astype(np.float32)

    def body(self, client: int, i: int) -> dict:
        tr = self.traffic
        v = self.vector(client, i)
        return {"knn": {"field": self.config["field"], "query_vector": v.tolist(),
                        "k": tr["k"], "num_candidates": tr["num_candidates"]},
                "size": tr["size"]}
