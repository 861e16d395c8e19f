"""The `vectors` kind: one `dense_vector` field of unit rows.

  * corpus: rows around seeded Gaussian centres (bench.py's `ann_knn`
    recipe: centre + noise * N(0, 1) per coordinate, then unit length),
    float32. The client processes get the centres, to draw queries
    around them.
  * segment: the port's `VectorField`; the rows are unit vectors
    already, so one array serves both of its planes.
  * check: plain exact kNN (`reference/knn.py`) in float64; the control
    takes its matmuls in TF32.

torch and the port are imported inside the functions.
"""

from __future__ import annotations

import numpy as np

from benchmark.harness.check import _page

CHUNK = 1 << 26  # elements drawn per call


def make(config: dict, seed: int, device) -> dict:
    import torch

    from benchmark.harness.corpus import generator

    a = config["assumed"]
    n, d = int(config["rows"]), int(config["dims"])
    g = generator(seed, device, 2)
    centres = torch.randn(int(a["centres"]), d, generator=g, device=device, dtype=torch.float32)
    rows = torch.empty(n, d, dtype=torch.float32, device=device)
    step = max(1, CHUNK // d)
    noise = float(a["noise"])
    for lo in range(0, n, step):
        hi = min(n, lo + step)
        pick = torch.randint(0, len(centres), (hi - lo,), generator=g, device=device)
        v = centres[pick]
        v.add_(torch.randn(hi - lo, d, generator=g, device=device, dtype=torch.float32), alpha=noise)
        v.div_(torch.linalg.vector_norm(v, dim=1, keepdim=True))
        rows[lo:hi] = v
    return {"vectors": rows, "centres": centres}


def client_context(config: dict, corpus: dict) -> dict:
    """The centres, as float32 bytes."""
    return {"centres": corpus["centres"].cpu().numpy().tobytes()}


def segment(config: dict, corpus: dict):
    from benchmark.harness.system import whole_segment
    from elasticsearch_tpu_torch.index.segment import VectorField

    rows = corpus["vectors"].cpu().numpy()
    n = rows.shape[0]
    field = VectorField(vectors=rows, exists=np.ones(n, bool), similarity=config["similarity"],
                        unit_vectors=rows)
    return whole_segment(n, vectors={config["field"]: field})


def index(config: dict) -> dict:
    return {"mappings": {"properties": {config["field"]: {
        "type": "dense_vector", "dims": int(config["dims"]), "similarity": config["similarity"]}}}}


def judge(config: dict, corpus: dict, maker, sampled: list, size: int, block: int = 64) -> dict:
    import torch

    from benchmark.reference import knn

    rows = corpus["vectors"]
    worst = {"score_err": 0.0, "hit_gap": 0.0}
    for lo in range(0, len(sampled), block):
        part = sampled[lo:lo + block]
        q = torch.from_numpy(np.stack([maker.vector(c, i) for c, i, *_ in part])).to(rows.device)
        S = knn.scores(q, rows)
        for j, (_c, _i, _t0, _t1, _ok, dig) in enumerate(part):
            _docs, vals = knn.top(S[j], size)
            vals = vals.double().cpu().numpy()
            sj = S[j]

            def score_of(d, sj=sj):
                return float(sj[d]) if 0 <= d < len(sj) else None

            e, g = _page(vals, score_of, dig["hits"], min(size, len(rows)))
            worst["score_err"] = max(worst["score_err"], e)
            worst["hit_gap"] = max(worst["hit_gap"], g)
        del S
    return worst


def control(config: dict, traffic: dict, corpus: dict, maker, n: int) -> dict:
    """The kNN matmuls in TF32 in the program's place."""
    import torch

    from benchmark.control import records
    from benchmark.reference import knn

    size, clients = int(traffic["size"]), int(traffic["clients"])
    rows = corpus["vectors"]
    q = torch.from_numpy(np.stack([maker.vector(j % clients, j // clients)
                                   for j in range(n)])).to(rows.device)
    tops = []
    for lo in range(0, n, 64):
        S = knn.scores(q[lo:lo + 64], rows, tf32=True)
        tops += [knn.top(S[j], size) for j in range(len(S))]
        del S
    recs = records(maker, n, clients, lambda c, i: (*tops[i * clients + c], size))
    return judge(config, corpus, maker, recs, size)
