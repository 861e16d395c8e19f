#!/usr/bin/env python3
"""The lower-precision control of the correctness check, at a cell's own
size on the card (not run by the benchmark's runs).

    python3 benchmark/control.py --workload <name> --seed <n> [--seed <n> ...]

The plain reference is put in the program's place and computed in the
precision below the configuration's, as the configuration's kind
(`kinds/<kind>.py`'s `control`) says: for float32, BM25 in bfloat16,
the kNN matmul in TF32. Its pages for the queries a run would send (the mix's
clients, in turn) are judged by the same check as the program's, and
each number is printed beside its limit with the `correct` that a run
would report (`check.verdict`): it has to be false, or the check could
not tell a lower precision from the stated one.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def records(maker, n: int, clients: int, pages) -> list:
    """Window-like records of the first `n` requests, answered by
    `pages(client, i)` -> (docs, scores, total)."""
    out = []
    for j in range(n):
        c, i = j % clients, j // clients
        docs, vals, total = pages(c, i)
        dig = {"hits": [[str(int(d)), float(v)] for d, v in zip(docs.tolist(), vals.tolist())],
               "total": [total, "eq"]}
        out.append((c, i, 0.0, 0.0, True, dig))
    return out


def control_readings(config: dict, traffic: dict, seed: int, n: int, device,
                     bench_dir=None) -> dict:
    """The control's readings at `config`'s size for `n` requests (none
    of them failed): the kind's `control` (`kinds/<kind>.py`)."""
    from benchmark.harness import corpus, spec
    from benchmark.harness.traffic import QueryMaker

    bench_dir = bench_dir or spec.BENCH_DIR
    corp = corpus.make(config, seed, device, bench_dir)
    maker = QueryMaker(traffic, config, corpus.client_context(config, corp, bench_dir), seed,
                       bench_dir)
    readings = spec.kind(config, bench_dir).control(config, traffic, corp, maker, n)
    return {**readings, "failed": 0}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, action="append", required=True)
    ap.add_argument("--queries", type=int, default=None)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch

    from benchmark.harness import check, spec

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    cell = spec.resolve(ROOT, args.workload)
    n = args.queries or int(cell.traffic["check_sample"])
    for seed in args.seed:
        t = time.monotonic()
        got = control_readings(cell.config, cell.traffic, seed, n, "cuda", cell.bench_dir)
        correct, compared = check.verdict(got, cell.config["limits"])
        print(json.dumps({"workload": cell.name, "seed": seed, "queries": n,
                          "seconds": time.monotonic() - t, "correct": correct,
                          "check": {k: {"value": v, "limit": lim} for k, v, lim, _ in compared}}))
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
