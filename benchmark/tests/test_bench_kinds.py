"""What a configuration's kind (`kinds/<kind>.py`) and a mix's body
(`bodies/<body>.py`) make, held to digests recorded before the code
moved out of the harness's branches: the corpus, the port's `Segment`,
the index's settings and mapping, the first request bodies, and the
readings of the check and of the control, for each configuration cut to
a test's size, at two seeds. `golden_kinds.json` holds the digests."""

import hashlib
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from benchmark.control import control_readings
from benchmark.harness import corpus, spec, system
from benchmark.harness.traffic import QueryMaker
from benchmark.tests.conftest import ROOT

GOLDEN = json.loads((Path(__file__).parent / "golden_kinds.json").read_text())
# each configuration at test_bench_generators.py's sizes, with its mix
CONFIGS = {
    "msmarco-passage-bm25": ({"passages": 3000, "assumed": {"vocab": 500}}, "bm25-match-c1"),
    "nq-openai-1536-exact": ({"rows": 2000, "dims": 24, "assumed": {"centres": 16}}, "knn-c1"),
}
SEEDS = (5, 2**31 + 77)
BODIES = 64
PAGES = 12
CONTROL_QUERIES = 24


def small(name: str):
    """(configuration, mix) of `name`, cut to a test's size."""
    over, mix = CONFIGS[name]
    cfg = json.loads((ROOT / "benchmark/configs" / f"{name}.json").read_text())
    cfg = {**cfg, **over, "assumed": {**cfg["assumed"], **over.get("assumed", {})}}
    tr = json.loads((ROOT / "benchmark/traffic" / f"{mix}.json").read_text())
    return cfg, tr


def _feed(h, x) -> None:
    if isinstance(x, torch.Tensor):
        x = x.cpu().numpy()
    if isinstance(x, np.ndarray):
        x = np.ascontiguousarray(x)
        h.update(f"a{x.dtype.str}{x.shape}".encode())
        h.update(x.reshape(-1).view(np.uint8))
    elif isinstance(x, dict):
        h.update(f"d{len(x)}".encode())
        for k in sorted(x):
            _feed(h, k)
            _feed(h, x[k])
    elif isinstance(x, (list, tuple)):
        h.update(f"l{len(x)}".encode())
        for v in x:
            _feed(h, v)
    elif hasattr(x, "__dict__"):
        h.update(type(x).__name__.encode())
        _feed(h, vars(x))
    else:
        h.update(repr((type(x).__name__, x)).encode())


def digest(x) -> str:
    """SHA-256 of tensors, arrays, objects' fields, dicts, lists and
    scalars, with their types, dtypes and shapes."""
    h = hashlib.sha256()
    _feed(h, x)
    return h.hexdigest()


def requests(tr: dict, n: int) -> list:
    """(client, i) of a run's first `n` requests."""
    clients = int(tr["clients"])
    return [(j % clients, j // clients) for j in range(n)]


def fixed_pages(tr: dict, n_docs: int) -> list:
    """Window-like records whose pages are fixed docs and scores (mostly
    wrong: every branch of the judge reads something)."""
    size, out = int(tr["size"]), []
    for j, (c, i) in enumerate(requests(tr, PAGES)):
        hits = [[str((37 * j + 11 * r) % n_docs), 1.0 / (1 + r + j)] for r in range(size - j % 2)]
        total = [[5 * j, "eq"], [5 * j, "gte"], 5 * j][j % 3]
        out.append((c, i, 0.0, 0.0, True, {"hits": hits, "total": total}))
    return out


def digests(name: str, seed: int) -> dict:
    cfg, tr = small(name)
    corp = corpus.make(cfg, seed, "cpu")
    ctx = corpus.client_context(cfg, corp)
    seg = system.segment(cfg, corp)
    maker = QueryMaker(tr, cfg, ctx, seed)
    judged = spec.kind(cfg).judge(cfg, corpus.make(cfg, seed, "cpu"), maker,
                                  fixed_pages(tr, seg.num_docs), int(tr["size"]))
    return {
        "corpus": digest(corp),
        "client_context": digest(ctx),
        "segment": digest(seg),
        "index": digest(system.index_body(cfg)),
        "bodies": digest([maker.body(c, i) for c, i in requests(tr, BODIES)]),
        "judge": digest(judged),
        "control": digest(control_readings(cfg, tr, seed, CONTROL_QUERIES, "cpu")),
    }


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("name", list(CONFIGS))
def test_the_move_keeps_every_input_and_reading(name, seed):
    got = digests(name, seed)
    want = GOLDEN["digests"][name][str(seed)]
    assert got == want, {k: v for k, v in got.items() if want.get(k) != v}
