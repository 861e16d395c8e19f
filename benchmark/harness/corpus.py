"""Corpora made on the device from the seed, in a few large calls.

The configuration's `kind` picks the generator:

  * `text`: passage lengths from a clipped log-normal, tokens from a Zipf
    law over the vocabulary. Every seed gets the same sizes (the work of
    a query is set by its terms' document frequencies): the lengths are
    the log-normal's quantiles, and term t occurs its expected number of
    times (the largest remainders rounded up); the seed permutes which
    passage gets which length and where each token falls. Returns the
    token stream (int32, passages in order) and the lengths.
  * `vectors`: rows around seeded Gaussian centres (bench.py's `ann_knn`
    recipe: centre + noise * N(0, 1) per coordinate, then unit length),
    float32.

The same seed gives the same tensors on the same device: the benchmark
makes the corpus once for the program and again for the reference.
"""

from __future__ import annotations

import math

import torch

from .traffic import norm_seed

CHUNK = 1 << 26  # elements drawn per call


def generator(seed: int, device, stream: int) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed((norm_seed(seed) * 1_000_003 + stream) % (2**63))
    return g


def text(config: dict, seed: int, device) -> dict:
    a = config["assumed"]
    n = int(config["passages"])
    vocab = int(a["vocab"])
    ln = a["length"]
    g = generator(seed, device, 1)
    sigma = float(ln["sigma"])
    mu = math.log(float(ln["mean"])) - sigma * sigma / 2
    q = (torch.arange(n, dtype=torch.float64, device=device) + 0.5) / n
    lengths = torch.exp(mu + sigma * torch.special.ndtri(q)).round_()
    lengths = lengths.clamp_(int(ln["min"]), int(ln["max"])).to(torch.int64)
    lengths = lengths[torch.randperm(n, generator=g, device=device)]
    total = int(lengths.sum())
    p = torch.arange(1, vocab + 1, dtype=torch.float64, device=device) ** -float(a["zipf_s"])
    expected = p / p.sum() * total
    counts = expected.floor().to(torch.int64)
    short = total - int(counts.sum())
    counts[torch.topk(expected - counts, short).indices] += 1
    tokens = torch.repeat_interleave(torch.arange(vocab, dtype=torch.int32, device=device), counts)
    stream = tokens[torch.randperm(total, generator=g, device=device)]
    return {"stream": stream, "lengths": lengths, "vocab": vocab}


def vectors(config: dict, seed: int, device) -> dict:
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


GENERATORS = {"text": text, "vectors": vectors}


def make(config: dict, seed: int, device) -> dict:
    return GENERATORS[config["kind"]](config, seed, device)


def client_context(config: dict, corpus: dict) -> dict:
    """What the client processes need to draw queries: the centres of a
    vector corpus, as float32 bytes."""
    if config["kind"] == "vectors":
        return {"centres": corpus["centres"].cpu().numpy().tobytes()}
    return {}
