"""Corpora made on the device from the seed, in a few large calls.

The configuration's `kind` makes it: `kinds/<kind>.py`'s `make`.

The same seed gives the same tensors on the same device: the benchmark
makes the corpus once for the program and again for the reference.
"""

from __future__ import annotations

import torch

from .spec import BENCH_DIR, kind
from .traffic import norm_seed


def generator(seed: int, device, stream: int) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed((norm_seed(seed) * 1_000_003 + stream) % (2**63))
    return g


def make(config: dict, seed: int, device, bench_dir=BENCH_DIR) -> dict:
    return kind(config, bench_dir).make(config, seed, device)


def client_context(config: dict, corpus: dict, bench_dir=BENCH_DIR) -> dict:
    """What the client processes need to draw queries (picklable)."""
    return kind(config, bench_dir).client_context(config, corpus)
