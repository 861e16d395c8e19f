"""The one general traffic generator.

A traffic mix is a JSON file of parameters under `traffic/`; this module
turns it, with the cell's configuration and the run's seed, into the
request body of any (client, request number). The client processes call
it to build what they send, and the correctness check calls it again to
know what was asked. Standard library and NumPy only: client processes
import it, and must not pay for PyTorch.

The mix's `body` names the maker of its bodies, `bodies/<body>.py` (see
`spec.py`): its `Maker(traffic, config, context, seed)` gives
`body(client, i)`, plus what its kinds' checks read of a request.
"""

from __future__ import annotations

import numpy as np

from .spec import BENCH_DIR, body

SEED_MOD = 2**63


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


def QueryMaker(traffic: dict, config: dict, context: dict, seed: int, bench_dir=BENCH_DIR):
    """Request bodies of one run: `body(client, i)` is the i-th request
    of client `client`, the same for the same seed in any process."""
    return body(traffic, bench_dir).Maker(traffic, config, context, seed)
