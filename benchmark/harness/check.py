"""Whether the timed path served the right answers.

Once the window has closed and the program's state is freed, a sample of
the requests completed in the window, drawn from the seed and holding
the slowest one, is answered again by the plain reference (`reference/`)
from the corpus made again from the seed, by the configuration's kind
(`kinds/<kind>.py`'s `judge`). Each served page is judged by what it
says:

  * `score_err`: the widest relative gap between a served hit's score
    and the reference's score of that same doc;
  * `hit_gap`: the widest relative amount by which the reference's score
    of the doc served at rank r lies below the reference's r-th best
    score (a wrong, missing or repeated doc reads 1);
  * `total_err` (where the kind reads totals): pages whose `hits.total`
    disagrees with the number of matching docs (an `eq` total must
    equal it; a `gte` one may not exceed it);
  * `failed`: requests of the window that returned an error.

Each number is compared with its limit from the configuration's
`limits`; the run is correct when it served answers and none exceeds
its limit (`verdict`, which the lower-precision control goes through
too).
"""

from __future__ import annotations

import numpy as np

from .traffic import norm_seed


def sample(records: list, n: int, seed: int) -> list:
    """Up to `n` of the window's good records, drawn from the seed, with
    the slowest among them."""
    if not records:
        return []
    rng = np.random.default_rng([norm_seed(seed), 7])
    slowest = max(range(len(records)), key=lambda j: records[j][3] - records[j][2])
    rest = [j for j in range(len(records)) if j != slowest]
    take = rng.choice(len(rest), size=min(n - 1, len(rest)), replace=False) if n > 1 else []
    return [records[slowest]] + [records[rest[j]] for j in sorted(take)]


def _page(ref_vals, score_of, hits, k_expected):
    """(score_err, hit_gap) of one served page."""
    score_err, gap = 0.0, 0.0
    if len(hits) != k_expected:
        gap = 1.0
    seen = set()
    for r, (doc_id, served) in enumerate(hits):
        try:
            d = int(doc_id)
        except (TypeError, ValueError):
            return 1.0, 1.0
        rs = score_of(d)
        if d in seen or rs is None or rs <= 0 or served is None or r >= len(ref_vals):
            gap = 1.0
            score_err = max(score_err, 1.0)
            continue
        seen.add(d)
        score_err = max(score_err, abs(float(served) - rs) / rs)
        best = float(ref_vals[r])
        gap = max(gap, max(0.0, (best - rs) / best))
    return score_err, gap


def compare(readings: dict, limits: dict) -> list:
    """[(name, reading, limit, ok)] for every limited number read."""
    out = []
    for name, limit in limits.items():
        if name in readings:
            v = readings[name]
            out.append((name, v, limit, v <= limit))
    return out


def verdict(readings: dict, limits: dict, served: bool = True):
    """(correct, compare's list): correct when answers were served and no
    number read exceeds its limit."""
    compared = compare(readings, limits)
    return bool(served) and all(c[3] for c in compared), compared
