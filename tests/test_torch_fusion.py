"""The port's reciprocal-rank fusion (`ops/fusion.py`) against the JAX
package's on the CPU: `_fuse_ranked` through `rrf_fuse_device` and the
host oracle `rrf_fuse_host`, with ties (one leg's rank 1 against the
other's rank 1), padding, duplicate docs inside a leg, and 2 and 3
legs. Scores agree exactly (float32 sums in the same leg order); docs
agree exactly (ties break on ascending doc on every side)."""

import numpy as np
import pytest
import torch

from elasticsearch_tpu.ops import fusion as jfusion

from elasticsearch_tpu_torch.ops import fusion

torch.set_num_threads(1)


def _legs(seed, n_legs, rows, width, pool, pad=0, dup=False):
    rng = np.random.default_rng(seed)
    legs = []
    for li in range(n_legs):
        arr = np.full((rows, width), -1, np.int32)
        for r in range(rows):
            m = width - (pad if (r + li) % 2 == 0 else 0)
            arr[r, :m] = rng.choice(pool, size=m, replace=False)
            if dup and m > 3:
                arr[r, 3] = arr[r, 1]  # the same doc twice in one leg
        legs.append(arr)
    return legs


CASES = [
    # (seed, legs, rows, width, doc pool, padding, duplicates, k)
    (1, 2, 4, 10, 30, 0, False, 10),   # overlapping legs
    (2, 2, 3, 10, 1000, 0, False, 10),  # disjoint: every rank a 2-way tie
    (3, 3, 4, 8, 20, 3, False, 12),    # 3 legs, padded rows
    (4, 2, 2, 6, 15, 2, True, 20),     # duplicates, k past the union
    (5, 3, 1, 16, 40, 5, True, 5),
]


@pytest.mark.parametrize("case", CASES, ids=[f"case{i}" for i in range(len(CASES))])
def test_fuse_matches_reference_and_host(case):
    seed, n_legs, rows, width, pool, pad, dup, k = case
    legs = _legs(seed, n_legs, rows, width, np.arange(pool), pad, dup)
    ts, td = fusion.rrf_fuse_device(legs, k, 60, device="cpu")
    js, jd = jfusion.rrf_fuse_device(legs, k, 60)
    hs, hd = fusion.rrf_fuse_host(legs, k, 60)
    jhs, jhd = jfusion.rrf_fuse_host(legs, k, 60)
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    np.testing.assert_array_equal(hs, jhs)
    np.testing.assert_array_equal(hd, jhd)
    np.testing.assert_array_equal(ts.numpy(), hs)
    np.testing.assert_array_equal(td.numpy(), hd)
    assert td.dtype == torch.int32 and ts.dtype == torch.float32


def test_rank_one_ties_break_on_ascending_doc():
    """A doc ranked 1 by the first leg only and one ranked 1 by the
    second leg only both score 1/61: the lower doc id comes first."""
    legs = [np.array([[9, 3]], np.int32), np.array([[4, 7]], np.int32)]
    s, d = fusion.rrf_fuse_device(legs, 4, 60, device="cpu")
    assert d.tolist() == [[4, 9, 3, 7]]
    assert s[0, 0] == s[0, 1] == np.float32(1.0) / np.float32(61)


def test_needs_two_legs():
    with pytest.raises(ValueError):
        fusion.rrf_fuse_device([np.zeros((1, 3), np.int32)], 3, device="cpu")
