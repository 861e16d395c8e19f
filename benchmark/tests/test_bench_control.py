"""The lower-precision control fails the check (at a test's size): the
reference put in the program's place in bfloat16 (BM25) or with TF32
matmuls (kNN) comes out not correct by the verdict a run applies, on
several seeds. `benchmark/control.py` runs the same at a cell's size on
the card."""

import pytest
import torch

from benchmark.control import control_readings
from benchmark.harness import check, spec
from benchmark.tests.conftest import ROOT


@pytest.mark.parametrize("seed", [1, 2**31 + 9, 77])
def test_bm25_in_bfloat16_fails_a_limit(seed):
    cell = spec.resolve(ROOT, "msmarco-passage-bm25.match.c1")
    cfg = {**cell.config, "passages": 20000,
           "assumed": {**cell.config["assumed"], "vocab": 3000}}
    got = control_readings(cfg, cell.traffic, seed, 48, "cpu")
    correct, compared = check.verdict(got, cfg["limits"])
    assert correct is False, compared


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [1, 2**31 + 9, 77])
def test_knn_with_tf32_fails_a_limit(seed):
    if not torch.cuda.is_available():
        pytest.skip("TF32 matmuls exist on the card only")
    cell = spec.resolve(ROOT, "nq-openai-1536-exact.knn.c1")
    cfg = {**cell.config, "rows": 200_000}
    got = control_readings(cfg, cell.traffic, seed, 64, "cuda")
    correct, compared = check.verdict(got, cfg["limits"])
    assert correct is False, compared
