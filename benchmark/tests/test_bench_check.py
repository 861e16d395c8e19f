"""The correctness check: its arithmetic on made-up pages, and whole runs
on the CPU at a tiny size (the harness's look for a card skipped) with
the timed path sound and broken underneath: a broken answer has to turn
`correct` false."""

import copy

import pytest
import torch

from benchmark.harness import check, spec
from benchmark.tests.conftest import ROOT

SMALL = {
    "msmarco-passage-bm25.match.c1": {
        "config": {"passages": 30000, "assumed": {"vocab": 3000, "zipf_s": 1.0,
                                                  "length": {"mean": 56, "sigma": 0.45, "min": 4,
                                                             "max": 200}}},
        "traffic": {"warmup_s": 0.5, "check_sample": 24}},
    "nq-openai-1536-exact.knn.c1": {
        "config": {"rows": 20000, "dims": 32},
        "traffic": {"warmup_s": 0.5, "check_sample": 24}},
}


def test_page_arithmetic():
    vals = [3.0, 2.0, 1.0]
    scores = {7: 3.0, 8: 2.0, 9: 1.0, 4: 0.5}
    of = scores.get
    assert check._page(vals, of, [["7", 3.0], ["8", 2.0], ["9", 1.0]], 3) == (0.0, 0.0)
    e, g = check._page(vals, of, [["7", 3.0], ["9", 1.0], ["8", 2.0]], 3)
    assert g == pytest.approx(0.5) and e == 0.0
    e, g = check._page(vals, of, [["7", 3.0 * (1 + 1e-4)], ["8", 2.0], ["9", 1.0]], 3)
    assert e == pytest.approx(1e-4) and g == 0.0
    assert check._page(vals, of, [["7", 3.0], ["8", 2.0]], 3)[1] == 1.0
    assert check._page(vals, of, [["7", 3.0], ["7", 3.0], ["9", 1.0]], 3)[1] == 1.0
    assert check._page(vals, of, [["5", 3.0], ["8", 2.0], ["9", 1.0]], 3)[1] == 1.0


def test_sample_holds_the_slowest_and_follows_the_seed():
    recs = [(c, i, float(i), float(i) + (5.0 if (c, i) == (2, 9) else 0.1), True, {})
            for c in range(4) for i in range(50)]
    a, b, other = check.sample(recs, 20, 99), check.sample(recs, 20, 99), check.sample(recs, 20, 98)
    assert a == b and a != other and len(a) == 20
    assert a[0][:2] == (2, 9)
    assert len(check.sample(recs[:5], 20, 1)) == 5


def test_compare():
    got = check.compare({"score_err": 2e-5, "hit_gap": 0.0, "extra": 9}, {"score_err": 1e-5,
                                                                          "hit_gap": 1e-5})
    assert got == [("score_err", 2e-5, 1e-5, False), ("hit_gap", 0.0, 1e-5, True)]
    limits = {"score_err": 1e-5, "failed": 0}
    assert check.verdict({"score_err": 1e-5, "failed": 0}, limits) == (
        True, [("score_err", 1e-5, 1e-5, True), ("failed", 0, 0, True)])
    assert check.verdict({"score_err": 2e-5, "failed": 0}, limits)[0] is False
    assert check.verdict({"score_err": 0.0, "failed": 1}, limits)[0] is False
    assert check.verdict({"score_err": 0.0, "failed": 0}, limits, served=False)[0] is False


def _cell(workload):
    cell = spec.resolve(ROOT, workload)
    over = SMALL[workload]
    cell.config = {**cell.config, **copy.deepcopy(over["config"])}
    cell.traffic = {**cell.traffic, **over["traffic"]}
    return cell


def _run(workload):
    from benchmark import run

    run.set_env(run.ROOT)
    return run.run_cell(_cell(workload), 2**31 + 77, 2.0, False, device="cpu",
                        log=lambda *a, **k: None)


def _score_altered(topk):
    def fault(x, k):
        v, i = topk(x, k)
        return v * (1 + 1e-3), i
    return fault


def _docs_swapped(topk):
    """The first three docs of every selection rotate, their scores
    staying where they were (a rotation, so that two selections in a
    row do not undo it)."""
    def fault(x, k):
        v, i = topk(x, k)
        if i.shape[-1] >= 3:
            i = torch.cat([i[..., 1:3], i[..., 0:1], i[..., 3:]], dim=-1)
        return v, i
    return fault


@pytest.mark.parametrize("workload", list(SMALL))
def test_a_sound_run_is_correct(workload):
    out = _run(workload)
    assert out["correct"], out["check"]
    assert out["failed"] == 0 and out["attempted"] > 0
    assert set(out["metrics"]) == {m.name for m in _cell(workload).end_to_end}
    assert list(out)[-1] == "check"


@pytest.mark.parametrize("fault", [_score_altered, _docs_swapped], ids=["score", "docs"])
@pytest.mark.parametrize("workload", list(SMALL))
def test_an_answer_altered_where_it_is_produced_is_caught(workload, fault, monkeypatch):
    from elasticsearch_tpu_torch.ops import scoring

    monkeypatch.setattr(scoring, "topk_desc", fault(scoring.topk_desc))
    out = _run(workload)
    assert not out["correct"], out["check"]
