"""BENCHMARK.json against the benchmark's contract, and the harness
finding every cell, configuration, traffic mix and metric by name."""

import json
import re
import shutil

import pytest

from benchmark.harness import spec
from benchmark.tests.conftest import ROOT

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
LINE = re.compile(r"^[^\n\t]{1,200}$")
WIDTH = re.compile(r"(_dim|_rank)$|hidden|intermediate|latent|state|projection|head|expansion|experts_per")


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert 1 <= len(BENCH["command"]) <= 32 and all(LINE.match(w) for w in BENCH["command"])
    assert 1 <= len(BENCH["paths"]) <= 16
    for p in BENCH["paths"]:
        assert re.match(r"^[A-Za-z0-9_.\-/]{1,200}$", p) and not p.startswith("/") and ".." not in p
        assert not p.endswith("_torch")
    assert isinstance(BENCH["run_seconds"], int) and 1 <= BENCH["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_check_fits_its_limit():
    n = len(BENCH["workloads"])
    per_run = BENCH["run_seconds"] + 60
    # the check's whole cost with the full 24 cells must fit
    assert 2 + 14 * 24 <= 10**6 and (2 + 14 * 24) * per_run + 24 * 2 * 90 + 1200 <= 43200
    assert 1 <= n <= 24


def test_names_units_and_lines():
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [e["name"] for e in BENCH[group]]
        assert len(set(names)) == len(names)
        assert all(NAME.match(x) for x in names)
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert LINE.match(c["source"]) and LINE.match(c["why"]) and len(c["reduced"]) <= 16
        assert all(NAME.match(k) and not WIDTH.search(k) for k in c["reduced"])
        assert c["file"].startswith("benchmark/") and (ROOT / c["file"]).is_file()
    files = [c["file"] for c in BENCH["configs"]]
    assert len(set(files)) == len(files)


def test_cells():
    configs = {c["name"] for c in BENCH["configs"]}
    pairs = set()
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["config"] in configs and NAME.match(w["traffic"]) and LINE.match(w["why"])
        assert w["chips"] in (1, 4)
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == configs
    assert sum(w["chips"] == 4 for w in BENCH["workloads"]) <= max(1, len(BENCH["workloads"]) // 4)


def test_metrics():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in e2e.values():
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    cells = {w["name"] for w in BENCH["workloads"]}
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert m["moves"] in e2e and LINE.match(m["layer"])
        assert set(m.get("workloads", cells)) <= cells
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"
    for w in cells:
        layer = [m for m in BENCH["per_layer"] if w in m.get("workloads", cells)]
        assert layer, f"{w} reports no per-layer metric"


@pytest.mark.parametrize("workload", [w["name"] for w in BENCH["workloads"]])
def test_every_cell_resolves(workload):
    cell = spec.resolve(ROOT, workload)
    assert {m.name for m in cell.end_to_end} == {"qps", "p50_ms", "setup_s"}
    assert cell.per_layer and all(callable(m.reader) for m in cell.per_layer)
    assert cell.config["kind"] in ("text", "vectors") and cell.traffic["clients"] >= 1
    assert set(cell.config["limits"]) >= {"score_err", "hit_gap", "failed"}


def test_added_files_are_found_without_an_edit(tmp_path):
    """A later cell, mix and metric are new files plus new entries."""
    root = tmp_path / "repo"
    shutil.copytree(ROOT / "benchmark", root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cfg = json.loads((ROOT / "benchmark/configs/nq-openai-1536-exact.json").read_text())
    cfg["rows"] = 1000
    (root / "benchmark/configs/nq-small.json").write_text(json.dumps(cfg))
    mix = json.loads((ROOT / "benchmark/traffic/knn-c1.json").read_text())
    mix["clients"] = 2
    (root / "benchmark/traffic/knn-c2.json").write_text(json.dumps(mix))
    (root / "benchmark/metrics/served_per_slice.py").write_text(
        "def read(ctx):\n    return ctx['slice']['requests']\n")
    bench["configs"].append({"name": "nq-small", "source": "x", "file": "benchmark/configs/nq-small.json",
                             "reduced": ["rows"], "why": "x"})
    bench["workloads"].append({"name": "nq-small.knn.c2", "config": "nq-small", "traffic": "knn-c2",
                               "chips": 1, "why": "x"})
    bench["per_layer"].append({"name": "served_per_slice", "unit": "req", "better": "higher",
                               "source": "host_clock", "layer": "REST", "moves": "qps",
                               "workloads": ["nq-small.knn.c2"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = spec.resolve(root, "nq-small.knn.c2", bench_dir=root / "benchmark")
    assert cell.config["rows"] == 1000 and cell.traffic["clients"] == 2
    got = spec.read_layer_metrics(cell, {"slice": {"requests": 7, "events": [], "lo": 0, "hi": 1,
                                                   "stats": None},
                                         "stats": None, "config": cell.config})
    assert got["served_per_slice"] == {"value": 7, "unit": "req"}
    # the existing cells resolve from the copy as they did
    assert spec.resolve(root, "nq-openai-1536-exact.knn.c1", bench_dir=root / "benchmark").chips == 1
