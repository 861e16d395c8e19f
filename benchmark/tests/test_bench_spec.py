"""BENCHMARK.json against the benchmark's contract, and the harness
finding every cell, configuration, traffic mix and metric by name."""

import json
import re
import shutil

import pytest

from benchmark.harness import spec
from benchmark.tests.conftest import ROOT

BENCH_DIR = ROOT / "benchmark"

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
    for group, name in (("kinds", cell.config["kind"]), ("bodies", cell.traffic["body"])):
        assert (BENCH_DIR / group / f"{name}.py").is_file()
    assert cell.traffic["clients"] >= 1
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


# A kind and a body that the benchmark does not have: rows of N(0, 1)
# under `l2_norm` in a field `pt`, on an index with its own codec.
POINTS_KIND = """
import numpy as np

from benchmark.harness.check import _page


def make(config, seed, device):
    import torch

    from benchmark.harness.corpus import generator

    g = generator(seed, device, 3)
    return {"rows": torch.randn(int(config["rows"]), int(config["dims"]), generator=g,
                                device=device, dtype=torch.float32)}


def client_context(config, corpus):
    return {}


def segment(config, corpus):
    from benchmark.harness.system import whole_segment
    from elasticsearch_tpu_torch.index.segment import VectorField

    rows = corpus["rows"].cpu().numpy()
    n = rows.shape[0]
    field = VectorField(vectors=rows, exists=np.ones(n, bool), similarity="l2_norm")
    return whole_segment(n, vectors={config["field"]: field})


def index(config):
    return {"settings": {"codec": config["codec"]},
            "mappings": {"properties": {config["field"]: {
                "type": "dense_vector", "dims": int(config["dims"]), "similarity": "l2_norm"}}}}


def _scores(rows, q, dtype):
    d = rows.to(dtype)[None, :, :] - q.to(dtype)[:, None, :]
    return (1 / (1 + (d * d).sum(-1))).double()


def _judge(rows, maker, sampled, size, dtype):
    import torch

    q = torch.from_numpy(np.stack([maker.vector(c, i) for c, i, *_ in sampled]))
    S = _scores(rows, q, torch.float64)
    worst = {"score_err": 0.0, "hit_gap": 0.0}
    for j, rec in enumerate(sampled):
        order = torch.sort(S[j], descending=True, stable=True).indices[:size]
        e, g = _page(S[j][order].numpy(), lambda d: float(S[j][d]) if 0 <= d < len(rows) else None,
                     rec[5]["hits"], size)
        worst["score_err"] = max(worst["score_err"], e)
        worst["hit_gap"] = max(worst["hit_gap"], g)
    return worst


def judge(config, corpus, maker, sampled, size):
    import torch

    return _judge(corpus["rows"], maker, sampled, size, torch.float64)


def control(config, traffic, corpus, maker, n):
    import torch

    from benchmark.control import records

    rows, size = corpus["rows"], int(traffic["size"])
    q = torch.from_numpy(np.stack([maker.vector(0, i) for i in range(n)]))
    low = _scores(rows, q, torch.bfloat16)
    tops = [torch.sort(low[i], descending=True, stable=True).indices[:size] for i in range(n)]
    recs = records(maker, n, 1, lambda c, i: (tops[i], low[i][tops[i]], size))
    return _judge(rows, maker, recs, size, torch.float64)
"""
NEAREST_BODY = """
import numpy as np

from benchmark.harness.traffic import norm_seed


class Maker:
    def __init__(self, traffic, config, context, seed):
        self.traffic, self.config, self.seed = traffic, config, norm_seed(seed)

    def vector(self, client, i):
        rng = np.random.default_rng([self.seed, int(client), int(i)])
        return rng.standard_normal(int(self.config["dims"]), dtype=np.float32)

    def body(self, client, i):
        return {"knn": {"field": self.config["field"], "query_vector": self.vector(client, i).tolist(),
                        "k": self.traffic["size"], "num_candidates": 50},
                "size": self.traffic["size"]}
"""


def _copy_with_points(tmp_path):
    """A copy of the benchmark with the `points` kind and the `nearest`
    body added as new files and entries only."""
    root = tmp_path / "repo"
    shutil.copytree(BENCH_DIR, root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    (root / "benchmark/kinds/points.py").write_text(POINTS_KIND)
    (root / "benchmark/bodies/nearest.py").write_text(NEAREST_BODY)
    cfg = {"name": "points-l2", "kind": "points", "rows": 3000, "dims": 16, "field": "pt",
           "codec": "best_compression",
           "deployment_shape": {"shards": 1, "replicas": 0},
           "limits": {"score_err": 1e-4, "hit_gap": 1e-4, "failed": 0}}
    (root / "benchmark/configs/points-l2.json").write_text(json.dumps(cfg))
    mix = {"name": "nearest-c1", "loop": "closed", "clients": 1, "warmup_s": 0.5,
           "body": "nearest", "size": 10, "check_sample": 24}
    (root / "benchmark/traffic/nearest-c1.json").write_text(json.dumps(mix))
    bench["configs"].append({"name": "points-l2", "source": "x",
                             "file": "benchmark/configs/points-l2.json", "reduced": [], "why": "x"})
    bench["workloads"].append({"name": "points-l2.nearest.c1", "config": "points-l2",
                               "traffic": "nearest-c1", "chips": 1, "why": "x"})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root


def test_a_kind_and_a_body_from_new_files_alone_run_end_to_end(tmp_path, monkeypatch):
    """The new kind makes its corpus, segment, index settings and mapping,
    its bodies reach the clients, its check finds a sound run correct and
    its control fails the limits; no file of the benchmark changed."""
    from benchmark import run
    from benchmark.control import control_readings
    from benchmark.harness import check, system

    root = _copy_with_points(tmp_path)
    cell = spec.resolve(root, "points-l2.nearest.c1", bench_dir=root / "benchmark")
    assert cell.bench_dir == root / "benchmark"
    settings = []
    prewarm = system.System.prewarm

    def read_settings(self):
        settings.append(system.http_json(self.port, "GET", f"/{system.INDEX}/_settings"))
        prewarm(self)

    monkeypatch.setattr(system.System, "prewarm", read_settings)
    run.set_env(run.ROOT)
    out = run.run_cell(cell, 2**31 + 91, 2.0, False, device="cpu", log=lambda *a, **k: None)
    assert out["correct"], out["check"]
    assert out["failed"] == 0 and out["attempted"] > 0
    assert set(out["check"]) == {"score_err", "hit_gap", "failed"}
    index = settings[0][system.INDEX]
    assert index.get("settings", index)["index"]["codec"] == "best_compression"
    low = control_readings(cell.config, cell.traffic, 3, 16, "cpu", cell.bench_dir)
    assert check.verdict(low, cell.config["limits"])[0] is False, low


@pytest.mark.parametrize("group,name", [("kinds", "points"), ("bodies", "nearest")])
def test_a_kind_or_body_with_no_module_fails_at_resolve_time(tmp_path, group, name):
    root = _copy_with_points(tmp_path)
    (root / "benchmark" / group / f"{name}.py").unlink()
    with pytest.raises(spec.SpecError, match=f"{group}: no module"):
        spec.resolve(root, "points-l2.nearest.c1", bench_dir=root / "benchmark")
    with pytest.raises(spec.SpecError, match="bad name"):
        spec.module_path(root / "benchmark", group, "../run")
