"""The benchmark's specification: `BENCHMARK.json` and the files its
names lead to.

Everything that belongs to one configuration, one traffic mix or one
per-layer metric sits in a file of its own, found by name:

  * a configuration: the `file` its `configs` entry names (JSON);
  * a traffic mix: `traffic/<name>.json`;
  * a configuration's `kind`: `kinds/<kind>.py`, everything that differs
    by kind (the corpus, the clients' context, the port's segment, the
    index's mapping and own settings, the check against the plain
    reference, the lower-precision control);
  * a mix's `body`: `bodies/<body>.py`, the maker of its request bodies;
  * a per-layer metric: `metrics/<name>.py`, whose `read(ctx)` returns
    the metric's value or None when the run gave it nothing to read.

So a later cell, mix, metric or kind is new files plus new entries, and
no file here changes.
"""

from __future__ import annotations

import importlib.util
import json
import re
import sys
from dataclasses import dataclass
from pathlib import Path
from typing import Callable, Dict, List, Optional

BENCH_DIR = Path(__file__).resolve().parent.parent
NAME_RE = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT_RE = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


class SpecError(ValueError):
    """BENCHMARK.json or a file it leads to is malformed."""


@dataclass
class Metric:
    name: str
    unit: str
    moves: Optional[str] = None
    workloads: Optional[List[str]] = None
    reader: Optional[Callable] = None


@dataclass
class Cell:
    name: str
    config: dict
    traffic: dict
    chips: int
    end_to_end: List[Metric]
    per_layer: List[Metric]
    # where the cell's kind, body and metric modules were found
    bench_dir: Path = BENCH_DIR


def _load_json(path: Path) -> dict:
    try:
        with open(path) as f:
            return json.load(f)
    except FileNotFoundError as e:
        raise SpecError(f"{path} is missing") from e


def module_path(bench_dir: Path, group: str, name) -> Path:
    """`<group>/<name>.py` under `bench_dir`, which has to exist."""
    if not isinstance(name, str) or not NAME_RE.match(name):
        raise SpecError(f"{group}: bad name {name!r}")
    path = bench_dir / group / f"{name}.py"
    if not path.is_file():
        raise SpecError(f"{group}: no module {name!r} at {path}")
    return path


def load_module(bench_dir: Path, group: str, name: str):
    """`<group>/<name>.py`, loaded from its path (a name may hold dots)."""
    path = module_path(bench_dir, group, name)
    spec = importlib.util.spec_from_file_location(
        f"bench_{group}_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def kind(config: dict, bench_dir: Path = BENCH_DIR):
    """The configuration's kind module, `kinds/<kind>.py`."""
    return load_module(bench_dir, "kinds", config.get("kind"))


def body(traffic: dict, bench_dir: Path = BENCH_DIR):
    """The mix's body module, `bodies/<body>.py`."""
    return load_module(bench_dir, "bodies", traffic.get("body"))


def load_reader(bench_dir: Path, name: str) -> Callable:
    """`metrics/<name>.py`'s `read`."""
    # readers share metrics/_common.py
    metrics = str(bench_dir / "metrics")
    if metrics not in sys.path:
        sys.path.insert(0, metrics)
    mod = load_module(bench_dir, "metrics", name)
    read = getattr(mod, "read", None)
    if not callable(read):
        raise SpecError(f"{mod.__file__} defines no read(ctx)")
    return read


def load_spec(root: Path) -> dict:
    """BENCHMARK.json at `root`, its names checked."""
    spec = _load_json(root / "BENCHMARK.json")
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [e["name"] for e in spec.get(group, [])]
        for n in names:
            if not NAME_RE.match(n):
                raise SpecError(f"{group}: bad name {n!r}")
        if len(set(names)) != len(names):
            raise SpecError(f"{group}: a name appears twice")
    for m in spec.get("end_to_end", []) + spec.get("per_layer", []):
        if not UNIT_RE.match(m["unit"]):
            raise SpecError(f"metric {m['name']}: bad unit {m['unit']!r}")
    return spec


def _metric(entry: dict) -> Metric:
    return Metric(name=entry["name"], unit=entry["unit"], moves=entry.get("moves"),
                  workloads=entry.get("workloads"))


def resolve(root: Path, workload: str, bench_dir: Path = BENCH_DIR) -> Cell:
    """The cell `workload` with its configuration, traffic mix and the
    metrics it reports; the per-layer ones with their readers."""
    spec = load_spec(root)
    cells = {w["name"]: w for w in spec["workloads"]}
    if workload not in cells:
        raise SpecError(f"no workload {workload!r} in BENCHMARK.json")
    w = cells[workload]
    configs = {c["name"]: c for c in spec["configs"]}
    if w["config"] not in configs:
        raise SpecError(f"workload {workload}: no config {w['config']!r}")
    config = _load_json(root / configs[w["config"]]["file"])
    traffic = _load_json(bench_dir / "traffic" / f"{w['traffic']}.json")
    module_path(bench_dir, "kinds", config.get("kind"))
    module_path(bench_dir, "bodies", traffic.get("body"))

    def applies(m: Metric) -> bool:
        return m.workloads is None or workload in m.workloads

    e2e = [m for m in map(_metric, spec["end_to_end"]) if applies(m)]
    reported = {m.name for m in e2e}
    layer = []
    for m in map(_metric, spec["per_layer"]):
        if applies(m) and m.moves in reported:
            m.reader = load_reader(bench_dir, m.name)
            layer.append(m)
    return Cell(name=workload, config=config, traffic=traffic, chips=int(w["chips"]),
                end_to_end=e2e, per_layer=layer, bench_dir=bench_dir)


def read_layer_metrics(cell: Cell, ctx: dict) -> Dict[str, dict]:
    """Each per-layer metric's reading; a reader that finds nothing to
    read returns None and the metric is left out."""
    out = {}
    for m in cell.per_layer:
        v = m.reader(ctx)
        if v is not None:
            out[m.name] = {"value": v, "unit": m.unit}
    return out
