"""Replay the JAX package's own test suites against the PyTorch port.

    python scripts/torch_reference_suites.py --device cpu|cuda \
        [--suites test_rest,test_dfs,...] [--junitxml out.xml] [-n WORKERS]

Runs the reference's test files (`tests/test_*.py`, not `test_torch_*`)
through `pytest.main` with `--noconftest -p torch_reference_suites -m
'not slow'`. This file is both that pytest plugin and the CLI. By
default `cpu` replays `CPU_SUITES` (tier-1 does, through
tests/test_torch_reference_suites.py) and `cuda` replays them and
`CARD_SUITES` (route (q) of chip_smoke.py).

- `elasticsearch_tpu` and `elasticsearch_tpu.*` resolve, by a meta-path
  finder, to the very module objects of `elasticsearch_tpu_torch.*`
  (`search.executor_jax` is `search.executor_torch`, `ops.pallas_knn` is
  `ops.int8_knn`, and `JaxExecutor` is `TorchExecutor`); a subprocess
  started as `python -m elasticsearch_tpu ...` runs the port's module.
  No module of the reference package is loaded: the guard fails the
  test module, and the run, where one was.
- An index setting `search.backend: jax` reads as `torch` in the
  replaying process only; the port refuses `jax` everywhere else.
- `--device cpu` passes `device="cpu"` to `ClusterService`,
  `IndexService`, `TpuNode` and `TorchExecutor` and pins the host
  segment build; `--device cuda` changes nothing, so every entry point
  and plain op takes its own default, the card, the device build runs,
  and the run exits 2 where no CUDA device is found. With `cuda` the
  guard also fails the run if `jax` was imported.
- `--noconftest` keeps `tests/conftest.py` (which imports `jax`) out: the
  plugin gives the fixtures, markers and environment it would have
  given, on the port's own singletons.

A test leaves the replay only through `DESELECT`, with one of three
reasons: (a) it probes JAX/XLA itself; (b) it is a known failure of the
reference; (c) it calls an op with the reference's signature or return
type, which the port changed by design, and a `tests/test_torch_*.py`
twin holds that op against the reference. The run prints one JSON line: the
suites, and per suite the tests collected, passed, failed, skipped and
deselected by reason, any entry of `DESELECT` that matched no test, the
guard's findings and the seconds. It exits with pytest's code, else 3
on a guard finding, 4 on a stale entry.
"""

import argparse
import importlib
import importlib.abc
import importlib.util
import inspect
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parent.parent
REFERENCE = "elasticsearch_tpu"
PORT = "elasticsearch_tpu_torch"
REFERENCE_DIR = ROOT / REFERENCE
# reference module path -> port module path, where the port renamed it
RENAMES = {
    "search.executor_jax": "search.executor_torch",
    "ops.pallas_knn": "ops.int8_knn",
}

# suites that pass whole on the CPU, less their deselections: the REST-,
# service- and node-level files; tier-1 replays them
# (tests/test_torch_reference_suites.py)
CPU_SUITES = [
    "test_admission", "test_advisor_fixes", "test_aggs", "test_aggs2",
    "test_aliases_templates", "test_analysis", "test_backpressure",
    "test_batcher", "test_can_match", "test_device_sort_aggs", "test_dfs",
    "test_distributed_search", "test_durability", "test_engine",
    "test_explain_rollover_innerhits", "test_faults",
    "test_highlight_analysis", "test_index_and_oracle", "test_ingest",
    "test_jax_parity", "test_mapper_extras", "test_mapping",
    "test_multinode", "test_native_plugins_cli", "test_nodes_stats_schema",
    "test_pagination", "test_positions", "test_profile", "test_queries2",
    "test_queries3", "test_query_cache", "test_quorum",
    "test_rank_eval_percolator", "test_relocation", "test_replication",
    "test_rest", "test_scripting", "test_serve_plans", "test_settings_stats",
    "test_slowlog", "test_snapshots", "test_suggest_update_validate",
    "test_tasks_reindex", "test_tracing", "test_transport", "test_utils",
]
# op-level suites, whose plain functions take the card by default: the
# card replays them after CPU_SUITES (route (q) of chip_smoke.py)
CARD_SUITES = [
    "test_aggs_device", "test_ann_ivf", "test_batched_scorer",
    "test_continuous_batching", "test_hybrid_rrf", "test_ingest_nrt",
    "test_mesh", "test_pipeline", "test_rerank", "test_sharded",
    "test_sparse", "test_wand_pallas",
]

BOTH, CPU, CUDA = ("cpu", "cuda"), ("cpu",), ("cuda",)
# test id (suite file::test, a parametrized test by its base name or one
# case) -> {device: (reason, why)}; for (c) `why` names the port test
# that holds the op against the reference
DESELECT = {}


def _deselect(reason, devices, why, *tests):
    for test in tests:
        for device in devices:
            DESELECT.setdefault(test, {})[device] = (reason, why)


_MESH8 = "needs the reference's forced 8-device XLA platform (tests/conftest.py:38-42)"
_DEVICE = "the op's device defaults to the card"

# (a) it probes JAX/XLA itself
_deselect("a", BOTH, "feeds jax arrays to the op (twin: tests/test_torch_rerank.py::"
                     "test_maxsim_matches_reference_every_row_bucket)",
          "test_rerank.py::TestMaxsimKernelParity::test_kernel_parity_every_row_bucket")
_deselect("a", BOTH, "reads the jit cache (`_cache_size`)",
          "test_continuous_batching.py::TestNoRecompileAfterWarmup::"
          "test_randomized_bucket_load_compiles_nothing_new")
_deselect("a", BOTH, "XLA's donated staging slabs (`staging_slab`)",
          "test_pipeline.py::TestStagingSlabs::test_ring_rotation_and_ledger_charge")
_deselect("a", BOTH, "jax.devices()", "test_mesh.py::TestLayouts::test_make_mesh_folding_api")
_deselect("a", BOTH, f"{_MESH8} (twin: tests/test_torch_mesh_multi.py)",
          "test_mesh.py::TestRoutingPredicate::test_auto_mode_engages_multi_shard",
          "test_mesh.py::TestObservability::test_device_stats_rows",
          "test_mesh.py::TestObservability::test_nodes_stats_devices_and_mesh_block",
          "test_aggs_device.py::TestMeshAggs::test_mesh_auto_keeps_request_cache_path",
          "test_sharded.py::TestShardedBM25::test_matches_per_shard_oracle_merge",
          "test_sharded.py::TestShardedBM25::test_empty_and_unknown_terms",
          "test_sharded.py::TestShardedKnn::test_matches_host_brute_force",
          "test_sharded.py::TestRRF::test_fuse_ranks")
_deselect("a", CUDA, "imports jax to count devices, skips under 2 "
                     "(twin: tests/test_torch_mesh_multi.py)",
          "test_ingest_nrt.py::TestPrewarmAndMesh::test_mesh_incremental_rebuild_reuses_unchanged_shards",
          "test_sparse.py::TestMeshSparse::test_mesh_vs_shard_parity")

# (b) known failures of the reference (ROADMAP queue 3): its kNN scores
# move an ulp with the launch's row count (0.9193673729896545 against
# 0.9193673133850098), and the port's product does the same
_deselect("b", BOTH, "a kNN score moves an ulp with the launch's row count",
          "test_continuous_batching.py::TestBucketParity::test_every_bucket_matches_fixed_shape[knn]",
          "test_pipeline.py::TestDepthParity::test_depth2_vs_depth1_float_exact")

# (c) the port changed the op's signature or return type by design
_deselect("c", BOTH, "`device` is a required argument (twin: tests/test_torch_ingest.py)",
          "test_ingest_nrt.py::TestBuildParity::test_quantize_int8_parity",
          "test_ingest_nrt.py::TestBuildParity::test_agg_perm_tables_parity")
_deselect("c", BOTH, "the port's distribution is `elasticsearch-tpu-torch` "
                     "(twin: tests/test_torch_durable_rest.py::TestCli)",
          "test_native_plugins_cli.py::TestCli::test_version")
_deselect("c", CPU, "`check` exits 1 without a card (twins: tests/test_torch_durable_rest.py::TestCli, "
                    "tests/test_torch_cuda.py::test_check_passes_on_card)",
          "test_native_plugins_cli.py::TestCli::test_check_passes")
_deselect("c", BOTH, "fuses on the card and returns tensors there (twin: tests/test_torch_fusion.py)",
          "test_hybrid_rrf.py::TestDeviceHostParity::test_random_legs",
          "test_hybrid_rrf.py::TestDeviceHostParity::test_tie_breaks_on_ascending_doc",
          "test_hybrid_rrf.py::TestDeviceHostParity::test_exact_dedup_single_contribution_per_leg",
          "test_hybrid_rrf.py::TestDeviceHostParity::test_three_legs")
_deselect("c", BOTH, f"{_DEVICE} and the index's centroids are a tensor there (twins: "
                     "tests/test_torch_ivf.py, tests/test_torch_cuda.py::test_served_ivf_on_card)",
          "test_ann_ivf.py::TestBuildMachinery::test_kmeans_build_deterministic")
_deselect("c", BOTH, f"{_DEVICE} and `search` returns tensors there (twins: "
                     "tests/test_torch_int8_knn.py, tests/test_torch_cuda.py)",
          "test_wand_pallas.py::TestInt8Quantization::test_int8_search_recall_vs_exact",
          "test_wand_pallas.py::TestInt8Quantization::test_dot_product_and_mip",
          "test_wand_pallas.py::TestInt8Quantization::test_padding_docs_excluded")
_deselect("c", CPU, f"{_DEVICE} (twin: tests/test_torch_ingest.py)",
          "test_ingest_nrt.py::TestBuildParity::test_device_build_bit_identical_all_families",
          "test_ingest_nrt.py::TestBuildParity::test_device_build_empty_and_tiny",
          "test_ingest_nrt.py::TestRefreshUnderFault::test_build_device_delay_slow_not_wrong",
          "test_ingest_nrt.py::TestRefreshUnderFault::test_engine_refresh_error_keeps_old_generation",
          "test_ingest_nrt.py::TestRefreshUnderFault::"
          "test_mid_build_crash_keeps_old_generation_and_loses_nothing")
_deselect("c", CPU, f"{_DEVICE} (twin: tests/test_torch_sparse.py)",
          "test_sparse.py::TestSparseBuildParity::test_device_build_bit_identical",
          "test_sparse.py::TestImpactKernel::test_scorer_matches_oracle")
_deselect("c", CPU, f"{_DEVICE} (twin: tests/test_torch_serving.py)",
          "test_batched_scorer.py::test_chunked_matches_oracle",
          "test_batched_scorer.py::test_chunking_splits_long_tile_lists",
          "test_batched_scorer.py::test_live_docs_masked",
          "test_wand_pallas.py::TestBlockMaxWand::test_exact_topk_vs_dense",
          "test_wand_pallas.py::TestBlockMaxWand::test_pruning_happens",
          "test_wand_pallas.py::TestBlockMaxWand::test_pure_rare_query_no_phase_b",
          "test_wand_pallas.py::TestBlockMaxWand::test_pruning_exact_with_deleted_docs")


def _port_name(fullname: str) -> str:
    rest = fullname[len(REFERENCE) + 1:] if fullname != REFERENCE else ""
    rest = RENAMES.get(rest, rest)
    return PORT + ("." + rest if rest else "")


class _AliasLoader(importlib.abc.Loader):
    def __init__(self, real):
        self.real = real

    def create_module(self, spec):
        module = importlib.import_module(self.real)
        self._spec = module.__spec__
        return module

    def exec_module(self, module):
        # the import system set `__spec__` to the alias's spec: give the
        # port's module its own back (its `__name__`, `__file__`,
        # `__package__` and `__path__` were never touched)
        module.__spec__ = self._spec


class ReferenceAlias(importlib.abc.MetaPathFinder):
    """Answers `elasticsearch_tpu[.x]` with the module object of
    `elasticsearch_tpu_torch[.x]`: no copy, no second import."""

    def find_spec(self, fullname, path=None, target=None):
        if fullname != REFERENCE and not fullname.startswith(REFERENCE + "."):
            return None
        real = _port_name(fullname)
        if importlib.util.find_spec(real) is None:
            return None
        return importlib.util.spec_from_loader(fullname, _AliasLoader(real))


def install_alias() -> None:
    if any(isinstance(f, ReferenceAlias) for f in sys.meta_path):
        return
    loaded = reference_modules_loaded()
    if loaded:
        raise RuntimeError(f"the reference package is already loaded: {loaded[:5]}")
    sys.meta_path.insert(0, ReferenceAlias())
    # `from elasticsearch_tpu.search import executor_jax` looks the name
    # up on the port's package, under the port's own module name
    for ref, port in RENAMES.items():
        parent, _, child = ref.rpartition(".")
        setattr(importlib.import_module(f"{PORT}.{parent}"), child,
                importlib.import_module(f"{PORT}.{port}"))
    executor = importlib.import_module(f"{PORT}.search.executor_torch")
    executor.JaxExecutor = executor.TorchExecutor
    from elasticsearch_tpu_torch.common import settings

    backend = settings.INDEX_SETTINGS["search.backend"]
    backend.parser = lambda v: "torch" if str(v) == "jax" else str(v)


def _alias_argv(args):
    """`python -m elasticsearch_tpu[.x] ...` -> the port's module: the
    alias at a process boundary, where no finder of ours runs."""
    if not isinstance(args, (list, tuple)):
        return args
    out = list(args)
    for i in range(len(out) - 1):
        nxt = out[i + 1]
        if out[i] == "-m" and isinstance(nxt, str) and (
            nxt == REFERENCE or nxt.startswith(REFERENCE + ".")
        ):
            out[i + 1] = _port_name(nxt)
    return out


def _alias_subprocesses() -> None:
    popen_init = subprocess.Popen.__init__

    def __init__(self, args, *a, **kw):
        popen_init(self, _alias_argv(args), *a, **kw)

    subprocess.Popen.__init__ = __init__


def reference_modules_loaded() -> list:
    """Names of loaded modules whose file lies in the reference package."""
    out = []
    for name, mod in list(sys.modules.items()):
        f = getattr(mod, "__file__", None)
        if f and Path(f).resolve().is_relative_to(REFERENCE_DIR):
            out.append(name)
    return sorted(out)


def guard_faults(device: str) -> list:
    bad = [f"reference module loaded: {m}" for m in reference_modules_loaded()]
    if device == "cuda" and "jax" in sys.modules:
        bad.append("jax was imported")
    return bad


def _force_cpu(cls) -> None:
    """Every `cls(...)` runs on the CPU, whatever device it was given."""
    init = cls.__init__
    sig = inspect.signature(init)

    def __init__(self, *args, **kwargs):
        bound = sig.bind(self, *args, **kwargs)
        bound.arguments["device"] = "cpu"
        init(*bound.args, **bound.kwargs)

    cls.__init__ = __init__


# ---------------------------------------------------------------- plugin


def pytest_addoption(parser):
    parser.addoption("--replay-device", default="cpu", choices=("cpu", "cuda"))
    parser.addoption("--replay-stats", default=None)


def pytest_configure(config):
    device = config.getoption("--replay-device")
    # the reference conftest's environment (tests/conftest.py:14-37)
    os.environ["ES_TPU_ADMISSION"] = "off"
    os.environ["ES_TPU_BUCKET_WARMUP"] = "0"
    os.environ["ES_TPU_BG_REFRESH"] = "off"
    # the card runs every suite under the device build (the port's
    # default); the CPU pins the host build as tier-1 does
    if device == "cpu":
        os.environ["ES_TPU_DEVICE_BUILD"] = "off"
    else:
        os.environ.pop("ES_TPU_DEVICE_BUILD", None)
    for line in (
        "faults: deterministic fault-injection tests (run in tier-1)",
        "slow: long-running tests excluded from tier-1",
        "mesh: mesh-parallel serving tests",
        "cuda: needs an NVIDIA GPU and nvcc",
    ):
        config.addinivalue_line("markers", line)
    install_alias()
    _alias_subprocesses()
    if device == "cpu":
        from elasticsearch_tpu_torch.cluster.indices import IndexService
        from elasticsearch_tpu_torch.cluster.node import TpuNode
        from elasticsearch_tpu_torch.cluster.service import ClusterService
        from elasticsearch_tpu_torch.search.executor_torch import TorchExecutor

        for cls in (ClusterService, IndexService, TpuNode, TorchExecutor):
            _force_cpu(cls)


def _suite(location) -> str:
    """A test's suite: the stem of its file (`item.location[0]`, a path
    relative to the root)."""
    return Path(location[0]).stem


def _deselection(nodeid: str, device: str):
    """(DESELECT key, reason) for a test this device leaves out, else None."""
    name = nodeid.split("/")[-1]
    for key in (name, name.split("[")[0]):
        entry = DESELECT.get(key, {}).get(device)
        if entry is not None:
            return key, entry[0]
    return None


@pytest.hookimpl(trylast=True)
def pytest_collection_modifyitems(config, items):
    """Drops the DESELECT entries of this device (after `-m`/`-k` have
    run) and writes, per suite, the tests collected and those dropped by
    reason, and every entry that matched nothing, to `--replay-stats`."""
    device = config.getoption("--replay-device")
    keep, drop, used, suites = [], [], set(), {}
    for item in items:
        row = suites.setdefault(_suite(item.location), {"collected": 0, "deselected": {}})
        row["collected"] += 1
        hit = _deselection(item.nodeid, device)
        if hit is None:
            keep.append(item)
            continue
        drop.append(item)
        used.add(hit[0])
        row["deselected"][hit[1]] = row["deselected"].get(hit[1], 0) + 1
    stale = sorted(
        k for k, by_device in DESELECT.items()
        if device in by_device and k.split("::")[0][:-3] in suites and k not in used
    )
    if drop:
        config.hook.pytest_deselected(items=drop)
        items[:] = keep
    path = config.getoption("--replay-stats")
    if path:
        worker = os.environ.get("PYTEST_XDIST_WORKER", "main")
        Path(f"{path}.{worker}").write_text(json.dumps({"suites": suites, "stale": stale}))


@pytest.fixture(autouse=True)
def _seed():
    np.random.seed(0)


@pytest.fixture(autouse=True)
def _reset_admission():
    yield
    from elasticsearch_tpu_torch.search.admission import admission

    admission.reset()


@pytest.fixture(autouse=True)
def _disarm_faults():
    yield
    from elasticsearch_tpu_torch.common.faults import faults

    if faults.active:
        faults.clear()


_GUARD_SEEN = pytest.StashKey[set]()


@pytest.fixture(autouse=True, scope="module")
def _no_leaked_batcher_threads(request):
    """The reference conftest's check of closed batchers, and the guard:
    a module of the reference package (or on the card `jax`) loaded since
    the plugin started, at collection or in a test, fails the first test
    module that ends after it."""
    device = request.config.getoption("--replay-device")
    seen = request.config.stash.setdefault(_GUARD_SEEN, set())
    yield
    from elasticsearch_tpu_torch.search.batcher import live_batchers

    leaked = []
    for b in list(live_batchers):
        if not getattr(b, "_closed", False):
            continue
        for t in list(b._threads):
            t.join(timeout=10.0)
            if t.is_alive():
                leaked.append(t.name)
    assert not leaked, f"closed QueryBatcher left live worker threads: {leaked}"
    new = sorted(set(guard_faults(device)) - seen)
    seen.update(new)
    assert not new, f"replay guard: {new}"


# ---------------------------------------------------------------- CLI


class _Tally:
    """Outcomes per suite, from the reports the main process sees."""

    def __init__(self):
        self.outcomes = {}

    def pytest_runtest_logreport(self, report):
        row = self.outcomes.setdefault(_suite(report.location), {})
        if report.failed:
            row[report.nodeid] = "failed"
        elif report.skipped and row.get(report.nodeid) != "failed":
            row[report.nodeid] = "skipped"
        elif report.passed and report.when == "call":
            row.setdefault(report.nodeid, "passed")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", required=True, choices=("cpu", "cuda"))
    ap.add_argument("--suites", default=None,
                    help="comma-separated suite names or test files "
                         "(default: CPU_SUITES, and CARD_SUITES with cuda)")
    ap.add_argument("--junitxml", default=None)
    ap.add_argument("-n", dest="workers", type=int, default=0,
                    help="pytest-xdist workers, where it is installed")
    args = ap.parse_args(argv)

    import torch

    if args.device == "cuda" and not torch.cuda.is_available():
        print("torch_reference_suites: no CUDA device", file=sys.stderr)
        return 2
    if args.suites:
        suites = args.suites.split(",")
    else:
        suites = CPU_SUITES + (CARD_SUITES if args.device == "cuda" else [])
    files = [s if s.endswith(".py") else str(ROOT / "tests" / f"{s}.py") for s in suites]
    here = str(Path(__file__).resolve().parent)
    sys.path[:0] = [here, str(ROOT)]
    # the xdist workers import the plugin by name too
    os.environ["PYTHONPATH"] = os.pathsep.join(
        [here, str(ROOT)] + [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep) if p]
    )
    stats = Path(tempfile.mkdtemp(prefix="replay-")) / "stats"
    cmd = files + [
        "--noconftest", "-p", "torch_reference_suites", "-m", "not slow",
        "-q", "-p", "no:cacheprovider", "-p", "no:randomly",
        f"--replay-device={args.device}", f"--replay-stats={stats}",
        f"--rootdir={ROOT}",
    ]
    if args.workers:
        cmd += ["-p", "xdist", "-n", str(args.workers), "--dist", "loadfile"]
    if args.junitxml:
        cmd.append(f"--junitxml={args.junitxml}")
    tally = _Tally()
    t0 = time.perf_counter()
    try:
        rc = int(pytest.main(cmd, plugins=[tally]))
        seconds = time.perf_counter() - t0
        written = sorted(stats.parent.glob("stats.*"))
        # every xdist worker collects every test: any one file says it all
        collection = json.loads(written[0].read_text()) if written else {"suites": {}, "stale": []}
    finally:
        shutil.rmtree(stats.parent, ignore_errors=True)
    bad = guard_faults(args.device)
    per_suite = {}
    for suite, row in collection["suites"].items():
        seen = list(tally.outcomes.get(suite, {}).values())
        per_suite[suite] = {
            "collected": row["collected"],
            "passed": seen.count("passed"),
            "failed": seen.count("failed"),
            "skipped": seen.count("skipped"),
            "deselected": row["deselected"],
        }
    total = lambda key: sum(r[key] for r in per_suite.values())  # noqa: E731
    out = {
        "replay": args.device,
        "suites": len(files),
        "collected": total("collected"),
        "passed": total("passed"),
        "failed": total("failed"),
        "skipped": total("skipped"),
        "deselected": {
            k: sum(r["deselected"].get(k, 0) for r in per_suite.values())
            for k in ("a", "b", "c")
        },
        "stale_deselections": collection["stale"],
        "guard": bad,
        "seconds": round(seconds, 3),
        "per_suite": per_suite,
    }
    print(json.dumps(out), flush=True)
    if bad:
        return 3
    if collection["stale"]:
        return 4
    return rc


if __name__ == "__main__":
    sys.exit(main())
