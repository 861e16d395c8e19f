"""The JAX package's own test suites replayed against the port, on the CPU.

`scripts/torch_reference_suites.py --device cpu` runs each suite of its
`CPU_SUITES` (the REST-, service- and node-level files) with
`elasticsearch_tpu.*` resolved to the port's module objects, once, in a
subprocess, with a junit file. Each suite is one case here: its passes
equal its collected tests less its listed deselections, with 0
failures. Further cases hold the alias (the same module objects under
both names), the port's refusal of `search.backend: jax` outside the
runner, the subprocess alias, the deselection table's reasons and
twins, and the guard, which must catch a planted import of the real
reference package.
"""

import json
import os
import re
import subprocess
import sys
import xml.etree.ElementTree as ET
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
RUNNER = ROOT / "scripts" / "torch_reference_suites.py"
sys.path.insert(0, str(RUNNER.parent))
import torch_reference_suites as rs  # noqa: E402

# xdist workers of the replay's own pytest; the whole replay stays well
# inside tier-1's time with the suite's other xdist workers beside it
WORKERS = 3
TIMEOUT_S = 600


def _run(args, timeout=TIMEOUT_S):
    # the runner sets the `ES_TPU_*` pins it needs; none of this
    # process's (another test's leftovers included) may reach it
    env = {k: v for k, v in os.environ.items() if not k.startswith("ES_TPU_")}
    proc = subprocess.run(
        [sys.executable, str(RUNNER), *args], cwd=ROOT, env=env, capture_output=True,
        text=True, timeout=timeout,
    )
    lines = [ln for ln in proc.stdout.splitlines() if ln.startswith('{"replay"')]
    out = json.loads(lines[-1]) if lines else None
    return proc, out


def _junit(path: Path) -> dict:
    """Per suite: tests, failures (errors included) and skips."""
    rows = {}
    for case in ET.parse(path).iter("testcase"):
        suite = case.get("classname").split(".")[1]
        row = rows.setdefault(suite, {"tests": 0, "failures": 0, "skipped": 0})
        row["tests"] += 1
        if case.find("failure") is not None or case.find("error") is not None:
            row["failures"] += 1
        elif case.find("skipped") is not None:
            row["skipped"] += 1
    return rows


@pytest.fixture(scope="module")
def replay(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("replay")
    junit = tmp / "replay.xml"
    proc, out = _run(["--device", "cpu", "--junitxml", str(junit), "-n", str(WORKERS)])
    assert out is not None, proc.stdout[-4000:] + proc.stderr[-4000:]
    return {"rc": proc.returncode, "out": out, "junit": _junit(junit),
            "tail": proc.stdout[-4000:]}


def test_replay_run_is_clean(replay):
    out = replay["out"]
    assert replay["rc"] == 0, replay["tail"]
    assert out["guard"] == [] and out["stale_deselections"] == []
    assert out["suites"] == len(rs.CPU_SUITES) and out["failed"] == 0
    assert sorted(out["per_suite"]) == sorted(rs.CPU_SUITES)
    print(f"replay: {out['passed']} passed of {out['collected']} in {out['seconds']} s")


@pytest.mark.parametrize("suite", rs.CPU_SUITES)
def test_reference_suite_replays_whole(replay, suite):
    row = replay["out"]["per_suite"][suite]
    listed = sum(row["deselected"].values())
    assert row["failed"] == 0 and row["skipped"] == 0, (suite, row)
    assert row["passed"] == row["collected"] - listed > 0, (suite, row)
    assert replay["junit"][suite] == {"tests": row["passed"], "failures": 0, "skipped": 0}


def test_alias_is_the_ports_module_objects():
    code = """
import json, sys
sys.path.insert(0, sys.argv[1])
import torch_reference_suites as rs
rs.install_alias()
import elasticsearch_tpu.search.executor_jax as a
import elasticsearch_tpu_torch.search.executor_torch as b
from elasticsearch_tpu.search import executor_jax
from elasticsearch_tpu.ops import pallas_knn
from elasticsearch_tpu.cluster.indices import IndexService
import elasticsearch_tpu_torch.ops.int8_knn as k
import elasticsearch_tpu_torch.cluster.indices as ci
from elasticsearch_tpu_torch.common.settings import validate_index_settings
print(json.dumps({
    "same": [a is b, executor_jax is b, pallas_knn is k, IndexService is ci.IndexService,
             sys.modules["elasticsearch_tpu.cluster.indices"] is ci,
             a.JaxExecutor is b.TorchExecutor],
    "names": [b.__name__, b.__spec__.name, k.__spec__.name],
    "files_in_port": all("elasticsearch_tpu_torch" in m.__file__ for n, m in sys.modules.items()
                         if n.startswith("elasticsearch_tpu.") and getattr(m, "__file__", None)),
    "backend": validate_index_settings({"search.backend": "jax"}, creating=True)["search.backend"],
    "reference": rs.reference_modules_loaded(),
}))
"""
    proc = subprocess.run([sys.executable, "-c", code, str(RUNNER.parent)], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-3000:]
    got = json.loads(proc.stdout.strip().splitlines()[-1])
    assert got["same"] == [True] * 6
    assert got["names"] == ["elasticsearch_tpu_torch.search.executor_torch"] * 2 + [
        "elasticsearch_tpu_torch.ops.int8_knn"]
    assert got["files_in_port"] and got["backend"] == "torch" and got["reference"] == []


def test_port_refuses_jax_backend_outside_the_runner():
    from elasticsearch_tpu_torch.cluster.indices import IndexService
    from elasticsearch_tpu_torch.common.settings import SettingsError, validate_index_settings

    with pytest.raises(SettingsError, match="search.backend"):
        validate_index_settings({"search.backend": "jax"}, creating=True)
    with pytest.raises(SettingsError, match="search.backend"):
        IndexService("refuse-jax", settings={"search.backend": "jax"}, device="cpu")
    assert validate_index_settings({"search.backend": "torch"}, creating=True) == {
        "search.backend": "torch"}


def test_subprocess_alias_runs_the_ports_cli():
    argv = [sys.executable, "-m", "elasticsearch_tpu", "check"]
    assert rs._alias_argv(argv) == [sys.executable, "-m", "elasticsearch_tpu_torch", "check"]
    assert rs._alias_argv([sys.executable, "-m", "elasticsearch_tpu.search.executor_jax"])[2] == (
        "elasticsearch_tpu_torch.search.executor_torch")
    assert rs._alias_argv([sys.executable, "-m", "elasticsearch_tpu_torch", "check"])[2] == (
        "elasticsearch_tpu_torch")
    assert rs._alias_argv("python -m elasticsearch_tpu") == "python -m elasticsearch_tpu"


def test_every_deselection_names_a_reason_and_its_twin():
    suites = set(rs.CPU_SUITES) | set(rs.CARD_SUITES)
    assert not set(rs.CPU_SUITES) & set(rs.CARD_SUITES)
    for test, by_device in rs.DESELECT.items():
        assert test.split("::")[0][:-3] in suites, test
        assert (ROOT / "tests" / test.split("::")[0]).exists(), test
        for device, (reason, why) in by_device.items():
            assert device in ("cpu", "cuda") and reason in ("a", "b", "c", "order"), test
            assert why, test
            if reason == "order":
                assert device == "cuda", test
            if reason in ("c", "order"):
                twins = re.findall(r"tests/(test_torch_\w+\.py)(?:::(\w+))?", why)
                assert twins, (test, why)
                for path, name in twins:
                    src = (ROOT / "tests" / path).read_text()
                    assert not name or re.search(rf"(def|class) {name}\b", src), (test, path, name)


def test_guard_catches_a_planted_reference_import(tmp_path):
    planted = tmp_path / "test_planted.py"
    planted.write_text(
        "import importlib.util, sys\n"
        "def test_plant():\n"
        f"    spec = importlib.util.spec_from_file_location('planted', {str(ROOT / 'elasticsearch_tpu' / 'utils' / 'smallfloat.py')!r})\n"
        "    mod = importlib.util.module_from_spec(spec)\n"
        "    spec.loader.exec_module(mod)\n"
        "    sys.modules['planted'] = mod\n"
    )
    proc, out = _run(["--device", "cpu", "--suites", str(planted)], timeout=300)
    assert out is not None, proc.stderr[-3000:]
    assert proc.returncode == 3
    assert out["guard"] == ["reference module loaded: planted"]
    # the module's own guard fails its teardown, where the import happened
    assert out["per_suite"]["test_planted"]["failed"] == 1
    assert "replay guard" in proc.stdout
