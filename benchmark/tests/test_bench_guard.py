"""Nothing the benchmark runs imports JAX or the JAX package; the
reference imports nothing of the program."""

import ast
import subprocess
import sys

import pytest

from benchmark.tests.conftest import ROOT

BENCH = ROOT / "benchmark"
BANNED = {"jax", "jaxlib", "flax", "elasticsearch_tpu"}


def imported_tops(path):
    tree = ast.parse(path.read_text())
    out = set()
    for n in ast.walk(tree):
        if isinstance(n, ast.Import):
            out |= {a.name.split(".")[0] for a in n.names}
        elif isinstance(n, ast.ImportFrom) and n.level == 0 and n.module:
            out.add(n.module.split(".")[0])
    return out


def test_no_file_under_the_benchmark_imports_jax_or_the_jax_package():
    for p in BENCH.rglob("*.py"):
        if "tests" in p.relative_to(BENCH).parts:
            continue
        assert not imported_tops(p) & BANNED, p


def test_the_reference_imports_nothing_of_the_program():
    for p in (BENCH / "reference").rglob("*.py"):
        tops = imported_tops(p)
        assert "elasticsearch_tpu_torch" not in tops and not tops & BANNED, p


def test_banned_modules_compares_whole_top_level_names(monkeypatch):
    from benchmark import run

    monkeypatch.setitem(sys.modules, "elasticsearch_tpu_torch_like", sys)
    assert "elasticsearch_tpu" not in run.banned_modules()
    monkeypatch.setitem(sys.modules, "elasticsearch_tpu.search", sys)
    assert run.banned_modules() == ["elasticsearch_tpu"]


def test_a_run_loads_neither_jax_nor_the_jax_package():
    """The harness, the port and the reference in a fresh process."""
    code = (
        "import sys; sys.path[:0] = [%r, %r]\n"
        "import run; run.set_env(run.ROOT)\n"
        "from benchmark.harness import check, clients, corpus, profile, spec, system, traffic\n"
        "from benchmark.reference import bm25, knn\n"
        "import benchmark.control\n"
        "import elasticsearch_tpu_torch.rest.server, elasticsearch_tpu_torch.search.executor_torch\n"
        "print(run.banned_modules())\n" % (str(ROOT), str(BENCH)))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_no_card_means_no_result():
    """With no CUDA device the run exits non-zero and prints no result
    line (it never falls back to the CPU)."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the run would measure it")
    out = subprocess.run([sys.executable, str(BENCH / "run.py"), "--workload",
                          "nq-openai-1536-exact.knn.c1", "--seed", "1", "--seconds", "1",
                          "--trace", "0"], capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert out.returncode != 0
    assert "{" not in out.stdout


def test_server_and_clients_get_cpus_apart():
    from benchmark import run

    assert run.split_cpus({3, 0, 7, 5}) == ([0, 3, 5], [7])
    assert run.split_cpus({2}) is None
