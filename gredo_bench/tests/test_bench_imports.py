"""The whole-name import rule: nothing the benchmark runs imports jax or the
JAX package (``repro``); the reference imports no part of the program
(``repro_torch``) either. Names are compared whole, by the part before the
first dot, so ``repro_torch`` is not ``repro``."""
from __future__ import annotations

import ast
import subprocess
import sys

import pytest

from gredo_bench import harness

MODULES = sorted(p for p in harness.HERE.rglob("*.py")
                 if "tests" not in p.parts)
# what the reference side may not reach: the program as well
NO_PROGRAM = {"reference.py", "datagen.py", "traffic.py", "stats.py",
              "roofline.py", "readers.py", "trace.py", "kinds/gcdi.py",
              "kinds/gcda.py", "kinds/paths.py"}


def top_level_imports(path) -> set:
    tree = ast.parse(path.read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", MODULES, ids=lambda p: p.name)
def test_no_jax_and_no_jax_package(path):
    assert not top_level_imports(path) & {"jax", "jaxlib", "flax", "repro"}
    assert "benchmarks/" not in path.read_text()


@pytest.mark.parametrize("name", sorted(NO_PROGRAM))
def test_reference_side_imports_no_program(name):
    assert "repro_torch" not in top_level_imports(harness.HERE / name)


def test_forbidden_modules_compares_whole_names(monkeypatch):
    # other test files in this process may have loaded jax: hide them here
    for name in list(sys.modules):
        if name.split(".")[0] in harness.FORBIDDEN:
            monkeypatch.delitem(sys.modules, name)
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "repro_torch_probe", object())
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "repro.core.engine", object())
    assert harness.forbidden_modules() == ["repro"]


def test_a_run_loads_no_jax(tmp_path):
    """A whole run on the CPU, in a fresh process: afterwards sys.modules
    holds neither jax nor the JAX package."""
    code = (
        "import sys; sys.path[:0] = [%r, %r]\n"
        "from gredo_bench import harness\n"
        "r = harness.run('ecom_sf10.gcdi', 5, 0.2, False, device='cpu',"
        " scale={'sf': 1}, quiet=True)\n"
        "assert r['correct'], r\n"
        "print(harness.forbidden_modules())\n"
    ) % (str(harness.REPO), str(harness.REPO / "src"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


@pytest.mark.parametrize("only_bench", [False, True])
def test_run_without_a_card_prints_no_result(tmp_path, only_bench):
    """Without a CUDA card (and in a folder holding only the benchmark's
    files) the command exits non-zero and prints nothing on stdout."""
    import shutil
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the no-card path is not taken")
    root = harness.REPO
    if only_bench:
        root = tmp_path / "checkout"
        shutil.copytree(harness.HERE, root / "gredo_bench",
                        ignore=shutil.ignore_patterns("__pycache__"))
        shutil.copy(harness.REPO / "BENCHMARK.json", root)
    out = subprocess.run(
        [sys.executable, "gredo_bench/run.py", "--workload",
         "ecom_sf10.gcdi", "--seed", "3", "--seconds", "1", "--trace", "0"],
        cwd=root, capture_output=True, text=True, timeout=300,
        env={"PATH": "/usr/bin:/bin", "HOME": str(tmp_path)})
    assert out.returncode != 0
    assert out.stdout.strip() == ""
