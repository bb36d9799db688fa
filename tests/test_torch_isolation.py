"""The port stands alone: ``repro_torch`` and ``chip_smoke.py`` import
neither JAX nor the JAX package (a query, an analytics task and the serving
launcher run in a fresh process without loading either), the kernels' CUDA
paths call no library kernel, the engine picks the card by default (and
raises without one), and
``chip_smoke.py`` fails without a card or without the repository."""
import ast
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"


def _imported_modules(path: Path) -> set:
    mods = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            mods.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            mods.add(node.module)
    return mods


def _foreign(mod: str) -> bool:
    top = mod.split(".")[0]
    return top in ("jax", "jaxlib", "repro")


@pytest.mark.parametrize("path", sorted(str(p.relative_to(ROOT)) for p in
                                        PORT.rglob("*.py")) + ["chip_smoke.py"])
def test_no_jax_or_reference_imports(path):
    bad = sorted(m for m in _imported_modules(ROOT / path) if _foreign(m))
    assert not bad, f"{path} imports {bad}"


def test_kernel_paths_call_no_library_kernel():
    """The wrappers and CUDA sources launch only the hand-written kernels;
    library calls belong to the plain versions (ref.py) alone. Each kernel
    of ``KERNELS`` has one wrapper and one source, and the source names the
    Pallas kernel, or the reference's host function, that it replaces."""
    from repro_torch.kernels import KERNELS
    banned_attrs = {"matmul", "mm", "bmm", "compile", "linear", "einsum",
                    "scaled_dot_product_attention", "embedding_bag"}
    wrappers = sorted(p for p in PORT.joinpath("kernels").rglob("*.py")
                      if p.name not in ("ref.py", "ops.py", "__init__.py"))
    assert wrappers == sorted(      # _lib.py + one wrapper per kernel
        [PORT / "kernels" / "_lib.py"]
        + [ROOT / "src" / (k.wrapper.replace(".", "/") + ".py")
           for k in KERNELS.values()])
    for p in wrappers:
        for node in ast.walk(ast.parse(p.read_text())):
            assert not (isinstance(node, ast.BinOp)
                        and isinstance(node.op, ast.MatMult)), p.name
            assert not (isinstance(node, ast.Attribute)
                        and node.attr in banned_attrs), (p.name, node.attr)
    sources = sorted(PORT.joinpath("csrc").glob("*.cu*"))
    assert [p for p in sources if p.suffix == ".cu"] == sorted(
        ROOT / k.source for k in KERNELS.values())   # one .cu per kernel
    assert [p.name for p in sources if p.suffix != ".cu"] == ["gemm.cuh"]
    for p in sources:
        text = p.read_text().lower()
        assert "cublas" not in text and "cudnn" not in text, p.name
    for k in KERNELS.values():      # each names what it replaces
        replaced = k.replaces.split(":")[0]
        assert (ROOT / replaced).is_file(), k
        what = ("pallas kernel" if replaced.startswith("src/repro/kernels/")
                else "reference's host function")
        assert f"replaces the {what}" in (ROOT / k.source).read_text().lower(), \
            k.source


def test_port_states_no_tpu_figures():
    for p in PORT.rglob("*"):
        if p.suffix in (".py", ".cu", ".cuh"):
            text = p.read_text()
            for word in ("v5e", "VMEM", "MXU", "819 GB"):
                assert word not in text, f"{p.relative_to(ROOT)}: {word}"


def test_query_in_fresh_process_loads_neither_jax_nor_reference():
    code = (
        "import sys\n"
        "from repro_torch.core import GredoEngine\n"
        "from repro_torch.data import m2bench\n"
        "from repro_torch.launch import serve\n"
        "eng = GredoEngine(m2bench.generate(sf=1, seed=0), device='cpu')\n"
        "r = eng.query(m2bench.q_g3())\n"
        "out = eng.analyze(m2bench.a3_multiply())\n"
        "assert r.nrows > 0 and out.shape[0] == out.shape[1]\n"
        "serve.main(['--device', 'cpu', '--gen', '4'])\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in\n"
        "       ('jax', 'jaxlib', 'repro')]\n"
        "assert not bad, bad\n"
        "print('clean')\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip().endswith("clean")


def test_engine_defaults_to_the_card():
    from repro_torch.core import Database, GredoEngine
    if torch.cuda.is_available():
        assert GredoEngine(Database()).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            GredoEngine(Database())
    assert GredoEngine(Database(), device="cpu").device.type == "cpu"


def _run_smoke(cwd: Path, script: Path):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    return subprocess.run([sys.executable, str(script)], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_chip_smoke_fails_alone_in_a_directory(tmp_path):
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    res = _run_smoke(tmp_path, tmp_path / "chip_smoke.py")
    assert res.returncode != 0
    assert '"ok": true' not in res.stdout


def test_chip_smoke_fails_without_a_card():
    if torch.cuda.is_available():
        assert torch.cuda.device_count() >= 1      # the card run is elsewhere
        return
    res = _run_smoke(ROOT, ROOT / "chip_smoke.py")
    assert res.returncode != 0
    assert '"ok": true' not in res.stdout
