"""The port stands apart from the JAX package and imports without a card.

* An AST scan of every module under ``src/repro_torch/``, of
  ``chip_smoke.py`` and of ``examples/cg_solve_torch.py``: no ``jax`` or ``repro`` import anywhere, no ``triton``
  import at module level, and no ``torch.sparse`` on the port's path.
* Importing every ``repro_torch`` module in a fresh interpreter on this
  CPU-only machine works and pulls in neither ``jax`` nor ``repro``.
* ``chip_smoke.py`` refuses to run without CUDA, and alone in a directory.
"""
import ast
import os
import pathlib
import re
import shutil
import subprocess
import sys

import pytest

REPO = pathlib.Path(__file__).resolve().parents[1]
PKG = REPO / "src" / "repro_torch"
MODULES = sorted(PKG.rglob("*.py"))
FILES = MODULES + [REPO / "chip_smoke.py",
                   REPO / "examples" / "cg_solve_torch.py"]


def _imports(tree):
    """(module name, is_module_level) for every import in ``tree``."""
    top = set(map(id, tree.body))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name, id(node) in top
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module, id(node) in top


def test_scan_covers_every_module_of_the_port():
    """The scans below walk the whole package: the verifier, the
    preconditioners and the conformance checkers among them."""
    names = {str(p.relative_to(PKG)) for p in MODULES}
    assert {"analysis/__init__.py", "analysis/report.py",
            "analysis/plan_check.py", "analysis/kernel_check.py",
            "solvers/precond.py", "testing/rect_check.py",
            "testing/precond_check.py"} <= names


def _root(name: str) -> str:
    return name.split(".")[0]


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(REPO)))
def test_no_reference_or_toplevel_triton_import(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for name, top in _imports(tree):
        assert _root(name) not in ("jax", "jaxlib", "repro"), (path, name)
        if _root(name) == "triton":
            assert not top, f"{path}: triton imported at module level"


@pytest.mark.parametrize("path", MODULES, ids=lambda p: str(p.relative_to(REPO)))
def test_no_library_sparse_on_the_port_path(path):
    text = path.read_text()
    assert not re.search(r"(?<!\w)torch\.sparse", text), path
    assert "cusparse" not in text.lower(), path


def _clean_env():
    """This interpreter's environment minus the test-only jax shim."""
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO / "src")
    return env


def test_port_imports_without_cuda_or_jax():
    mods = sorted(".".join(p.relative_to(REPO / "src").with_suffix("").parts)
                  .removesuffix(".__init__") for p in MODULES)
    code = ("import sys, importlib\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro', 'triton')]\n"
            "assert not bad, bad\n"
            "print(len(sys.modules))\n")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=_clean_env(), timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]


def test_chip_smoke_fails_without_cuda():
    res = subprocess.run([sys.executable, str(REPO / "chip_smoke.py")],
                         capture_output=True, text=True, env=_clean_env(),
                         cwd=REPO, timeout=300)
    assert res.returncode != 0
    assert '"ok": true' not in res.stdout


def test_chip_smoke_fails_alone_in_a_directory(tmp_path):
    shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    res = subprocess.run([sys.executable, "chip_smoke.py"],
                         capture_output=True, text=True, env=env,
                         cwd=tmp_path, timeout=300)
    assert res.returncode != 0
    assert '"ok": true' not in res.stdout
