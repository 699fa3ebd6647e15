"""Repository-wide pytest set-up.

* Applies the jax >= 0.9 compatibility shim (``tests/_jaxcompat``) before
  any test module imports the JAX reference package, and prepends the
  shim's directory to ``PYTHONPATH`` so subprocesses inherit it (as
  ``sitecustomize``).  Done here, once per process, rather than in single
  test files: under ``pytest-xdist --dist loadfile`` a patch applied by one
  file would make other files pass or fail by worker placement.
* Registers the ``cuda`` marker for tests that need an NVIDIA card.
* Restores the solver and preconditioner registries of both packages
  after each test, for the same reason: ``tests/test_solvers.py``
  registers names that ``tests/test_precond.py``'s conformance sweep
  would then expect in its subprocess's output when both files share a
  worker, and a solver a port test registers would leak into another
  file's ``available_solvers()``.
"""
from __future__ import annotations

import importlib.util
import os
import sys

import pytest

#: module -> registry dict restored after every test (if the module is
#: loaded; this file never imports the JAX package itself)
_REGISTRIES = (("repro.solvers.base", "_SOLVERS"),
               ("repro.solvers.precond", "_PRECONDS"),
               ("repro_torch.solvers.base", "_SOLVERS"),
               ("repro_torch.solvers.precond", "_PRECONDS"))

_SHIM_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         "tests", "_jaxcompat")


def _install_jax_shim() -> None:
    if _SHIM_DIR not in sys.path:
        sys.path.insert(0, _SHIM_DIR)
    paths = os.environ.get("PYTHONPATH", "")
    if _SHIM_DIR not in paths.split(os.pathsep):
        os.environ["PYTHONPATH"] = (_SHIM_DIR + os.pathsep + paths
                                    if paths else _SHIM_DIR)
    spec = importlib.util.spec_from_file_location(
        "_repro_jaxcompat", os.path.join(_SHIM_DIR, "sitecustomize.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)        # runs apply()


_install_jax_shim()


@pytest.fixture(autouse=True)
def _restore_registries():
    saved = []
    for mod, attr in _REGISTRIES:
        reg = getattr(sys.modules.get(mod), attr, None)
        if reg is not None:
            saved.append((reg, dict(reg)))
    yield
    for reg, before in saved:
        reg.clear()
        reg.update(before)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU with nvcc (skipped without one)")
