"""Repository-wide pytest set-up.

* Applies the jax >= 0.9 compatibility shim (``tests/_jaxcompat``) before
  any test module imports the JAX reference package, and prepends the
  shim's directory to ``PYTHONPATH`` so subprocesses inherit it (as
  ``sitecustomize``).  Done here, once per process, rather than in single
  test files: under ``pytest-xdist --dist loadfile`` a patch applied by one
  file would make other files pass or fail by worker placement.
* Registers the ``cuda`` marker for tests that need an NVIDIA card.
"""
from __future__ import annotations

import importlib.util
import os
import sys

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


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU with nvcc (skipped without one)")
