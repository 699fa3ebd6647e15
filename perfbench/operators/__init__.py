"""Operator generators, one module per generator, found by the name a
configuration's ``operator.generator`` gives.

Each module has ``make(**params) -> Operator``: a square sparse matrix in
CSR on the host, float64 values, int64 indices.  The operator belongs to
the deployment (its configuration fixes every parameter), so it is the
same in every run of a cell.  A module that sets ``CACHE = True`` has its
operator kept in a cache directory after the first run that makes it
(``build/perfbench/operators`` inside the checkout), at a fixed path
named by the generator and its parameters, so that later runs load it
instead of making it again.
"""
from __future__ import annotations

import dataclasses
import hashlib
import importlib
import json
import os
import shutil
from pathlib import Path

import numpy as np

__all__ = ["Operator", "generate"]


@dataclasses.dataclass
class Operator:
    """A square CSR matrix: ``indptr`` ``(n + 1,)``, ``indices`` and
    ``data`` ``(nnz,)``, columns ascending within each row."""

    indptr: np.ndarray
    indices: np.ndarray
    data: np.ndarray

    @property
    def n(self) -> int:
        return len(self.indptr) - 1

    @property
    def nnz(self) -> int:
        return int(self.indptr[-1])


def _load(path: Path) -> Operator:
    return Operator(indptr=np.load(path / "indptr.npy"),
                    indices=np.load(path / "indices.npy").astype(np.int64),
                    data=np.load(path / "data.npy"))


def _save(op: Operator, path: Path) -> None:
    """Write ``op`` beside ``path`` and move it into place whole, so that a
    run cut while writing leaves no half operator behind."""
    tmp = path.with_name(f"{path.name}.part{os.getpid()}")
    tmp.mkdir(parents=True, exist_ok=True)
    np.save(tmp / "indptr.npy", op.indptr)
    np.save(tmp / "indices.npy", op.indices.astype(np.int32))
    np.save(tmp / "data.npy", op.data)
    try:
        tmp.rename(path)
    except OSError:             # another run put it there first
        shutil.rmtree(tmp, ignore_errors=True)


def generate(spec: dict, cache: Path | None = None) -> Operator:
    """The operator a configuration's ``operator`` entry names:
    ``{"generator": <module name>, **params}``, from ``cache`` where the
    generator allows it and a run has put it there."""
    params = dict(spec)
    name = params.pop("generator")
    mod = importlib.import_module(f"perfbench.operators.{name}")
    if cache is None or not getattr(mod, "CACHE", False):
        return mod.make(**params)
    key = hashlib.sha256(json.dumps(spec, sort_keys=True).encode()).hexdigest()
    path = Path(cache) / f"{name}-{key[:16]}"
    if path.is_dir():
        return _load(path)
    op = mod.make(**params)
    if op.n < 2**31:
        _save(op, path)
    return op
