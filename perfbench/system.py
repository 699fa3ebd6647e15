"""The system under test, as the benchmark drives it: ``repro_torch``'s
plan (``build_spmv_plan``) and what a traffic generator needs around its
solver (``make_solver``: cg + jacobi on the plan's SELL kernels): the
placement of a right-hand side into the solver's layout by the layout's
own slot table, the one ``to_dist`` reads, the way back for the kept
answers, a deadline for a solve, and the check that no JAX was loaded.
"""
from __future__ import annotations

import contextlib
import importlib
import signal
import sys
import time

import numpy as np
import torch

__all__ = ["Late", "build_plan", "deadline", "plant", "port_csr",
           "Placement", "assemble", "forbidden_modules"]

#: top-level module names that may not be loaded in a run (the JAX package
#: and JAX itself), compared as whole names: ``repro_torch`` is not ``repro``
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_modules(modules=None) -> list:
    """The names of :data:`FORBIDDEN` among the top-level names of
    ``modules`` (default: this process's ``sys.modules``)."""
    names = list(sys.modules) if modules is None else modules
    return sorted({m.split(".")[0] for m in names} & set(FORBIDDEN))


class Late(Exception):
    """A solve had not returned by its deadline."""


@contextlib.contextmanager
def deadline(seconds: float):
    """Raise :class:`Late` in this (main) thread if the block is still
    running after ``seconds``."""
    def ring(signum, frame):
        raise Late(f"still running after {seconds:.1f} s")
    old = signal.signal(signal.SIGALRM, ring)
    signal.setitimer(signal.ITIMER_REAL, max(seconds, 1e-3))
    try:
        yield
    finally:
        signal.setitimer(signal.ITIMER_REAL, 0)
        signal.signal(signal.SIGALRM, old)


def plant(spec: str | None) -> None:
    """Call ``module:function`` (a test's fault, planted underneath the
    timed path) in this process; ``None`` plants nothing."""
    if spec:
        mod, fn = spec.split(":")
        getattr(importlib.import_module(mod), fn)()


def port_csr(op):
    """The benchmark's operator as the program's host CSR type."""
    from repro_torch.sparse.csr import CSRMatrix

    return CSRMatrix(indptr=op.indptr, indices=op.indices, data=op.data,
                     shape=(op.n, op.n))


def build_plan(op, plan_cfg: dict, device) -> tuple:
    """``build_spmv_plan`` on the operator: ``(plan, layout, seconds)``,
    the seconds on the host clock around the call (placement on
    ``device`` included)."""
    from repro_torch.core import build_spmv_plan

    A = port_csr(op)
    t0 = time.perf_counter()
    plan, layout = build_spmv_plan(
        A, plan_cfg["n_node"], plan_cfg["n_core"], mode=plan_cfg["mode"],
        format=plan_cfg["format"], transport=plan_cfg["transport"],
        device=device)
    return plan, layout, time.perf_counter() - t0


class Placement:
    """A global vector ``(n,)`` on the device -> the solver's layout
    ``plan.cg_shape``, by the slot table ``g`` (``layout["global_row_of"]``):
    slot ``s`` holds row ``g[s]``, a pad slot (``g < 0``) holds 0."""

    def __init__(self, g: np.ndarray, device):
        g = torch.from_numpy(np.ascontiguousarray(g)).to(device)
        self.valid = g >= 0
        self.idx = torch.where(self.valid, g, torch.zeros_like(g))

    def __call__(self, v: torch.Tensor) -> torch.Tensor:
        return torch.where(self.valid, v[self.idx], torch.zeros((), dtype=v.dtype,
                                                                 device=v.device))


def assemble(x: np.ndarray, g: np.ndarray, n: int) -> np.ndarray:
    """The whole vector ``(n,)`` from a block ``x`` of the solver's layout
    (``(n_node, n_core, rc_pad)``) and its slot table ``g``."""
    out = np.zeros(n, dtype=x.dtype)
    ok = g >= 0
    out[g[ok]] = x[ok]
    return out
