"""The fused CG entry point: the registry ``cg`` solver with ``jacobi``."""
from __future__ import annotations

from repro_torch.core.spmv import SpMVPlan

__all__ = ["make_fused_cg"]


def make_fused_cg(plan: SpMVPlan, check_every: int = 16):
    """``solve(b, tol=..., maxiter=...)`` -> ``(x, iters, rel_residual)``,
    all vectors in CG layout.  Equivalent to ``make_solver(plan,
    solver="cg", precond="jacobi", ...)``."""
    # the solvers import the core package, so the core imports them late
    from repro_torch.solvers.base import make_solver

    return make_solver(plan, solver="cg", precond="jacobi",
                       check_every=check_every)
