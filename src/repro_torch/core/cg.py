"""Distributed Conjugate Gradient with Jacobi preconditioning.

The paper's benchmark (Sec. 3): pressure matrices "solved using the
Conjugate Gradient method with a Jacobi preconditioner and the number of
iterations was limited to 10,000".  SpMV dominates the iteration cost.

``cg_solve`` is the *unfused* baseline: vectors in CG layout, dots as one
sum over the whole array, the SpMV re-entered each iteration.  ``make_cg``
is the historical entry point; ``fused=True`` returns the registry ``cg``
solver with ``jacobi`` (``repro_torch.solvers.make_solver``), whose dots
keep the per-shard partial + cross-shard sum grouping.

Both run ``check_every`` gated iterations between host syncs (see
``repro_torch.solvers.base``), so the iteration count is exact with no
``.item()`` per iteration.
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.core.spmv import SpMVPlan, make_spmv

__all__ = ["cg_solve", "make_cg"]


def cg_solve(spmv: Callable, b: torch.Tensor, m_inv: torch.Tensor,
             mask: torch.Tensor, tol: float, maxiter: int,
             check_every: int = 16, mesh=None):
    """Preconditioned CG; all vectors in CG layout.

    Returns ``(x, iters, rel_residual)``, the scalars as 0-d tensors.  On
    a process ``mesh`` the vectors are the rank's shard and each dot is
    the rank's partial summed over the ranks (``psum``), so its rounding
    is the fused solver's, not the one full-array sum of the virtual
    mesh.
    """
    # the solvers import the core package, so the core imports them late
    from repro_torch.core.collectives import psum
    from repro_torch.solvers.base import local_dot

    def _dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """Full-array f32 dot on CG-layout vectors (any shape) -> scalar."""
        if mesh is not None and mesh.is_process:
            return psum(local_dot(a, b), mesh=mesh)
        return local_dot(a.reshape(-1), b.reshape(-1))

    if check_every < 1:
        raise ValueError(f"check_every must be >= 1, got {check_every}")
    dev = b.device
    tol = torch.tensor(tol, dtype=torch.float32, device=dev)
    cap = torch.tensor(maxiter, dtype=torch.int32, device=dev)
    b = b * mask
    bnorm = torch.sqrt(_dot(b, b))
    tol2 = (tol * torch.clamp(bnorm, min=1e-30)) ** 2

    x = torch.zeros_like(b)
    r = b
    z = m_inv * r
    p = z
    rz = _dot(r, z)
    rr = _dot(r, r)
    k = torch.zeros((), dtype=torch.int32, device=dev)

    def active():
        return (k < cap) & (rr > tol2)

    while bool(active()):                       # one host sync per block
        for _ in range(check_every):
            a = active()
            ap = spmv(p)
            alpha = rz / _dot(p, ap)
            x = torch.where(a, x + alpha * p, x)
            r = torch.where(a, r - alpha * ap, r)
            z = m_inv * r
            rz_new = _dot(r, z)
            beta = rz_new / rz
            p = torch.where(a, z + beta * p, p)
            rz = torch.where(a, rz_new, rz)
            rr = torch.where(a, _dot(r, r), rr)
            k = k + a.to(k.dtype)
    rel = torch.sqrt(rr) / torch.clamp(bnorm, min=1e-30)
    return x, k, rel


def make_cg(plan: SpMVPlan, fused: bool = False, check_every: int = 16,
            transport: str | None = None, neighbor_offsets=None,
            wire_dtype: str | None = None):
    """Bundle a plan into ``solve(b, tol=..., maxiter=...)`` returning
    ``(x, iters, rel_residual)`` with ``x`` in CG layout.

    ``fused=True`` returns the registry ``cg`` solver with the ``jacobi``
    preconditioner instead — same return contract.  ``transport`` /
    ``neighbor_offsets`` / ``wire_dtype`` select the halo exchange as in
    ``make_spmv`` (``"auto"`` autotunes first).
    """
    from repro_torch.solvers.base import make_solver
    from repro_torch.solvers.precond import jacobi_inverse

    if fused:
        return make_solver(plan, solver="cg", precond="jacobi",
                           transport=transport,
                           neighbor_offsets=neighbor_offsets,
                           wire_dtype=wire_dtype, check_every=check_every)
    spmv = make_spmv(plan, transport=transport,
                     neighbor_offsets=neighbor_offsets,
                     wire_dtype=wire_dtype)
    m_inv = jacobi_inverse(plan.diag_a, plan.mask)

    def solve(b: torch.Tensor, tol: float = 1e-8, maxiter: int = 10_000):
        return cg_solve(spmv, b, m_inv, plan.mask, tol, maxiter,
                        check_every=check_every, mesh=plan.mesh)

    solve.spmv = spmv
    solve.transport = spmv.transport
    solve.wire_dtype = spmv.wire_dtype
    return solve
