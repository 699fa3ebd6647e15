"""The shipped Krylov solvers: ``cg`` (so far).

``cg``  preconditioned CG, two cross-shard reductions per iteration (p·Ap,
        then the stacked [r·z, r·r]).  It runs on ``(nrhs, n_node, n_core,
        rc_pad)`` blocks with per-RHS freezing: a converged column's state
        is carried through bit-unchanged while the rest iterate.
"""
from __future__ import annotations

import torch

from repro_torch.solvers.base import (Solver, SolverCtx, pdot, pdot_stack,
                                      register_solver)

__all__ = ["CGSolver"]


def _gate(active, new, old):
    """Freeze converged RHS columns: keep ``old`` where ``active`` is off."""
    a = active.reshape(active.shape + (1,) * (new.dim() - active.dim()))
    return torch.where(a, new, old)


class CGSolver(Solver):
    """Preconditioned CG (2 cross-shard reductions per iteration)."""

    name = "cg"

    def loop_setup(self, ctx: SolverCtx, b, tol, maxiter):
        z0 = ctx.precond(b)
        s0 = pdot_stack((b, b), (b, z0))       # [b·b, r0·z0], one reduction
        bnorm = torch.sqrt(s0[0])
        tol2 = (tol * torch.clamp(bnorm, min=1e-30)) ** 2
        aux = {"cap": maxiter, "bnorm": bnorm, "tol2": tol2}
        nrhs = b.shape[0]
        state = {"k": torch.zeros((nrhs,), dtype=torch.int32,
                                  device=b.device),
                 "x": torch.zeros_like(b), "r": b, "p": z0, "rz": s0[1],
                 "rr": s0[0]}
        return aux, state

    def loop_active(self, ctx: SolverCtx, aux, state):
        return (state["k"] < aux["cap"]) & (state["rr"] > aux["tol2"])

    def loop_body(self, ctx: SolverCtx, aux, state):
        k, x, r, p = state["k"], state["x"], state["r"], state["p"]
        rz, rr = state["rz"], state["rr"]
        active = (k < aux["cap"]) & (rr > aux["tol2"])
        ap = ctx.spmv(p)
        den = pdot(p, ap)                      # reduction 1
        alpha = (rz / den)[:, None, None, None]
        x = _gate(active, x + alpha * p, x)
        r = _gate(active, r - alpha * ap, r)
        z = ctx.precond(r)
        s = pdot_stack((r, z), (r, r))         # reduction 2: [r·z, r·r]
        beta = (s[0] / rz)[:, None, None, None]
        p = _gate(active, z + beta * p, p)
        return {"k": k + active.to(k.dtype), "x": x, "r": r, "p": p,
                "rz": _gate(active, s[0], rz), "rr": _gate(active, s[1], rr)}

    def loop_finish(self, ctx: SolverCtx, aux, state):
        rel = torch.sqrt(state["rr"]) / torch.clamp(aux["bnorm"], min=1e-30)
        return state["x"], state["k"], rel


register_solver(CGSolver())
