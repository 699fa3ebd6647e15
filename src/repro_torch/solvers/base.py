"""Krylov solver registry + the solve factory, on a virtual mesh.

Every solver is a named plugin supplying the loop hooks; everything around
it — the two-phase SpMV body, the preconditioner application, the VecDot
reductions — is shared machinery owned by this module.

A solver sees the world through a :class:`SolverCtx`:

  * ``ctx.spmv``    — the distributed SpMV on ``(nrhs, n_node, n_core,
                      rc_pad)`` blocks;
  * ``ctx.precond`` — shard-local ``z = M^-1 r``;
  * ``pdot`` / ``pdot_stack`` — the VecDot split: the per-shard local
                      partial (:func:`local_dot`), then a sum over the
                      shards — the JAX package's ``psum``, in the same
                      two-stage grouping.

Vectors inside a solver loop are ``(nrhs, n_node, n_core, rc_pad)``; the
unbatched path is the same code with ``nrhs == 1``.  A converged RHS is
frozen (its state kept bit-for-bit) while the rest iterate.

The JAX package runs the loop as one ``while_loop`` on the device.  Here
the loop is Python: ``check_every`` iterations run between host syncs,
each gated by the per-RHS ``active`` flag, so the extra iterations after
convergence change nothing and the iteration count stays exact, with no
``.item()`` per iteration.

``make_solver`` is the user entry point::

    solve = make_solver(plan, solver="cg", precond="jacobi")
    x, iters, rel = solve(bd, tol=1e-6, maxiter=10_000)
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from repro_torch.solvers.precond import Preconditioner, get_precond

__all__ = ["local_dot", "pdot", "pdot_stack", "SolverCtx", "Solver",
           "register_solver", "get_solver", "available_solvers",
           "make_solver", "to_dist_batch", "from_dist_batch"]


# --------------------------------------------------------------------- #
# the VecDot pattern
# --------------------------------------------------------------------- #
def local_dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Local f32 dot over the trailing axis (no cross-shard sum): one
    partial per leading index, e.g. ``(nrhs, n_node, n_core)``."""
    return (a.to(torch.float32) * b.to(torch.float32)).sum(-1)


def pdot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """VecDot on ``(nrhs, n_node, n_core, rc_pad)``: per-shard partials,
    then the sum over the shards -> ``(nrhs,)``."""
    return local_dot(a, b).sum(dim=(-2, -1))


def pdot_stack(*pairs) -> torch.Tensor:
    """k VecDots stacked into one ``(k, nrhs)`` reduction."""
    return torch.stack([local_dot(a, b) for a, b in pairs]).sum(dim=(-2, -1))


# --------------------------------------------------------------------- #
# solver protocol
# --------------------------------------------------------------------- #
@dataclasses.dataclass(frozen=True)
class SolverCtx:
    """Everything a solver's loop may touch, pre-bound by make_solver."""

    spmv: Callable[[torch.Tensor], torch.Tensor]
    precond: Callable[[torch.Tensor], torch.Tensor]


class Solver:
    """Interface of a registered Krylov solver.

    Subclasses set ``name`` and implement the loop hooks.  The state is a
    ``dict[str, torch.Tensor]`` that carries ``"x"`` (the iterate) and
    ``"k"`` (per-RHS iteration count, int32).  :meth:`shard_loop` composes
    ``loop_setup``, ``loop_body`` and ``loop_finish``.
    """

    name: str = ""

    def lossy_wire_options(self) -> dict:
        """Option defaults for a lossy halo wire codec (bf16/int8): a
        quantised SpMV is a different perturbed operator on every call,
        and a solver whose recurrences amplify that would tighten its
        options here.  ``cg`` needs none."""
        return {}

    def loop_setup(self, ctx: SolverCtx, b, tol, maxiter):
        """``(aux, initial state)``."""
        raise NotImplementedError

    def loop_active(self, ctx: SolverCtx, aux: dict, state: dict):
        """Per-RHS ``(nrhs,)`` bool: which columns are still iterating."""
        raise NotImplementedError

    def loop_cond(self, ctx: SolverCtx, aux: dict, state: dict):
        """Scalar bool tensor: any RHS still iterating?"""
        return torch.any(self.loop_active(ctx, aux, state))

    def loop_body(self, ctx: SolverCtx, aux: dict, state: dict) -> dict:
        """One gated iteration on the state dict."""
        raise NotImplementedError

    def loop_finish(self, ctx: SolverCtx, aux: dict, state: dict):
        """``(x, iters, rel)`` from a final state."""
        raise NotImplementedError

    def shard_loop(self, ctx: SolverCtx, b: torch.Tensor, tol: torch.Tensor,
                   maxiter: torch.Tensor, check_every: int = 16):
        """Run the iteration on ``(nrhs, n_node, n_core, rc_pad)`` blocks.

        ``check_every`` gated iterations run between host syncs; the loop
        stops at the first sync that finds no active RHS.  Returns
        ``(x, iters, rel)``: ``x`` shaped like ``b``, ``iters``/``rel``
        ``(nrhs,)``.
        """
        if check_every < 1:
            raise ValueError(f"check_every must be >= 1, got {check_every}")
        aux, state = self.loop_setup(ctx, b, tol, maxiter)
        while bool(self.loop_cond(ctx, aux, state)):    # one host sync
            for _ in range(check_every):
                state = self.loop_body(ctx, aux, state)
        return self.loop_finish(ctx, aux, state)


_SOLVERS: dict[str, Solver] = {}


def register_solver(solver: Solver, overwrite: bool = False) -> Solver:
    """Register ``solver`` under ``solver.name`` for lookup by name."""
    if not solver.name:
        raise ValueError("a Solver needs a non-empty name")
    if solver.name in _SOLVERS and not overwrite:
        raise ValueError(f"solver {solver.name!r} is already registered "
                         "(pass overwrite=True to replace it)")
    _SOLVERS[solver.name] = solver
    return solver


def get_solver(solver: str | Solver) -> Solver:
    """Resolve a solver name (or pass through an instance)."""
    if isinstance(solver, Solver):
        return solver
    try:
        return _SOLVERS[solver]
    except KeyError:
        raise ValueError(f"unknown solver {solver!r}; available: "
                         f"{available_solvers()}") from None


def available_solvers() -> tuple[str, ...]:
    return tuple(sorted(_SOLVERS))


# --------------------------------------------------------------------- #
# batched vector layout helpers
# --------------------------------------------------------------------- #
def to_dist_batch(B, layout: dict, plan) -> torch.Tensor:
    """Stack ``(nrhs, n)`` global RHS columns into the batched CG layout
    ``(n_node, n_core, nrhs, rc_pad)`` (the JAX package's layout)."""
    from repro_torch.core.spmv import to_dist
    return torch.stack([to_dist(b, layout, plan) for b in B], dim=2)


def from_dist_batch(xd: torch.Tensor, layout: dict, plan) -> np.ndarray:
    """Inverse of :func:`to_dist_batch` -> ``(nrhs, n)`` numpy array."""
    from repro_torch.core.spmv import from_dist
    return np.stack([from_dist(xd[:, :, j], layout, plan)
                     for j in range(xd.shape[2])])


# --------------------------------------------------------------------- #
# the factory
# --------------------------------------------------------------------- #
def make_solver(plan, *, solver: str | Solver = "cg",
                precond: str | Preconditioner = "jacobi",
                transport: str | None = None,
                neighbor_offsets: list[int] | None = None,
                wire_dtype: str | None = None,
                nrhs: int | None = None, check_every: int = 16):
    """Bundle a plan and a registered solver/preconditioner pair into
    ``solve(b, tol=..., maxiter=...)`` on the plan's device.

    ``nrhs=None``: ``b`` is one RHS in CG layout ``(n_node, n_core,
    rc_pad)`` and ``iters``/``rel`` are 0-d tensors.  ``nrhs=k``: ``b`` is
    the batched layout ``(n_node, n_core, k, rc_pad)``
    (:func:`to_dist_batch`) and ``iters``/``rel`` are ``(k,)``.

    ``transport`` selects the halo exchange by name (``None`` follows the
    plan's stamp; ``"auto"`` autotunes the SpMV on the plan's device first
    and uses the stamped winner), ``neighbor_offsets`` overrides
    ring/pairwise's offsets, ``wire_dtype`` the halo wire codec (``None``
    follows ``plan.wire_dtype``); exposed as ``solve.transport`` /
    ``solve.wire_dtype``.

    ``check_every`` is the number of gated iterations between host syncs.
    """
    from repro_torch.core.spmv import make_shard_body

    # resolve every name first: an unknown solver/precond raises before
    # transport="auto" spends time on candidate SpMVs
    sol = get_solver(solver)
    pre = get_precond(precond)
    transport = transport if transport is not None else plan.transport
    if transport == "auto":     # explicit, or a deferred plan stamp
        from repro_torch.core.transport import autotune_transport
        transport = autotune_transport(
            plan, neighbor_offsets=neighbor_offsets,
            wire_dtype=wire_dtype).winner
    body = make_shard_body(plan, transport=transport,
                           neighbor_offsets=neighbor_offsets,
                           wire_dtype=wire_dtype)
    pdata = pre.build(plan)
    ctx = SolverCtx(spmv=lambda v: torch.stack([body(vj) for vj in v]),
                    precond=lambda r: pre.apply(pdata, r))
    batched = nrhs is not None

    def solve(b: torch.Tensor, tol: float = 1e-8, maxiter: int = 10_000):
        if batched:
            if b.dim() != 4 or b.shape[2] != nrhs:
                raise ValueError(f"solve: expected (n_node, n_core, {nrhs}, "
                                 f"rc_pad), got {tuple(b.shape)}")
            bb = b.permute(2, 0, 1, 3)              # (nrhs, n_node, ...)
        else:
            bb = b[None]
        tol_t = torch.tensor(tol, dtype=torch.float32, device=plan.device)
        maxiter_t = torch.tensor(maxiter, dtype=torch.int32,
                                 device=plan.device)
        x, iters, rel = sol.shard_loop(ctx, bb * plan.mask, tol_t,
                                       maxiter_t, check_every=check_every)
        if not batched:
            return x[0], iters[0], rel[0]
        return x.permute(1, 2, 0, 3), iters, rel

    solve.solver = sol.name
    solve.precond = pre.name
    solve.transport = body.transport
    solve.wire_dtype = body.wire_dtype
    return solve
