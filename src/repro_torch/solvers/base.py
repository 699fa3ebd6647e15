"""Krylov solver registry + the solve factory, on a virtual mesh.

Every solver is a named plugin supplying the loop hooks; everything around
it — the two-phase SpMV body, the preconditioner application, the VecDot
reductions — is shared machinery owned by this module.

A solver sees the world through a :class:`SolverCtx`:

  * ``ctx.spmv``    — the distributed SpMV on ``(nrhs, n_node, n_core,
                      rc_pad)`` blocks: one call of the shard body on the
                      whole block (one exchange, one batched kernel
                      launch for all columns; a block of one runs the
                      single-column kernels);
  * ``ctx.precond`` — shard-local ``z = M^-1 r``;
  * ``ctx.options`` — the solver's static options, resolved on the host by
                      ``Solver.prepare`` (e.g. Chebyshev's eigenvalue
                      bounds);
  * ``pdot`` / ``pdot_stack`` — the VecDot split: the per-shard local
                      partial (:func:`local_dot`), then ``psum`` over the
                      shards (``repro_torch.core.collectives``), in the
                      JAX package's two-stage grouping.  Each call is one
                      cross-shard reduction; :func:`reduction_census`
                      counts them over one loop body.

Vectors inside a solver loop are ``(nrhs, n_node, n_core, rc_pad)``; the
unbatched path is the same code with ``nrhs == 1``.  A converged RHS is
frozen (its state kept bit-for-bit) while the rest iterate.

The JAX package runs the loop as one ``while_loop`` on the device.  Here
the loop is Python: ``check_every`` iterations run between host syncs,
each gated by the per-RHS ``active`` flag, so the extra iterations after
convergence change nothing and the iteration count stays exact, with no
``.item()`` per iteration.  The resilient driver
(``repro_torch.solvers.resilient``) runs the same ``loop_body`` in chunks;
since the monolithic entry (``loop_setup``) is ``loop_restart`` from
``x = 0``, a chunked solve lands on the monolithic iterate bit for bit.

``make_solver`` is the user entry point::

    solve = make_solver(plan, solver="pipelined_cg", precond="jacobi",
                        A=A, layout=layout)
    x, iters, rel = solve(bd, tol=1e-6, maxiter=10_000)
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Callable

import numpy as np
import torch

from repro_torch.core.collectives import (SOLVER_REDUCTION_OPS, psum,
                                         record_collectives)
from repro_torch.solvers.precond import Preconditioner, get_precond

__all__ = ["local_dot", "pdot", "pdot_stack", "SolverCtx", "Solver",
           "register_solver", "get_solver", "available_solvers",
           "make_solver", "to_dist_batch", "from_dist_batch",
           "count_reductions", "reduction_census", "make_precond_apply",
           "check_nrhs", "gather_dist_batch"]


# --------------------------------------------------------------------- #
# the VecDot pattern
# --------------------------------------------------------------------- #
@contextlib.contextmanager
def count_reductions():
    """Count the cross-shard reductions (the ``psum`` of every
    ``pdot``/``pdot_stack`` call) issued inside the block: ``with
    count_reductions() as n: ...`` leaves the count in ``n[0]`` when the
    block ends.  A view of ``record_collectives``; nested blocks each
    count what they enclose."""
    box = [0]
    with record_collectives() as log:
        try:
            yield box
        finally:
            box[0] = sum(c.kind in SOLVER_REDUCTION_OPS for c in log)


def local_dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Local f32 dot over the trailing axis (no cross-shard sum): one
    partial per leading index, e.g. ``(nrhs, n_node, n_core)``."""
    return (a.to(torch.float32) * b.to(torch.float32)).sum(-1)


def pdot(a: torch.Tensor, b: torch.Tensor, *, mesh=None) -> torch.Tensor:
    """VecDot on ``(nrhs, n_node, n_core, rc_pad)``: per-shard partials,
    then the ``psum`` over the shards -> ``(nrhs,)``.  One reduction.  On
    a process ``mesh`` the blocks are the rank's ``(nrhs, 1, 1, rc_pad)``
    and every rank gets the same sum."""
    return psum(local_dot(a, b), mesh=mesh)


def pdot_stack(*pairs, mesh=None) -> torch.Tensor:
    """k VecDots stacked into one ``(k, nrhs)`` reduction."""
    return psum(torch.stack([local_dot(a, b) for a, b in pairs]), mesh=mesh)


# --------------------------------------------------------------------- #
# solver protocol
# --------------------------------------------------------------------- #
@dataclasses.dataclass(frozen=True)
class SolverCtx:
    """Everything a solver's loop may touch, pre-bound by make_solver.

    ``spmv``/``precond`` act on ``(nrhs, n_node, n_core, rc_pad)`` blocks;
    ``maxiter_static`` caps every solve's ``maxiter``; ``options`` holds
    the solver-specific static options ``Solver.prepare`` resolved;
    ``mesh`` is the plan's process mesh (``None`` on the virtual mesh),
    which every ``pdot`` of the loop names.
    """

    spmv: Callable[[torch.Tensor], torch.Tensor]
    precond: Callable[[torch.Tensor], torch.Tensor]
    maxiter_static: int = 10_000
    options: dict = dataclasses.field(default_factory=dict)
    mesh: object | None = None


class Solver:
    """Interface of a registered Krylov solver.

    Subclasses set ``name`` and implement the loop hooks; ``prepare`` runs
    once on the host at build time and may derive static options from the
    matrix (Chebyshev estimates its eigenvalue bounds there).

    The same hooks serve two regimes: the monolithic :meth:`shard_loop`
    (``make_solver``) and the chunked resilient driver, which runs
    ``loop_body`` in bounded chunks with the state crossing the host
    between them.  The state is a ``dict`` that carries ``"x"`` (the
    iterate) and ``"k"`` (per-RHS iteration count, int32);
    :meth:`state_kinds` declares each entry a ``"vector"`` (``(nrhs,
    n_node, n_core, rc_pad)``) or a ``"scalar"`` (per-RHS ``(nrhs,)``, or
    a host ``int``).

    :meth:`loop_restart` rebuilds a valid state from any iterate ``x`` by
    a true-residual recompute (r = b − Ax) and a reset recurrence chain:
    the one recovery primitive behind cold start (the default
    :meth:`loop_setup` is a restart from ``x = 0``), rollback after
    corruption, and resume on another plan.  :meth:`state_to_global` /
    :meth:`state_from_global` move the checkpointable part of the state
    (the iterate) between a plan's layout and global row order.
    """

    name: str = ""
    #: cross-shard reductions one ``loop_body`` issues — the solver's side
    #: of the census contract (:func:`reduction_census` counts them)
    reductions_per_iter: int | None = None
    #: :meth:`guard_scalars` keys that must stay strictly positive while
    #: the solve is healthy (SPD breakdown: CG's rz and p·Ap)
    positive_scalars: tuple[str, ...] = ()
    #: whether a flat true-residual trajectory means the solve is stuck;
    #: a-priori-budget methods (Chebyshev) idle at their floor legitimately
    stagnation_guard: bool = True

    def prepare(self, plan, precond: Preconditioner, pdata: dict, A=None,
                layout=None, options: dict | None = None) -> dict:
        """Resolve static solve options on the host.  Default: passthrough."""
        return dict(options or {})

    def lossy_wire_options(self) -> dict:
        """Option defaults for a lossy halo wire codec (bf16/int8): a
        quantised SpMV is a different perturbed operator on every call,
        and a solver whose recurrences amplify that tightens its options
        here.  Merged under the caller's options by ``make_refine``."""
        return {}

    # -- the loop hooks ------------------------------------------------- #
    def state_kinds(self) -> dict[str, str]:
        """``{state key: "vector" | "scalar"}`` — the loop-state layout."""
        raise NotImplementedError(
            f"solver {self.name!r} does not implement the chunked-loop "
            "protocol (state_kinds)")

    def loop_aux(self, ctx: SolverCtx, b, tol, maxiter) -> dict:
        """Derived per-solve values (tolerances, caps, budgets), recomputed
        at every chunk entry: cheap and deterministic."""
        raise NotImplementedError

    def loop_restart(self, ctx: SolverCtx, aux: dict, b, x, k) -> dict:
        """State continuing from iterate ``x`` at iteration count ``k``:
        true-residual recompute + recurrence-chain reset."""
        raise NotImplementedError

    def loop_setup(self, ctx: SolverCtx, b, tol, maxiter):
        """Monolithic entry: ``(aux, initial state)`` — a restart from
        ``x = 0``, so cold start and the chunked driver are one path."""
        aux = self.loop_aux(ctx, b, tol, maxiter)
        k = torch.zeros((b.shape[0],), dtype=torch.int32, device=b.device)
        return aux, self.loop_restart(ctx, aux, b, torch.zeros_like(b), k)

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

    def guard_scalars(self, state: dict) -> dict:
        """The state scalars a host-side guard checks between chunks
        (finite? positive where SPD demands it?); ``{}`` for
        residual-free recurrences (Chebyshev)."""
        return {}

    # -- layout-independent checkpoint state ---------------------------- #
    def state_to_global(self, state_host: dict, layout: dict, plan) -> dict:
        """State -> checkpoint payload in global row order.  ``x`` is in
        batched layout ``(n_node, n_core, nrhs, rc_pad)``; the default
        persists the iterate alone, all ``loop_restart`` needs.  On a
        rank-local plan every rank calls this and rank 0 gets the whole
        payload (:func:`gather_dist_batch`); the others get ``None``."""
        x = gather_dist_batch(state_host["x"], layout, plan)
        return None if x is None else {"x": x}

    def state_from_global(self, gstate: dict, layout: dict, plan,
                          dtype=None) -> torch.Tensor:
        """Checkpoint payload -> the iterate in (possibly another) plan's
        batched layout ``(n_node, n_core, nrhs, rc_pad)``."""
        return to_dist_batch(np.atleast_2d(np.asarray(gstate["x"])),
                             layout, plan, dtype=dtype)

    # -- the monolithic composition (the make_solver path) -------------- #
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
        # one host sync per block; on a process mesh every rank reads the
        # same psum'd residuals, so all leave at the same block
        while bool(self.loop_cond(ctx, aux, state)):
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
def to_dist_batch(B, layout: dict, plan, dtype=None) -> torch.Tensor:
    """Stack ``(nrhs, n)`` global RHS columns into the batched CG layout
    ``(n_node, n_core, nrhs, rc_pad)`` (the JAX package's layout), in
    ``dtype`` (default: the plan's).  Packed on the host and moved in one
    transfer; column ``j`` is ``to_dist(B[j])`` byte for byte.  A
    rank-local plan gets its own shard ``(1, 1, nrhs, rc_pad)``."""
    from repro_torch.core.spmv import rank_rows
    g = rank_rows(layout["global_row_of"], plan)
    B = np.asarray(B)
    out = np.zeros(plan.cg_shape[:2] + (B.shape[0], plan.rc_pad),
                   dtype=B.dtype)
    ii, cc, ss = np.nonzero(g >= 0)
    out[ii, cc, :, ss] = B[:, g[ii, cc, ss]].T
    return torch.from_numpy(out).to(
        device=plan.device, dtype=plan.mask.dtype if dtype is None
        else dtype)


def from_dist_batch(xd: torch.Tensor, layout: dict, plan) -> np.ndarray:
    """Inverse of :func:`to_dist_batch` -> ``(nrhs, n)`` numpy array (one
    device-to-host copy); a rank-local plan fills only its own rows."""
    from repro_torch.core.spmv import rank_rows
    g = rank_rows(layout["global_row_of"], plan)
    xh = xd.detach().cpu().numpy()
    out = np.zeros((xh.shape[2], plan.n), dtype=xh.dtype)
    ii, cc, ss = np.nonzero(g >= 0)
    out[:, g[ii, cc, ss]] = xh[ii, cc, :, ss].T
    return out


def gather_dist_batch(xd: torch.Tensor, layout: dict, plan,
                      to: int | None = 0) -> np.ndarray | None:
    """:func:`from_dist_batch` of the whole mesh: on a rank-local plan
    every rank's rows gathered bit for bit into the whole ``(nrhs, n)``
    on rank ``to`` (``None`` on the others), or on every rank with
    ``to=None`` (``CGMesh.gather_rows``, host control).  On the virtual
    mesh :func:`from_dist_batch` itself."""
    if not getattr(plan, "is_rank_local", False):
        return from_dist_batch(xd, layout, plan)
    from repro_torch.core.spmv import rank_rows
    g = rank_rows(layout["global_row_of"], plan)
    xh = xd.detach().cpu().numpy()
    ii, cc, ss = np.nonzero(g >= 0)
    return plan.mesh.gather_rows(xh[ii, cc, :, ss].T, g[ii, cc, ss],
                                 plan.n, to=to)


def check_nrhs(nrhs: int | None) -> None:
    """Raise unless ``nrhs`` is ``None`` or fits one batched launch."""
    from repro_torch.kernels.ops import MAX_NRHS
    if nrhs is not None and not (isinstance(nrhs, int)
                                 and 1 <= nrhs <= MAX_NRHS):
        raise ValueError(f"nrhs must be None or an int in 1..{MAX_NRHS} "
                         f"(the columns one batched SpMV launch takes), got "
                         f"{nrhs!r}")


# --------------------------------------------------------------------- #
# the factory
# --------------------------------------------------------------------- #
def make_solver(plan, *, solver: str | Solver = "cg",
                precond: str | Preconditioner = "jacobi",
                transport: str | None = None,
                neighbor_offsets: list[int] | None = None,
                wire_dtype: str | None = None,
                maxiter_static: int = 10_000,
                nrhs: int | None = None, check_every: int = 16,
                A=None, layout: dict | None = None,
                options: dict | None = None,
                precond_options: dict | None = None):
    """Bundle a plan and a registered solver/preconditioner pair into
    ``solve(b, tol=..., maxiter=...)`` on the plan's device.

    ``nrhs=None``: ``b`` is one RHS in CG layout ``(n_node, n_core,
    rc_pad)`` and ``iters``/``rel`` are 0-d tensors.  ``nrhs=k``: ``b`` is
    the batched layout ``(n_node, n_core, k, rc_pad)``
    (:func:`to_dist_batch`) and ``iters``/``rel`` are ``(k,)``.

    ``A``/``layout`` (the host matrix and the layout dict from
    ``build_spmv_plan``) are needed only by build-time host work:
    ``solver="chebyshev"`` estimates its eigenvalue bounds from them when
    ``options`` does not pin ``lmin``/``lmax``, and ``block_jacobi`` /
    ``two_level`` build their blocks and coarse space from them (through
    ``Preconditioner.bind``).  ``options`` are the
    solver's (``pipelined_cg``'s ``replace_every``, Chebyshev's bounds),
    resolved by ``Solver.prepare`` and exposed as ``solve.options``;
    ``precond_options`` the preconditioner's.  Every ``maxiter`` is capped
    at ``maxiter_static``.

    ``transport`` selects the halo exchange by name (``None`` follows the
    plan's stamp; ``"auto"`` autotunes the SpMV on the plan's device first
    and uses the stamped winner), ``neighbor_offsets`` overrides
    ring/pairwise's offsets, ``wire_dtype`` the halo wire codec (``None``
    follows ``plan.wire_dtype``); exposed as ``solve.transport`` /
    ``solve.wire_dtype``.  ``solve.pdata`` / ``solve.papply`` are what
    ``Preconditioner.bind`` returned.

    ``nrhs`` is at most ``MAX_NRHS`` (16), the most columns one batched
    kernel launch takes.

    ``check_every`` is the number of gated iterations between host syncs.
    ``solve.parts(b, tol, maxiter)`` returns ``(solver, ctx, b block, tol,
    maxiter)`` as the loop sees them (:func:`reduction_census` runs one
    body on them).

    On a rank-local plan (a process mesh, ``plan.mesh``) every rank calls
    ``make_solver`` and ``solve`` alike, with its own shard of ``b``
    (``(1, 1, rc_pad)``, or ``(1, 1, k, rc_pad)``) and gets its shard of
    ``x``; the dots are ``psum``s over the ranks, so every rank stops at
    the same iteration.  ``"auto"`` times every candidate on every rank
    and picks one winner for all (``autotune_transport``); ``two_level``
    cuts its R and P plans to the rank.
    """
    from repro_torch.core.spmv import make_shard_body

    check_nrhs(nrhs)
    # resolve every name and option first: an unknown solver, precond or
    # option raises before transport="auto" spends time on candidate SpMVs
    sol = get_solver(solver)
    pre = get_precond(precond)
    pre.validate_options(precond_options)
    pdata, papply = pre.bind(plan, layout=layout, A=A,
                             options=precond_options)
    opts = sol.prepare(plan, pre, pdata, A=A, layout=layout, options=options)
    transport = transport if transport is not None else plan.transport
    if transport == "auto":     # explicit, or a deferred plan stamp
        from repro_torch.core.transport import autotune_transport
        transport = autotune_transport(
            plan, neighbor_offsets=neighbor_offsets,
            wire_dtype=wire_dtype).winner
    body = make_shard_body(plan, transport=transport,
                           neighbor_offsets=neighbor_offsets,
                           wire_dtype=wire_dtype)
    ctx = SolverCtx(spmv=body, precond=lambda r: papply(pdata, r),
                    maxiter_static=maxiter_static, options=opts,
                    mesh=plan.mesh)
    batched = nrhs is not None

    def parts(b: torch.Tensor, tol: float, maxiter: int):
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
        return sol, ctx, bb * plan.mask, tol_t, maxiter_t

    def solve(b: torch.Tensor, tol: float = 1e-8, maxiter: int = 10_000):
        _, _, bb, tol_t, maxiter_t = parts(b, tol, maxiter)
        x, iters, rel = sol.shard_loop(ctx, bb, tol_t, maxiter_t,
                                       check_every=check_every)
        if not batched:
            return x[0], iters[0], rel[0]
        return x.permute(1, 2, 0, 3), iters, rel

    solve.parts = parts
    solve.solver = sol.name
    solve.precond = pre.name
    solve.check_every = check_every
    solve.transport = body.transport
    solve.wire_dtype = body.wire_dtype
    solve.options = opts
    solve.pdata, solve.papply = pdata, papply
    return solve


def make_precond_apply(plan, *, precond: str | Preconditioner = "jacobi",
                       A=None, layout: dict | None = None,
                       precond_options: dict | None = None,
                       backend: str = "kernel"):
    """Standalone preconditioner application on the plan's device:
    ``apply(rd) -> zd`` over CG-layout ``(n_node, n_core, rc_pad)``.

    The same ``bind`` ``make_solver`` runs, without a Krylov loop around
    it — what ``repro_torch.testing.precond_check`` holds against each
    preconditioner's numpy ``host_apply``.  ``backend`` is the shard
    body's (``"kernel"`` | ``"plain"``) for preconditioners that run
    SpMVs.  Carries ``apply.precond`` (the resolved name) and
    ``apply.pdata`` / ``apply.papply`` (what ``bind`` returned; ``papply``
    takes loop-layout ``(nrhs, n_node, n_core, rc_pad)`` blocks)."""
    pre = get_precond(precond)
    pre.validate_options(precond_options)
    pdata, papply = pre.bind(plan, layout=layout, A=A, backend=backend,
                             options=precond_options)

    def apply(rd: torch.Tensor) -> torch.Tensor:
        if tuple(rd.shape) != plan.cg_shape:
            raise ValueError(f"precond apply: expected {plan.cg_shape}, "
                             f"got {tuple(rd.shape)}")
        return papply(pdata, rd[None])[0]

    apply.precond = pre.name
    apply.pdata, apply.papply = pdata, papply
    return apply


def reduction_census(solve, b: torch.Tensor, tol: float = 1e-8,
                     maxiter: int = 10_000) -> int:
    """Cross-shard reductions that one ``loop_body`` of ``solve`` (built
    by :func:`make_solver`) issues on ``b``: the port's form of the JAX
    package's while-body all-reduce census.  The SpMV reduces nothing, so
    the count is the solver's own and must equal its
    ``reductions_per_iter``."""
    sol, ctx, bb, tol_t, maxiter_t = solve.parts(b, tol, maxiter)
    aux, state = sol.loop_setup(ctx, bb, tol_t, maxiter_t)
    with count_reductions() as n:
        sol.loop_body(ctx, aux, state)
    return n[0]
