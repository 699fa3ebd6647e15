"""Mixed-precision iterative refinement: f64 outer loop over any inner solver.

The compressed wire formats (``repro_torch.core.transport``
``wire_dtype=``) perturb every SpMV by up to the codec's relative bound,
so a plain Krylov solve over bf16/int8 wire stalls at a true-residual
floor well above f32 round-off.  Classical iterative refinement recovers
the lost accuracy: the *outer* loop lives on the host in f64 and only ever
evaluates exact residuals, while the *inner* solve runs on the plan's
device at loose tolerance over the lossy wire::

    r = b - A x                (host, f64, exact matvec)
    solve  A d ~= r / ||r||    (device, f32 + lossy wire, tol = inner_tol)
    x <- x + ||r|| d           (host, f64 accumulate)

One cycle contracts the error by the inner solve's attained relative
accuracy, so refinement converges geometrically to tolerances far below
the f32 floor as long as the inner solve makes any progress.  Normalising
the residual to unit norm before each inner solve keeps late-cycle
residuals well inside f32 range.

``make_refine`` builds the inner solver ONCE and returns a host-driven
``refine(b, tol, max_cycles)``.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.solvers.base import get_solver, make_solver

__all__ = ["RefineResult", "make_refine", "refine_solve"]


@dataclasses.dataclass
class RefineResult:
    """What a refinement solve hands back (host numpy, global ordering)."""

    x: np.ndarray           # (n,) solution
    cycles: int             # outer refinement cycles run
    inner_iters: int        # total inner Krylov iterations across cycles
    rel: float              # final TRUE relative residual (f64 host)
    converged: bool
    history: list           # [(cycle, rel)] after each outer recompute
    solver: str             # inner solver / precond / transport / wire
    precond: str
    transport: str
    wire_dtype: str


def make_refine(plan, *, solver="cg", precond="jacobi",
                A=None, layout: dict | None = None,
                inner_tol: float = 1e-4, maxiter_inner: int = 10_000,
                transport=None, neighbor_offsets=None,
                wire_dtype: str | None = None, check_every: int = 16,
                options: dict | None = None,
                precond_options: dict | None = None):
    """Wrap a registry solver in the f64 iterative-refinement outer loop.

    ``A`` (host ``CSRMatrix``) and ``layout`` (the dict ``build_spmv_plan``
    returned) are required: the outer loop recomputes r = b − Ax in f64
    on the host every cycle.  ``inner_tol`` is the per-cycle inner target;
    it should sit just above the inner solve's attainable floor for the
    chosen ``wire_dtype`` (1e-4 suits bf16/int8).

    ``options``/``precond_options`` go to ``make_solver``.  When the wire
    codec (``wire_dtype``, else the plan's stamp) is lossy, the solver's
    ``lossy_wire_options`` are merged under ``options``: explicit options
    win.

    Returns ``refine(b, tol=1e-7, max_cycles=40) -> RefineResult`` for a
    single global ``(n,)`` RHS.  The inner solver is built once and shared
    across cycles; exposed as ``refine.solve`` (with the usual
    ``.solver``/``.transport``/``.wire_dtype`` stamps).
    """
    if A is None or layout is None:
        raise ValueError("make_refine needs A= (host matrix with matvec) "
                         "and layout= for the f64 outer residual recompute")
    from repro_torch.core.spmv import from_dist, to_dist
    from repro_torch.core.transport import get_codec, plan_wire_dtype

    codec = get_codec(wire_dtype if wire_dtype is not None
                      else plan_wire_dtype(plan))
    if not codec.exact:
        # solver-specific stability defaults for a quantised SpMV
        # (pipelined CG's tighter residual-replacement period)
        options = {**get_solver(solver).lossy_wire_options(),
                   **(options or {})}
    solve = make_solver(plan, solver=solver, precond=precond,
                        transport=transport,
                        neighbor_offsets=neighbor_offsets,
                        wire_dtype=wire_dtype, check_every=check_every,
                        A=A, layout=layout, options=options,
                        precond_options=precond_options)

    def refine(b, tol: float = 1e-7,
               max_cycles: int = 40) -> RefineResult:
        b = np.asarray(b, np.float64)
        if b.ndim != 1:
            raise ValueError("refine expects a single global (n,) RHS")
        bnorm = max(float(np.linalg.norm(b)), 1e-300)
        x = np.zeros_like(b)
        r = b.copy()
        rel = float(np.linalg.norm(r)) / bnorm
        history: list = []
        inner_total = 0
        cycles = 0
        stalled = 0
        while rel > tol and cycles < max_cycles:
            cycles += 1
            rn = max(float(np.linalg.norm(r)), 1e-300)
            # unit-norm residual: late cycles push ||r|| toward 1e-7 and
            # below, where a raw f32 inner RHS would underflow its dots
            rd = to_dist(np.asarray(r / rn, np.float32), layout, plan)
            dd, it, _ = solve(rd, tol=inner_tol, maxiter=maxiter_inner)
            inner_total += int(it)
            d = np.asarray(from_dist(dd, layout, plan), np.float64)
            x = x + rn * d
            r = b - np.asarray(A.matvec(x), np.float64)
            prev, rel = rel, float(np.linalg.norm(r)) / bnorm
            history.append((cycles, rel))
            # a cycle that fails to halve the residual means the inner
            # solve is at its floor for this system — further cycles
            # cannot help
            stalled = stalled + 1 if rel > 0.5 * prev else 0
            if stalled >= 3:
                break
        return RefineResult(
            x=x, cycles=cycles, inner_iters=inner_total, rel=rel,
            converged=bool(rel <= tol), history=history,
            solver=solve.solver, precond=solve.precond,
            transport=solve.transport, wire_dtype=solve.wire_dtype)

    refine.solve = solve
    refine.solver = solve.solver
    refine.precond = solve.precond
    refine.transport = solve.transport
    refine.wire_dtype = solve.wire_dtype
    return refine


def refine_solve(A, b, *, n_node: int = 1, n_core: int = 1,
                 mode: str = "balanced", node_partition=None,
                 format: str = "ell", solver="cg", precond="jacobi",
                 transport=None, wire_dtype: str = "f32",
                 inner_tol: float = 1e-4, maxiter_inner: int = 10_000,
                 tol: float = 1e-7, max_cycles: int = 40,
                 device=None, options: dict | None = None,
                 precond_options: dict | None = None) -> RefineResult:
    """One-shot convenience: build the plan on ``device`` (default
    ``cuda``), refine, return the result."""
    from repro_torch.core.spmv import build_spmv_plan

    plan, layout = build_spmv_plan(
        A, n_node, n_core, mode=mode, node_partition=node_partition,
        format=format,
        transport=transport if isinstance(transport, str) else "a2a",
        wire_dtype=wire_dtype, device=device)
    refine = make_refine(plan, solver=solver, precond=precond,
                         A=A, layout=layout, inner_tol=inner_tol,
                         maxiter_inner=maxiter_inner, transport=transport,
                         neighbor_offsets=layout["neighbor_offsets"],
                         options=options, precond_options=precond_options)
    return refine(b, tol=tol, max_cycles=max_cycles)
