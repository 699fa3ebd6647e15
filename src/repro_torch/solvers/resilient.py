"""Resilient solves: chunked Krylov execution + host guard + elastic restart.

``make_solver`` runs a solve to its end with a host sync every
``check_every`` iterations and nothing else: a NaN, an SPD breakdown or a
preemption kills the whole solve.  This module runs the *same* hooks
(``loop_body``, the same per-iteration operations and reductions) in
bounded chunks of ``check_every`` iterations:

    restart ──> [ chunk ──> guard ──> checkpoint ] ──> finish
                   ^            │
                   └─ rollback ─┘   (bounded retries, then SolveFailure)

A chunk is ``steps`` gated iterations with no host sync inside, then a
true-residual probe (1 SpMV + 1 reduction) and one host sync.  Between
chunks a **host-side guard** (riding ``fault.Watchdog`` /
``fault.StepGuard``) checks the state: non-finite guard scalars or true
residual, SPD breakdown (CG's ``r·z ≤ 0`` / ``p·Ap ≤ 0``), divergence
against the recorded trajectory, recurrence-vs-true residual mismatch, and
stagnation.  A bad verdict rolls back to the last good iterate through the
solver's ``loop_restart`` (r = b − Ax and a β-chain reset) and retries;
``max_retries`` consecutive failures raise :class:`SolveFailure`.

Gated iterations after convergence change nothing and the monolithic
``make_solver`` entry is ``loop_restart`` from ``x = 0``, so a clean
chunked solve from ``x = 0`` gives the monolithic ``x`` bit for bit,
whatever ``check_every`` either side uses.

Checkpoints are **layout-independent**: ``Solver.state_to_global`` maps
the iterate to global row order and ``repro_torch.checkpoint`` persists
it in the JAX package's format.  A restore may land on another grid, node
partition, format or transport: ``resilient_solve(..., resume_from=dir)``
re-enters through ``loop_restart`` at the checkpointed iterate and count.

Fault injection for tests is deterministic
(``repro_torch.runtime.fault.FaultInjector``): a NaN in one real slot of a
named shard of a named state vector, a chunk run through
``repro_torch.core.transport.FaultyTransport`` (bit-flipped halo), and
SIGKILL preemption mid-solve (``repro_torch.testing.resilience_check``).

Inside the loop a vector is ``(nrhs, n_node, n_core, rc_pad)``; a global
``x`` crosses in the batched layout ``(n_node, n_core, nrhs, rc_pad)``
(``to_dist_batch`` / ``from_dist_batch``).

On a **process mesh** (a rank-local plan, ``repro_torch.launch.mesh``)
every rank runs the driver alike, and every chunk ends in one verdict all
ranks hold, so no rank rolls back, checkpoints or stops apart from the
others (ranks that did would hang each other in the next collective).
The guard's device scalars are ``psum``'d, equal on every rank; the host
f64 true residual (over ``x`` gathered to rank 0) and the watchdog's
straggler flag are rank 0's, and rank 0's verdict is agreed
(``CGMesh.agree``).  A checkpoint is ``x`` gathered to rank 0 and written
there in the same format, then a barrier; a resume reads it on every
rank, each taking its rows, so checkpoints cross between the process
mesh, the virtual mesh and the JAX package.  ``nan`` poisons the rank
that owns the injector's shard; ``preempt`` kills every rank at the same
chunk boundary, after the last checkpoint's barrier.
"""
from __future__ import annotations

import dataclasses
import logging
from typing import Callable

import numpy as np
import torch

from repro_torch.runtime.fault import FaultInjector, StepGuard, Watchdog
from repro_torch.solvers.base import (SolverCtx, check_nrhs,
                                      gather_dist_batch, get_solver, pdot,
                                      to_dist_batch)
from repro_torch.solvers.precond import get_precond

__all__ = ["resilient_solve", "make_resilient", "ResilientResult",
           "SolveFailure"]

_log = logging.getLogger(__name__)


class SolveFailure(RuntimeError):
    """A solve the resilience layer could not save: ``max_retries``
    consecutive chunks failed the guard.  Carries the post-mortem."""

    def __init__(self, message: str, *, reason: str, iteration: int,
                 retries: int, trajectory: list):
        super().__init__(message)
        self.reason = reason
        self.iteration = iteration
        self.retries = retries
        self.trajectory = trajectory


@dataclasses.dataclass
class ResilientResult:
    """What a resilient solve hands back (host numpy, global ordering)."""

    x: np.ndarray               # (n,) or (nrhs, n) global solution
    iters: np.ndarray           # per-RHS iteration counts (scalar unbatched)
    rel: np.ndarray             # solver-reported relative residual
    true_rel: float             # final true relative residual (worst RHS)
    converged: bool
    chunks: int                 # chunks executed (incl. retried)
    rollbacks: int
    trajectory: list            # [(iteration, worst true_rel)] good chunks
    resumed_from: int | None    # checkpoint step we resumed at, if any
    checkpoint_dir: str | None


def _to_loop(xb: torch.Tensor) -> torch.Tensor:
    """Batched layout ``(n_node, n_core, nrhs, rc_pad)`` -> loop layout."""
    return xb.permute(2, 0, 1, 3)


def _to_batch(x: torch.Tensor) -> torch.Tensor:
    """Loop layout ``(nrhs, n_node, n_core, rc_pad)`` -> batched layout."""
    return x.permute(1, 2, 0, 3)


@dataclasses.dataclass
class _Programs:
    restart: Callable
    chunk: Callable
    finish: Callable
    transport: str
    wire_dtype: str


class _Resilient:
    """The chunked-execution programs for one (plan, solver, precond) —
    the resilient analogue of ``make_solver``'s closure."""

    def __init__(self, plan, layout, sol, pre, kinds, opts, build,
                 transport):
        self.plan, self.layout = plan, layout
        self.sol, self.pre = sol, pre
        self.kinds, self.opts = kinds, opts
        self._build = build
        self._clean = build(transport)
        self.builds = 1
        self._faulty: _Programs | None = None
        self.transport = self._clean.transport
        self.wire_dtype = self._clean.wire_dtype

    @property
    def restart(self):
        return self._clean.restart

    @property
    def chunk(self):
        return self._clean.chunk

    @property
    def finish(self):
        return self._clean.finish

    def faulty_chunk(self):
        """The chunk on a corrupting transport wrapper — built lazily, used
        only for an armed ``bitflip`` chunk."""
        if self._faulty is None:
            from repro_torch.core.transport import (FaultyTransport,
                                                    get_transport)
            base = get_transport(self.transport)
            self._faulty = self._build(FaultyTransport(base=base))
            self.builds += 1
        return self._faulty.chunk


def make_resilient(plan, *, solver="cg", precond="jacobi", transport=None,
                   neighbor_offsets=None, wire_dtype: str | None = None,
                   maxiter_static: int = 10_000,
                   A=None, layout: dict | None = None,
                   options: dict | None = None,
                   precond_options: dict | None = None,
                   backend: str = "kernel") -> _Resilient:
    """Build the three chunked-execution programs for a registered
    solver/preconditioner pair on the plan's device (``make_solver``'s
    plumbing), all on loop-layout ``(nrhs, n_node, n_core, rc_pad)``
    blocks:

    ``restart(b, tol, maxiter, x, k)``          -> state dict
    ``chunk(b, tol, maxiter, steps, state)``
        -> ``(state, done, true_rel, active)``
    ``finish(b, tol, maxiter, state)``          -> ``(x, iters, rel)``

    ``chunk`` runs ``steps`` gated iterations of the solver's
    ``loop_body``, then the true-residual probe (1 SpMV + 1 reduction,
    outside the iterations: the per-iteration census is unchanged).

    ``backend`` is the shard body's local matvec (``"kernel"``: the
    kernel wrappers; ``"plain"``: their plain versions everywhere).  The
    result counts its program builds in ``builds`` (the clean triple, and
    the faulty chunk once it is asked for).  On a rank-local plan every
    rank builds the same programs on its shard.
    """
    from repro_torch.core.spmv import make_shard_body

    sol = get_solver(solver)
    pre = get_precond(precond)
    pre.validate_options(precond_options)
    kinds = sol.state_kinds()
    if "x" not in kinds or "k" not in kinds:
        raise ValueError(f"solver {sol.name!r} state_kinds() must include "
                         "'x' and 'k'")
    pdata, papply = pre.bind(plan, layout=layout, A=A, backend=backend,
                             options=precond_options)
    opts = sol.prepare(plan, pre, pdata, A=A, layout=layout, options=options)
    transport = transport if transport is not None else plan.transport
    if transport == "auto":
        from repro_torch.core.transport import autotune_transport
        transport = autotune_transport(
            plan, neighbor_offsets=neighbor_offsets,
            wire_dtype=wire_dtype).winner
    mask = plan.mask

    def build(tr) -> _Programs:
        body = make_shard_body(plan, transport=tr,
                               neighbor_offsets=neighbor_offsets,
                               wire_dtype=wire_dtype, backend=backend)
        ctx = SolverCtx(spmv=body, precond=lambda r: papply(pdata, r),
                        maxiter_static=maxiter_static, options=opts,
                        mesh=plan.mesh)

        def restart(b, tol, maxiter, x, k):
            aux = sol.loop_aux(ctx, b, tol, maxiter)
            return sol.loop_restart(ctx, aux, b, x * mask, k)

        def chunk(b, tol, maxiter, steps: int, state):
            aux = sol.loop_aux(ctx, b, tol, maxiter)
            for _ in range(steps):
                state = sol.loop_body(ctx, aux, state)
            active = sol.loop_active(ctx, aux, state)
            # the chunk-level true-residual probe: the guard's only
            # detector for corruption the recurrences never see (a NaN in
            # x, a flipped halo, anything in Chebyshev)
            rt = b - ctx.spmv(state["x"])
            true_rel = (torch.sqrt(pdot(rt, rt, mesh=ctx.mesh))
                        / torch.clamp(aux["bnorm"], min=1e-30))
            return state, ~torch.any(active), true_rel, active

        def finish(b, tol, maxiter, state):
            aux = sol.loop_aux(ctx, b, tol, maxiter)
            return sol.loop_finish(ctx, aux, state)

        return _Programs(restart=restart, chunk=chunk, finish=finish,
                         transport=body.transport,
                         wire_dtype=body.wire_dtype)

    return _Resilient(plan, layout, sol, pre, kinds, opts, build, transport)


# --------------------------------------------------------------------- #
# the host-side guard
# --------------------------------------------------------------------- #
def _host(v) -> np.ndarray:
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    return np.asarray(v)


def _guard_verdict(sol, state: dict, true_rel: np.ndarray, *,
                   best_rel: float, tol: float, since_improve: int,
                   stall_chunks: int, divergence_factor: float,
                   mismatch_factor: float,
                   done: bool = False) -> tuple[bool, str]:
    """(ok, reason) for one completed chunk.  Pure host numpy — reads the
    state scalars the iteration already reduced plus the chunk's
    true-residual probe."""
    scalars = {k: _host(v) for k, v in sol.guard_scalars(state).items()}
    for k, v in scalars.items():
        if not np.all(np.isfinite(v)):
            return False, f"nonfinite:{k}"
    worst = float(np.max(true_rel))
    if not np.isfinite(worst):
        return False, "nonfinite:true_residual"
    for k in sol.positive_scalars:
        if k in scalars and np.any(scalars[k] <= 0):
            return False, f"breakdown:{k}"
    if worst > divergence_factor * max(best_rel, tol):
        return False, "diverged"
    if "rr" in scalars:
        # the recurrence residual and the true residual must tell the same
        # story; a silently-corrupted x leaves the recurrence pristine
        rec = float(np.max(np.sqrt(np.maximum(scalars["rr"], 0.0))))
        if worst > mismatch_factor * (rec + tol) and worst > 10 * tol:
            return False, "mismatch"
    # stagnation means "stuck" only for residual-driven solvers still
    # asking for iterations; an a-priori-budget method idling at its floor
    # and a chunk that reported completion are both healthy
    if (sol.stagnation_guard and not done
            and since_improve >= stall_chunks and worst > 10 * tol):
        return False, "stagnation"
    return True, "ok"


# --------------------------------------------------------------------- #
# the driver
# --------------------------------------------------------------------- #
def resilient_solve(A_or_plan, b, *, solver="cg", precond="jacobi",
                    layout: dict | None = None, A=None,
                    n_node: int = 1, n_core: int = 1, mode: str = "balanced",
                    node_partition=None, format: str = "ell",
                    transport=None, neighbor_offsets=None,
                    wire_dtype: str | None = None,
                    tol: float = 1e-5, maxiter: int = 10_000,
                    maxiter_static: int = 10_000,
                    check_every: int = 50, max_retries: int = 3,
                    checkpoint_dir: str | None = None,
                    resume_from: str | None = None,
                    injector: FaultInjector | None = None,
                    watchdog: Watchdog | None = None,
                    options: dict | None = None,
                    precond_options: dict | None = None,
                    divergence_factor: float = 1e3,
                    mismatch_factor: float = 1e3,
                    stall_chunks: int = 8,
                    programs: _Resilient | None = None,
                    device=None, mesh=None) -> ResilientResult:
    """Run a registered solver under the resilience protocol.

    ``A_or_plan``: a host matrix (``matvec`` / ``n_rows`` / ``diagonal``)
    — the plan is built here on ``device`` (default ``cuda``) with
    ``n_node``/``n_core``/``mode``/``format``/``node_partition`` — or an
    existing ``SpMVPlan`` (then ``layout`` is required and ``A`` optional:
    with the host matrix the guard recomputes the true residual in f64 on
    the host; without it the chunk's device probe is used).

    ``b`` is a global RHS, ``(n,)`` or ``(nrhs, n)`` numpy.

    ``check_every`` bounds each chunk; the guard runs between chunks and a
    healthy chunk's iterate is kept (a device reference) and, with
    ``checkpoint_dir``, persisted layout-independently.  ``resume_from``
    restores the latest checkpoint in that directory onto *this* plan —
    any grid, partition, format or transport — and resumes from the
    checkpointed iteration.

    ``injector`` arms one deterministic fault
    (``repro_torch.runtime.fault.FaultInjector``); production solves leave
    it ``None``.  ``programs`` reuses a :func:`make_resilient` result built
    for this plan.

    ``wire_dtype`` selects the halo wire codec (``None`` follows
    ``plan.wire_dtype``).  A lossy codec separates recurrence and true
    residual by up to its relative bound, so the guard's mismatch and
    stagnation verdicts use ``max(tol, codec.rel_bound)``; the solver's
    ``tol`` itself is untouched.

    On a rank-local plan (or with a host matrix and a process ``mesh``:
    the plan is built whole on the host and cut to this rank) every rank
    calls this alike, with the same global ``b``; see the module
    docstring.  ``x`` is returned whole on every rank.
    """
    from repro_torch.checkpoint import latest_step
    from repro_torch.checkpoint import load as ckpt_load
    from repro_torch.checkpoint import save as ckpt_save
    from repro_torch.core.spmv import build_spmv_plan, shard_plan
    from repro_torch.core.transport import get_codec

    if hasattr(A_or_plan, "matvec"):
        A = A_or_plan
        on_ranks = mesh is not None and mesh.is_process
        plan, layout = build_spmv_plan(
            A, n_node, n_core, mode=mode, node_partition=node_partition,
            format=format,
            transport=transport if isinstance(transport, str) else "a2a",
            wire_dtype=wire_dtype if wire_dtype is not None else "f32",
            device="cpu" if on_ranks else device)
        if on_ranks:
            plan = shard_plan(plan, mesh, device=device)
        if neighbor_offsets is None:
            neighbor_offsets = layout["neighbor_offsets"]
    else:
        plan = A_or_plan
        if layout is None:
            raise ValueError("resilient_solve(plan, ...) needs layout= "
                             "(the dict build_spmv_plan returned with it)")
    n_node, n_core = plan.n_node, plan.n_core
    # the process mesh whose ranks must decide as one (None: virtual)
    mesh = plan.mesh if plan.is_rank_local else None

    b = np.asarray(b, np.float64)
    unbatched = b.ndim == 1
    B = np.atleast_2d(b)
    nrhs, n = B.shape
    if n != plan.n:
        raise ValueError(f"b has {n} rows, plan has {plan.n}")
    check_nrhs(nrhs)

    if programs is not None:
        if programs.plan is not plan:
            raise ValueError("programs= was built for a different plan")
        rs = programs
    else:
        rs = make_resilient(plan, solver=solver, precond=precond,
                            transport=transport,
                            neighbor_offsets=neighbor_offsets,
                            wire_dtype=wire_dtype,
                            maxiter_static=maxiter_static, A=A,
                            layout=layout, options=options,
                            precond_options=precond_options)
    sol = rs.sol
    guard_tol = float(max(tol, get_codec(rs.wire_dtype).rel_bound))
    if injector is not None and injector.kind == "nan":
        key = injector.state_key
        if rs.kinds.get(key) != "vector":
            raise ValueError(
                f"injector state_key {key!r} is not a vector state of "
                f"solver {sol.name!r}; vectors: "
                f"{[k for k, v in rs.kinds.items() if v == 'vector']}")

    dev = plan.device
    bd = to_dist_batch(B, layout, plan)
    # the loop-layout RHS exactly as make_solver forms it
    bb = _to_loop(bd) * plan.mask
    told = torch.tensor(tol, dtype=torch.float32, device=dev)
    mxd = torch.tensor(maxiter, dtype=torch.int32, device=dev)
    bnorms = np.maximum(np.linalg.norm(B, axis=1), 1e-30)

    def true_rel_of(X) -> np.ndarray:
        R = B - np.stack([A.matvec(X[j].astype(np.float64))
                          for j in range(nrhs)])
        return np.linalg.norm(R, axis=1) / bnorms

    def host_true_rel(x_loop) -> np.ndarray | None:
        """The host f64 true residual (rank 0's, over the gathered ``x``,
        on a process mesh: ``None`` on the other ranks)."""
        if A is None:
            return None
        X = gather_dist_batch(_to_batch(x_loop), layout, plan)
        return None if X is None else true_rel_of(X)

    # ---- entry: cold start, or elastic resume from a checkpoint -------- #
    resumed_from = None
    trajectory: list = []
    if resume_from is not None:
        step = latest_step(resume_from)
        if step is None:
            raise ValueError(f"resume_from={resume_from!r}: no checkpoint "
                             "found")
        like = {"x": np.empty((nrhs, plan.n), np.float32)}
        gstate, extra = ckpt_load(resume_from, step, like)
        if extra.get("n") not in (None, plan.n) or \
                extra.get("nrhs") not in (None, nrhs):
            raise ValueError(
                f"checkpoint is for n={extra.get('n')}, "
                f"nrhs={extra.get('nrhs')}; this solve has n={plan.n}, "
                f"nrhs={nrhs}")
        x_entry = _to_loop(sol.state_from_global(gstate, layout, plan,
                                                 dtype=bd.dtype))
        k_entry = torch.tensor(np.asarray(extra.get("iteration",
                                                    [step] * nrhs),
                                          np.int32), device=dev)
        trajectory = [tuple(t) for t in extra.get("trajectory", [])]
        resumed_from = step
        _log.info("resuming from %s step %d (solver then: %s)",
                  resume_from, step, extra.get("solver"))
    else:
        x_entry = torch.zeros_like(bb)
        k_entry = torch.zeros((nrhs,), dtype=torch.int32, device=dev)

    state = rs.restart(bb, told, mxd, x_entry, k_entry)
    last_good = (state["x"], _host(state["k"]).astype(np.int32))

    def persist(x_loop, k_host, step_tag=None):
        if checkpoint_dir is None:
            return
        # on a process mesh: gathered to rank 0, written there, then a
        # barrier, so no rank runs on (or is preempted) before it is down
        g = sol.state_to_global({"x": _to_batch(x_loop)}, layout, plan)
        if g is not None:
            g = {k: np.asarray(v, np.float32) for k, v in g.items()}
            step = int(np.max(k_host)) if step_tag is None else step_tag
            ckpt_save(checkpoint_dir, step, g,
                      extra={"iteration": np.asarray(k_host).tolist(),
                             "solver": sol.name, "precond": rs.pre.name,
                             "tol": float(tol), "n": int(plan.n),
                             "nrhs": int(nrhs),
                             "trajectory": [list(t) for t in trajectory]})
        if mesh is not None:
            mesh.barrier()

    persist(*last_good)             # survive a preemption before chunk 1

    wd = watchdog or Watchdog()
    best_rel = min([t[1] for t in trajectory], default=1.0)
    since_improve = 0
    chunks = rollbacks = retries = 0
    true_rel_vec = np.ones(nrhs)
    done = False

    while not done:
        k_cur = int(np.max(_host(state["k"])))
        program = rs.chunk
        if injector is not None and injector.crossed(k_cur,
                                                     k_cur + check_every):
            if injector.kind == "preempt":
                injector.preempt()         # SIGKILL — never returns
            elif injector.kind == "nan":
                nd, cd = injector.shard
                nd, cd = nd % n_node, cd % n_core
                # on a process mesh only the rank holding the shard
                at = (nd, cd) if mesh is None else (
                    (0, 0) if (mesh.node, mesh.core) == (nd, cd) else None)
                if at is not None:
                    # only a slot the mask marks real can propagate: the
                    # matvec and the reductions never read padding
                    valid = np.flatnonzero(_host(plan.mask[at]) > 0)
                    slot = (int(valid[injector.poison_slot(len(valid))])
                            if len(valid) else 0)
                    key = injector.state_key
                    arr = state[key].clone()     # last_good may share it
                    arr[(slice(None),) + at + (slot,)] = float("nan")
                    state = {**state, key: arr}
                    _log.warning("injected NaN into %s shard (%d,%d) slot "
                                 "%d at iteration %d", key, nd, cd, slot,
                                 k_cur)
            elif injector.kind == "bitflip":
                program = rs.faulty_chunk()
                _log.warning("running chunk at iteration %d through the "
                             "faulty transport", k_cur)

        # an emergency save is a collective on a process mesh, which a rank
        # failing alone would enter alone: there the last good chunk's
        # checkpoint (already on disk) is what survives
        guard = StepGuard(wd, on_emergency=None if mesh is not None
                          else lambda: persist(*last_good))
        with guard:
            new_state, done_d, true_rel_d, _ = program(
                bb, told, mxd, check_every, state)
            done = bool(done_d)               # the chunk's one host sync
        chunks += 1
        dev_true_rel = _host(true_rel_d)
        k_host = _host(new_state["k"]).astype(np.int32)
        k_cur = int(np.max(k_host))
        tr = host_true_rel(new_state["x"])
        true_rel_vec = tr if tr is not None else dev_true_rel

        ok, reason = _guard_verdict(
            sol, new_state, true_rel_vec,
            best_rel=best_rel, tol=guard_tol, since_improve=since_improve,
            stall_chunks=stall_chunks, divergence_factor=divergence_factor,
            mismatch_factor=mismatch_factor, done=done)
        slow = guard.slow
        if mesh is not None:            # one verdict for every rank: 0's
            ok, reason, true_rel_vec, slow = mesh.agree(
                (ok, reason, true_rel_vec, slow))
        if slow:
            _log.warning("chunk ending at iteration %d was a straggler "
                         "(%.3g s)", k_cur, guard.last_dt)
        if not ok:
            retries += 1
            rollbacks += 1
            k_good = int(np.max(last_good[1]))
            _log.warning("guard verdict %s at iteration %d "
                         "(retry %d/%d) — rolling back to iteration %d",
                         reason, k_cur, retries, max_retries, k_good)
            if retries > max_retries:
                raise SolveFailure(
                    f"solve failed at iteration {k_cur}: {reason} "
                    f"persisted through {retries - 1} rollbacks",
                    reason=reason, iteration=k_cur, retries=retries - 1,
                    trajectory=trajectory)
            state = rs.restart(bb, told, mxd, last_good[0],
                               torch.tensor(last_good[1], device=dev))
            done = False
            continue

        retries = 0
        state = new_state
        worst = float(np.max(true_rel_vec))
        trajectory.append((k_cur, worst))
        if worst < best_rel * 0.999:
            best_rel = worst
            since_improve = 0
        else:
            since_improve += 1
        last_good = (state["x"], k_host)
        persist(*last_good)

    x, iters, rel = rs.finish(bb, told, mxd, state)
    # whole on every rank; the same bits everywhere, so the same residual
    X = gather_dist_batch(_to_batch(x), layout, plan, to=None)
    if A is not None:
        true_rel_vec = true_rel_of(X)
    iters = _host(iters)
    rel = _host(rel)
    return ResilientResult(
        x=X[0] if unbatched else X,
        iters=iters[0] if unbatched else iters,
        rel=rel[0] if unbatched else rel,
        true_rel=float(np.max(true_rel_vec)),
        converged=bool(np.all(rel <= tol * 1.001) or
                       np.all(true_rel_vec <= tol * 10)),
        chunks=chunks, rollbacks=rollbacks, trajectory=trajectory,
        resumed_from=resumed_from, checkpoint_dir=checkpoint_dir)
