"""Continuous-batching solve engine: slot/refill over a warm chunked loop.

The engine keeps a fixed batch of ``nrhs`` right-hand-side slots and runs
the chunked programs of ``make_resilient`` over the whole batch: a column
that freezes (converged: the solvers' per-RHS gating keeps its state bit
for bit) retires at the next chunk boundary and its slot is respliced
with the next queued RHS mid-solve, so one slow column never idles the
others.  Every SpMV of the batch is one call of the batched shard body:
one exchange and one launch of the batched ELL/SELL kernel for all
``nrhs`` columns.

The splice is the engine's core move, and its correctness claim is
bit-exactness for bystanders: splicing a new RHS into slot ``j`` leaves
every other column's trajectory bitwise unchanged.  Mechanically:

1. write the new column into the host RHS mirror and its tol into the
   per-RHS tol vector; pack the spliced columns on the host and move them
   in one transfer, then copy them into their slots of the device batch
   (survivor columns keep their device bytes) and zero the spliced ``x``
   columns with one ``torch.where``;
2. run the *whole batch* through the ``restart`` program — the solver's
   ``loop_restart`` true-residual re-basing (the one recovery primitive
   behind cold start, rollback and elastic resume);
3. merge per state key with one ``torch.where`` each: spliced columns take
   the restart output, all others keep their prior state bit for bit —
   vector kinds select on the RHS axis, per-RHS scalars elementwise, and
   whole-batch scalars (pipelined CG's host trip counter ``t``) keep
   their old value so the survivors' residual-replacement schedule does
   not move.

Every per-iteration operation of the shipped solvers is column-local (the
batched kernels sum each column alone; reductions are per RHS), so after
the merge a surviving column's future iterates are a function of exactly
the state it already had.  A chunk runs ``check_every`` gated iterations
whatever the batch holds; a frozen column's gated iterations are identity.

Retirement reads the chunk's per-column ``active`` output (the
``loop_active`` hook): an inactive column with budget left has converged
— its iterate is extracted (``from_dist``), its slot freed.  A column that
exhausts ``maxiter`` or blows its wall-clock deadline produces a
structured :class:`~repro_torch.solvers.resilient.SolveFailure`; deadline
evictions force-idle the slot (b = 0, tol = 1 re-bases to an immediately
inactive column) so the batch carries no zombie work.  The true relative
residual of each retired request is computed on the host in float64.

Warm restart: :meth:`SolveEngine.checkpoint` persists the in-flight batch
layout-independently (``state_to_global`` + the global RHS block + tols /
iteration counts) through ``repro_torch.checkpoint`` in the JAX package's
format; :meth:`restore` re-enters on a fresh engine — any grid,
partition, format or transport, and either package's checkpoint —
through the same ``restart`` program.
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from repro_torch.serve.plans import PlanCache
from repro_torch.solvers.resilient import SolveFailure
from repro_torch.util import resolve_device

__all__ = ["EngineConfig", "Request", "SlotResult", "SolveEngine"]

#: tol stamped on idle slots: with b = 0 the residual norm is exactly 0,
#: so any positive tolerance makes the column inactive on entry
_IDLE_TOL = 1.0


@dataclasses.dataclass
class EngineConfig:
    """Static configuration of one engine (validated before any build)."""

    nrhs: int = 4                       # batch slots
    n_node: int = 1
    n_core: int = 1
    solver: str = "cg"
    precond: str = "jacobi"
    format: str = "ell"
    transport: str = "a2a"
    wire_dtype: str = "f32"
    mode: str = "balanced"
    node_partition: str | None = None
    backend: str = "kernel"             # the shard body's: "kernel"|"plain"
    check_every: int = 32               # iterations per chunk
    maxiter: int = 10_000               # per-request iteration budget
    maxiter_static: int = 10_000
    max_queue: int = 256                # admission bound (queue_full beyond)
    default_tol: float = 1e-5
    batch_fill_timeout_s: float = 0.0   # defer a cold launch this long
    options: dict | None = None         # solver options (e.g. lmin/lmax)

    def validate(self) -> "EngineConfig":
        """Fail fast, before any plan build or warm-up is spent, with the
        registries' own listings."""
        from repro_torch.core.spmv import BACKENDS
        from repro_torch.core.transport import (available_transports,
                                                available_wire_dtypes)
        from repro_torch.kernels.ops import MAX_NRHS
        from repro_torch.solvers.base import available_solvers
        from repro_torch.solvers.precond import available_preconds
        from repro_torch.sparse.formats import available_formats

        def check(kind, value, registered):
            if value not in registered:
                raise ValueError(f"unknown {kind} {value!r}; available: "
                                 f"{tuple(registered)}")

        check("solver", self.solver, available_solvers())
        check("precond", self.precond, available_preconds())
        check("format", self.format, available_formats())
        check("transport", self.transport,
              available_transports() + ("auto",))
        check("wire_dtype", self.wire_dtype, available_wire_dtypes())
        check("backend", self.backend, BACKENDS)
        for name, lo in (("nrhs", 1), ("n_node", 1), ("n_core", 1),
                         ("check_every", 1), ("maxiter", 1),
                         ("maxiter_static", 1), ("max_queue", 1)):
            v = getattr(self, name)
            if not isinstance(v, int) or v < lo:
                raise ValueError(f"{name} must be an int >= {lo}, got {v!r}")
        if self.nrhs > MAX_NRHS:
            raise ValueError(f"nrhs must be <= {MAX_NRHS} (the columns one "
                             f"batched SpMV launch takes), got {self.nrhs}")
        if not self.default_tol > 0:
            raise ValueError(f"default_tol must be > 0, "
                             f"got {self.default_tol!r}")
        if self.batch_fill_timeout_s < 0:
            raise ValueError("batch_fill_timeout_s must be >= 0, got "
                             f"{self.batch_fill_timeout_s!r}")
        return self


@dataclasses.dataclass
class Request:
    """One queued/in-flight RHS (engine-internal; the service wraps it)."""

    rid: int
    b: np.ndarray                       # (n,) global RHS, f64
    tol: float
    deadline_s: float | None = None     # wall-clock budget from submit
    submit_t: float = 0.0
    admit_t: float | None = None
    slot: int | None = None
    resumed: bool = False               # re-entered from a checkpoint


@dataclasses.dataclass
class SlotResult:
    """What retiring a slot yields (success or structured failure)."""

    request: Request
    x: np.ndarray | None                # (n,) global solution (None on fail)
    iterations: int
    residual: float                     # true relative residual (host f64)
    converged: bool
    queue_s: float
    solve_s: float
    failure: SolveFailure | None = None


class SolveEngine:
    """The persistent continuous-batching solver engine.

    ``A`` is a host CSR matrix (``repro_torch.sparse``); ``config`` an
    :class:`EngineConfig`; ``device`` where the plan and the batch live
    (``cuda`` unless the caller passes another, e.g. ``"cpu"``); ``cache``
    an optional shared :class:`~repro_torch.serve.plans.PlanCache` (a
    fresh private one otherwise).  Building the engine builds (or
    cache-hits) the plan and the warm restart/chunk/finish triple at
    serving shapes; everything after is warm.
    """

    def __init__(self, A, config: EngineConfig, device=None,
                 cache: PlanCache | None = None):
        import scipy.sparse

        cfg = config.validate()
        self.cfg = cfg
        self.A = A
        self.device = resolve_device(device)
        self.cache = cache if cache is not None else PlanCache()
        plan_kw = dict(n_node=cfg.n_node, n_core=cfg.n_core, mode=cfg.mode,
                       node_partition=cfg.node_partition, format=cfg.format,
                       transport=cfg.transport, wire_dtype=cfg.wire_dtype,
                       device=self.device)
        key = self.cache.plan_key(A, **plan_kw)
        self.plan, self.layout = self.cache.plan_for(
            A, fingerprint=key.fingerprint, **plan_kw)
        self.rs = self.cache.programs_for(
            key, self.plan, self.layout, solver=cfg.solver,
            precond=cfg.precond, nrhs=cfg.nrhs, backend=cfg.backend,
            maxiter_static=cfg.maxiter_static, A=A, options=cfg.options)
        self.kinds = self.rs.kinds
        # the host f64 operator of the retirement residual (a CSR product,
        # ~10x numpy's bincount matvec at full size)
        self._A64 = scipy.sparse.csr_matrix(
            (np.asarray(A.data, np.float64), A.indices, A.indptr),
            shape=A.shape)
        # global row -> flat slot of the (n_node, n_core, rc_pad) layout,
        # on the host (packing a column) and the device (extracting one)
        g = np.asarray(self.layout["global_row_of"]).reshape(-1)
        self._slot_of_row = np.empty(self.plan.n, np.int64)
        self._slot_of_row[g[g >= 0]] = np.flatnonzero(g >= 0)
        dev, k, n = self.plan.device, cfg.nrhs, self.plan.n
        self._slot_dev = torch.from_numpy(self._slot_of_row).to(dev)
        self._mxd = torch.tensor(cfg.maxiter, dtype=torch.int32, device=dev)

        self._B = np.zeros((k, n))          # host f64 mirror of the batch
        self._tol = np.full((k,), _IDLE_TOL, np.float32)
        self._told = torch.from_numpy(self._tol).to(dev)
        shape = (k, self.plan.n_node, self.plan.n_core, self.plan.rc_pad)
        self._bd = torch.zeros(shape, dtype=torch.float32, device=dev)
        self._state = self.rs.restart(
            self._bd, self._told, self._mxd, torch.zeros_like(self._bd),
            torch.zeros((k,), dtype=torch.int32, device=dev))
        self._slots: list[Request | None] = [None] * k
        self._queue: list[Request] = []
        self._force_idle: set[int] = set()
        self._next_rid = 0
        self.counters = {"submitted": 0, "retired": 0, "failed": 0,
                         "splices": 0, "chunks": 0, "evicted": 0}
        # all-idle warm splice: runs the splice path's operations once at
        # build time so the first real request does not pay them
        self._splice([(j, None) for j in range(k)])
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        self.counters["splices"] = 0
        self._exec_baseline = self.cache.executable_counts(self.rs)

    # ------------------------------------------------------------------ #
    # queue
    # ------------------------------------------------------------------ #
    def submit(self, b, tol: float | None = None,
               deadline_s: float | None = None,
               now: float | None = None) -> Request:
        """Queue one RHS.  Raises :class:`SolveFailure` (reason
        ``queue_full``) past ``max_queue`` and ``ValueError`` on a
        malformed request — both before the RHS touches any device."""
        cfg = self.cfg
        b = np.asarray(b, np.float64)
        if b.shape != (self.plan.n,):
            raise ValueError(f"b must be shape ({self.plan.n},), "
                             f"got {b.shape}")
        tol = float(cfg.default_tol if tol is None else tol)
        if not tol > 0:
            raise ValueError(f"tol must be > 0, got {tol!r}")
        if deadline_s is not None and not deadline_s > 0:
            raise ValueError(f"deadline_s must be > 0, got {deadline_s!r}")
        if len(self._queue) >= cfg.max_queue:
            raise SolveFailure(
                f"queue full ({cfg.max_queue} pending)",
                reason="queue_full", iteration=0, retries=0, trajectory=[])
        req = Request(rid=self._next_rid, b=b, tol=tol,
                      deadline_s=deadline_s,
                      submit_t=time.perf_counter() if now is None else now)
        self._next_rid += 1
        self._queue.append(req)
        self.counters["submitted"] += 1
        return req

    @property
    def in_flight(self) -> int:
        return sum(r is not None for r in self._slots)

    @property
    def queued(self) -> int:
        return len(self._queue)

    def idle(self) -> bool:
        return self.in_flight == 0 and not self._queue

    # ------------------------------------------------------------------ #
    # the splice
    # ------------------------------------------------------------------ #
    def _pack(self, cols: list[int]) -> torch.Tensor:
        """The mirror's columns ``cols`` in loop layout ``(len(cols),
        n_node, n_core, rc_pad)`` on the device: packed on the host, one
        transfer.  Column ``j`` is ``to_dist(B[j])`` byte for byte (the
        same float64 -> float32 rounding)."""
        out = np.zeros((len(cols), self._bd[0].numel()), np.float32)
        for i, j in enumerate(cols):
            out[i, self._slot_of_row] = self._B[j]
        return torch.from_numpy(out).to(self.plan.device).view(
            (len(cols),) + tuple(self._bd.shape[1:]))

    def _splice(self, assignments: list[tuple[int, Request | None]]):
        """Re-base slots ``j`` (``None`` request = force-idle) through one
        whole-batch ``restart`` call, then merge so only the spliced
        columns change — the bit-exactness contract in the module doc.

        The device work does not grow with the slot count: one transfer
        of the spliced RHS columns and one indexed copy of them into
        ``b``, one select for ``x``, the ``restart`` call, and one select
        per state key."""
        dev = self.plan.device
        keep = np.ones((self.cfg.nrhs,), bool)
        k = self._state["k"].cpu().numpy().copy()
        for j, req in assignments:
            if req is None:
                self._B[j] = 0.0
                self._tol[j] = _IDLE_TOL
            else:
                self._B[j] = req.b
                self._tol[j] = req.tol
            keep[j] = False
            k[j] = 0
        keepv = torch.from_numpy(keep).to(dev)
        keep4 = keepv[:, None, None, None]
        cols = [j for j, _ in assignments]
        self._bd = self._bd.index_copy(
            0, torch.tensor(cols, device=dev), self._pack(cols))
        self._told = torch.from_numpy(self._tol.copy()).to(dev)
        x = torch.where(keep4, self._state["x"], 0.0)
        fresh = self.rs.restart(self._bd, self._told, self._mxd, x,
                                torch.from_numpy(k).to(dev))
        merged = {}
        for key, old in self._state.items():
            new = fresh[key]
            if self.kinds[key] == "vector":
                merged[key] = torch.where(keep4, old, new)
            elif isinstance(old, torch.Tensor) and old.dim() == 1:
                merged[key] = torch.where(keepv, old, new)  # per-RHS scalar
            else:
                # whole-batch scalars (pipelined CG's trip counter t) keep
                # the OLD value: survivors' replace schedule must not move
                merged[key] = old
        self._state = merged
        self.counters["splices"] += len(assignments)

    def _admit(self, now: float) -> None:
        assignments: list[tuple[int, Request | None]] = []
        for j, slot in enumerate(self._slots):
            if slot is not None:
                continue
            if self._queue:
                req = self._queue.pop(0)
                req.admit_t = now
                req.slot = j
                self._slots[j] = req
                assignments.append((j, req))
                self._force_idle.discard(j)
            elif j in self._force_idle:
                assignments.append((j, None))
                self._force_idle.discard(j)
        if assignments:
            self._splice(assignments)

    # ------------------------------------------------------------------ #
    # the chunk step
    # ------------------------------------------------------------------ #
    def step(self, now: float | None = None) -> list[SlotResult]:
        """Admit -> run one ``check_every``-iteration chunk -> retire.

        Returns the slots retired at this boundary (possibly empty).  A
        cold engine with a part-filled queue defers the launch up to
        ``batch_fill_timeout_s`` so a burst arriving within the window
        shares one batch from iteration 0."""
        real_time = now is None
        now = time.perf_counter() if real_time else now
        cfg = self.cfg
        if (self.in_flight == 0 and self._queue
                and len(self._queue) < cfg.nrhs
                and cfg.batch_fill_timeout_s > 0
                and now - self._queue[0].submit_t < cfg.batch_fill_timeout_s):
            return []
        self._admit(now)
        if self.in_flight == 0:
            return []
        state, _, _, active = self.rs.chunk(
            self._bd, self._told, self._mxd, cfg.check_every, self._state)
        self._state = state
        active = active.cpu().numpy()       # the chunk's one host sync
        self.counters["chunks"] += 1
        return self._retire(active,
                            time.perf_counter() if real_time else now)

    def _retire(self, active: np.ndarray, now: float) -> list[SlotResult]:
        cfg = self.cfg
        k = self._state["k"].cpu().numpy()
        results: list[SlotResult] = []
        for j, req in enumerate(self._slots):
            if req is None:
                continue
            over_deadline = (req.deadline_s is not None
                             and now - req.submit_t > req.deadline_s)
            if active[j] and not over_deadline:
                continue
            iters = int(k[j])
            # from_dist of column j: gathered on the device, one copy of
            # its n values
            xj = self._state["x"][j].reshape(-1)[self._slot_dev].cpu().numpy()
            rel = self._true_rel(xj, req.b)
            queue_s = (req.admit_t or req.submit_t) - req.submit_t
            solve_s = now - (req.admit_t or req.submit_t)
            if over_deadline and active[j]:
                fail = SolveFailure(
                    f"request {req.rid} missed its {req.deadline_s:.3g}s "
                    f"deadline at iteration {iters}",
                    reason="deadline", iteration=iters, retries=0,
                    trajectory=[(iters, rel)])
                results.append(SlotResult(
                    request=req, x=None, iterations=iters, residual=rel,
                    converged=False, queue_s=queue_s, solve_s=solve_s,
                    failure=fail))
                self.counters["evicted"] += 1
                self.counters["failed"] += 1
                self._force_idle.add(j)     # zombie column: re-base to idle
            elif iters >= cfg.maxiter:
                fail = SolveFailure(
                    f"request {req.rid} hit maxiter={cfg.maxiter} at "
                    f"residual {rel:.3g} (tol {req.tol:.3g})",
                    reason="maxiter", iteration=iters, retries=0,
                    trajectory=[(iters, rel)])
                results.append(SlotResult(
                    request=req, x=None, iterations=iters, residual=rel,
                    converged=False, queue_s=queue_s, solve_s=solve_s,
                    failure=fail))
                self.counters["failed"] += 1
            else:
                results.append(SlotResult(
                    request=req, x=xj, iterations=iters, residual=rel,
                    converged=True, queue_s=queue_s, solve_s=solve_s))
                self.counters["retired"] += 1
            self._slots[j] = None
        return results

    def _true_rel(self, x: np.ndarray, b: np.ndarray) -> float:
        r = b - self._A64 @ x.astype(np.float64)
        return float(np.linalg.norm(r)
                     / max(np.linalg.norm(b), 1e-30))

    def drain(self) -> list[SlotResult]:
        """Run chunks until queue and batch are empty; all retirements."""
        results: list[SlotResult] = []
        while not self.idle():
            got = self.step()
            results.extend(got)
            if not got and self.in_flight == 0 and self._queue:
                # cold batch deferred by the fill timeout: nothing else
                # can arrive inside drain, so launch immediately
                self._admit(time.perf_counter())
        return results

    # ------------------------------------------------------------------ #
    # warm restart (layout-independent, via repro_torch.checkpoint)
    # ------------------------------------------------------------------ #
    def checkpoint(self, path: str, step: int | None = None) -> str:
        """Persist the in-flight batch: global-ordered iterates + RHS block
        + per-slot tols/budgets/request ids, in the JAX package's format.
        Queued (unadmitted) requests are the caller's to resubmit — they
        hold no solver state."""
        from repro_torch.checkpoint import save
        g = self.rs.sol.state_to_global(
            {"x": self._state["x"].permute(1, 2, 0, 3)}, self.layout,
            self.plan)
        tree = {"x": np.asarray(g["x"], np.float32),
                "b": np.asarray(self._B, np.float32)}
        k = self._state["k"].cpu().numpy().astype(np.int32)
        extra = {"n": int(self.plan.n), "nrhs": int(self.cfg.nrhs),
                 "solver": self.cfg.solver,
                 "iteration": k.tolist(),
                 "tol": np.asarray(self._tol, np.float64).tolist(),
                 "rids": [r.rid if r is not None else None
                          for r in self._slots]}
        return save(path, int(np.max(k)) if step is None else step,
                    tree, extra=extra)

    def restore(self, path: str, step: int | None = None) -> list[Request]:
        """Re-enter the latest (or given) checkpoint on THIS engine — any
        grid/partition/format/transport, via ``loop_restart`` re-basing.
        Returns the re-created in-flight requests (fresh clocks)."""
        from repro_torch.checkpoint import latest_step, load
        from repro_torch.solvers.base import to_dist_batch
        cfg = self.cfg
        if step is None:
            step = latest_step(path)
            if step is None:
                raise ValueError(f"restore: no checkpoint under {path!r}")
        like = {"x": np.zeros((cfg.nrhs, self.plan.n), np.float32),
                "b": np.zeros((cfg.nrhs, self.plan.n), np.float32)}
        tree, extra = load(path, step, like)
        if (extra.get("n") != self.plan.n
                or extra.get("nrhs") != cfg.nrhs):
            raise ValueError(
                f"checkpoint is for n={extra.get('n')}, "
                f"nrhs={extra.get('nrhs')}; this engine has "
                f"n={self.plan.n}, nrhs={cfg.nrhs}")
        if self.in_flight or self._queue:
            raise RuntimeError("restore on a busy engine")
        dev = self.plan.device
        B = np.asarray(tree["b"], np.float64)
        self._B = B.copy()
        self._bd = to_dist_batch(B, self.layout, self.plan).permute(
            2, 0, 1, 3).contiguous()
        self._tol = np.asarray(extra["tol"], np.float32)
        self._told = torch.from_numpy(self._tol.copy()).to(dev)
        k = torch.from_numpy(np.asarray(extra["iteration"], np.int32)).to(dev)
        x_entry = self.rs.sol.state_from_global(
            {"x": np.asarray(tree["x"])}, self.layout, self.plan,
            dtype=self._bd.dtype).permute(2, 0, 1, 3).contiguous()
        self._state = self.rs.restart(self._bd, self._told, self._mxd,
                                      x_entry, k)
        now = time.perf_counter()
        restored: list[Request] = []
        for j, rid in enumerate(extra.get("rids", [])):
            if rid is None:
                self._slots[j] = None
                continue
            req = Request(rid=int(rid), b=B[j], tol=float(self._tol[j]),
                          submit_t=now, admit_t=now, slot=j, resumed=True)
            self._next_rid = max(self._next_rid, req.rid + 1)
            self._slots[j] = req
            restored.append(req)
        return restored

    # ------------------------------------------------------------------ #
    def stats(self) -> dict:
        """Engine counters + cache stats + the zero-rebuild evidence:
        ``recompiles`` counts plan, program and kernel-library builds
        after this engine's warm-up — 0 across a serving lifetime."""
        execs = self.cache.executable_counts(self.rs)
        recompiles = sum(max(0, execs[k] - self._exec_baseline[k])
                         for k in execs)
        return {**self.counters,
                "cache": self.cache.stats.as_dict(),
                "executables": execs,
                "recompiles": recompiles}
