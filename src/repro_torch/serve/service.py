"""The request-facing API over :class:`~repro_torch.serve.engine.SolveEngine`.

``SolveService`` is what a caller holds: ``submit(b, tol) -> future``,
``drain() -> [results]``.  The service is synchronous and single-threaded
— a future is resolved by *pumping* the engine (running chunk steps) from
``result()`` / ``drain()``, so there is no background thread and no lock:
the deterministic, testable shape the rest of the repo's drivers use.

Admission policy lives at the boundary:

* malformed requests (shape, ``tol <= 0``, ``deadline_s <= 0``) raise
  ``ValueError`` at ``submit`` — before the RHS is queued;
* a queue past ``max_queue`` raises the structured
  :class:`~repro_torch.solvers.resilient.SolveFailure` (reason ``queue_full``)
  at ``submit`` — backpressure the caller can see;
* per-request deadlines and iteration budgets fail *as results*: the
  future resolves, ``result()`` raises the ``SolveFailure`` (reasons
  ``deadline`` / ``maxiter``), and the batch keeps serving everyone else.

Each success carries the request's full accounting: iterations, the host
f64 true relative residual, queue latency (submit -> admitted into a
slot) and solve latency (admitted -> retired).
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.serve.engine import EngineConfig, SolveEngine
from repro_torch.serve.plans import PlanCache
from repro_torch.solvers.resilient import SolveFailure

__all__ = ["SolveResult", "SolveFuture", "SolveService"]


@dataclasses.dataclass
class SolveResult:
    """Structured per-request outcome."""

    request_id: int
    x: np.ndarray                       # (n,) global solution
    iterations: int
    residual: float                     # host f64 true relative residual
    tol: float
    queue_s: float                      # submit -> admitted
    solve_s: float                      # admitted -> retired


class SolveFuture:
    """Handle for one submitted RHS.  ``result()`` pumps the engine until
    this request retires; it raises the request's ``SolveFailure`` if the
    solve failed (deadline / maxiter)."""

    def __init__(self, service: "SolveService", rid: int):
        self._service = service
        self.request_id = rid
        self._result: SolveResult | None = None
        self._failure: SolveFailure | None = None

    def done(self) -> bool:
        return self._result is not None or self._failure is not None

    def result(self, max_steps: int = 1_000_000) -> SolveResult:
        steps = 0
        while not self.done():
            if steps >= max_steps:
                raise RuntimeError(
                    f"request {self.request_id} unresolved after "
                    f"{max_steps} engine steps")
            self._service._pump()
            steps += 1
        if self._failure is not None:
            raise self._failure
        return self._result

    # the service resolves futures from retirement records
    def _resolve(self, result: SolveResult | None,
                 failure: SolveFailure | None):
        self._result, self._failure = result, failure


class SolveService:
    """``submit``/``drain`` over a persistent continuous-batching engine.

    ``A`` is the host CSR operator; ``config`` the engine configuration
    (validated up front, listing registered names on any unknown);
    ``cache`` an optional shared :class:`~repro_torch.serve.plans.PlanCache`
    so several services over the same operator share plans and warm
    programs; ``device`` where the engine runs (``cuda`` unless the caller
    passes another, e.g. ``"cpu"``).
    """

    def __init__(self, A, config: EngineConfig | None = None,
                 cache: PlanCache | None = None, device=None):
        self.engine = SolveEngine(A, config or EngineConfig(),
                                  device=device, cache=cache)
        self._futures: dict[int, SolveFuture] = {}

    # ------------------------------------------------------------------ #
    def submit(self, b, tol: float | None = None,
               deadline_s: float | None = None) -> SolveFuture:
        """Queue one RHS; returns its future.  Raises ``ValueError`` on a
        malformed request and ``SolveFailure(reason='queue_full')`` past
        the admission bound — both immediately, nothing is queued."""
        req = self.engine.submit(b, tol=tol, deadline_s=deadline_s)
        fut = SolveFuture(self, req.rid)
        self._futures[req.rid] = fut
        return fut

    def drain(self) -> list[SolveResult]:
        """Serve until queue and batch are empty.  Returns the successful
        results (submit order); failed requests keep their failure on the
        future, where ``result()`` raises it."""
        for rec in self.engine.drain():
            self._record(rec)
        done = [f for f in self._futures.values() if f._result is not None]
        return sorted((f._result for f in done),
                      key=lambda r: r.request_id)

    def stats(self) -> dict:
        return self.engine.stats()

    # ------------------------------------------------------------------ #
    def _pump(self):
        for rec in self.engine.step():
            self._record(rec)

    def _record(self, rec):
        fut = self._futures.get(rec.request.rid)
        if fut is None:                 # engine-level request (restore)
            fut = SolveFuture(self, rec.request.rid)
            self._futures[rec.request.rid] = fut
        if rec.failure is not None:
            fut._resolve(None, rec.failure)
        else:
            fut._resolve(SolveResult(
                request_id=rec.request.rid, x=rec.x,
                iterations=rec.iterations, residual=rec.residual,
                tol=rec.request.tol, queue_s=rec.queue_s,
                solve_s=rec.solve_s), None)
