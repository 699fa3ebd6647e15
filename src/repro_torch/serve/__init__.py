"""Solve-as-a-service: persistent engine + continuous multi-RHS batching.

The serving layer turns the solver stack into a long-lived service: a
plan/program cache (``repro_torch.serve.plans``) keeps warm programs per
operator, a continuous-batching engine (``repro_torch.serve.engine``)
keeps every batch slot busy by retiring converged columns and splicing
queued RHS in mid-solve, every SpMV of the batch one launch of the
batched kernel, and a request API (``repro_torch.serve.service``) wraps
it in submit/future/drain with structured per-request accounting.
"""
from repro_torch.serve.engine import EngineConfig, SolveEngine
from repro_torch.serve.plans import PlanCache, matrix_fingerprint
from repro_torch.serve.service import (SolveFuture, SolveResult,
                                       SolveService)

__all__ = ["EngineConfig", "SolveEngine", "PlanCache",
           "matrix_fingerprint", "SolveFuture", "SolveResult",
           "SolveService"]
