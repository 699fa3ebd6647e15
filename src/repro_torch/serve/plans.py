"""Plan/program cache: warm programs for known operators, on one device.

A solve *service* amortises everything the script path pays per run: the
host-side partition/pack (``build_spmv_plan``) and the build of the three
chunked-execution programs (``make_resilient``'s restart/chunk/finish)
with their first run on the device.  The cache is two-level, mirroring
what is reusable:

``PlanKey``
    matrix content hash x (partition knobs, format, transport,
    wire_dtype, device) -> the packed :class:`~repro_torch.core.spmv.SpMVPlan`
    and its layout dict.  Two services over the same operator share one
    plan.

``ProgramKey``
    ``PlanKey`` x (solver, precond, nrhs, backend, maxiter_static,
    options) -> the :class:`~repro_torch.solvers.resilient._Resilient`
    program triple.  A submitted RHS against a known operator runs warm
    programs with no rebuild.

``programs_for`` *warms* a fresh triple at once: one restart + chunk +
finish call on zeros at the exact shapes the engine uses (loop-layout
``(nrhs, n_node, n_core, rc_pad)`` b, per-RHS ``(nrhs,)`` tol), then the
splice path's restart.  PyTorch runs eagerly, so there is no trace to
compile: what the warm run pays up front is the CUDA kernel library's
``nvcc`` build and load at first use and the allocator's first blocks.
That time lands in :attr:`CacheStats.compile_s` (the JAX package's name,
kept) at build, not in the first request's latency.

The JAX package's ``batch_sharding`` (the committed ``NamedSharding``
every serving array rides) has no counterpart: the virtual mesh lives on
one device, whose tensors carry no sharding to key a program on.

The matrix fingerprint hashes the full CSR content (shape, indptr,
indices, values), not just the sparsity pattern: a plan packs *values*
into shard blocks, so same-pattern/different-values operators must miss.
It is the JAX package's hex string for the same CSR.
"""
from __future__ import annotations

import dataclasses
import hashlib
import time

import numpy as np
import torch

__all__ = ["matrix_fingerprint", "PlanKey", "ProgramKey", "CacheStats",
           "PlanCache"]


def matrix_fingerprint(A) -> str:
    """Content hash of a host CSR matrix (shape + indptr + indices +
    values) — the identity of an operator as the cache sees it."""
    h = hashlib.sha256()
    h.update(np.asarray(A.shape, np.int64).tobytes())
    h.update(np.ascontiguousarray(A.indptr, dtype=np.int64).tobytes())
    h.update(np.ascontiguousarray(A.indices, dtype=np.int64).tobytes())
    h.update(np.ascontiguousarray(A.data, dtype=np.float64).tobytes())
    return h.hexdigest()[:16]


@dataclasses.dataclass(frozen=True)
class PlanKey:
    """Identity of one packed SpMV plan.  ``device`` is the port's: a plan
    lives on one device and serves only engines there."""

    fingerprint: str
    n_node: int
    n_core: int
    mode: str
    node_partition: str
    format: str
    transport: str
    wire_dtype: str
    device: str = "cuda"


@dataclasses.dataclass(frozen=True)
class ProgramKey:
    """Identity of one restart/chunk/finish triple."""

    plan: PlanKey
    solver: str
    precond: str
    nrhs: int
    backend: str
    maxiter_static: int
    options: tuple = ()


@dataclasses.dataclass
class CacheStats:
    plan_hits: int = 0
    plan_misses: int = 0
    program_hits: int = 0
    program_misses: int = 0
    compile_s: float = 0.0      # wall time spent building + warming misses

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


class PlanCache:
    """The two-level plan/program cache.

    One cache instance may back many engines/services; keys carry the
    virtual mesh's shape (n_node, n_core) and the device.
    """

    def __init__(self):
        self._plans: dict[PlanKey, tuple] = {}
        self._programs: dict[ProgramKey, object] = {}
        #: plan builds per key (1 once built: a hit never rebuilds)
        self._plan_builds: dict[PlanKey, int] = {}
        self.stats = CacheStats()

    # ------------------------------------------------------------------ #
    def plan_key(self, A, *, n_node: int, n_core: int,
                 mode: str = "balanced", node_partition: str | None = None,
                 format: str = "ell", transport: str = "a2a",
                 wire_dtype: str = "f32", fingerprint: str | None = None,
                 device="cuda") -> PlanKey:
        if node_partition is None:
            node_partition = "nnz" if mode == "balanced" else "rows"
        return PlanKey(
            fingerprint=fingerprint or matrix_fingerprint(A),
            n_node=int(n_node), n_core=int(n_core), mode=mode,
            node_partition=node_partition, format=format,
            transport=transport, wire_dtype=wire_dtype,
            device=str(torch.device(device)))

    def plan_for(self, A, *, n_node: int, n_core: int,
                 mode: str = "balanced", node_partition: str | None = None,
                 format: str = "ell", transport: str = "a2a",
                 wire_dtype: str = "f32", fingerprint: str | None = None,
                 device="cuda"):
        """``(plan, layout)`` for this operator/partition/format/transport
        on ``device``, building (and caching) on first sight."""
        key = self.plan_key(A, n_node=n_node, n_core=n_core, mode=mode,
                            node_partition=node_partition, format=format,
                            transport=transport, wire_dtype=wire_dtype,
                            fingerprint=fingerprint, device=device)
        hit = self._plans.get(key)
        if hit is not None:
            self.stats.plan_hits += 1
            return hit
        self.stats.plan_misses += 1
        t0 = time.perf_counter()
        from repro_torch.core.spmv import build_spmv_plan
        plan, layout = build_spmv_plan(
            A, key.n_node, key.n_core, mode=key.mode,
            node_partition=key.node_partition, format=key.format,
            transport=key.transport, wire_dtype=key.wire_dtype,
            device=key.device)
        self.stats.compile_s += time.perf_counter() - t0
        self._plans[key] = (plan, layout)
        self._plan_builds[key] = self._plan_builds.get(key, 0) + 1
        return plan, layout

    # ------------------------------------------------------------------ #
    def programs_for(self, key: PlanKey, plan, layout, *, solver: str,
                     precond: str, nrhs: int, backend: str = "kernel",
                     maxiter_static: int = 10_000, A=None,
                     options: dict | None = None):
        """The warm program triple for (plan, solver, precond, nrhs).  A
        miss builds via ``make_resilient`` and at once runs restart/chunk/
        finish on zeros at the engine's exact serving shapes, so every
        build second is paid here and counted."""
        pkey = ProgramKey(
            plan=key, solver=solver, precond=precond, nrhs=int(nrhs),
            backend=backend, maxiter_static=int(maxiter_static),
            options=tuple(sorted((options or {}).items())))
        rs = self._programs.get(pkey)
        if rs is not None:
            self.stats.program_hits += 1
            return rs
        self.stats.program_misses += 1
        t0 = time.perf_counter()
        from repro_torch.solvers.resilient import make_resilient
        rs = make_resilient(
            plan, solver=solver, precond=precond, backend=backend,
            neighbor_offsets=layout["neighbor_offsets"],
            maxiter_static=maxiter_static, A=A, layout=layout,
            options=options)
        rs.plan_key = key
        self._warm(rs, plan, nrhs)
        self.stats.compile_s += time.perf_counter() - t0
        self._programs[pkey] = rs
        return rs

    @staticmethod
    def _warm(rs, plan, nrhs: int) -> None:
        """Run all three programs once at serving shapes: loop-layout b,
        per-RHS tol vector.  An all-idle batch (b = 0, tol = 1) is
        inactive on entry, so the warm chunk runs one gated no-op
        iteration.  ``restart`` runs a second time on an ``x`` selected
        from the chunk's output, as a splice forms it.  On CUDA the first
        launch builds and loads the kernel library here."""
        dev = plan.device
        shape = (nrhs, plan.n_node, plan.n_core, plan.rc_pad)
        bd = torch.zeros(shape, dtype=torch.float32, device=dev)
        tol = torch.ones((nrhs,), dtype=torch.float32, device=dev)
        mxd = torch.tensor(1, dtype=torch.int32, device=dev)
        k0 = torch.zeros((nrhs,), dtype=torch.int32, device=dev)
        state = rs.restart(bd, tol, mxd, torch.zeros_like(bd), k0)
        state = rs.chunk(bd, tol, mxd, 1, state)[0]
        rs.finish(bd, tol, mxd, state)
        keep = torch.zeros((nrhs,), dtype=torch.bool, device=dev)
        rs.restart(bd, tol, mxd,
                   torch.where(keep[:, None, None, None], state["x"], 0.0),
                   k0)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    # ------------------------------------------------------------------ #
    def executable_counts(self, rs) -> dict:
        """Builds behind one warm program triple — the zero-rebuild
        evidence, each flat across a serving lifetime: ``plan`` (builds
        of its plan by this cache: 1), ``programs`` (builds of the triple
        by ``make_resilient``: 1) and ``kernel_library`` (loads of the
        CUDA kernel library in this process: 1 once a kernel launched, 0
        on the CPU)."""
        from repro_torch.kernels import spmv_cuda
        return {"plan": self._plan_builds.get(getattr(rs, "plan_key", None),
                                              0),
                "programs": int(rs.builds),
                "kernel_library": spmv_cuda.loads()}
