"""Serve-smoke gate: the solve service on one device.

Usage:  python -m repro_torch.testing.serve_check [--device cpu] [...]

Drives the continuous-batching engine end to end on the virtual
``--n-node x --n-core`` mesh held on ``--device`` (default ``cuda``) and
checks the service's three gates:

  1. correctness — N queued requests (N >= 4 x nrhs, per-request tols
     cycling {tol, 3 tol, 10 tol} so slots retire at different times and
     every request enters via a mid-solve splice) all converge, and every
     solution matches the host numpy f64 CG oracle within the solver's
     f32 bounds (``BOUNDS``, the JAX package's ``serve_check``'s);
  2. economics — the same requests served one at a time through a warm
     ``make_solver`` on the same plan take longer: continuous batching
     must win on makespan by ``--min-speedup``;
  3. cache — a second service over the same operator from the same
     :class:`~repro_torch.serve.plans.PlanCache` is a pure hit (no plan
     rebuild, no build seconds added), and the serving engine adds no
     plan, program or kernel-library build after warm-up
     (``recompiles == 0``).

Prints verdict lines and a final ``OK``/``FAIL`` (exit 0 / 1).
"""
from __future__ import annotations

import argparse
import sys
import time

#: f32 (true-residual, oracle solution error) bounds per solver, as the
#: JAX package's serve_check and resilience_check hold them
BOUNDS = {"cg": (2e-4, 1e-2), "pipelined_cg": (1e-3, 3e-2),
          "chebyshev": (2e-3, 5e-2)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n-node", type=int, default=2)
    ap.add_argument("--n-core", type=int, default=4)
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--nrhs", type=int, default=4)
    ap.add_argument("--solver", default="cg")
    ap.add_argument("--precond", default="jacobi")
    ap.add_argument("--format", default="ell")
    ap.add_argument("--transport", default="a2a")
    ap.add_argument("--n-surface", type=int, default=48)
    ap.add_argument("--layers", type=int, default=8)
    ap.add_argument("--tol", type=float, default=1e-5)
    ap.add_argument("--check-every", type=int, default=20)
    ap.add_argument("--min-speedup", type=float, default=1.05,
                    help="continuous makespan must beat sequential by "
                         "at least this factor")
    ap.add_argument("--device", default="cuda",
                    help="where the service runs: cuda (default) or cpu")
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    from repro_torch.core.spmv import to_dist
    from repro_torch.serve import EngineConfig, PlanCache, SolveService
    from repro_torch.solvers import make_solver
    from repro_torch.sparse import graded_extruded_mesh_matrix
    from repro_torch.testing.refine_check import host_cg

    def sync():
        if torch.device(args.device).type == "cuda":
            torch.cuda.synchronize()

    A = graded_extruded_mesh_matrix(args.n_surface, args.layers, seed=0)
    n = A.n_rows
    N, K = args.requests, args.nrhs
    rng = np.random.default_rng(0)
    B = rng.normal(size=(N, n))
    tols = [args.tol * (1, 3, 10)[i % 3] for i in range(N)]

    cache = PlanCache()
    cfg = EngineConfig(
        nrhs=K, n_node=args.n_node, n_core=args.n_core,
        solver=args.solver, precond=args.precond, format=args.format,
        transport=args.transport, check_every=args.check_every,
        default_tol=args.tol)
    svc = SolveService(A, cfg, cache=cache, device=args.device)
    engine = svc.engine
    plan, layout = engine.plan, engine.layout

    # one-at-a-time baseline: a warm make_solver on the same plan
    seq_solve = make_solver(
        plan, nrhs=None, solver=args.solver, precond=args.precond,
        transport=args.transport,
        neighbor_offsets=layout["neighbor_offsets"], A=A, layout=layout)
    seq_solve(to_dist(B[0], layout, plan), tol=args.tol, maxiter=50)
    sync()

    t0 = time.perf_counter()
    for i in range(N):
        seq_solve(to_dist(B[i], layout, plan), tol=tols[i],
                  maxiter=cfg.maxiter)
    sync()
    t_seq = time.perf_counter() - t0

    futs = [svc.submit(B[i], tol=tols[i]) for i in range(N)]
    t0 = time.perf_counter()
    results = svc.drain()
    sync()
    t_cont = time.perf_counter() - t0
    resolved = [f.result() for f in futs]

    ok = True
    served = (len(results) == len(resolved) == N)
    print(f"SERVED {len(results)}/{N} {'ok' if served else 'BAD'}")
    ok &= served

    tr_max, dx_max = BOUNDS.get(args.solver, (2e-3, 5e-2))
    worst_tr, worst_dx = 0.0, 0.0
    for i, r in enumerate(resolved):
        xh = host_cg(A, B[i], tol=1e-10, maxiter=20_000)
        dx = float(np.linalg.norm(r.x - xh)
                   / max(float(np.linalg.norm(xh)), 1e-30))
        worst_tr, worst_dx = max(worst_tr, r.residual), max(worst_dx, dx)
    conv = worst_tr < tr_max and worst_dx < dx_max
    print(f"ORACLE worst_true_rel {worst_tr:.3e} (< {tr_max:.0e}) "
          f"worst_dx {worst_dx:.3e} (< {dx_max:.0e}) "
          f"{'ok' if conv else 'BAD'}")
    ok &= conv

    st = engine.stats()
    spliced = st["splices"] >= N        # every request entered via splice
    print(f"SPLICES {st['splices']} (>= {N}) CHUNKS {st['chunks']} "
          f"{'ok' if spliced else 'BAD'}")
    ok &= spliced

    speedup = t_seq / max(t_cont, 1e-9)
    fast = speedup >= args.min_speedup
    print(f"MAKESPAN sequential {t_seq:.3f}s continuous {t_cont:.3f}s "
          f"speedup {speedup:.2f}x (>= {args.min_speedup}x) "
          f"{'ok' if fast else 'BAD'}")
    ok &= fast

    warm = st["recompiles"] == 0
    print(f"RECOMPILES {st['recompiles']} EXECUTABLES {st['executables']} "
          f"{'ok' if warm else 'BAD'}")
    ok &= warm

    # a second service over the same operator: pure cache hit
    before = dict(cache.stats.as_dict())
    SolveService(A, cfg, cache=cache, device=args.device)
    after = cache.stats.as_dict()
    hit = (after["plan_hits"] == before["plan_hits"] + 1
           and after["program_hits"] == before["program_hits"] + 1
           and after["plan_misses"] == before["plan_misses"]
           and after["program_misses"] == before["program_misses"]
           and after["compile_s"] == before["compile_s"])
    print(f"CACHE {after} {'ok' if hit else 'BAD'}")
    ok &= hit

    print("OK" if ok else "FAIL")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
