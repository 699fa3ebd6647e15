"""Solve-serving CLI: queued RHS through the continuous-batching engine.

A thin CLI over ``repro_torch.serve``, on one device (``--device``,
default ``cuda``; ``cpu`` runs the kernels' plain versions):

  PYTHONPATH=src python -m repro_torch.launch.serve \\
      --n-node 2 --n-core 2 --requests 16 --nrhs 4 --tol 1e-5

Prints one JSON dict: per-request convergence/latency aggregates, engine
counters, and the plan-cache stats (hits / misses / build seconds).
"""
from __future__ import annotations

import argparse
import json
import sys
import time


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n-node", type=int, default=1)
    ap.add_argument("--n-core", type=int, default=1)
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--nrhs", type=int, default=4, help="batch slots")
    ap.add_argument("--solver", default="cg")
    ap.add_argument("--precond", default="jacobi")
    ap.add_argument("--format", default="ell")
    ap.add_argument("--transport", default="a2a")
    ap.add_argument("--wire-dtype", default="f32")
    ap.add_argument("--matrix", default="graded",
                    choices=["mesh", "graded"])
    ap.add_argument("--n-surface", type=int, default=60)
    ap.add_argument("--layers", type=int, default=8)
    ap.add_argument("--tol", type=float, default=1e-5)
    ap.add_argument("--tol-spread", action="store_true",
                    help="cycle requests through {tol, 3*tol, 10*tol} so "
                         "columns retire at different times (exercises "
                         "the mid-solve splice)")
    ap.add_argument("--check-every", type=int, default=25)
    ap.add_argument("--maxiter", type=int, default=10_000)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--oracle", action="store_true",
                    help="also solve every request with the host numpy "
                         "f64 CG oracle and report the worst relative "
                         "solution error")
    ap.add_argument("--device", default="cuda",
                    help="where the engine runs: cuda (default) or cpu")
    args = ap.parse_args(argv)

    import numpy as np

    from repro_torch.serve import EngineConfig, PlanCache, SolveService
    from repro_torch.sparse import (extruded_mesh_matrix,
                                    graded_extruded_mesh_matrix)

    gen = (graded_extruded_mesh_matrix if args.matrix == "graded"
           else extruded_mesh_matrix)
    A = gen(args.n_surface, args.layers, seed=0)
    cfg = EngineConfig(
        nrhs=args.nrhs, n_node=args.n_node, n_core=args.n_core,
        solver=args.solver, precond=args.precond, format=args.format,
        transport=args.transport, wire_dtype=args.wire_dtype,
        check_every=args.check_every, maxiter=args.maxiter,
        default_tol=args.tol)
    t0 = time.perf_counter()
    svc = SolveService(A, cfg, cache=PlanCache(), device=args.device)
    t_build = time.perf_counter() - t0

    rng = np.random.default_rng(args.seed)
    B = rng.normal(size=(args.requests, A.n_rows))
    tols = ([args.tol, 3 * args.tol, 10 * args.tol]
            if args.tol_spread else [args.tol])
    futs = [svc.submit(B[i], tol=tols[i % len(tols)])
            for i in range(args.requests)]
    t0 = time.perf_counter()
    results = svc.drain()
    t_serve = time.perf_counter() - t0
    resolved = [f.result() for f in futs]

    out = {"requests": args.requests, "nrhs": args.nrhs,
           "solver": args.solver, "n_node": args.n_node,
           "n_core": args.n_core, "n_rows": A.n_rows,
           "device": str(svc.engine.device),
           "served": len(results),
           "converged": len(resolved),
           "iterations": [r.iterations for r in resolved],
           "worst_residual_over_tol": max(
               r.residual / r.tol for r in resolved),
           "build_s": round(t_build, 2), "serve_s": round(t_serve, 3),
           "solves_per_s": round(len(results) / max(t_serve, 1e-9), 1),
           **{k: v for k, v in svc.stats().items()
              if k != "executables"}}
    if args.oracle:
        from repro_torch.testing.refine_check import host_cg
        errs = []
        for i, r in enumerate(resolved):
            xo = host_cg(A, B[i], tol=1e-10, maxiter=20_000)
            errs.append(float(np.linalg.norm(r.x - xo)
                              / np.linalg.norm(xo)))
        out["worst_oracle_err"] = max(errs)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
