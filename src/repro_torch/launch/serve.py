"""Solve-serving CLI: queued RHS through the continuous-batching engine.

A thin CLI over ``repro_torch.serve``, on one device (``--device``,
default ``cuda``; ``cpu`` runs the kernels' plain versions):

  PYTHONPATH=src python -m repro_torch.launch.serve \\
      --n-node 2 --n-core 2 --requests 16 --nrhs 4 --tol 1e-5

Prints one JSON dict: per-request convergence/latency aggregates, engine
counters, and the plan-cache stats (hits / misses / build seconds).

``--mesh process`` serves on a process mesh (``repro_torch.launch.mesh``):
one spawned rank per shard (``--dist-backend`` gloo or nccl), requests
submitted on rank 0; the dict is rank 0's, plus ``ranks`` and
``ranks_agree`` (every rank retired the same requests at the same
iterations).
"""
from __future__ import annotations

import argparse
import json
import sys
import time

from repro_torch.launch.mesh import add_dist_backend, dist_backend


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
    ap.add_argument("--mesh", default="virtual",
                    choices=["virtual", "process"],
                    help="virtual: the grid on one device; process: one "
                         "spawned rank per shard")
    add_dist_backend(ap)
    args = ap.parse_args(argv)
    dist_backend(ap, args, args.n_node * args.n_core)

    if args.mesh == "process":
        from repro_torch.launch.mesh import spawn_cg_mesh
        ranks = spawn_cg_mesh(_rank_run, args.n_node, args.n_core,
                              args.device, backend=args.dist_backend,
                              args=(args,), timeout=3600)
        out = ranks[0]
        out.update(ranks=len(ranks), ranks_agree=all(
            r["iterations"] == out["iterations"] for r in ranks))
    else:
        out = run(args)
    print(json.dumps(out))
    return 0


def _rank_run(mesh, args) -> dict:
    return run(args, mesh)


def run(args, mesh=None) -> dict:
    """Serve ``--requests`` RHS; the JSON dict (on a process ``mesh``
    every rank serves, rank 0 submits, and ``iterations`` is each rank's
    own)."""
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
    svc = SolveService(A, cfg, cache=PlanCache(),
                       device=args.device if mesh is None else mesh.device,
                       mesh=mesh)
    t_build = time.perf_counter() - t0

    rng = np.random.default_rng(args.seed)
    B = rng.normal(size=(args.requests, A.n_rows))
    tols = ([args.tol, 3 * args.tol, 10 * args.tol]
            if args.tol_spread else [args.tol])
    decides = mesh is None or mesh.rank == 0
    futs = [svc.submit(B[i], tol=tols[i % len(tols)])
            for i in range(args.requests)] if decides else []
    t0 = time.perf_counter()
    results = svc.drain()
    t_serve = time.perf_counter() - t0
    # rank 0's futures; elsewhere the results themselves (x is rank 0's)
    resolved = [f.result() for f in futs] if decides else results

    out = {"requests": args.requests, "nrhs": args.nrhs,
           "solver": args.solver, "n_node": args.n_node,
           "n_core": args.n_core, "n_rows": A.n_rows,
           "device": str(svc.engine.device),
           "served": len(results),
           "converged": len(resolved),
           "iterations": [r.iterations for r in resolved],
           "worst_residual_over_tol": max(
               r.residual / r.tol for r in resolved) if decides else None,
           "build_s": round(t_build, 2), "serve_s": round(t_serve, 3),
           "solves_per_s": round(len(results) / max(t_serve, 1e-9), 1),
           **{k: v for k, v in svc.stats().items()
              if k != "executables"}}
    if args.oracle and decides:
        from repro_torch.testing.refine_check import host_cg
        errs = []
        for i, r in enumerate(resolved):
            xo = host_cg(A, B[i], tol=1e-10, maxiter=20_000)
            errs.append(float(np.linalg.norm(r.x - xo)
                              / np.linalg.norm(xo)))
        out["worst_oracle_err"] = max(errs)
    return out


if __name__ == "__main__":
    sys.exit(main())
