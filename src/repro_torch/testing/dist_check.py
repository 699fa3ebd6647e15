"""Distributed correctness check of the port on one device.

Usage:  python -m repro_torch.testing.dist_check [--device cpu] \
            --n-node 4 --n-core 2 --mode balanced [--cg] [--fused] \
            [--solver all --nrhs 4] [--check-every 25 --inject-fault nan@30]

The port of ``repro.testing.dist_check``: the same flags, output lines
(``SPMV_REL_ERR``, ``CG_ITERS``, ``FUSED_ITERS``, ``SOLVER``,
``RESILIENT``, then ``OK`` / ``FAIL``), thresholds and f64 host-CG oracle.
The whole ``--n-node x --n-core`` grid is the virtual mesh on
``--device`` (default ``cuda``): no subprocess, no fake devices.
``--backend`` selects the SpMV line's local matvec: ``kernel`` (the
wrappers: the CUDA kernels on the card, their plain versions on the CPU)
or ``plain`` (the plain versions on any device); the solves always run
the wrappers, which the port selects by device.  ``--inject-fault
preempt@N`` SIGKILLs this process mid-solve.
"""
from __future__ import annotations

import argparse
import sys

import numpy as np

from repro_torch.testing.refine_check import host_cg


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n-node", type=int, default=4)
    ap.add_argument("--n-core", type=int, default=2)
    ap.add_argument("--mode", default="balanced")
    ap.add_argument("--node-partition", default=None,
                    choices=["rows", "nnz"])
    ap.add_argument("--backend", default="kernel",
                    choices=["kernel", "plain"])
    ap.add_argument("--transport", default="a2a",
                    help="halo transport (repro_torch.core.transport); "
                         "'auto' autotunes on the device and stamps the "
                         "plan")
    ap.add_argument("--format", default="ell",
                    help="shard storage format (repro_torch.sparse.formats)")
    ap.add_argument("--matrix", default="mesh",
                    choices=["mesh", "graded", "random"])
    ap.add_argument("--n-surface", type=int, default=80)
    ap.add_argument("--layers", type=int, default=6)
    ap.add_argument("--n", type=int, default=400)
    ap.add_argument("--cg", action="store_true")
    ap.add_argument("--fused", action="store_true",
                    help="also run the fused CG and compare it against "
                         "the unfused cg_solve")
    ap.add_argument("--solver", default=None,
                    help="verify a registered solver against the numpy f64 "
                         "host-CG oracle; 'all' sweeps every registered "
                         "solver")
    ap.add_argument("--precond", default="jacobi",
                    help="preconditioner for --solver runs")
    ap.add_argument("--nrhs", type=int, default=0,
                    help="with --solver: also run a batched (nrhs, n) solve "
                         "and check every column against the oracle")
    ap.add_argument("--check-every", type=int, default=0,
                    help="with --solver: run under the resilient driver in "
                         "chunks of this many iterations instead of the "
                         "monolithic loop")
    ap.add_argument("--inject-fault", default=None, metavar="KIND@ITER",
                    help="with --check-every: arm a deterministic fault "
                         "(nan|bitflip|preempt, e.g. 'nan@30'): the "
                         "resilient driver must detect, roll back, and "
                         "still converge (preempt SIGKILLs this process)")
    ap.add_argument("--resume-from", default=None,
                    help="with --check-every: resume from the latest "
                         "checkpoint in this directory")
    ap.add_argument("--checkpoint-dir", default=None,
                    help="with --check-every: persist per-chunk "
                         "checkpoints here")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from repro_torch.core import (build_spmv_plan, from_dist, make_cg,
                                  make_shard_body, make_spmv, to_dist)
    from repro_torch.sparse import (extruded_mesh_matrix,
                                    graded_extruded_mesh_matrix,
                                    random_spd_matrix)

    if args.matrix == "mesh":
        A = extruded_mesh_matrix(args.n_surface, args.layers, seed=0)
    elif args.matrix == "graded":
        A = graded_extruded_mesh_matrix(args.n_surface, args.layers, seed=0)
    else:
        A = random_spd_matrix(args.n, nnz_per_row=9, seed=0)

    plan, layout = build_spmv_plan(A, args.n_node, args.n_core,
                                   mode=args.mode,
                                   node_partition=args.node_partition,
                                   format=args.format, device=args.device)
    nb = layout["node_bounds"]
    print(f"FORMAT {layout['format']} "
          f"NODE_SIZES {np.diff(nb).tolist()} "
          f"NODE_IMB {layout['stats']['node_imbalance']:.3f} "
          f"CORE_IMB {layout['stats']['core_imbalance']:.3f} "
          f"WASTE {layout['stats']['padding_waste']:.3f}")
    spmv = make_spmv(plan, transport=args.transport,
                     neighbor_offsets=layout["neighbor_offsets"])
    print(f"TRANSPORT {spmv.transport}"
          + (" (auto)" if args.transport == "auto" else ""))
    if args.transport == "auto":
        # the autotuner stamped its winner into the plan; later builds
        # follow the stamp instead of re-running the timing sweep
        args.transport = None
    if args.backend == "plain":
        spmv = make_shard_body(plan, transport=args.transport,
                               neighbor_offsets=layout["neighbor_offsets"],
                               backend="plain")

    rng = np.random.default_rng(1)
    x = rng.normal(size=A.n_rows)
    y_ref = A.matvec(x)
    y = from_dist(spmv(to_dist(x, layout, plan)), layout, plan)
    err = float(np.abs(y - y_ref).max() / np.abs(y_ref).max())
    print(f"SPMV_REL_ERR {err:.3e}")
    ok = err < 5e-5

    if args.cg or args.fused:
        # tol above the float32 attainable-accuracy floor of these small
        # matrices (~1e-4 true residual): below it iteration counts are
        # reduction-order noise
        cg_tol = 1e-5
        solve = make_cg(plan)
        b = rng.normal(size=A.n_rows)
        bd = to_dist(b, layout, plan)
        xd, iters, rel = solve(bd, tol=cg_tol, maxiter=2000)
        xs = from_dist(xd, layout, plan)
        true_rel = float(np.linalg.norm(A.matvec(xs) - b) / np.linalg.norm(b))
        print(f"CG_ITERS {int(iters)} CG_REL {float(rel):.3e} "
              f"TRUE_REL {true_rel:.3e}")
        ok = ok and true_rel < 2e-4 and int(iters) < 2000

    if args.fused:
        fsolve = make_cg(plan, fused=True, transport=args.transport,
                         neighbor_offsets=layout["neighbor_offsets"])
        xf, itf, relf = fsolve(bd, tol=cg_tol, maxiter=2000)
        xfs = from_dist(xf, layout, plan)
        f_rel = float(np.linalg.norm(A.matvec(xfs) - b) / np.linalg.norm(b))
        dx = float(np.abs(xfs - xs).max() / max(np.abs(xs).max(), 1e-30))
        diters = abs(int(itf) - int(iters))
        # the fused solution must agree with a solve that never touches
        # the distributed layout
        xh = host_cg(A, b, tol=1e-8, maxiter=4000)
        dx_host = float(np.linalg.norm(xfs - xh)
                        / max(np.linalg.norm(xh), 1e-30))
        print(f"FUSED_ITERS {int(itf)} FUSED_REL {float(relf):.3e} "
              f"FUSED_TRUE_REL {f_rel:.3e} DX {dx:.3e} DITERS {diters} "
              f"DX_HOST {dx_host:.3e}")
        ok = (ok and f_rel < 2e-4 and diters <= 1 and dx < 1e-3
              and dx_host < 1e-2)

    if args.solver:
        ok = solvers(args, A, plan, layout, rng,
                     b if (args.cg or args.fused) else None) and ok

    print("OK" if ok else "FAIL")
    return 0 if ok else 1


def solvers(args, A, plan, layout, rng, b) -> bool:
    """The ``--solver`` lines: each solver (monolithic or resilient, and
    batched with ``--nrhs``) against the f64 host-CG oracle."""
    from repro_torch.core import from_dist, to_dist
    from repro_torch.solvers import (available_solvers, from_dist_batch,
                                     make_solver, resilient_solve,
                                     to_dist_batch)

    solver_tol = 1e-5
    # f32 attainable true-residual / solution-error floors per solver:
    # pipelined CG trades ~1 digit of attainable accuracy for the overlap,
    # Chebyshev stops on its a-priori error bound
    bounds = {"cg": (2e-4, 1e-2), "pipelined_cg": (1e-3, 3e-2),
              "chebyshev": (2e-3, 5e-2)}
    names = (available_solvers() if args.solver == "all"
             else tuple(args.solver.split(",")))
    b = rng.normal(size=A.n_rows) if b is None else b
    bd = to_dist(b, layout, plan)
    xh = host_cg(A, b, tol=1e-10, maxiter=20_000)
    xh_norm = max(float(np.linalg.norm(xh)), 1e-30)
    if args.nrhs > 1:
        B = np.random.default_rng(11).normal(size=(args.nrhs, A.n_rows))
        Bd = to_dist_batch(B, layout, plan)
        Xh = [host_cg(A, B[j], tol=1e-10, maxiter=20_000)
              for j in range(args.nrhs)]
    ok = True
    for name in names:
        tr_max, dx_max = bounds.get(name, (2e-3, 5e-2))
        if args.check_every > 0:
            # chunking (and any injected fault + rollback) must not change
            # where the solve lands
            from repro_torch.runtime.fault import FaultInjector
            inj = (FaultInjector.parse(args.inject_fault)
                   if args.inject_fault else None)
            res = resilient_solve(
                plan, b, layout=layout, A=A, solver=name,
                precond=args.precond, transport=args.transport,
                neighbor_offsets=layout["neighbor_offsets"],
                tol=solver_tol, maxiter=5000, check_every=args.check_every,
                checkpoint_dir=args.checkpoint_dir,
                resume_from=args.resume_from, injector=inj)
            dxh = float(np.linalg.norm(res.x - xh)) / xh_norm
            line_ok = (res.converged and res.true_rel < tr_max
                       and dxh < dx_max)
            if inj is not None and inj.kind != "preempt":
                # an armed fault must trip the guard: zero rollbacks means
                # the injection was a no-op
                line_ok = line_ok and res.rollbacks > 0
            print(f"RESILIENT {name} PRECOND {args.precond} "
                  f"ITERS {int(np.max(res.iters))} "
                  f"CHUNKS {res.chunks} ROLLBACKS {res.rollbacks} "
                  f"TRUE_REL {res.true_rel:.3e} DX_HOST {dxh:.3e} "
                  f"{'ok' if line_ok else 'BAD'}")
            ok = ok and line_ok
            continue
        solve = make_solver(plan, solver=name, precond=args.precond,
                            transport=args.transport,
                            neighbor_offsets=layout["neighbor_offsets"],
                            A=A, layout=layout)
        xd, its, rel = solve(bd, tol=solver_tol, maxiter=5000)
        xs = from_dist(xd, layout, plan)
        tr = float(np.linalg.norm(A.matvec(xs) - b) / np.linalg.norm(b))
        dxh = float(np.linalg.norm(xs - xh)) / xh_norm
        line_ok = tr < tr_max and dxh < dx_max and int(its) < 5000
        print(f"SOLVER {name} PRECOND {args.precond} ITERS {int(its)} "
              f"REL {float(rel):.3e} TRUE_REL {tr:.3e} "
              f"DX_HOST {dxh:.3e} {'ok' if line_ok else 'BAD'}")
        ok = ok and line_ok
        if args.nrhs > 1:
            bsolve = make_solver(plan, solver=name, precond=args.precond,
                                 transport=args.transport,
                                 neighbor_offsets=layout["neighbor_offsets"],
                                 nrhs=args.nrhs, A=A, layout=layout)
            Xd, itb, _ = bsolve(Bd, tol=solver_tol, maxiter=5000)
            Xs = from_dist_batch(Xd, layout, plan)
            worst = max(float(np.linalg.norm(Xs[j] - Xh[j]))
                        / max(float(np.linalg.norm(Xh[j])), 1e-30)
                        for j in range(args.nrhs))
            itb = np.asarray(itb.cpu())
            b_ok = worst < dx_max and int(itb.max()) < 5000
            print(f"SOLVER {name} NRHS {args.nrhs} ITERS {itb.tolist()} "
                  f"WORST_DX_HOST {worst:.3e} {'ok' if b_ok else 'BAD'}")
            ok = ok and b_ok
    return ok


if __name__ == "__main__":
    sys.exit(main())
