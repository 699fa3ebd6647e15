"""Mixed-precision refinement over lossy halo wire, checked on one device.

Usage:  python -m repro_torch.testing.refine_check [--device cpu]

``make_refine(solver=<solver>, wire_dtype=<wd>)`` must converge to
``--tol`` (default 1e-7, below the f32 floor) against a numpy f64 CG
oracle, for every registered solver × every wire dtype, on the virtual
``--n-node x --n-core`` mesh held on ``--device`` (default ``cuda``).
Prints one ``REFINE`` line per pair.  Then a chunked ``resilient_solve``
(cg, int8 wire) to a tol above the int8 floor must converge with zero
rollbacks: quantisation noise must not look like corruption to the
codec-aware guard (one ``RESILIENT`` line).  Last line ``OK`` (exit 0) or
``FAIL``.
"""
from __future__ import annotations

import argparse
import sys

import numpy as np


def host_cg(A, b, tol: float = 1e-8, maxiter: int = 4000) -> np.ndarray:
    """Reference numpy (float64) Jacobi-preconditioned CG."""
    d = np.asarray(A.diagonal(), dtype=np.float64)
    m_inv = np.where(d != 0, 1.0 / np.where(d != 0, d, 1.0), 0.0)
    x = np.zeros(A.n_rows)
    r = np.asarray(b, np.float64).copy()
    z = m_inv * r
    p = z.copy()
    rz = float(r @ z)
    bnorm = max(float(np.linalg.norm(b)), 1e-30)
    for _ in range(maxiter):
        if np.linalg.norm(r) / bnorm <= tol:
            break
        ap = A.matvec(p)
        alpha = rz / float(p @ ap)
        x += alpha * p
        r -= alpha * ap
        z = m_inv * r
        rz_new = float(r @ z)
        p = z + (rz_new / rz) * p
        rz = rz_new
    return x


def inner_tol_for(wire_dtype: str, solver: str = "cg") -> float:
    """The inner target just above the inner solve's lossy-wire floor:
    cruder codecs need a looser (cheaper) inner solve, and pipelined CG's
    drift adds about a digit on top (``solvers/krylov.py``)."""
    tol = {"f32": 1e-5, "bf16": 1e-4}.get(wire_dtype, 1e-3)
    if solver == "pipelined_cg" and wire_dtype != "f32":
        tol = max(tol * 10, 1e-3)
    return tol


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n-node", type=int, default=4)
    ap.add_argument("--n-core", type=int, default=2)
    ap.add_argument("--mode", default="balanced")
    ap.add_argument("--format", default="ell")
    ap.add_argument("--transport", default="a2a")
    ap.add_argument("--matrix", default="graded",
                    choices=["mesh", "graded", "random"])
    ap.add_argument("--n-surface", type=int, default=80)
    ap.add_argument("--layers", type=int, default=6)
    ap.add_argument("--n", type=int, default=400)
    ap.add_argument("--solvers", default="all",
                    help="comma list of registered solvers, or 'all'")
    ap.add_argument("--wire-dtypes", default="all",
                    help="comma list of wire dtypes, or 'all'")
    ap.add_argument("--tol", type=float, default=1e-7,
                    help="outer refinement target (vs the f64 oracle)")
    ap.add_argument("--max-cycles", type=int, default=40)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from repro_torch.core import build_spmv_plan
    from repro_torch.core.transport import available_wire_dtypes, get_codec
    from repro_torch.solvers import (available_solvers, make_refine,
                                     resilient_solve)
    from repro_torch.sparse import (extruded_mesh_matrix,
                                    graded_extruded_mesh_matrix,
                                    random_spd_matrix)

    if args.matrix == "mesh":
        A = extruded_mesh_matrix(args.n_surface, args.layers, seed=0)
    elif args.matrix == "graded":
        A = graded_extruded_mesh_matrix(args.n_surface, args.layers, seed=0)
    else:
        A = random_spd_matrix(args.n, nnz_per_row=9, seed=0)
    solvers = (available_solvers() if args.solvers == "all"
               else tuple(args.solvers.split(",")))
    wire_dtypes = (available_wire_dtypes() if args.wire_dtypes == "all"
                   else tuple(args.wire_dtypes.split(",")))

    b = np.random.default_rng(1).normal(size=A.n_rows)
    xh = host_cg(A, b, tol=1e-12, maxiter=40_000)
    xh_norm = max(float(np.linalg.norm(xh)), 1e-30)
    ok = True
    for wd in wire_dtypes:
        # one plan per wire dtype: the stamp flows into every solver
        plan, layout = build_spmv_plan(
            A, args.n_node, args.n_core, mode=args.mode, format=args.format,
            transport=args.transport, wire_dtype=wd, device=args.device)
        for name in solvers:
            refine = make_refine(
                plan, solver=name, precond="jacobi", A=A, layout=layout,
                inner_tol=inner_tol_for(wd, name), maxiter_inner=1000,
                neighbor_offsets=layout["neighbor_offsets"])
            res = refine(b, tol=args.tol, max_cycles=args.max_cycles)
            dxh = float(np.linalg.norm(res.x - xh)) / xh_norm
            # rel is the f64 true residual; dxh adds a kappa factor on
            # top of it, so give it an order of magnitude of headroom
            line_ok = res.converged and dxh < 100 * args.tol
            print(f"REFINE {name} WIRE {wd} CYCLES {res.cycles} "
                  f"INNER_ITERS {res.inner_iters} REL {res.rel:.3e} "
                  f"DX_HOST {dxh:.3e} {'ok' if line_ok else 'BAD'}")
            ok = ok and line_ok
    res = resilient_solve(
        A, b, solver="cg", precond="jacobi", n_node=args.n_node,
        n_core=args.n_core, mode=args.mode, format=args.format,
        transport=args.transport, wire_dtype="int8",
        tol=max(1e-4, 2 * get_codec("int8").rel_bound), maxiter=5000,
        check_every=25, device=args.device)
    line_ok = res.converged and res.rollbacks == 0
    print(f"RESILIENT cg WIRE int8 ITERS {int(np.max(res.iters))} "
          f"CHUNKS {res.chunks} ROLLBACKS {res.rollbacks} "
          f"TRUE_REL {res.true_rel:.3e} {'ok' if line_ok else 'BAD'}")
    ok = ok and line_ok
    print("OK" if ok else "FAIL")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
