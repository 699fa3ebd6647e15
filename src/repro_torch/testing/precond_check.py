"""Preconditioner conformance harness for the port, on one device.

Usage:  python -m repro_torch.testing.precond_check [--device cpu] \
            [--case graded] [--include-faulty] [--scaling]

Every *registered* preconditioner (``repro_torch.solvers.precond``) is
swept on the same plan — one nobody listed still gets checked, so
registering one that breaks conformance fails here.  Checks per (case,
format, preconditioner):

  host    ``make_precond_apply`` (the ``bind`` ``make_solver`` runs)
          reproduces the preconditioner's numpy ``host_apply`` oracle in
          global row ordering (f32 on the device against f64 on the host,
          relative tolerance);
  sym     M⁻¹ is symmetric on an SPD operator — v·M⁻¹w == w·M⁻¹v on the
          f64 host oracle (tight) and through the device program (fp
          tolerance);
  spd     r·M⁻¹r > 0 (definiteness: CG's contract);
  static  the collective contract, counted: one apply issues exactly
          ``reductions_per_apply`` cross-shard reductions (0 for a
          ``local_only`` one; ``count_reductions``), and a ``local_only``
          apply of a residual held on one shard leaves every other shard
          exactly 0 (it reads and writes its own slice only);
  cross   (``two_level`` only) the device apply decomposes as smoother +
          coarse correction: z_2l == z_smoother + P·A_c⁻¹·R r with the
          coarse term recomputed on the host from the aggregation —
          catching a wrong R/P wiring that still looks symmetric.

``--include-faulty`` registers the deliberately broken ``FaultyPrecond``
(its device apply negates Jacobi: indefinite and host-inconsistent while
truthfully local); the harness must then FAIL it (exit 1).

``--scaling`` runs the iteration-scaling regression instead: CG (tol
1e-6, maxiter 400) on growing graded extruded meshes (``SCALING_MESHES``,
4×2 rows-partition ell), asserting one-level ``block_jacobi`` counts grow
monotonically with the mesh while ``two_level`` (agg ``SCALING_AGG``)
stays flat (max/min <= ``--flat-bound``).  Emits one ``SCALING {json}``
line with per-mesh iterations and solve times.

Plan cases are ``transport_check``'s builders: ``graded`` (non-uniform
two-level node bounds + halo), ``single`` (banded extrusion ordering),
``halofree`` (one node owns everything — no exchange).  Prints ``OK`` or
``FAIL``.  The virtual mesh holds the whole grid on ``--device`` (default
``cuda``).
"""
from __future__ import annotations

import argparse
import json
import sys
import time

CASES = ("graded", "single", "halofree")

#: device-vs-host relative tolerance: f32 gathers and products against an
#: f64 host oracle (the JAX package's bound)
DEV_TOL = 5e-4
SYM_TOL_HOST = 1e-10
SYM_TOL_DEV = 2e-3

#: the regression meshes: graded extruded (48, L) at growing layer
#: counts — same surface, 2x rows per step (the JAX package's)
SCALING_MESHES = ((48, 6), (48, 12), (48, 24))
#: aggregate size for the regression (the JAX package's)
SCALING_AGG = 8


def _rel(a, b) -> float:
    import numpy as np
    den = max(float(np.linalg.norm(b)), 1e-300)
    return float(np.linalg.norm(np.asarray(a) - np.asarray(b))) / den


def static_check(pre, apply_d, plan) -> tuple[bool, int, bool | None]:
    """``(ok, reductions, local)``: the reductions one apply issues
    against ``reductions_per_apply``; for a ``local_only`` one, whether a
    residual held on one shard (the middle one) stays on it."""
    import torch

    from repro_torch.solvers import count_reductions

    r = torch.zeros(plan.cg_shape, device=plan.device)
    i, c = plan.n_node // 2, plan.n_core // 2
    r[i, c] = plan.mask[i, c] * torch.linspace(1.0, 2.0, plan.rc_pad,
                                               device=plan.device)
    with count_reductions() as n:
        z = apply_d(r)
    local = None
    if pre.local_only:
        rest = z.clone()
        rest[i, c] = 0.0
        local = not bool(rest.any())
    ok = n[0] == (0 if pre.local_only else pre.reductions_per_apply)
    return ok and local is not False, n[0], local


def conformance(case: str, n_node: int, n_core: int, formats, device,
                preconds=None) -> bool:
    import numpy as np

    from repro_torch.core import from_dist, to_dist
    from repro_torch.solvers import (available_preconds, get_precond,
                                     make_precond_apply)
    from repro_torch.solvers.precond import TwoLevelPrecond
    from repro_torch.testing.transport_check import build_case

    preconds = tuple(preconds) if preconds else available_preconds()
    ok = True
    for fmt in formats:
        A, plan, layout = build_case(case, n_node, n_core, fmt, device)
        rng = np.random.default_rng(11)
        r = rng.normal(size=A.n_rows)
        v = rng.normal(size=A.n_rows)
        print(f"CASE {case} FORMAT {fmt} n={A.n_rows} "
              f"n_node={plan.n_node} n_core={plan.n_core} hs={plan.hs}")

        for pname in preconds:
            pre = get_precond(pname)
            line = [f"PRECOND {pname}"]
            apply_d = make_precond_apply(plan, precond=pname, A=A,
                                         layout=layout)
            host = pre.host_apply(plan, layout, A)

            def dev(u, apply_d=apply_d):
                return from_dist(apply_d(to_dist(u, layout, plan,
                                                 space="row")),
                                 layout, plan).astype(np.float64)

            # host: device program == numpy oracle (global ordering)
            zr_d, zr_h = dev(r), np.asarray(host(r), np.float64)
            e = _rel(zr_d, zr_h)
            h_ok = e <= DEV_TOL
            line.append(f"host={e:.2e}<={DEV_TOL:.0e}="
                        f"{'ok' if h_ok else 'BAD'}")

            # sym: v.(M^-1 r) == r.(M^-1 v), host tight + device fp
            zv_h = np.asarray(host(v), np.float64)
            sh = abs(float(v @ zr_h) - float(r @ zv_h)) / max(
                abs(float(v @ zr_h)), 1e-300)
            zv_d = dev(v)
            sd = abs(float(v @ zr_d) - float(r @ zv_d)) / max(
                abs(float(v @ zr_d)), 1e-300)
            s_ok = sh <= SYM_TOL_HOST and sd <= SYM_TOL_DEV
            line.append(f"sym={sh:.1e}/{sd:.1e}="
                        f"{'ok' if s_ok else 'BAD'}")

            # spd: r.(M^-1 r) > 0 ("none" included: identity is SPD)
            quad = float(r @ zr_d)
            p_ok = quad > 0.0
            line.append(f"spd={quad:.3g}={'ok' if p_ok else 'BAD'}")

            # static: the declared reductions, counted; locality, probed
            c_ok, nred, local = static_check(pre, apply_d, plan)
            line.append(f"static[{'local' if pre.local_only else 'comm'}]"
                        f"=reductions {nred}"
                        + ("" if local is None else f", local {local}")
                        + f"={'ok' if c_ok else 'BAD'}")
            ok &= h_ok and s_ok and p_ok and c_ok

            # cross: two_level decomposes into smoother + host coarse term
            if pname == "two_level":
                opts = pre.validate_options(None)
                sm_d = make_precond_apply(plan, precond=opts["smoother"],
                                          A=A, layout=layout)
                zs = dev(r, sm_d)
                agg_of, nc = TwoLevelPrecond._aggregates(A.n_rows,
                                                         opts["agg_size"])
                ainv = TwoLevelPrecond._galerkin_inverse(A, agg_of, nc)
                rc = np.bincount(agg_of, weights=r, minlength=nc)
                e2 = _rel(zr_d, zs + (ainv @ rc)[agg_of])
                x_ok = e2 <= DEV_TOL
                line.append(f"cross={e2:.2e}={'ok' if x_ok else 'BAD'}")
                ok &= x_ok
            print(" ".join(line))
    return ok


def scaling(n_node: int, n_core: int, device, flat_bound: float) -> bool:
    import numpy as np

    from repro_torch.core import build_spmv_plan, to_dist
    from repro_torch.solvers import make_solver
    from repro_torch.sparse import graded_extruded_mesh_matrix

    out = {"meshes": [], "block_jacobi": {"iters": [], "time_s": []},
           "two_level": {"iters": [], "time_s": []}}
    for n_surface, layers in SCALING_MESHES:
        A = graded_extruded_mesh_matrix(n_surface, layers, seed=0)
        plan, layout = build_spmv_plan(A, n_node, n_core, mode="balanced",
                                       node_partition="rows", format="ell",
                                       device=device)
        rng = np.random.default_rng(7)
        bd = to_dist(rng.normal(size=A.n_rows), layout, plan)
        out["meshes"].append([n_surface, layers, A.n_rows])
        row = [f"n={A.n_rows}"]
        for pname in ("block_jacobi", "two_level"):
            po = {"agg_size": SCALING_AGG} if pname == "two_level" else None
            solve = make_solver(plan, solver="cg", precond=pname, A=A,
                                layout=layout, precond_options=po)
            solve(bd, tol=1e-6, maxiter=400)               # warm
            t0 = time.perf_counter()
            _, it, rel = solve(bd, tol=1e-6, maxiter=400)
            dt = time.perf_counter() - t0
            out[pname]["iters"].append(int(it))
            out[pname]["time_s"].append(round(dt, 4))
            row.append(f"{pname}: iters={int(it)} rel={float(rel):.1e} "
                       f"t={dt * 1e3:.0f}ms")
        print("  ".join(row))

    bj = out["block_jacobi"]["iters"]
    tl = out["two_level"]["iters"]
    mono = all(b >= a for a, b in zip(bj, bj[1:]))
    flat = max(tl) / min(tl)
    grow = bj[-1] > bj[0]
    ok = mono and grow and flat <= flat_bound
    out.update(bj_monotone=mono, bj_grows=grow,
               tl_flat_ratio=round(flat, 3), flat_bound=flat_bound, ok=ok)
    print(f"SCALING {json.dumps(out)}")
    print(f"block_jacobi iters {bj} monotone={'ok' if mono else 'BAD'} "
          f"growing={'ok' if grow else 'BAD'}; two_level iters {tl} "
          f"max/min={flat:.2f}<={flat_bound}="
          f"{'ok' if flat <= flat_bound else 'BAD'}")
    return ok


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n-node", type=int, default=4)
    ap.add_argument("--n-core", type=int, default=2)
    ap.add_argument("--case", default="graded", choices=CASES)
    ap.add_argument("--formats", default="ell,sell")
    ap.add_argument("--preconds", default=None,
                    help="comma list (default: every registered precond)")
    ap.add_argument("--include-faulty", action="store_true",
                    help="register the broken 'faulty' preconditioner "
                         "before the sweep; the harness must then fail "
                         "(exit 1)")
    ap.add_argument("--scaling", action="store_true",
                    help="run the iteration-scaling regression instead "
                         "of the conformance sweep")
    ap.add_argument("--flat-bound", type=float, default=1.3,
                    help="two_level max/min iteration ratio bound across "
                         "the scaling meshes")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    import torch

    from repro_torch.solvers.precond import (FaultyPrecond, register_precond,
                                             unregister_precond)

    device = torch.device(args.device)
    if args.scaling:
        ok = scaling(args.n_node, args.n_core, device, args.flat_bound)
        print("OK" if ok else "FAIL")
        return 0 if ok else 1

    if args.include_faulty:
        register_precond(FaultyPrecond())
    try:
        ok = conformance(args.case, args.n_node, args.n_core,
                         args.formats.split(","), device,
                         args.preconds.split(",") if args.preconds else None)
    finally:
        if args.include_faulty:
            unregister_precond("faulty")
    print("OK" if ok else "FAIL")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
