"""SPMD contract verifier CLI for the port — the registry-wide sweep.

Usage:  python -m repro_torch.testing.analyze [--device cpu] \
            [--n-node 4 --n-core 2] [--include-faulty] [--json report.json] \
            [--strict] [--hlo]

The port of ``repro.testing.analyze``.  Sweeps **every registered** format
x transport x solver x preconditioner x wire-dtype combination through the
three layers of ``repro_torch.analysis``, plus a rectangular-plan section
(fat R-style and tall P-style probes through the plan/kernel/trace layers
— the shapes the two-level preconditioner builds internally):

  plan     host numpy invariants per format (single-writer ghost slots,
           slot-map permutation, partition bounds, storage accounting);
  kernel   static gather/scatter index streams in-bounds per format;
  trace    traced runs per combo (``trace_pass``): zero-all-reduce SpMV,
           census == ``predicted_cost`` (+1 assembly all_gather), derived
           wire bytes == predicted, payload lint, per-solver
           reductions/iter, local-only preconditioners, numeric lints.

Because the registries are enumerated, a newly registered
transport/format/solver is verified the moment it exists —
``--include-faulty`` registers the deliberately corrupting
``FaultyTransport`` and the analyzer must flag it (exit 1).

``--hlo`` also runs each solver's real ``make_solver`` for one
``check_every`` block and holds its live census against the contract (on
the card, through the Hopper kernels).  The plans live on ``--device``
(default ``cuda``); on the CPU every trace runs the plain versions.

Prints one human line per check group, a violation listing, and a final
JSON line (``--json PATH`` also writes it to a file).  Exit code 1 iff any
error-severity violation (``--strict``: any violation at all).
"""
import argparse
import json
import sys
import time

#: solver-specific static options the sweep pins so every registered
#: solver can be traced without a matrix-dependent prepare step
#: (Chebyshev's bounds would otherwise come from a host Lanczos run).
DEFAULT_SOLVER_OPTIONS = {"chebyshev": {"lmin": 0.1, "lmax": 2.0}}


def _csv(value: str, everything: tuple) -> tuple:
    if value == "all":
        return tuple(everything)
    names = tuple(s for s in value.split(",") if s)
    unknown = set(names) - set(everything)
    if unknown:
        raise SystemExit(f"unknown names {sorted(unknown)}; "
                         f"registered: {list(everything)}")
    return names


def run_sweep(args) -> dict:
    import numpy as np

    from repro_torch.analysis import (check_kernel_streams, check_plan,
                                      check_precond_static,
                                      check_solver_static, check_spmv_static)
    from repro_torch.analysis.report import Report
    from repro_torch.analysis.trace_pass import check_solver_hlo
    from repro_torch.core import build_spmv_plan
    from repro_torch.core.transport import (available_transports,
                                            available_wire_dtypes)
    from repro_torch.solvers.base import available_solvers
    from repro_torch.solvers.precond import available_preconds
    from repro_torch.sparse import (CSRMatrix, available_formats,
                                    graded_extruded_mesh_matrix)

    formats = _csv(args.formats, available_formats())
    transports = _csv(args.transports, available_transports())
    solvers = _csv(args.solvers, available_solvers())
    preconds = _csv(args.preconds, available_preconds())
    wire_dtypes = _csv(args.wire_dtypes, available_wire_dtypes())

    A = graded_extruded_mesh_matrix(args.n_surface, args.layers, seed=0)
    total = Report()
    t0 = time.perf_counter()

    def tick(label: str, rep: Report) -> None:
        total.extend(rep.violations)
        total.count(rep.checks)
        state = "ok" if rep.ok(args.strict) else "FAIL"
        extra = ""
        if rep.violations:
            extra = "  " + " ".join(f"{c}x{n}"
                                    for c, n in rep.summary().items())
        print(f"  [{state:>4}] {label:<40} {rep.checks} checks{extra}")

    def build(M, fmt):
        return build_spmv_plan(M, n_node=args.n_node, n_core=args.n_core,
                               format=fmt, device=args.device)

    for fmt in formats:
        plan, layout = build(A, fmt)
        print(f"format {fmt}: n={plan.n} hs={plan.hs} g_pad={plan.g_pad}")
        tick(f"plan[{fmt}]", check_plan(plan, layout))
        tick(f"kernel[{fmt}]", check_kernel_streams(plan))
        for tname in transports:
            for wdt in wire_dtypes:
                tick(f"spmv[{fmt} x {tname} x {wdt}]",
                     check_spmv_static(plan, tname, wire_dtype=wdt))
        for pname in preconds:
            tick(f"precond[{fmt} x {pname}]",
                 check_precond_static(plan, pname, A=A, layout=layout))
        for sname in solvers:
            opts = DEFAULT_SOLVER_OPTIONS.get(sname)
            for pname in preconds:
                for wdt in wire_dtypes:
                    tick(f"solver[{fmt} x {sname} x {pname} x {wdt}]",
                         check_solver_static(plan, sname, pname, A=A,
                                             layout=layout, options=opts,
                                             wire_dtype=wdt))
        if args.hlo:
            for sname in solvers:
                tick(f"hlo[{fmt} x {sname}]",
                     check_solver_hlo(plan, sname, "jacobi", A=A,
                                      layout=layout,
                                      options=DEFAULT_SOLVER_OPTIONS.get(
                                          sname)))

    # rectangular plans: fat (R-style restriction shape) and tall
    # (P-style prolongation shape) probes through the plan/kernel/trace
    # layers.  Solvers and preconditioners are square-only, so the sweep
    # stops at the SpMV contract for these.
    def rect_probe(n_rows: int, n_cols: int, seed: int) -> CSRMatrix:
        rng = np.random.default_rng(seed)
        rows = np.repeat(np.arange(n_rows), 4)
        cols = rng.integers(0, n_cols, size=rows.size)
        vals = rng.standard_normal(rows.size) + 2.0
        return CSRMatrix.from_coo(rows, cols, vals, (n_rows, n_cols))

    n = A.n_rows
    for label, R in (("fat", rect_probe(n // 2, n, seed=3)),
                     ("tall", rect_probe(n, n // 2, seed=5))):
        for fmt in formats:
            plan_r, layout_r = build(R, fmt)
            print(f"rect[{label}] {fmt}: {plan_r.n}x{plan_r.n_cols} "
                  f"hs={plan_r.hs} g_pad={plan_r.g_pad}")
            tick(f"rect-plan[{label} x {fmt}]",
                 check_plan(plan_r, layout_r))
            tick(f"rect-kernel[{label} x {fmt}]",
                 check_kernel_streams(plan_r))
            for tname in transports:
                for wdt in wire_dtypes:
                    tick(f"rect-spmv[{label} x {fmt} x {tname} x {wdt}]",
                         check_spmv_static(plan_r, tname, wire_dtype=wdt))

    wall = time.perf_counter() - t0
    for v in total.violations:
        print(v)
    ok = total.ok(args.strict)
    print(f"analyze: {total.checks} checks, {len(total.errors)} errors, "
          f"{len(total.warnings)} warnings in {wall:.2f}s -> "
          f"{'OK' if ok else 'FAIL'}")
    return {**total.as_dict(), "ok": ok, "strict": args.strict,
            "wall_s": round(wall, 3),
            "sweep": {"formats": list(formats),
                      "transports": list(transports),
                      "solvers": list(solvers),
                      "preconds": list(preconds),
                      "wire_dtypes": list(wire_dtypes),
                      "n_node": args.n_node, "n_core": args.n_core,
                      "include_faulty": args.include_faulty,
                      "hlo": args.hlo, "device": args.device}}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--n-node", type=int, default=4)
    p.add_argument("--n-core", type=int, default=2)
    p.add_argument("--n-surface", type=int, default=32,
                   help="mesh surface points of the probe matrix")
    p.add_argument("--layers", type=int, default=4)
    p.add_argument("--formats", default="all")
    p.add_argument("--transports", default="all")
    p.add_argument("--solvers", default="all")
    p.add_argument("--preconds", default="all")
    p.add_argument("--wire-dtypes", default="all",
                   help="halo wire codecs to sweep (f32 | bf16 | int8)")
    p.add_argument("--include-faulty", action="store_true",
                   help="register the corrupting FaultyTransport into the "
                        "sweep; the analyzer must then exit nonzero")
    p.add_argument("--strict", action="store_true",
                   help="warnings gate the exit code too")
    p.add_argument("--hlo", action="store_true",
                   help="also run each solver's make_solver for one "
                        "check_every block and spot-check its live census")
    p.add_argument("--json", default=None, metavar="PATH",
                   help="also write the JSON report to PATH")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    from repro_torch.core.transport import (FaultyTransport,
                                            register_transport,
                                            unregister_transport)

    faulty = None
    try:
        if args.include_faulty:
            faulty = register_transport(FaultyTransport(), overwrite=True)
        out = run_sweep(args)
    finally:
        if faulty is not None:
            unregister_transport(faulty.name)

    if args.json:
        with open(args.json, "w") as fh:
            json.dump(out, fh, indent=2)
    print(json.dumps(out))
    return 0 if out["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
