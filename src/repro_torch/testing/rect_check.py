"""Rectangular-SpMV conformance harness for the port, on one device.

Usage:  python -m repro_torch.testing.rect_check [--device cpu] \
            [--n-node 4 --n-core 2]

``build_spmv_plan`` accepts any rectangular CSR: the row partition keys
the output slot layout, a separate column-space partition keys ownership
and the halo exchange.  This harness sweeps seeded random rectangular
matrices — tall, fat, and the structured 0/1 aggregation restriction the
two-level preconditioner builds — through ``make_spmv`` on the virtual
mesh, against the numpy ``A.matvec`` oracle:

  oracle  y = from_dist(make_spmv(to_dist(x, space="col")), space="row")
          matches ``A.matvec(x)`` within f32 tolerance, per
          (shape, format, transport, node partition);
  xident  every registered transport's output is **bit-identical** to
          ``a2a``'s on the same plan;
  pin     rebuilding the plan with ``row_space``/``col_space`` pinned to
          the first build's exported spaces reproduces its output bit for
          bit (the pin contract the two-level preconditioner relies on to
          share A's layout with R and P).

Shapes cover both node partitions (``rows`` uniform and ``nnz``
non-uniform bounds), so column ownership and row ownership genuinely
differ.  Every plan is built with ``verify=True``.  Prints ``OK`` or
``FAIL``; exit code 0 iff every check passed.  The virtual mesh holds the
whole grid on ``--device`` (default ``cuda``).
"""
from __future__ import annotations

import argparse
import sys

OR_TOL = 1e-5     # f32 device accumulation vs f64 numpy oracle
KINDS = ("tall", "fat", "agg")


def build_rect(kind: str, seed: int):
    """A seeded rectangular CSRMatrix: 'tall' (3:1), 'fat' (1:3), or
    'agg' (the two-level 0/1 restriction shape, fat and structured) — the
    JAX package's ``rect_check`` matrices, entry for entry."""
    import numpy as np

    from repro_torch.sparse import CSRMatrix

    rng = np.random.default_rng(seed)
    if kind == "tall":
        n_rows, n_cols = 420, 140
    elif kind == "fat":
        n_rows, n_cols = 140, 420
    elif kind == "agg":
        n_cols = 416
        agg = np.arange(n_cols, dtype=np.int64) // 16
        return CSRMatrix.from_coo(agg, np.arange(n_cols, dtype=np.int64),
                                  np.ones(n_cols),
                                  (int(agg[-1]) + 1, n_cols))
    else:
        raise ValueError(f"unknown kind {kind!r}; one of {KINDS}")
    per_row = 5
    rows = np.repeat(np.arange(n_rows, dtype=np.int64), per_row)
    cols = rng.integers(0, n_cols, size=rows.size)
    vals = rng.standard_normal(rows.size)
    return CSRMatrix.from_coo(rows, cols, vals, (n_rows, n_cols))


def check_matrix(A, x, n_node: int, n_core: int, fmt: str, part: str,
                 device, transports, label: str = "") -> bool:
    """oracle, xident and pin on one (matrix, format, node partition);
    prints one line per transport; returns whether all passed."""
    import numpy as np
    import torch

    from repro_torch.core import build_spmv_plan, from_dist, make_spmv
    from repro_torch.core import to_dist

    plan, layout = build_spmv_plan(A, n_node, n_core, mode="balanced",
                                   node_partition=part, format=fmt,
                                   device=device, verify=True)
    y_host = np.asarray(A.matvec(x), np.float64)
    xd = to_dist(x, layout, plan, space="col")
    print(f"{label}{A.n_rows}x{A.n_cols} FORMAT {fmt} PART {part} "
          f"hs={plan.hs} g_pad={plan.g_pad} rc_pad={plan.rc_pad} "
          f"cc_pad={plan.cc_pad}")
    ok = True
    y_ref = None
    for name in transports:
        yd = make_spmv(plan, transport=name)(xd)
        y = from_dist(yd, layout, plan, space="row").astype(np.float64)
        err = (np.linalg.norm(y - y_host)
               / max(np.linalg.norm(y_host), 1e-300))
        o_ok = bool(err <= OR_TOL)
        line = [f"  TRANSPORT {name}",
                f"oracle={err:.2e}<={OR_TOL:.0e}={'ok' if o_ok else 'BAD'}"]
        if y_ref is None:
            y_ref = yd
        else:
            i_ok = torch.equal(yd.view(torch.int32), y_ref.view(torch.int32))
            line.append(f"xident={'ok' if i_ok else 'BAD'}")
            ok &= i_ok
        ok &= o_ok
        print(" ".join(line))

    # pin round trip: a rebuild against the exported spaces must
    # reproduce the plan's output bit for bit
    plan2, layout2 = build_spmv_plan(
        A, n_node, n_core, mode="balanced", node_partition=part, format=fmt,
        device=device, row_space=layout["row_space"],
        col_space=layout["col_space"])
    y2 = make_spmv(plan2)(to_dist(x, layout2, plan2, space="col"))
    p_ok = torch.equal(y2.view(torch.int32), y_ref.view(torch.int32))
    ok &= p_ok
    print(f"  PIN roundtrip={'ok' if p_ok else 'BAD'}")
    return ok


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n-node", type=int, default=4)
    ap.add_argument("--n-core", type=int, default=2)
    ap.add_argument("--formats", default="ell,sell")
    ap.add_argument("--transports", default=None,
                    help="comma list (default: every registered transport)")
    ap.add_argument("--kinds", default=",".join(KINDS))
    ap.add_argument("--seeds", default="3,5")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    from repro_torch.core import available_transports

    device = torch.device(args.device)
    transports = (tuple(args.transports.split(","))
                  if args.transports else available_transports())
    ok = True
    for kind in args.kinds.split(","):
        for seed in (int(s) for s in args.seeds.split(",")):
            A = build_rect(kind, seed)
            x = np.random.default_rng(100 + seed).normal(size=A.n_cols)
            for fmt in args.formats.split(","):
                for part in ("rows", "nnz"):
                    ok &= check_matrix(A, x, args.n_node, args.n_core, fmt,
                                       part, device, transports,
                                       label=f"KIND {kind} seed={seed} ")
    print("OK" if ok else "FAIL")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
