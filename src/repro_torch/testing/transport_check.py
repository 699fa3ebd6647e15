"""Halo-transport conformance harness for the port, on one device.

Usage:  python -m repro_torch.testing.transport_check --case graded \
            [--device cpu] [--wire-dtype all] [--autotune]

Every *registered* transport (``repro_torch.core.transport``) is swept
against the ``a2a`` reference on the same plan.  Three checks per (case,
format, wire dtype, transport):

  ghost   the assembled ghost buffer (``make_exchange`` probe) is
          **bit-identical** to a2a's at every real slot (< g_pad) on every
          (node, core) shard, and identical across the core axis;
  host    the transport's numpy ``host_exchange`` reference reproduces the
          device ghost buffer bit for bit (real slots);
  spmv    ``make_spmv`` output is bit-identical to a2a's.

The bit-identity checks hold *within* a wire dtype: every transport
encodes the same (sender core -> destination node) chunks.  The
**bounded-error tier** then holds each ghost against the exact f32 a2a
ghost: f32 wire must be bit-identical, a lossy codec within
``codec.rel_bound * max|x|``.

Plan cases cover the neighbour-structure regimes the transports
specialise for: ``graded`` (non-uniform two-level node bounds),
``uniform`` (equal-rows node bounds), ``single`` (banded extrusion
ordering — one neighbour each side), ``dense`` (random sparsity — every
pair communicates), ``halofree`` (hs == 0 — no exchange at all, SpMV check
only).  ``--autotune`` also runs ``autotune_transport`` and checks that
the stamped winner's SpMV is what ``transport="auto"`` returns.
``--include-faulty`` registers the corrupting ``faulty`` transport first:
on any case with halo traffic the run must then FAIL (exit 1).

Exit code 0 iff every check passed.  The virtual mesh holds the whole
``n_node x n_core`` grid on ``--device`` (default ``cuda``).
"""
from __future__ import annotations

import argparse
import sys

CASES = ("graded", "uniform", "single", "dense", "halofree")


def build_case(case: str, n_node: int, n_core: int, fmt: str, device):
    """``(A, plan, layout)`` of one conformance case."""
    from repro_torch.core import build_spmv_plan
    from repro_torch.sparse import (extruded_mesh_matrix,
                                    graded_extruded_mesh_matrix,
                                    random_spd_matrix)

    if case == "graded":        # skewed nnz -> non-uniform node_bounds
        A = graded_extruded_mesh_matrix(48, 6, seed=0)
        kw = dict(mode="balanced", node_partition="nnz")
    elif case == "uniform":     # equal-rows node split
        A = extruded_mesh_matrix(48, 6, seed=0)
        kw = dict(mode="balanced", node_partition="rows")
    elif case == "single":      # banded: one neighbour each side
        A = extruded_mesh_matrix(64, 4, seed=1)
        kw = dict(mode="task")
    elif case == "dense":       # random sparsity: all pairs communicate
        A = random_spd_matrix(640, nnz_per_row=9, seed=2)
        kw = dict(mode="balanced")
    elif case == "halofree":    # single node owns everything: hs == 0
        A = graded_extruded_mesh_matrix(48, 6, seed=0)
        n_node, n_core = 1, n_node * n_core
        kw = dict(mode="balanced")
    else:
        raise ValueError(f"unknown case {case!r}; one of {CASES}")
    plan, layout = build_spmv_plan(A, n_node, n_core, format=fmt,
                                   device=device, **kw)
    return A, plan, layout


def check_case(case: str, n_node: int, n_core: int, fmt: str, device,
               transports=None, wire_dtypes=("f32",),
               autotune: bool = False) -> bool:
    """Run every check on one (case, format); print one line per
    (wire dtype, transport); return whether all passed."""
    import numpy as np

    from repro_torch.core import (available_transports, make_exchange,
                                  make_spmv, resolve_transport, to_dist)
    from repro_torch.core.transport import autotune_transport, get_codec

    transports = transports or available_transports()
    A, plan, layout = build_case(case, n_node, n_core, fmt, device)
    rng = np.random.default_rng(7)
    xd = to_dist(rng.normal(size=A.n_rows), layout, plan)
    xd_np, g = xd.cpu().numpy(), plan.g_pad
    print(f"CASE {case} FORMAT {fmt} n_node={plan.n_node} "
        f"n_core={plan.n_core} hs={plan.hs} g_pad={g} "
        f"offsets={layout['neighbor_offsets']}")

    def ghost_of(name, wd):
        return make_exchange(plan, transport=name,
                             wire_dtype=wd)(xd).cpu().numpy()

    ok = True
    # the bounded-error tier's yardstick: the exact (f32-wire) ghost
    exact_ref = ghost_of("a2a", "f32") if plan.hs else None
    for wd in wire_dtypes:
        codec = get_codec(wd)
        ghost_ref = ghost_of("a2a", wd) if plan.hs else None
        y_ref = make_spmv(plan, transport="a2a", wire_dtype=wd)(xd)
        for name in transports:
            line = [f"TRANSPORT {name} WIRE {wd}"]
            if plan.hs:
                ghost = ghost_of(name, wd)
                # chunk identity: same codec, same chunks -> the decoded
                # ghosts agree to the bit across transports
                g_ok = bool(np.array_equal(ghost[..., :g],
                                           ghost_ref[..., :g]))
                g_ok &= all(np.array_equal(ghost[:, 0, :g], ghost[:, c, :g])
                            for c in range(plan.n_core))
                tr, state = resolve_transport(name, plan, wire_dtype=wd)
                host = tr.host_exchange(xd_np, plan.send_own.cpu().numpy(),
                                        plan.recv_own.cpu().numpy(), g,
                                        state)
                h_ok = bool(np.array_equal(host[..., :g], ghost[..., :g]))
                with np.errstate(invalid="ignore"):    # faulty: inf - inf
                    err = float(np.abs(ghost[..., :g]
                                       - exact_ref[..., :g]).max())
                bound = codec.rel_bound * float(np.abs(xd_np).max())
                e_ok = (err == 0.0 if codec.exact else err <= bound)
                line += [f"ghost={'ok' if g_ok else 'BAD'}",
                         f"host={'ok' if h_ok else 'BAD'}",
                         f"err={err:.2e}<={bound:.2e}="
                         f"{'ok' if e_ok else 'BAD'}"]
                ok &= g_ok and h_ok and e_ok
            y = make_spmv(plan, transport=name, wire_dtype=wd)(xd)
            s_ok = bool(bits_equal(y, y_ref))
            line.append(f"spmv={'ok' if s_ok else 'BAD'}")
            ok &= s_ok
            print(" ".join(line))

    if autotune:
        res = autotune_transport(plan, iters=5, warmup=1)
        a_ok = (plan.transport == res.winner
                and res.winner in available_transports())
        y_auto = make_spmv(plan, transport="auto")(xd)
        y_win = make_spmv(plan, transport=res.winner)(xd)
        a_ok &= bool(bits_equal(y_auto, y_win))
        t = " ".join(f"{k}={v:.0f}us" for k, v in
                     sorted(res.timings_us.items()))
        print(f"AUTOTUNE winner={res.winner} {t} {'ok' if a_ok else 'BAD'}")
        ok &= a_ok
    return ok


def bits_equal(a, b) -> bool:
    """Bit-level equality of two float32 tensors (NaNs and signed zeros
    included)."""
    import torch

    return a.shape == b.shape and torch.equal(a.view(torch.int32),
                                              b.view(torch.int32))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n-node", type=int, default=4)
    ap.add_argument("--n-core", type=int, default=2)
    ap.add_argument("--case", default="graded", choices=CASES + ("all",))
    ap.add_argument("--formats", default="ell,sell")
    ap.add_argument("--transports", default=None,
                    help="comma list (default: every registered transport)")
    ap.add_argument("--wire-dtype", default="f32",
                    help="halo wire codec(s) to sweep, comma list "
                         "(f32 | bf16 | int8, or 'all')")
    ap.add_argument("--autotune", action="store_true",
                    help="also run autotune_transport and verify the "
                         "stamped winner is what transport='auto' builds")
    ap.add_argument("--include-faulty", action="store_true",
                    help="register the corrupting 'faulty' transport "
                         "before the sweep; on any case with halo traffic "
                         "the harness is EXPECTED to fail it (exit 1)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from repro_torch.core.transport import (FaultyTransport,
                                            available_wire_dtypes,
                                            register_transport,
                                            unregister_transport)

    wire_dtypes = (available_wire_dtypes() if args.wire_dtype == "all"
                   else tuple(args.wire_dtype.split(",")))
    transports = (tuple(args.transports.split(","))
                  if args.transports else None)
    cases = CASES if args.case == "all" else (args.case,)
    if args.include_faulty:
        register_transport(FaultyTransport())
    try:
        ok = True
        for case in cases:
            for fmt in args.formats.split(","):
                ok &= check_case(case, args.n_node, args.n_core, fmt,
                                 args.device, transports=transports,
                                 wire_dtypes=wire_dtypes,
                                 autotune=args.autotune)
    finally:
        if args.include_faulty:
            unregister_transport("faulty")
    print("OK" if ok else "FAIL")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
