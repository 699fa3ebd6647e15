"""Measured SpMV / CG timing of the port, as one JSON dict.

Usage:  python -m repro_torch.testing.bench_spmv [--device cpu] \
            --n-node 4 --n-core 2 [--format sell] \
            [--transport a2a,ring,pairwise,hier] [--wire-dtype f32,int8] \
            [--cg [--fused] | --solver cg --nrhs 4] [--iters 50] \
            [--mesh process [--dist-backend nccl]]

The port of ``repro.testing.bench_spmv``: the same flags and the same keys
where a counterpart exists (``us_per_spmv``, ``us_per_spmv_min``,
``us_per_iter``, the ``transports`` / ``wire`` sweeps, ``predicted``,
``traced_wire_bytes``, ``collectives``, ``collectives_per_iter``,
``census_split``).

What the numbers are: one device holds the whole ``n_node x n_core`` grid
as a virtual mesh, so there is no wire.  ``--mesh process`` times the same
calls on every rank of a process mesh instead (``--dist-backend`` gloo,
or nccl with one rank per card: the wire between cards), each on its own
shard; the dict is rank 0's plus each timing by rank (``..._by_rank``).
There each SpMV entry also carries the shard body's ``schedule`` (its
issue / wait / launch steps, which ``--mode`` sets: ``vector`` waits for
the exchange before its one launch, ``task`` / ``balanced`` launch the
diag pass while it is in flight) and ``wire_us_per_spmv`` /
``exposed_us_per_spmv``: µs of collectives per SpMV, and of them the
part no local work hid (``WIRE``).  The times are of the card's
gathers, scatters and kernels (CUDA events on the card, after
``--warmup`` calls, median and min over ``--reps`` repetitions of
``--iters`` calls); on the CPU they are host-clock times of the plain
versions and say nothing about a device.  The census is recorded
(``repro_torch.core.collectives.record_collectives``), not compiled:

``collectives``           one SpMV call (the SpMV sweep and ``--cg``'s
                          unfused baseline, whose dots are whole-array
                          sums on one device), or a solver's setup plus
                          one ``loop_body`` (``--solver``, ``--cg
                          --fused``: the reference's whole-module census);
``collectives_per_iter``  one ``loop_body`` (the reference's while body);
``census_split``          its solver reductions vs transport traffic;
``traced_wire_bytes``     derived from the payloads the recorded exchange
                          handed its collectives, as if each node were its
                          own device (``predicted`` is the transport's
                          table).
"""
from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np

from repro_torch.launch.mesh import add_dist_backend, dist_backend


def timed(fn, device, calls: int = 1):
    """``(seconds, last result)`` of ``calls`` back-to-back ``fn()``: CUDA
    events on the card, the host clock elsewhere."""
    import torch

    if device.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(calls):
            out = fn()
        return time.perf_counter() - t0, out
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(calls):
        out = fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / 1e3, out


def loop_census(solve, b, tol: float, maxiter: int) -> tuple[dict, dict]:
    """``(setup + one loop_body, one loop_body)`` collective censuses of a
    ``make_solver`` solve on ``b``."""
    from repro_torch.core.collectives import census, record_collectives

    sol, ctx, bb, tol_t, maxiter_t = solve.parts(b, tol, maxiter)
    with record_collectives() as whole:
        aux, state = sol.loop_setup(ctx, bb, tol_t, maxiter_t)
        with record_collectives() as body:
            sol.loop_body(ctx, aux, state)
    return census(whole), census(body)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n-node", type=int, required=True)
    ap.add_argument("--n-core", type=int, required=True)
    ap.add_argument("--mode", default="balanced")
    ap.add_argument("--node-partition", default=None,
                    choices=["rows", "nnz"],
                    help="node-axis row split (default: nnz for balanced "
                         "mode, rows otherwise)")
    ap.add_argument("--transport", default="a2a",
                    help="halo transport, 'auto' to autotune, or a comma "
                         "list to sweep (SpMV path only): per-transport "
                         "timings + census under 'transports'")
    ap.add_argument("--format", default="ell",
                    help="shard storage format: 'ell' or 'sell'")
    ap.add_argument("--matrix", default="mesh", choices=["mesh", "graded"],
                    help="'graded' = skewed adapted-mesh analogue with "
                         "exponentially varying row nnz")
    ap.add_argument("--n-surface", type=int, default=2000)
    ap.add_argument("--layers", type=int, default=16)
    ap.add_argument("--iters", type=int, default=50)
    ap.add_argument("--warmup", type=int, default=3,
                    help="SpMV sweep: calls of each SpMV before timing "
                         "starts")
    ap.add_argument("--reps", type=int, default=5,
                    help="SpMV sweep: timed repetitions of the --iters "
                         "loop per transport; us_per_spmv is their median, "
                         "us_per_spmv_min their min")
    ap.add_argument("--wire-dtype", default="f32",
                    help="halo wire codec (f32 | bf16 | int8), or a comma "
                         "list to sweep (SpMV path only): per-dtype timings "
                         "+ predicted and traced wire bytes under 'wire'")
    ap.add_argument("--cg", action="store_true")
    ap.add_argument("--fused", action="store_true",
                    help="with --cg: time the fused CG solver")
    ap.add_argument("--solver", default=None,
                    help="time a registered solver instead of the --cg path")
    ap.add_argument("--precond", default="jacobi",
                    help="preconditioner for --solver")
    ap.add_argument("--nrhs", type=int, default=0,
                    help="with --solver: batched multi-RHS solve width")
    ap.add_argument("--tol", type=float, default=1e-8)
    ap.add_argument("--check-every", type=int, default=0,
                    help="with --solver: also time the resilient chunked "
                         "driver and report its per-iteration overhead vs "
                         "the monolithic loop under 'resilient'")
    ap.add_argument("--no-collectives", action="store_true",
                    help="skip the recorded collective census")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--mesh", default="virtual",
                    choices=["virtual", "process"],
                    help="virtual: the grid on one device; process: one "
                         "spawned rank per shard, each timing its shard")
    add_dist_backend(ap)
    args = ap.parse_args(argv)
    backend = dist_backend(ap, args, args.n_node * args.n_core)

    import torch

    from repro_torch.core import build_spmv_plan
    from repro_torch.sparse import (extruded_mesh_matrix,
                                    graded_extruded_mesh_matrix)
    from repro_torch.util import device_name

    if (args.solver or args.cg) and "," in args.transport:
        ap.error("--transport sweeps are SpMV-only; pick one transport "
                 "for --solver/--cg runs")
    if (args.solver or args.cg) and "," in args.wire_dtype:
        ap.error("--wire-dtype sweeps are SpMV-only; pick one wire dtype "
                 "for --solver/--cg runs")
    if args.cg and not args.solver and args.wire_dtype != "f32":
        ap.error("--cg is the f32-wire path; use --solver for compressed "
                 "wire")
    device = torch.device(args.device)

    t0 = time.perf_counter()
    gen = (graded_extruded_mesh_matrix if args.matrix == "graded"
           else extruded_mesh_matrix)
    A = gen(args.n_surface, args.layers, seed=0)
    t_gen = time.perf_counter() - t0
    on_ranks = args.mesh == "process"
    t0 = time.perf_counter()
    # a process mesh's ranks each place their own shard on the device
    plan, layout = build_spmv_plan(A, args.n_node, args.n_core,
                                   mode=args.mode,
                                   node_partition=args.node_partition,
                                   format=args.format,
                                   device="cpu" if on_ranks else device)
    t_plan = time.perf_counter() - t0

    stats = layout["stats"]
    out = {"n_node": args.n_node, "n_core": args.n_core, "mode": args.mode,
           "node_partition": layout["node_partition"],
           "format": layout["format"],
           "transport": args.transport, "matrix": args.matrix,
           "n_rows": A.n_rows, "nnz": A.nnz,
           "t_gen_s": round(t_gen, 2), "t_plan_s": round(t_plan, 3),
           "halo_bytes_per_node": layout["halo"].comm_bytes_per_node(
               itemsize=4),
           "node_imbalance": round(stats["node_imbalance"], 4),
           "core_imbalance": round(stats["core_imbalance"], 4),
           "padding_waste": round(stats["padding_waste"], 4),
           "device": device_name(device),
           "timer": "cuda_events" if device.type == "cuda" else "host_clock",
           }
    if not on_ranks:
        out.update(bench(args, A, plan, layout, device))
        print(json.dumps(out))
        return 0

    import tempfile

    from repro_torch.launch.mesh import spawn_cg_mesh, write_plan

    with tempfile.TemporaryDirectory(prefix="bench_spmv_") as d:
        write_plan(plan, d)
        ranks = spawn_cg_mesh(_rank_bench, args.n_node, args.n_core, device,
                              backend=backend, args=(d, args, A, layout),
                              timeout=1800)
    out.update(ranks[0])
    out.update(mesh="process", dist_backend=backend, ranks=len(ranks),
               **{f"{k}_by_rank": [r[k] for r in ranks]
                  for k in ("us_per_spmv", "us_per_iter", "wire_us_per_spmv",
                            "exposed_us_per_spmv") if k in ranks[0]})
    print(json.dumps(out))
    return 0


def _rank_bench(mesh, plan_dir: str, args, A, layout) -> dict:
    """One rank of ``--mesh process``: :func:`bench` on its shard."""
    from repro_torch.launch.mesh import read_plan

    return bench(args, A, read_plan(plan_dir, mesh), layout, mesh.device)


def bench(args, A, plan, layout, device) -> dict:
    """The timed run the flags ask for, on ``plan`` (whole, or a rank's
    shard): the SpMV sweep, ``--cg`` or ``--solver``."""
    from repro_torch.core import make_cg, to_dist
    from repro_torch.core.collectives import census, record_collectives

    rng = np.random.default_rng(0)
    x = to_dist(rng.normal(size=A.n_rows), layout, plan)
    out = {}
    if args.solver or (args.cg and args.fused):
        out.update(solver_run(args, A, plan, layout, rng, device))
    elif args.cg:
        solve = make_cg(plan, transport=args.transport,
                        neighbor_offsets=layout["neighbor_offsets"])
        b = to_dist(rng.normal(size=A.n_rows), layout, plan)
        solve(b, tol=args.tol, maxiter=200)                 # warmup
        dt, (_, it, rel) = timed(
            lambda: solve(b, tol=args.tol, maxiter=args.iters), device)
        it, rel = int(it), float(rel)
        out.update(cg_iters=it, cg_rel=rel, fused=False,
                   transport=solve.transport,
                   us_per_iter=dt / max(it, 1) * 1e6)
        if not args.no_collectives:
            with record_collectives() as log:
                solve.spmv(b)
            out["collectives"] = census(log)
    else:
        out.update(spmv_sweep(args, A, plan, x, device))
    return out


def solver_run(args, A, plan, layout, rng, device) -> dict:
    """``--solver`` (and ``--cg --fused``, the registry cg + jacobi):
    iterations and us/iteration of one timed solve after a warm one, its
    recorded census, and with ``--check-every`` the resilient driver's."""
    from repro_torch.core import to_dist
    from repro_torch.core.collectives import census_split
    from repro_torch.solvers import make_solver, to_dist_batch

    solver = args.solver or "cg"
    precond = args.precond if args.solver else "jacobi"
    nrhs = args.nrhs if (args.solver and args.nrhs > 1) else None
    solve = make_solver(plan, solver=solver, precond=precond,
                        transport=args.transport,
                        neighbor_offsets=layout["neighbor_offsets"],
                        wire_dtype=args.wire_dtype, nrhs=nrhs, A=A,
                        layout=layout)
    if nrhs:
        b_host = rng.normal(size=(nrhs, A.n_rows))
        b = to_dist_batch(b_host, layout, plan)
    else:
        b_host = rng.normal(size=A.n_rows)
        b = to_dist(b_host, layout, plan)
    solve(b, tol=args.tol, maxiter=200)                     # warmup
    dt, (_, it, rel) = timed(
        lambda: solve(b, tol=args.tol, maxiter=args.iters), device)
    iters = int(it.max())
    out = {"wire_dtype": solve.wire_dtype, "transport": solve.transport,
           "nrhs": nrhs or 1, "cg_iters": iters,
           "cg_rel": float(rel.max()),
           "us_per_iter": dt / max(iters, 1) * 1e6}
    if args.solver:
        out.update(solver=solver, precond=precond)
    else:
        out["fused"] = True
    if not args.no_collectives:
        whole, per_iter = loop_census(solve, b, args.tol, args.iters)
        out["collectives"] = whole
        out["collectives_per_iter"] = per_iter
        out["census_split"] = census_split(per_iter)
    if args.solver and args.check_every > 0:
        from repro_torch.solvers import make_resilient, resilient_solve

        # one set of chunked programs, warmed and timed through the same
        # object; the guard's stall verdict is disabled (tol below the f32
        # floor makes every chunk look stagnant): this times the chunking
        rs = make_resilient(plan, solver=solver, precond=precond,
                            transport=args.transport,
                            neighbor_offsets=layout["neighbor_offsets"],
                            wire_dtype=args.wire_dtype, A=A, layout=layout)
        kw = dict(solver=solver, precond=precond, layout=layout, A=None,
                  tol=args.tol, maxiter=args.iters,
                  check_every=args.check_every, stall_chunks=10**9,
                  programs=rs)
        resilient_solve(plan, b_host, **kw)                 # warmup
        dt, res = timed(lambda: resilient_solve(plan, b_host, **kw), device)
        r_iters = int(np.max(np.asarray(res.iters)))
        r_us = dt / max(r_iters, 1) * 1e6
        out["resilient"] = {
            "check_every": args.check_every, "chunks": res.chunks,
            "iters": r_iters, "us_per_iter": r_us,
            "overhead_vs_monolithic":
                round(r_us / out["us_per_iter"] - 1.0, 4)}
    return out


def spmv_sweep(args, A, plan, x, device) -> dict:
    """Every ``--transport`` x ``--wire-dtype``: timings, the transport's
    predicted cost, the recorded census and wire bytes of one SpMV."""
    from repro_torch.analysis.trace_pass import derived_wire_bytes
    from repro_torch.core import make_spmv, transport_census
    from repro_torch.core.collectives import (census, record_collectives,
                                              reset_wire, wire_seconds)
    from repro_torch.core.transport import autotune_transport

    names = args.transport.split(",")
    wire_dtypes = args.wire_dtype.split(",")
    wire_sweep = {}
    for wd in wire_dtypes:
        predicted = transport_census(plan, wire_dtype=wd)
        sweep = {}
        for name in names:
            res = {}
            if name == "auto":
                at = autotune_transport(plan, wire_dtype=wd)
                spmv = at.spmv
                res["resolved"] = at.winner
                res["autotune"] = {
                    "winner": at.winner,
                    "timings_us": {k: round(v, 1)
                                   for k, v in at.timings_us.items()},
                    "timings_min_us": {k: round(v, 1) for k, v in
                                       at.timings_min_us.items()}}
            else:
                spmv = make_spmv(plan, transport=name, wire_dtype=wd)
                res["resolved"] = spmv.transport
            for _ in range(max(args.warmup, 1)):
                spmv(x)
            rep_us = [timed(lambda: spmv(x), device, args.iters)[0]
                      / args.iters * 1e6 for _ in range(max(args.reps, 1))]
            if plan.is_rank_local:
                reset_wire()
                timed(lambda: spmv(x), device, args.iters)
                wire, exposed = wire_seconds()
                res.update(schedule=[" ".join(s) for s in spmv.schedule],
                           wire_us_per_spmv=wire / args.iters * 1e6,
                           exposed_us_per_spmv=exposed / args.iters * 1e6)
            res["us_per_spmv"] = float(np.median(rep_us))
            res["us_per_spmv_min"] = float(np.min(rep_us))
            res["reps_us"] = [round(v, 1) for v in rep_us]
            res["gflops"] = (2.0 * A.nnz
                             / (res["us_per_spmv_min"] * 1e-6) / 1e9)
            res["predicted"] = predicted[res["resolved"]]
            with record_collectives() as log:
                spmv(x)
            if plan.hs > 0:
                res["traced_wire_bytes"] = derived_wire_bytes(
                    log, plan.n_node, plan.n_core)
            if not args.no_collectives:
                res["collectives"] = census(log)
            sweep[name] = res
        wire_sweep[wd] = sweep
    first = wire_sweep[wire_dtypes[0]][names[0]]
    out = {"transports": wire_sweep[wire_dtypes[0]],
           "wire_dtype": wire_dtypes[0],
           "transport": first["resolved"] if len(names) == 1 else "sweep",
           "us_per_spmv": first["us_per_spmv"],
           "us_per_spmv_min": first["us_per_spmv_min"],
           "gflops": first["gflops"]}
    for key in ("schedule", "wire_us_per_spmv", "exposed_us_per_spmv"):
        if key in first:
            out[key] = first[key]
    if len(wire_dtypes) > 1:
        out["wire"] = wire_sweep
    if "collectives" in first:
        out["collectives"] = first["collectives"]
    return out


if __name__ == "__main__":
    sys.exit(main())
