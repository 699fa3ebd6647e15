"""End-to-end paper benchmark on the PyTorch/CUDA port: the Sec. 3
protocol on a virtual 4×2 node×core mesh held on one device.

The port's counterpart of ``examples/cg_solve.py``: it builds the
extruded-mesh pressure matrix and runs the full solve four ways:

  * the three SpMV algorithm modes with the unfused baseline against the
    fused registry ``cg``;
  * the solver registry (``repro_torch.solvers``): ``cg`` /
    ``pipelined_cg`` / ``chebyshev`` selected **by name**, each with the
    ``jacobi`` preconditioner, reporting per-iteration time and the
    per-iteration reduction census (``reduction_census``: the
    cross-shard reductions one loop body issues);
  * the transport registry (``repro_torch.core.transport``): every
    registered halo transport's SpMV timed beside its predicted wire bytes,
    then ``autotune_transport`` stamping the measured winner into the plan
    and the registry ``cg`` re-run on it (``transport="auto"``);
  * the resilient driver: the registry ``cg`` in chunks of 50 iterations,
    clean and with a NaN planted at iteration 60, which the guard must
    roll back.

    PYTHONPATH=src python examples/cg_solve_torch.py [--device cuda|cpu]
        [--n-surface 1500 --layers 12]

The last line is one JSON object of the results, keyed as the reference
example keys them.
"""
import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.core import (autotune_transport, available_transports,  # noqa: E402
                              build_spmv_plan, from_dist, make_cg, make_spmv,
                              to_dist)
from repro_torch.runtime.fault import FaultInjector  # noqa: E402
from repro_torch.solvers import (make_resilient, make_solver,  # noqa: E402
                                 reduction_census, resilient_solve)
from repro_torch.sparse import extruded_mesh_matrix  # noqa: E402

N_NODE, N_CORE = 4, 2


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--n-surface", type=int, default=1500)
    ap.add_argument("--layers", type=int, default=12)
    args = ap.parse_args(argv)
    device = torch.device(args.device)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    def timed(fn):
        fn()                                   # warm (CUDA: build, load)
        sync()
        t0 = time.perf_counter()
        out = fn()
        sync()
        return out, time.perf_counter() - t0

    name = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")
    print(f"device: {name} -> virtual hybrid mesh {N_NODE} nodes x "
          f"{N_CORE} cores")
    A = extruded_mesh_matrix(n_surface=args.n_surface, layers=args.layers,
                             seed=0)
    print(f"pressure matrix: {A.n_rows} DoF, {A.nnz} nnz")
    b = np.random.default_rng(1).normal(size=A.n_rows)

    def true_rel(xd, layout, plan):
        xs = from_dist(xd, layout, plan).astype(np.float64)
        return float(np.linalg.norm(A.matvec(xs) - b) / np.linalg.norm(b))

    results = {}
    for mode in ("vector", "task", "balanced"):
        plan, layout = build_spmv_plan(A, N_NODE, N_CORE, mode=mode,
                                       device=device)
        bd = to_dist(b, layout, plan)
        for tag, fused in (("unfused", False), ("fused", True)):
            solve = make_cg(plan, fused=fused)
            (xd, it, rel), dt = timed(
                lambda: solve(bd, tol=1e-8, maxiter=10_000))
            results[f"{mode}/{tag}"] = dict(
                iters=int(it), us_per_iter=dt / int(it) * 1e6,
                rel=float(rel), true_rel=true_rel(xd, layout, plan))
            r = results[f"{mode}/{tag}"]
            print(f"{mode:9s} {tag:8s}: {r['iters']:4d} iters, "
                  f"{r['us_per_iter']:8.1f} us/iter, "
                  f"true rel {r['true_rel']:.2e}")

    # --- the Krylov registry: solvers selected by name ------------------ #
    plan, layout = build_spmv_plan(A, N_NODE, N_CORE, mode="balanced",
                                   format="sell", device=device)
    bd = to_dist(b, layout, plan)
    for sname in ("cg", "pipelined_cg", "chebyshev"):
        solve = make_solver(plan, solver=sname, precond="jacobi",
                            A=A, layout=layout,
                            neighbor_offsets=layout["neighbor_offsets"])
        (xd, it, rel), dt = timed(lambda: solve(bd, tol=1e-5,
                                                maxiter=10_000))
        census = reduction_census(solve, bd, tol=1e-5, maxiter=10_000)
        results[f"solver/{sname}"] = dict(
            iters=int(it), us_per_iter=dt / max(int(it), 1) * 1e6,
            true_rel=true_rel(xd, layout, plan), allreduce_per_iter=census)
        r = results[f"solver/{sname}"]
        print(f"{sname:13s} jacobi  : {r['iters']:4d} iters, "
              f"{r['us_per_iter']:8.1f} us/iter, {census} reductions/iter, "
              f"true rel {r['true_rel']:.2e}")

    # --- the transport registry: every halo exchange, then auto -------- #
    for tname in available_transports():
        spmv = make_spmv(plan, transport=tname)
        _, dt = timed(lambda: [spmv(bd) for _ in range(50)])
        us = dt / 50 * 1e6
        cost = layout["transport_census"][tname]
        results[f"transport/{tname}"] = dict(
            us_per_spmv=us, wire_bytes=cost["wire_bytes"])
        print(f"transport {tname:9s}: {us:8.1f} us/spmv, "
              f"{cost['wire_bytes']:6d} predicted wire B, "
              f"{cost['collective-permute']} ppermute")

    res = autotune_transport(plan)
    solve = make_solver(plan, solver="cg", precond="jacobi")  # stamped
    _, it_a, _ = solve(bd, tol=1e-5, maxiter=10_000)
    results["transport/auto"] = dict(winner=res.winner, iters=int(it_a))
    print(f"autotune -> {res.winner}; registry cg on the stamped plan: "
          f"{int(it_a)} iters (transport={solve.transport})")

    # --- resilience: chunked execution, fault injection, rollback ------- #
    # the same registry cg under the resilient driver: a NaN planted in the
    # iterate mid-solve is caught by the between-chunk guard, rolled back
    # to the last healthy chunk, and the solve still converges
    rs = make_resilient(plan, solver="cg", precond="jacobi", A=A,
                        layout=layout,
                        neighbor_offsets=layout["neighbor_offsets"])
    kw = dict(solver="cg", precond="jacobi", layout=layout, A=A, tol=1e-5,
              maxiter=10_000, check_every=50, programs=rs)
    clean, dt = timed(lambda: resilient_solve(plan, b, **kw))
    r_us = dt / max(int(np.max(clean.iters)), 1) * 1e6
    mono_us = results["solver/cg"]["us_per_iter"]
    faulted = resilient_solve(plan, b, injector=FaultInjector.parse("nan@60"),
                              **kw)
    results["resilient/cg"] = dict(
        iters=int(np.max(clean.iters)), chunks=clean.chunks,
        us_per_iter=r_us, overhead_vs_monolithic=r_us / mono_us - 1.0,
        faulted_rollbacks=faulted.rollbacks,
        faulted_converged=faulted.converged,
        faulted_true_rel=faulted.true_rel)
    print(f"resilient cg  chunked : {int(np.max(clean.iters)):4d} iters in "
          f"{clean.chunks} chunks, {r_us:8.1f} us/iter "
          f"({(r_us / mono_us - 1.0) * 100:+.1f}% vs monolithic)")
    print(f"resilient cg  nan@60  : detected + rolled back "
          f"{faulted.rollbacks}x, converged={faulted.converged}, "
          f"true rel {faulted.true_rel:.2e}")
    assert faulted.rollbacks > 0 and faulted.converged

    print(json.dumps(results))
    return 0


if __name__ == "__main__":
    sys.exit(main())
