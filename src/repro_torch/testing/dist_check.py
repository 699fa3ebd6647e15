"""Distributed correctness check of the port on one device.

Usage:  python -m repro_torch.testing.dist_check [--device cpu] \
            --n-node 4 --n-core 2 --mode balanced [--cg] [--fused] \
            [--solver all --nrhs 4] [--check-every 25 --inject-fault nan@30]
            [--mesh process]

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

``--mesh process`` runs the same lines on a process mesh
(``repro_torch.launch.mesh``): this process builds the plan once and
spawns one rank per shard, each on ``--device`` with its own shard
(``--dist-backend gloo``, the default; ``nccl`` puts rank ``r`` on
``cuda:r`` and needs a card per rank);
the lines are printed from the ranks' shards, and a line is ``BAD`` unless
every rank reports the same iterations.  A ``MESH`` line adds each
rank's SpMV ``y`` against its row of the virtual mesh's (bit for bit) and
a jacobi-cg solve's iterations against the virtual mesh's (±1).
``--transport auto`` autotunes on the ranks (one winner for all, or the
``TRANSPORT`` line is ``BAD``); ``--check-every`` runs the resilient
driver on the ranks, each ``RESILIENT`` line from rank 0's whole ``x``.
``--inject-fault preempt@N`` kills every rank: the run prints a ``KILLED``
line with the ranks' exit codes and exits 137.

On a process mesh each mode also prints its schedule (``SCHEDULE <mode>``,
the shard body's issue / wait / launch steps: ``vector`` waits for the
exchange before its one launch, ``task`` and ``balanced`` launch the diag
pass while it is in flight) and its wire per SpMV (``WIRE <mode>``: ms of
collectives and ms of them exposed, the largest over the ranks, after
``SPMV_REPS`` calls).  ``--modes vector,task`` alternates the modes in
one run on the one rows partition they share (vector, task, vector,
task): each mode's ``y`` and every jacobi-cg iterate (``x`` after each
iteration up to convergence) must be bit for bit the first mode's
(the ``MODES`` line).
"""
from __future__ import annotations

import argparse
import dataclasses
import sys
import tempfile

import numpy as np

from repro_torch.launch.mesh import add_dist_backend, dist_backend
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
    ap.add_argument("--mesh", default="virtual",
                    choices=["virtual", "process"],
                    help="virtual: the grid on one device; process: one "
                         "spawned rank per shard")
    ap.add_argument("--modes", default=None,
                    help="with --mesh process: a comma list of modes that "
                         "share one partition (vector,task), alternated in "
                         "one run and held bit for bit to each other")
    add_dist_backend(ap)
    args = ap.parse_args(argv)
    dist_backend(ap, args, args.n_node * args.n_core)
    if args.modes is not None:
        from repro_torch.core.spmv import MODES

        if args.mesh != "process":
            ap.error("--modes needs --mesh process")
        modes = args.modes.split(",")
        if not set(modes) <= set(MODES) or len(set(modes)) != len(modes):
            ap.error(f"--modes takes distinct names of {MODES}")
        if len(modes) > 1 and "balanced" in modes:
            ap.error("--modes: balanced partitions by non-zeros; it shares "
                     "no partition with vector or task")
        args.mode = modes[0]
    if args.mesh == "process":
        return process_main(args)

    from repro_torch.core import (build_spmv_plan, from_dist, make_cg,
                                  make_shard_body, make_spmv, to_dist)

    A = _matrix(args)
    plan, layout = build_spmv_plan(A, args.n_node, args.n_core,
                                   mode=args.mode,
                                   node_partition=args.node_partition,
                                   format=args.format, device=args.device)
    _format_line(layout)
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
    ok = spmv_line(from_dist(spmv(to_dist(x, layout, plan)), layout, plan),
                   A.matvec(x))

    if args.cg or args.fused:
        solve = make_cg(plan)
        b = rng.normal(size=A.n_rows)
        bd = to_dist(b, layout, plan)
        xd, iters, rel = solve(bd, tol=CG_TOL, maxiter=2000)
        xs = from_dist(xd, layout, plan)
        ok = cg_line(A, b, xs, int(iters), float(rel)) and ok

    if args.fused:
        fsolve = make_cg(plan, fused=True, transport=args.transport,
                         neighbor_offsets=layout["neighbor_offsets"])
        xf, itf, relf = fsolve(bd, tol=CG_TOL, maxiter=2000)
        ok = fused_line(A, b, xs, int(iters), from_dist(xf, layout, plan),
                        int(itf), float(relf)) and ok

    if args.solver:
        ok = solvers(args, A, plan, layout, rng,
                     b if (args.cg or args.fused) else None) and ok

    print("OK" if ok else "FAIL")
    return 0 if ok else 1


# ---------------------------------------------------------------------- #
# the lines, from global vectors (either mesh)
# ---------------------------------------------------------------------- #
# tol above the float32 attainable-accuracy floor of these small matrices
# (~1e-4 true residual): below it iteration counts are reduction-order
# noise
CG_TOL = SOLVER_TOL = 1e-5
#: SpMV calls a ``WIRE <mode>`` line averages over
SPMV_REPS = 10
#: f32 attainable true-residual / solution-error floors per solver:
#: pipelined CG trades ~1 digit of attainable accuracy for the overlap,
#: Chebyshev stops on its a-priori error bound
BOUNDS = {"cg": (2e-4, 1e-2), "pipelined_cg": (1e-3, 3e-2),
          "chebyshev": (2e-3, 5e-2)}


def _matrix(args):
    from repro_torch.sparse import (extruded_mesh_matrix,
                                    graded_extruded_mesh_matrix,
                                    random_spd_matrix)

    if args.matrix == "mesh":
        return extruded_mesh_matrix(args.n_surface, args.layers, seed=0)
    if args.matrix == "graded":
        return graded_extruded_mesh_matrix(args.n_surface, args.layers,
                                           seed=0)
    return random_spd_matrix(args.n, nnz_per_row=9, seed=0)


def _format_line(layout) -> None:
    nb = layout["node_bounds"]
    print(f"FORMAT {layout['format']} "
          f"NODE_SIZES {np.diff(nb).tolist()} "
          f"NODE_IMB {layout['stats']['node_imbalance']:.3f} "
          f"CORE_IMB {layout['stats']['core_imbalance']:.3f} "
          f"WASTE {layout['stats']['padding_waste']:.3f}")


def _true_rel(A, x, b) -> float:
    return float(np.linalg.norm(A.matvec(x) - b) / np.linalg.norm(b))


def spmv_line(y, y_ref) -> bool:
    err = float(np.abs(y - y_ref).max() / np.abs(y_ref).max())
    print(f"SPMV_REL_ERR {err:.3e}")
    return err < 5e-5


def cg_line(A, b, xs, iters: int, rel: float, tail: str = "") -> bool:
    true_rel = _true_rel(A, xs, b)
    print(f"CG_ITERS {iters} CG_REL {rel:.3e} TRUE_REL {true_rel:.3e}"
          + tail)
    return true_rel < 2e-4 and iters < 2000


def fused_line(A, b, xs, iters: int, xfs, itf: int, relf: float,
               tail: str = "") -> bool:
    """The fused solve against the unfused one and against a solve that
    never touches the distributed layout."""
    f_rel = _true_rel(A, xfs, b)
    dx = float(np.abs(xfs - xs).max() / max(np.abs(xs).max(), 1e-30))
    diters = abs(itf - iters)
    xh = host_cg(A, b, tol=1e-8, maxiter=4000)
    dx_host = float(np.linalg.norm(xfs - xh)
                    / max(np.linalg.norm(xh), 1e-30))
    print(f"FUSED_ITERS {itf} FUSED_REL {relf:.3e} "
          f"FUSED_TRUE_REL {f_rel:.3e} DX {dx:.3e} DITERS {diters} "
          f"DX_HOST {dx_host:.3e}" + tail)
    return f_rel < 2e-4 and diters <= 1 and dx < 1e-3 and dx_host < 1e-2


def solver_line(name: str, precond: str, A, b, xs, its: int, rel: float,
                xh, agree: bool = True) -> bool:
    tr_max, dx_max = BOUNDS.get(name, (2e-3, 5e-2))
    tr = _true_rel(A, xs, b)
    dxh = float(np.linalg.norm(xs - xh)) / max(float(np.linalg.norm(xh)),
                                               1e-30)
    ok = agree and tr < tr_max and dxh < dx_max and its < 5000
    print(f"SOLVER {name} PRECOND {precond} ITERS {its} "
          f"REL {rel:.3e} TRUE_REL {tr:.3e} "
          f"DX_HOST {dxh:.3e} {'ok' if ok else 'BAD'}")
    return ok


def resilient_line(name: str, precond: str, res, xh, armed: bool,
                   agree: bool = True) -> bool:
    """A resilient solve against the oracle; an ``armed`` fault must trip
    the guard (zero rollbacks means the injection was a no-op)."""
    tr_max, dx_max = BOUNDS.get(name, (2e-3, 5e-2))
    dxh = float(np.linalg.norm(res.x - xh)) / max(float(np.linalg.norm(xh)),
                                                  1e-30)
    ok = (agree and res.converged and res.true_rel < tr_max
          and dxh < dx_max and (res.rollbacks > 0 or not armed))
    print(f"RESILIENT {name} PRECOND {precond} "
          f"ITERS {int(np.max(res.iters))} "
          f"CHUNKS {res.chunks} ROLLBACKS {res.rollbacks} "
          f"TRUE_REL {res.true_rel:.3e} DX_HOST {dxh:.3e} "
          f"{'ok' if ok else 'BAD'}")
    return ok


def batched_line(name: str, Xs, Xh, itb: list, agree: bool = True) -> bool:
    worst = max(float(np.linalg.norm(Xs[j] - Xh[j]))
                / max(float(np.linalg.norm(Xh[j])), 1e-30)
                for j in range(len(Xh)))
    ok = agree and worst < BOUNDS.get(name, (2e-3, 5e-2))[1] \
        and max(itb) < 5000
    print(f"SOLVER {name} NRHS {len(Xh)} ITERS {itb} "
          f"WORST_DX_HOST {worst:.3e} {'ok' if ok else 'BAD'}")
    return ok


def _solver_rhs(args, A, rng, b):
    """The ``--solver`` lines' right-hand sides and their host oracles:
    ``(names, b, xh, B, Xh)`` (``B``/``Xh`` ``None`` without ``--nrhs``)."""
    from repro_torch.solvers import available_solvers

    names = (available_solvers() if args.solver == "all"
             else tuple(args.solver.split(",")))
    b = rng.normal(size=A.n_rows) if b is None else b
    xh = host_cg(A, b, tol=1e-10, maxiter=20_000)
    B = Xh = None
    if args.nrhs > 1:
        B = np.random.default_rng(11).normal(size=(args.nrhs, A.n_rows))
        Xh = [host_cg(A, B[j], tol=1e-10, maxiter=20_000)
              for j in range(args.nrhs)]
    return names, b, xh, B, Xh


def solvers(args, A, plan, layout, rng, b) -> bool:
    """The ``--solver`` lines: each solver (monolithic or resilient, and
    batched with ``--nrhs``) against the f64 host-CG oracle."""
    from repro_torch.core import from_dist, to_dist
    from repro_torch.solvers import (from_dist_batch, make_solver,
                                     resilient_solve, to_dist_batch)

    names, b, xh, B, Xh = _solver_rhs(args, A, rng, b)
    bd = to_dist(b, layout, plan)
    ok = True
    for name in names:
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
                tol=SOLVER_TOL, maxiter=5000, check_every=args.check_every,
                checkpoint_dir=args.checkpoint_dir,
                resume_from=args.resume_from, injector=inj)
            ok = resilient_line(name, args.precond, res, xh,
                                inj is not None and inj.kind != "preempt"
                                ) and ok
            continue
        kw = dict(solver=name, precond=args.precond,
                  transport=args.transport,
                  neighbor_offsets=layout["neighbor_offsets"], A=A,
                  layout=layout)
        xd, its, rel = make_solver(plan, **kw)(bd, tol=SOLVER_TOL,
                                               maxiter=5000)
        ok = solver_line(name, args.precond, A, b,
                         from_dist(xd, layout, plan), int(its), float(rel),
                         xh) and ok
        if B is not None:
            Xd, itb, _ = make_solver(plan, nrhs=args.nrhs, **kw)(
                to_dist_batch(B, layout, plan), tol=SOLVER_TOL,
                maxiter=5000)
            ok = batched_line(name, from_dist_batch(Xd, layout, plan), Xh,
                              np.asarray(itb.cpu()).tolist()) and ok
    return ok


# ---------------------------------------------------------------------- #
# --mesh process
# ---------------------------------------------------------------------- #
def _row(a, mesh):
    import torch

    return torch.from_numpy(np.array(
        a[mesh.node:mesh.node + 1, mesh.core:mesh.core + 1])).to(mesh.device)


def _np(t):
    return t.detach().cpu().numpy()


def _rank(mesh, plan_dir: str, job: dict) -> dict:
    """One rank's share of every line: its shard of each result and its
    iteration counts."""
    from repro_torch.core import make_cg, make_shard_body, make_spmv
    from repro_torch.launch.mesh import read_plan
    from repro_torch.solvers import make_solver

    a = job["args"]
    plan = read_plan(plan_dir, mesh)
    route = dict(transport=a["transport"],
                 neighbor_offsets=job["layout"]["neighbor_offsets"])
    spmv = make_spmv(plan, **route)
    transport = spmv.transport
    if a["transport"] == "auto":
        # the autotuner stamped its winner into the plan; later builds
        # follow the stamp instead of re-running the timing sweep
        route["transport"] = None
    if a["backend"] == "plain":
        spmv = make_shard_body(plan, backend="plain", **route)
    out = {"y": _np(spmv(_row(job["x"], mesh))), "solvers": {},
           "transport": transport}
    if a["cg"] or a["fused"]:
        xd, it, rel = make_cg(plan)(_row(job["b"], mesh), tol=CG_TOL,
                                    maxiter=2000)
        out["cg"] = (_np(xd), int(it), float(rel))
    if a["fused"]:
        xd, it, rel = make_cg(plan, fused=True, **route)(
            _row(job["b"], mesh), tol=CG_TOL, maxiter=2000)
        out["fused"] = (_np(xd), int(it), float(rel))
    for name in job["solvers"]:
        if a["check_every"] > 0:
            out["solvers"][name] = _rank_resilient(plan, name, job, route)
            continue
        kw = dict(solver=name, precond=a["precond"], A=job["A"],
                  layout=job["layout"], options=job["options"].get(name),
                  **route)
        xd, it, rel = make_solver(plan, **kw)(
            _row(job["b_solver"], mesh), tol=SOLVER_TOL, maxiter=5000)
        res = {"x": _np(xd), "iters": int(it), "rel": float(rel)}
        if job["B"] is not None:
            Xd, itb, _ = make_solver(plan, nrhs=a["nrhs"], **kw)(
                _row(job["B"], mesh), tol=SOLVER_TOL, maxiter=5000)
            res.update(X=_np(Xd), iters_b=_np(itb).tolist())
        out["solvers"][name] = res
    xd, it, _ = make_solver(plan, **route)(_row(job["b_mesh"], mesh),
                                           tol=CG_TOL, maxiter=2000)
    out["mesh_cg"] = int(it)
    out["modes"] = _rank_modes(mesh, plan, job, route)
    return out


def _rank_modes(mesh, plan, job: dict, route: dict) -> list:
    """Each of ``job["modes"]`` on this rank, alternated (every mode, then
    every mode again): the plan under that mode's schedule, its ``y``, its
    schedule and wire per SpMV; in the first round also jacobi-cg's every
    iterate (:func:`cg_iterates`).  One entry per run, in run order."""
    from repro_torch.core import make_spmv
    from repro_torch.core.collectives import reset_wire, wire_seconds
    from repro_torch.solvers import make_solver

    x, b = _row(job["x"], mesh), _row(job["b_mesh"], mesh)
    runs = []
    for rnd in range(2):
        for mode in job["modes"]:
            pm = dataclasses.replace(plan, mode=mode)
            spmv = make_spmv(pm, **route)
            run = {"mode": mode, "schedule": spmv.schedule,
                   "y": _np(spmv(x))}
            mesh.barrier()
            reset_wire()
            for _ in range(SPMV_REPS):
                spmv(x)
            run["wire_ms"] = [v * 1e3 / SPMV_REPS for v in wire_seconds()]
            if rnd == 0:
                run["iterates"] = cg_iterates(make_solver(pm, **route), b,
                                              CG_TOL, 2000)
            runs.append(run)
    return runs


def cg_iterates(solve, b, tol: float, maxiter: int) -> list:
    """Every iterate of ``solve`` (a ``make_solver`` solve) on ``b``: its
    loop, one body at a time, ``x`` read after each iteration until no
    right-hand side is active."""
    sol, ctx, bb, tol_t, maxiter_t = solve.parts(b, tol, maxiter)
    aux, state = sol.loop_setup(ctx, bb, tol_t, maxiter_t)
    xs = []
    while bool(sol.loop_cond(ctx, aux, state)):
        state = sol.loop_body(ctx, aux, state)
        xs.append(_np(state["x"]))
    return xs


def modes_lines(ranks, modes) -> bool:
    """The ``SCHEDULE`` and ``WIRE`` lines of each mode and, for more than
    one mode, the ``MODES`` line: every run's ``y`` and every iterate bit
    for bit the first mode's, on every rank."""
    ok = True
    runs = [r["modes"] for r in ranks]
    for i, mode in enumerate(modes):
        steps = " > ".join(" ".join(s) for s in runs[0][i]["schedule"])
        print(f"SCHEDULE {mode} {steps}")
        wire = [r[j]["wire_ms"] for r in runs
                for j in range(len(r)) if r[j]["mode"] == mode]
        print(f"WIRE {mode} PER_SPMV_MS {max(w[0] for w in wire):.4f} "
              f"EXPOSED_MS {max(w[1] for w in wire):.4f}")
        ok = ok and all(w[1] <= w[0] for w in wire)
    if len(modes) > 1:
        def bits(a, b):
            return np.array_equal(a.view(np.int32), b.view(np.int32))

        y_ok = all(bits(run["y"], r[0]["y"]) for r in runs for run in r)
        n_its = [len(r[i]["iterates"]) for r in runs
                 for i in range(len(modes))]
        x_ok = _agree(n_its) and all(
            bits(a, b) for r in runs for i in range(1, len(modes))
            for a, b in zip(r[i]["iterates"], r[0]["iterates"]))
        m_ok = y_ok and x_ok
        print(f"MODES {','.join(modes)} RUNS {len(runs[0])} SPMV_BITWISE "
              f"{'ok' if y_ok else 'BAD'} ITERATES {n_its[0]} BITWISE "
              f"{'ok' if x_ok else 'BAD'} {'ok' if m_ok else 'BAD'}")
        ok = ok and m_ok
    return ok


def _rank_resilient(plan, name: str, job: dict, route: dict) -> dict:
    """A ``--check-every`` solve on a rank: the resilient driver, with
    any injected fault; ``x`` comes back whole."""
    from repro_torch.runtime.fault import FaultInjector
    from repro_torch.solvers import resilient_solve

    a = job["args"]
    inj = (FaultInjector.parse(a["inject_fault"]) if a["inject_fault"]
           else None)
    res = resilient_solve(
        plan, job["b_solver_global"], layout=job["layout"], A=job["A"],
        solver=name, precond=a["precond"], tol=SOLVER_TOL, maxiter=5000,
        check_every=a["check_every"], checkpoint_dir=a["checkpoint_dir"],
        resume_from=a["resume_from"], injector=inj,
        options=job["options"].get(name), **route)
    return {"res": res, "iters": int(np.max(res.iters)),
            "armed": inj is not None and inj.kind != "preempt"}


def _whole(rows, plan):
    """The ranks' shards ``(1, 1, ...)``, in rank order, as one
    ``(n_node, n_core, ...)`` tensor on the CPU."""
    import torch

    a = np.concatenate([r[0, 0][None] for r in rows])
    return torch.from_numpy(a.reshape((plan.n_node, plan.n_core)
                                      + a.shape[1:]))


def _agree(vals) -> bool:
    return all(v == vals[0] for v in vals)


def process_main(args) -> int:
    """The lines of :func:`main` on a process mesh (see the module
    docstring)."""
    import torch

    from repro_torch.core import build_spmv_plan, from_dist, make_spmv, to_dist
    from repro_torch.launch.mesh import RanksKilled, spawn_cg_mesh, write_plan
    from repro_torch.solvers import (from_dist_batch, make_solver,
                                     to_dist_batch)

    A = _matrix(args)
    # the launcher's copy of the plan, on the host: each rank places its
    # own shard on --device
    plan, layout = build_spmv_plan(A, args.n_node, args.n_core,
                                   mode=args.mode,
                                   node_partition=args.node_partition,
                                   format=args.format, device="cpu")
    _format_line(layout)

    # the same draws, in the same order, as the virtual mesh's lines
    rng = np.random.default_rng(1)
    x = rng.normal(size=A.n_rows)
    b = rng.normal(size=A.n_rows) if (args.cg or args.fused) else None
    names, b_solver, xh, B, Xh = (_solver_rhs(args, A, rng, b)
                                  if args.solver else ((), None, None,
                                                       None, None))
    b_mesh = np.random.default_rng(3).normal(size=A.n_rows)
    # Chebyshev's bounds, estimated once on the host as make_solver would
    options = {name: make_solver(plan, solver=name, precond=args.precond,
                                 A=A, layout=layout).options
               for name in names if name == "chebyshev"}

    def dist(v):
        return None if v is None else _np(to_dist(v, layout, plan))

    job = {"args": vars(args), "A": A, "layout": layout, "solvers": names,
           "options": options, "x": dist(x), "b": dist(b),
           "b_solver": dist(b_solver), "b_mesh": dist(b_mesh),
           "b_solver_global": b_solver,
           "B": None if B is None else _np(to_dist_batch(B, layout, plan)),
           "modes": args.modes.split(",") if args.modes else [args.mode]}
    with tempfile.TemporaryDirectory(prefix="dist_check_") as d:
        write_plan(plan, d)
        try:
            ranks = spawn_cg_mesh(_rank, args.n_node, args.n_core,
                                  args.device, backend=args.dist_backend,
                                  args=(d, job), timeout=600)
        except RanksKilled as e:      # preempt@N: every rank killed
            print(f"KILLED exit codes {e.exitcodes}")
            return 137
    won = [r["transport"] for r in ranks]
    print(f"TRANSPORT {won[0]}" + (" (auto)" if args.transport == "auto"
                                   else "")
          + ("" if _agree(won) else f" RANKS BAD {won}"))

    def whole(rows):
        return from_dist(_whole(rows, plan), layout, plan)

    y_rows = _whole([r["y"] for r in ranks], plan)
    ok = spmv_line(from_dist(y_rows, layout, plan), A.matvec(x))
    ok = ok and _agree(won)
    for key in ("cg", "fused"):
        if key not in ranks[0]:
            continue
        its = [r[key][1] for r in ranks]
        xk = whole([r[key][0] for r in ranks])
        tail = f" RANKS {'ok' if _agree(its) else 'BAD'}"
        if key == "cg":
            xs, iters = xk, its[0]
            ok = cg_line(A, b, xs, iters, ranks[0][key][2], tail) and ok
        else:
            ok = fused_line(A, b, xs, iters, xk, its[0], ranks[0][key][2],
                            tail) and ok
        ok = ok and _agree(its)
    for name in names:
        res = [r["solvers"][name] for r in ranks]
        its = [r["iters"] for r in res]
        if args.check_every > 0:
            ok = resilient_line(name, args.precond, res[0]["res"], xh,
                                res[0]["armed"], agree=_agree(its)) and ok
            continue
        ok = solver_line(name, args.precond, A, b_solver,
                         whole([r["x"] for r in res]), its[0],
                         res[0]["rel"], xh, agree=_agree(its)) and ok
        if B is not None:
            itb = [r["iters_b"] for r in res]
            Xs = from_dist_batch(_whole([r["X"] for r in res], plan),
                                 layout, plan)
            ok = batched_line(name, Xs, Xh, itb[0], agree=_agree(itb)) and ok

    # against the virtual mesh on the same device: SpMV bits, cg counts
    vp, vl = build_spmv_plan(A, args.n_node, args.n_core, mode=args.mode,
                             node_partition=args.node_partition,
                             format=args.format, device=args.device)
    # every transport's y is a2a's, bit for bit: the ranks' winner
    route = dict(transport=won[0], neighbor_offsets=vl["neighbor_offsets"])
    yv = make_spmv(vp, **route)(to_dist(x, vl, vp))
    y_bits = torch.equal(yv.cpu().view(torch.int32),
                         y_rows.view(torch.int32))
    _, itv, _ = make_solver(vp, **route)(to_dist(b_mesh, vl, vp),
                                         tol=CG_TOL, maxiter=2000)
    its = [r["mesh_cg"] for r in ranks]
    m_ok = y_bits and _agree(its) and abs(its[0] - int(itv)) <= 1
    print(f"MESH process {args.dist_backend} RANKS {len(ranks)} "
          f"SPMV_BITWISE "
          f"{'ok' if y_bits else 'BAD'} CG_ITERS {its[0]} VIRTUAL "
          f"{int(itv)} {'ok' if m_ok else 'BAD'}")
    ok = modes_lines(ranks, job["modes"]) and ok and m_ok
    print("OK" if ok else "FAIL")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
