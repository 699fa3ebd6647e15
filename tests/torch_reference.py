"""Dump the JAX reference's results for the port's parity tests.

Usage:  python tests/torch_reference.py OUT.npz [CASE ...]
        python tests/torch_reference.py OUT.npz --transports
        python tests/torch_reference.py OUT.npz --refine
        python tests/torch_reference.py OUT.npz --solvers
        python tests/torch_reference.py OUT.npz --resilient PORT_CKPT REF_CKPT
        python tests/torch_reference.py OUT.npz --rect
        python tests/torch_reference.py OUT.npz --precond
        python tests/torch_reference.py OUT.npz --serve PORT_CKPT REF_CKPT

A case is ``FORMAT/N_NODExN_CORE`` (default: ``ell/4x2 sell/4x2 ell/1x4
sell/1x4``) on ``graded_extruded_mesh_matrix(48, 6, seed=0)`` — the golden
fixture's matrix, with its seeded ``x``/``b`` (``default_rng(7)``).  Needs
``N_NODE * N_CORE`` XLA devices (``--xla_force_host_platform_device_count``,
set by the caller).  Writes, per case, under ``"<case>/<name>"``:

  plan arrays    every ``plan_fields`` array plus ``diag_a`` and ``mask``;
  meta           the plan meta as a JSON string;
  ghost          the assembled ghost buffers ``(n_node, n_core, g_pad+1)``
                 of the ``a2a`` exchange of ``x`` (halo plans only);
  y_jnp/pallas   ``make_spmv`` of ``x`` in distributed layout, for
                 ``backend="jnp"`` and ``"pallas"`` (interpret mode);
  cg_<tol>_x     the fused CG solve (``make_solver``, cg + jacobi,
  cg_<tol>_iters maxiter 400) of ``b`` at each tol of ``TOLS``,
                 distributed layout;
  cgu_<tol>_...  the same through the unfused ``make_cg``.

``--transports`` dumps, for each case of ``repro.testing.transport_check``
with halo traffic (ell, 4×2, its seeded ``x``, ``default_rng(7)``), under
``"<case>/<transport>/<wire dtype>/<name>"``: ``ghost``, the
``make_exchange`` probe ``(n_node, n_core, g_pad + 1)``, and ``host``,
the transport's ``host_exchange``.

``--refine`` dumps ``make_refine`` (cg + jacobi, ``refine_check``'s inner
tolerance per wire dtype, maxiter_inner 1000) on
``graded_extruded_mesh_matrix(80, 6)`` at 4×2, ell and sell, for each wire
dtype, of ``refine_check``'s RHS (``default_rng(1)``) to tol 1e-7, under
``"<format>/<wire dtype>/<name>"``: ``cycles``, ``rel``, ``x``; and the
options ``make_refine`` gives ``pipelined_cg`` over each wire dtype (its
``lossy_wire_options`` merged in on a lossy codec) under
``"<format>/<wire dtype>/pipelined_cg/options"`` (a JSON string).

``--solvers`` dumps, for each golden case (the default ``CASES``, the
golden matrix and ``b``), ``make_solver(A=, layout=)`` with jacobi for each
of ``SOLVERS`` at each tol of ``SOLVER_TOLS`` (maxiter 2000), under
``"<case>/<solver>/<name>"``: ``<tol>_x`` (distributed layout),
``<tol>_iters``, ``<tol>_rel``, ``lmin``/``lmax`` (chebyshev's resolved
options), ``reductions_per_iter`` and ``census``, the all-reduce count of
the compiled while body (``repro.util.while_body_collective_counts``);
and, at ``examples/cg_solve.py``'s size and plan
(``extruded_mesh_matrix(1500, 12)``, 4×2 balanced sell, RHS
``default_rng(1)``), each solver's count at tol 1e-5 under
``"example/<solver>/iters"``.

``--rect`` dumps, for each ``repro.testing.rect_check`` matrix (tall,
fat, agg; seed 3) at 4×2, ell and sell, ``rows`` and ``nnz`` node
partitions, ``make_spmv`` of ``x`` (``default_rng(103)``, column layout)
back in global row order, under ``"<kind>/<format>/<part>/y"``.

``--precond`` dumps, on the golden matrix at 4×2 (``node_partition
"nnz"``), ell and sell, ``make_precond_apply`` of ``r``
(``default_rng(11)``) for jacobi, block_jacobi and two_level in global
row order, under ``"<format>/<precond>/z"``; and for each of
``precond_check``'s ``SCALING_MESHES`` (4×2 rows-partition ell, RHS
``default_rng(7)``) the cg iteration counts with block_jacobi and
two_level (agg ``SCALING_AGG``) at each tol of ``SCALING_TOLS``, under
``"scaling/<n_surface>x<layers>/<precond>/<tol>"``.

``--serve PORT_CKPT REF_CKPT`` dumps the solve service's pieces:
``fingerprint/<name>``, ``matrix_fingerprint`` of
``graded_extruded_mesh_matrix(16, 4)`` (``graded``) and of the golden
matrix (``golden``); ``dist_batch/bd`` and ``dist_batch/back``,
``to_dist_batch`` / ``from_dist_batch`` of three RHS (``default_rng(1)``)
on that graded matrix's 2×2 nnz plan (non-uniform node bounds);
``nrhs3/<format>/iters``, ``make_solver(nrhs=3)`` (cg + jacobi, tol 1e-5,
maxiter 2000) on the golden matrix at 4×2 of three RHS
(``default_rng(7)``); ``engine/<n_node>x<n_core>/iters`` and ``.../x``,
a ``SolveService`` (nrhs 3, check_every 5, ell) on the graded matrix
serving nine RHS (``default_rng(3)``, tols cycling ``SERVE_TOLS``) at 1×1
and 2×2.  Then on the graded matrix at 1×1 (nrhs 2, check_every 5): an
ell engine takes two RHS (``default_rng(11)``, tols 1e-5 / 3e-5), runs one
chunk and checkpoints to ``REF_CKPT``; fresh sell engines restore
``REF_CKPT`` and ``PORT_CKPT`` (written by the port the same way) and
drain: ``resume_ref/...`` and ``resume_port/...`` (``rids``, ``iters``,
``x``, ``residual``).

``--resilient PORT_CKPT REF_CKPT`` works on ``resilience_check``'s system
(``graded_extruded_mesh_matrix(48, 6)``, RHS ``default_rng(1)``, jacobi,
tol 1e-5, check_every 10).  Under ``"<solver>/<name>"``, a clean chunked
``resilient_solve`` per solver at 4×2, ell, a2a: ``iters``, ``x``,
``chunks``, ``rollbacks``, ``true_rel``.  Then cg: a solve cut at maxiter
25 writes its checkpoints to ``REF_CKPT`` (``ckpt/x``, ``ckpt/step``);
the reference resumes from ``REF_CKPT`` and from ``PORT_CKPT`` (written by
the port) at 2×2, sell, ring, to tol: ``resume_ref/*`` and
``resume_port/*`` (``iters``, ``x``, ``resumed_from``, ``converged``,
``true_rel``).
"""
import json
import sys

import numpy as np

CASES = ("ell/4x2", "sell/4x2", "ell/1x4", "sell/1x4")
#: 1e-6 is the golden fixture's tolerance; 3e-6 and 1e-5 sit above the
#: float32 plateau where iteration counts at 1e-6 depend on rounding order
TOLS = (1e-6, 3e-6, 1e-5)
SOLVERS = ("cg", "pipelined_cg", "chebyshev")
#: --solvers' tolerances: 1e-3 sits above the f32 plateau, where even
#: pipelined_cg's count is set by the operator and not by rounding
SOLVER_TOLS = (1e-3,) + TOLS
PLAN_META = ("n", "n_node", "n_core", "rc_pad", "nl_pad", "g_pad", "hs",
             "mode", "format", "transport", "wire_dtype")
#: --precond's scaling tolerances: 1e-6 is precond_check's; 3e-6 and 1e-5
#: sit above the smallest mesh's float32 plateau
SCALING_TOLS = (1e-6, 3e-6, 1e-5)
#: --serve's per-request tolerances, cycled over the queue
SERVE_TOLS = (1e-5, 3e-5, 1e-4)


def dump_case(case: str, A, x, b) -> dict:
    import jax
    from jax.sharding import Mesh

    from repro.core import build_spmv_plan, make_cg, make_spmv, to_dist
    from repro.core.spmv import plan_fields, plan_shard_arrays
    from repro.core.transport import make_exchange
    from repro.solvers import make_solver

    fmt, grid = case.split("/")
    n_node, n_core = (int(v) for v in grid.split("x"))
    mesh = Mesh(np.array(jax.devices()[:n_node * n_core]).reshape(
        n_node, n_core), ("node", "core"))
    plan, layout = build_spmv_plan(A, n_node, n_core, mode="balanced",
                                   node_partition="nnz", format=fmt)
    out = {name: np.asarray(arr) for name, arr in
           zip(plan_fields(plan), plan_shard_arrays(plan))}
    out["diag_a"] = np.asarray(plan.diag_a)
    out["mask"] = np.asarray(plan.mask)
    out["meta"] = np.asarray(json.dumps(
        {k: getattr(plan, k) for k in PLAN_META}))
    xd = to_dist(x, layout, plan)
    if plan.hs:
        out["ghost"] = np.asarray(make_exchange(plan, mesh)(xd))
    for backend in ("jnp", "pallas"):
        out[f"y_{backend}"] = np.asarray(
            make_spmv(plan, mesh, backend=backend)(xd))
    bd = to_dist(b, layout, plan)
    solvers = {"cg": make_solver(plan, mesh, solver="cg", precond="jacobi"),
               "cgu": make_cg(plan, mesh)}
    for key, solve in solvers.items():
        for tol in TOLS:
            xs, iters, _ = solve(bd, tol=tol, maxiter=400)
            out[f"{key}_{tol:g}_x"] = np.asarray(xs)
            out[f"{key}_{tol:g}_iters"] = np.asarray(iters)
    return out


def dump_transports() -> dict:
    import jax
    from jax.sharding import Mesh

    from repro.core import available_transports, resolve_transport, to_dist
    from repro.core.transport import available_wire_dtypes, make_exchange
    from repro.testing.transport_check import CASES as TCASES
    from repro.testing.transport_check import build_case

    out = {}
    for case in TCASES:
        A, plan, layout = build_case(case, 4, 2, "ell")
        if not plan.hs:
            continue
        mesh = Mesh(np.array(jax.devices()[:8]).reshape(4, 2),
                    ("node", "core"))
        x = np.random.default_rng(7).normal(size=A.n_rows)
        xd = to_dist(x, layout, plan)
        xd_np, g = np.asarray(xd), plan.g_pad
        for name in available_transports():
            for wd in available_wire_dtypes():
                key = f"{case}/{name}/{wd}"
                out[f"{key}/ghost"] = np.asarray(make_exchange(
                    plan, mesh, transport=name, wire_dtype=wd)(xd))
                tr, state = resolve_transport(name, plan, wire_dtype=wd)
                out[f"{key}/host"] = tr.host_exchange(
                    xd_np, np.asarray(plan.send_own),
                    np.asarray(plan.recv_own), g, state)
    return out


def dump_refine() -> dict:
    import jax
    from jax.sharding import Mesh

    from repro.core import build_spmv_plan
    from repro.core.transport import available_wire_dtypes
    from repro.solvers import make_refine
    from repro.sparse import graded_extruded_mesh_matrix

    A = graded_extruded_mesh_matrix(80, 6, seed=0)
    b = np.random.default_rng(1).normal(size=A.n_rows)
    mesh = Mesh(np.array(jax.devices()[:8]).reshape(4, 2), ("node", "core"))
    out = {}
    for fmt in ("ell", "sell"):
        for wd in available_wire_dtypes():
            plan, layout = build_spmv_plan(A, 4, 2, format=fmt,
                                           wire_dtype=wd)
            res = make_refine(
                plan, mesh, A=A, layout=layout,
                inner_tol={"f32": 1e-5, "bf16": 1e-4}.get(wd, 1e-3),
                maxiter_inner=1000)(b, tol=1e-7)
            out[f"{fmt}/{wd}/cycles"] = np.asarray(res.cycles)
            out[f"{fmt}/{wd}/rel"] = np.asarray(res.rel)
            out[f"{fmt}/{wd}/x"] = res.x
            refine = make_refine(plan, mesh, solver="pipelined_cg", A=A,
                                 layout=layout)
            out[f"{fmt}/{wd}/pipelined_cg/options"] = np.asarray(
                json.dumps(refine.solve.options))
    return out


def _mesh(n_node: int, n_core: int):
    import jax
    from jax.sharding import Mesh

    return Mesh(np.array(jax.devices()[:n_node * n_core]).reshape(
        n_node, n_core), ("node", "core"))


def dump_solvers(A, b) -> dict:
    import jax.numpy as jnp

    from repro.core import build_spmv_plan, to_dist
    from repro.solvers import get_solver, make_solver
    from repro.sparse import extruded_mesh_matrix
    from repro.util import while_body_collective_counts

    out = {}
    for case in CASES:
        fmt, grid = case.split("/")
        n_node, n_core = (int(v) for v in grid.split("x"))
        mesh = _mesh(n_node, n_core)
        plan, layout = build_spmv_plan(A, n_node, n_core, mode="balanced",
                                       node_partition="nnz", format=fmt)
        bd = to_dist(b, layout, plan)
        for name in SOLVERS:
            key = f"{case}/{name}"
            solve = make_solver(plan, mesh, solver=name, precond="jacobi",
                                A=A, layout=layout)
            for tol in SOLVER_TOLS:
                xs, iters, rel = solve(bd, tol=tol, maxiter=2000)
                out[f"{key}/{tol:g}_x"] = np.asarray(xs)
                out[f"{key}/{tol:g}_iters"] = np.asarray(iters)
                out[f"{key}/{tol:g}_rel"] = np.asarray(rel)
            if name == "chebyshev":
                out[f"{key}/lmin"] = np.asarray(solve.options["lmin"])
                out[f"{key}/lmax"] = np.asarray(solve.options["lmax"])
            out[f"{key}/reductions_per_iter"] = np.asarray(
                get_solver(name).reductions_per_iter)
            out[f"{key}/census"] = np.asarray(while_body_collective_counts(
                solve.jitted, bd, jnp.asarray(1e-5, jnp.float32),
                jnp.asarray(2000, jnp.int32))["all-reduce"])
    Ae = extruded_mesh_matrix(n_surface=1500, layers=12, seed=0)
    be = np.random.default_rng(1).normal(size=Ae.n_rows)
    plan, layout = build_spmv_plan(Ae, 4, 2, mode="balanced", format="sell")
    for name in SOLVERS:
        solve = make_solver(plan, _mesh(4, 2), solver=name, A=Ae,
                            layout=layout)
        out[f"example/{name}/iters"] = np.asarray(
            solve(to_dist(be, layout, plan), tol=1e-5, maxiter=10_000)[1])
    return out


def _resilient_row(res) -> dict:
    return {"iters": np.asarray(res.iters), "x": res.x,
            "chunks": np.asarray(res.chunks),
            "rollbacks": np.asarray(res.rollbacks),
            "true_rel": np.asarray(res.true_rel),
            "converged": np.asarray(res.converged),
            "resumed_from": np.asarray(-1 if res.resumed_from is None
                                       else res.resumed_from)}


def dump_resilient(port_ckpt: str, ref_ckpt: str) -> dict:
    from repro.checkpoint import latest_step, load
    from repro.solvers import resilient_solve
    from repro.sparse import graded_extruded_mesh_matrix

    A = graded_extruded_mesh_matrix(48, 6, seed=0)
    b = np.random.default_rng(1).normal(size=A.n_rows)
    kw = dict(precond="jacobi", tol=1e-5, check_every=10)
    out = {}
    for name in SOLVERS:
        res = resilient_solve(A, b, solver=name, n_node=4, n_core=2,
                              format="ell", transport="a2a",
                              mesh=_mesh(4, 2), maxiter=5000, **kw)
        out.update({f"{name}/{k}": v for k, v in _resilient_row(res).items()})
    resilient_solve(A, b, solver="cg", n_node=4, n_core=2, format="ell",
                    transport="a2a", mesh=_mesh(4, 2), maxiter=25,
                    checkpoint_dir=ref_ckpt, **kw)
    step = latest_step(ref_ckpt)
    gstate, _ = load(ref_ckpt, step,
                     {"x": np.zeros((1, A.n_rows), np.float32)})
    out["ckpt/step"] = np.asarray(step)
    out["ckpt/x"] = np.asarray(gstate["x"])
    for tag, ck in (("resume_ref", ref_ckpt), ("resume_port", port_ckpt)):
        res = resilient_solve(A, b, solver="cg", n_node=2, n_core=2,
                              format="sell", transport="ring",
                              mesh=_mesh(2, 2), maxiter=5000,
                              resume_from=ck, **kw)
        out.update({f"{tag}/{k}": v for k, v in _resilient_row(res).items()})
    return out


def dump_rect() -> dict:
    from repro.core import build_spmv_plan, from_dist, make_spmv, to_dist
    from repro.testing.rect_check import build_rect

    mesh = _mesh(4, 2)
    out = {}
    for kind in ("tall", "fat", "agg"):
        A = build_rect(kind, 3)
        x = np.random.default_rng(103).normal(size=A.n_cols)
        for fmt in ("ell", "sell"):
            for part in ("rows", "nnz"):
                plan, layout = build_spmv_plan(A, 4, 2, mode="balanced",
                                               node_partition=part,
                                               format=fmt)
                y = make_spmv(plan, mesh)(to_dist(x, layout, plan,
                                                  space="col"))
                out[f"{kind}/{fmt}/{part}/y"] = np.asarray(
                    from_dist(y, layout, plan, space="row"))
    return out


def dump_precond() -> dict:
    from repro.core import build_spmv_plan, from_dist, to_dist
    from repro.solvers import make_solver
    from repro.solvers.base import make_precond_apply
    from repro.sparse import graded_extruded_mesh_matrix
    from repro.testing.precond_check import SCALING_AGG, SCALING_MESHES

    mesh = _mesh(4, 2)
    out = {}
    A = graded_extruded_mesh_matrix(48, 6, seed=0)
    r = np.random.default_rng(11).normal(size=A.n_rows)
    for fmt in ("ell", "sell"):
        plan, layout = build_spmv_plan(A, 4, 2, mode="balanced",
                                       node_partition="nnz", format=fmt)
        for pname in ("jacobi", "block_jacobi", "two_level"):
            apply = make_precond_apply(plan, mesh, precond=pname, A=A,
                                       layout=layout)
            out[f"{fmt}/{pname}/z"] = np.asarray(from_dist(
                apply(to_dist(r, layout, plan)), layout, plan))
    for n_surface, layers in SCALING_MESHES:
        A = graded_extruded_mesh_matrix(n_surface, layers, seed=0)
        plan, layout = build_spmv_plan(A, 4, 2, mode="balanced",
                                       node_partition="rows", format="ell")
        bd = to_dist(np.random.default_rng(7).normal(size=A.n_rows),
                     layout, plan)
        for pname in ("block_jacobi", "two_level"):
            po = {"agg_size": SCALING_AGG} if pname == "two_level" else None
            solve = make_solver(plan, mesh, solver="cg", precond=pname,
                                A=A, layout=layout, precond_options=po)
            for tol in SCALING_TOLS:
                out[f"scaling/{n_surface}x{layers}/{pname}/{tol:g}"] = \
                    np.asarray(solve(bd, tol=tol, maxiter=400)[1])
    return out


def dump_serve(port_ckpt: str, ref_ckpt: str) -> dict:
    from repro.core import build_spmv_plan
    from repro.serve import (EngineConfig, PlanCache, SolveEngine,
                             SolveService, matrix_fingerprint)
    from repro.solvers import make_solver
    from repro.solvers.base import from_dist_batch, to_dist_batch
    from repro.sparse import graded_extruded_mesh_matrix

    A = graded_extruded_mesh_matrix(16, 4, seed=0)
    G = graded_extruded_mesh_matrix(48, 6, seed=0)
    out = {"fingerprint/graded": np.asarray(matrix_fingerprint(A)),
           "fingerprint/golden": np.asarray(matrix_fingerprint(G))}
    plan, layout = build_spmv_plan(A, 2, 2, mode="balanced",
                                   node_partition="nnz")
    B = np.random.default_rng(1).normal(size=(3, A.n_rows))
    bd = to_dist_batch(B, layout, plan)
    out["dist_batch/bd"] = np.asarray(bd)
    out["dist_batch/back"] = from_dist_batch(bd, layout, plan)

    Bg = np.random.default_rng(7).normal(size=(3, G.n_rows))
    for fmt in ("ell", "sell"):
        plan, layout = build_spmv_plan(G, 4, 2, mode="balanced",
                                       node_partition="nnz", format=fmt)
        solve = make_solver(plan, _mesh(4, 2), nrhs=3, A=G, layout=layout)
        out[f"nrhs3/{fmt}/iters"] = np.asarray(solve(
            to_dist_batch(Bg, layout, plan), tol=1e-5, maxiter=2000)[1])

    cache = PlanCache()
    kw = dict(check_every=5, maxiter=2000, maxiter_static=2000)
    Bq = np.random.default_rng(3).normal(size=(9, A.n_rows))
    for n_node, n_core in ((1, 1), (2, 2)):
        svc = SolveService(A, EngineConfig(nrhs=3, n_node=n_node,
                                           n_core=n_core, **kw),
                           cache=cache, mesh=_mesh(n_node, n_core))
        futs = [svc.submit(Bq[i], tol=SERVE_TOLS[i % 3]) for i in range(9)]
        svc.drain()
        res = [f.result() for f in futs]
        out[f"engine/{n_node}x{n_core}/iters"] = np.asarray(
            [r.iterations for r in res])
        out[f"engine/{n_node}x{n_core}/x"] = np.stack([r.x for r in res])

    Bc = np.random.default_rng(11).normal(size=(2, A.n_rows))
    e1 = SolveEngine(A, EngineConfig(nrhs=2, **kw), mesh=_mesh(1, 1),
                     cache=cache)
    e1.submit(Bc[0], tol=1e-5)
    e1.submit(Bc[1], tol=3e-5)
    e1.step()
    e1.checkpoint(ref_ckpt)
    for tag, ck in (("resume_ref", ref_ckpt), ("resume_port", port_ckpt)):
        e2 = SolveEngine(A, EngineConfig(nrhs=2, format="sell", **kw),
                         mesh=_mesh(1, 1), cache=cache)
        e2.restore(ck)
        recs = sorted(e2.drain(), key=lambda r: r.request.rid)
        out[f"{tag}/rids"] = np.asarray([r.request.rid for r in recs])
        out[f"{tag}/iters"] = np.asarray([r.iterations for r in recs])
        out[f"{tag}/x"] = np.stack([r.x for r in recs])
        out[f"{tag}/residual"] = np.asarray([r.residual for r in recs])
    return out


def main() -> int:
    path, cases = sys.argv[1], sys.argv[2:] or CASES
    if cases == ["--transports"]:
        np.savez(path, **dump_transports())
        return 0
    if cases == ["--refine"]:
        np.savez(path, **dump_refine())
        return 0
    if cases == ["--rect"]:
        np.savez(path, **dump_rect())
        return 0
    if cases == ["--precond"]:
        np.savez(path, **dump_precond())
        return 0
    if cases[0] == "--serve":
        np.savez(path, **dump_serve(*cases[1:]))
        return 0
    if cases[0] == "--resilient":
        np.savez(path, **dump_resilient(*cases[1:]))
        return 0
    from repro.sparse import graded_extruded_mesh_matrix

    A = graded_extruded_mesh_matrix(48, 6, seed=0)
    rng = np.random.default_rng(7)
    x = rng.standard_normal(A.n_rows).astype(np.float32)
    b = rng.standard_normal(A.n_rows).astype(np.float32)
    if cases == ["--solvers"]:
        np.savez(path, **dump_solvers(A, b))
        return 0
    arrays = {}
    for case in cases:
        for name, arr in dump_case(case, A, x, b).items():
            arrays[f"{case}/{name}"] = arr
    np.savez(path, **arrays)
    return 0


if __name__ == "__main__":
    sys.exit(main())
