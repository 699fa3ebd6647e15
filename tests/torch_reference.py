"""Dump the JAX reference's results for the port's parity tests.

Usage:  python tests/torch_reference.py OUT.npz [CASE ...]

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
"""
import json
import sys

import numpy as np

CASES = ("ell/4x2", "sell/4x2", "ell/1x4", "sell/1x4")
#: 1e-6 is the golden fixture's tolerance; 3e-6 and 1e-5 sit above the
#: float32 plateau where iteration counts at 1e-6 depend on rounding order
TOLS = (1e-6, 3e-6, 1e-5)
PLAN_META = ("n", "n_node", "n_core", "rc_pad", "nl_pad", "g_pad", "hs",
             "mode", "format", "transport", "wire_dtype")


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


def main() -> int:
    path, cases = sys.argv[1], sys.argv[2:] or CASES
    from repro.sparse import graded_extruded_mesh_matrix

    A = graded_extruded_mesh_matrix(48, 6, seed=0)
    rng = np.random.default_rng(7)
    x = rng.standard_normal(A.n_rows).astype(np.float32)
    b = rng.standard_normal(A.n_rows).astype(np.float32)
    arrays = {}
    for case in cases:
        for name, arr in dump_case(case, A, x, b).items():
            arrays[f"{case}/{name}"] = arr
    np.savez(path, **arrays)
    return 0


if __name__ == "__main__":
    sys.exit(main())
