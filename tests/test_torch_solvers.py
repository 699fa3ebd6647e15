"""The port's registry solvers (cg, pipelined_cg, chebyshev) against the
JAX reference, on the CPU.

The reference side (``make_solver(A=, layout=)`` with jacobi on 8 XLA host
devices) runs in one ``tests/torch_reference.py --solvers`` subprocess on
the golden matrix ``graded_extruded_mesh_matrix(48, 6)`` with its seeded
``b``, at 4×2 and the halo-free 1×4, ell and sell.  The port runs the same
with ``device="cpu"``.

Tolerances:
  * Chebyshev's bounds within 1e-12 relative (both are the same host f64
    Lanczos sweep on the same matvec) and its trip counts equal: they are
    computed a priori from the bounds and the f32 tol.
  * cg within ±1 of the reference's count at tol 1e-3, 1e-5 and 3e-6 on
    the same plan.  This matrix sits on its float32 plateau (true residual
    ~2e-4), where counts below ~3e-6 depend on summation order.
  * pipelined_cg: its count is set by rounding.  Its recurrences amplify
    a last-bit difference (the reference's own ``x`` on its 1×1 and 4×2
    plans part by 3e-5 relative after 10 iterations, the port's and the
    reference's on the 1×1 plan by 8e-5; cg's by 1e-6), and at 1e-5 it
    converges after its restart at iteration 50 on a residual already at
    the f32 floor: the reference's own count moves by 3 between two plans
    of one operator (81–84 at 1e-5), and even at 1e-3 the port's and the
    reference's counts part by 6 on the 1×4 plans.  So at 1e-5 and 3e-6
    the port's count must lie within ±2 of the range the reference spans
    over the four plans, and it is not compared at 1e-3.
  * ``x`` within 1e-3·max|x| (cg, chebyshev) and 5e-2·max|x|
    (pipelined_cg, the reference's own ``sol_rtol``,
    ``tests/test_solvers.py``) of the reference's at 1e-5.
  * the reduction census equal to the reference's compiled while-body
    all-reduce count and its ``reductions_per_iter``: 2 / 1 / 0.
  * batching (nrhs=1 against unbatched; two columns against each alone)
    bit for bit, within the port.
"""
import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from conftest import run_subprocess
from repro_torch.core import build_spmv_plan, from_dist, to_dist
from repro_torch.solvers import (Solver, SolverCtx, available_solvers,
                                 chebyshev_iters_for_tol, count_reductions,
                                 estimate_eig_bounds, from_dist_batch,
                                 get_precond, get_solver, make_solver, pdot,
                                 pdot_stack, reduction_census, to_dist_batch)
from repro_torch.sparse import (extruded_mesh_matrix,
                                graded_extruded_mesh_matrix)

HERE = pathlib.Path(__file__).resolve().parent
CASES = ("ell/4x2", "sell/4x2", "ell/1x4", "sell/1x4")
SOLVERS = ("cg", "pipelined_cg", "chebyshev")
TOLS = (1e-5, 3e-6)
X_RTOL = {"cg": 1e-3, "pipelined_cg": 5e-2, "chebyshev": 1e-3}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The shapes here are tiny: one intra-op thread runs them faster than
    a pool, and leaves the cores to the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    out = tmp_path_factory.mktemp("ref") / "solvers.npz"
    res = run_subprocess([str(HERE / "torch_reference.py"), str(out),
                          "--solvers"], device_count=8)
    assert res.returncode == 0, res.stderr[-4000:]
    with np.load(out) as d:
        return {k: d[k] for k in d.files}


@pytest.fixture(scope="module")
def golden():
    A = graded_extruded_mesh_matrix(48, 6, seed=0)
    rng = np.random.default_rng(7)
    rng.standard_normal(A.n_rows)                      # x of the fixture
    b = rng.standard_normal(A.n_rows).astype(np.float32)
    return A, b


@pytest.fixture(scope="module")
def solves(golden):
    """Each golden case's plan and one built solver per name (Chebyshev's
    bounds estimated once per plan, as make_solver does)."""
    A, _ = golden
    out = {}
    for case in CASES:
        fmt, grid = case.split("/")
        n_node, n_core = (int(v) for v in grid.split("x"))
        plan, layout = build_spmv_plan(A, n_node, n_core, mode="balanced",
                                       node_partition="nnz", format=fmt,
                                       device="cpu")
        out[case] = (plan, layout, {
            name: make_solver(plan, solver=name, precond="jacobi", A=A,
                              layout=layout) for name in SOLVERS})
    return out


def test_registry_holds_the_three_solvers():
    assert available_solvers() == ("cg", "chebyshev", "pipelined_cg")
    assert {n: get_solver(n).reductions_per_iter for n in SOLVERS} == {
        "cg": 2, "pipelined_cg": 1, "chebyshev": 0}


@pytest.mark.parametrize("case", CASES)
def test_chebyshev_bounds_and_trip_counts(case, solves, reference):
    """The bounds, and the reference's counts as the error bound gives
    them from the port's bounds (the port's own counts are held to the
    reference's in ``test_solver_matches_reference``)."""
    solve = solves[case][2]["chebyshev"]
    key = f"{case}/chebyshev"
    for bound in ("lmin", "lmax"):
        want = float(reference[f"{key}/{bound}"])
        assert abs(solve.options[bound] - want) <= 1e-12 * abs(want)
    for tol in TOLS:
        assert int(reference[f"{key}/{tol:g}_iters"]) == \
            chebyshev_iters_for_tol(solve.options["lmin"],
                                    solve.options["lmax"], tol)


@pytest.mark.parametrize("name", SOLVERS)
@pytest.mark.parametrize("case", CASES)
def test_solver_matches_reference(case, name, solves, golden, reference):
    A, b = golden
    plan, layout, solvers = solves[case]
    bd = to_dist(b, layout, plan)
    for tol in ((1e-3,) if name == "cg" else ()) + TOLS:
        x, iters, rel = solvers[name](bd, tol=tol, maxiter=2000)
        want = int(reference[f"{case}/{name}/{tol:g}_iters"])
        if name == "pipelined_cg":
            span = [int(reference[f"{c}/{name}/{tol:g}_iters"])
                    for c in CASES]
            assert min(span) - 2 <= int(iters) <= max(span) + 2, \
                (int(iters), span)
        else:
            assert abs(int(iters) - want) <= (1 if name == "cg" else 0), \
                (tol, int(iters), want)
        assert float(rel) <= tol
        if tol == 1e-5:
            ref_x = reference[f"{case}/{name}/1e-05_x"]
            np.testing.assert_allclose(
                x.numpy(), ref_x, atol=X_RTOL[name] * np.abs(ref_x).max())
            xg = from_dist(x, layout, plan).astype(np.float64)
            true_rel = np.linalg.norm(A.matvec(xg) - b) / np.linalg.norm(b)
            assert true_rel < 1e-3                 # float32 plateau ~2e-4


@pytest.mark.parametrize("case", CASES[:2])
def test_reduction_census(case, solves, golden, reference):
    _, b = golden
    plan, layout, solvers = solves[case]
    bd = to_dist(b, layout, plan)
    for name, solve in solvers.items():
        n = reduction_census(solve, bd, tol=1e-5, maxiter=2000)
        assert n == get_solver(name).reductions_per_iter
        assert n == int(reference[f"{case}/{name}/census"])
        assert n == int(reference[f"{case}/{name}/reductions_per_iter"])


def test_count_reductions_counts_pdot_calls():
    a = torch.ones(1, 2, 2, 8)
    with count_reductions() as outer:
        pdot(a, a)
        with count_reductions() as inner:
            pdot_stack((a, a), (a, a))
        pdot_stack((a, a))
    assert (outer[0], inner[0]) == (3, 1)
    pdot(a, a)                                # no counter open: no effect
    assert outer[0] == 3


@pytest.mark.parametrize("name", SOLVERS)
def test_batched_solves_equal_unbatched_bit_for_bit(name, solves, golden):
    _, b = golden
    plan, layout, solvers = solves["sell/4x2"]
    opts = solvers[name].options
    rng = np.random.default_rng(11)
    B = np.stack([b, rng.standard_normal(b.size).astype(np.float32)])
    one = solvers[name]
    # a cap of 300 stops chebyshev before its budget; the others converge
    kw = dict(tol=1e-5, maxiter=300)
    x1, it1, rel1 = make_solver(plan, solver=name, nrhs=1, options=opts)(
        to_dist_batch(B[:1], layout, plan), **kw)
    x0, it0, rel0 = one(to_dist(B[0], layout, plan), **kw)
    assert torch.equal(x1[:, :, 0], x0) and int(it1[0]) == int(it0)
    assert torch.equal(rel1[0], rel0)
    X, iters, _ = make_solver(plan, solver=name, nrhs=2, options=opts)(
        to_dist_batch(B, layout, plan), **kw)
    Xg = from_dist_batch(X, layout, plan)
    for j in range(2):
        xj, itj, _ = one(to_dist(B[j], layout, plan), **kw)
        assert int(iters[j]) == int(itj)
        np.testing.assert_array_equal(Xg[j], from_dist(xj, layout, plan))


@pytest.mark.parametrize("name", SOLVERS)
def test_check_every_and_maxiter_static(name, solves, golden):
    """Gated iterations after convergence are no-ops; maxiter_static caps
    every solve."""
    _, b = golden
    plan, layout, solvers = solves["ell/4x2"]
    opts = solvers[name].options
    bd = to_dist(b, layout, plan)
    # cg and pipelined_cg converge before the cap, chebyshev stops at it
    runs = [make_solver(plan, solver=name, options=opts, check_every=c)(
        bd, tol=1e-5, maxiter=200) for c in (1, 7, 16)]
    for other in runs[1:]:
        for g, o in zip(runs[0], other):
            assert torch.equal(g, o)
    _, iters, _ = make_solver(plan, solver=name, options=opts,
                              maxiter_static=13)(bd, tol=1e-5, maxiter=2000)
    assert int(iters) == 13


def test_options_validation_and_early_failure(solves, golden):
    A, _ = golden
    plan, layout, _ = solves["ell/4x2"]
    with pytest.raises(ValueError, match="eigenvalue bounds"):
        make_solver(plan, solver="chebyshev")
    with pytest.raises(ValueError, match="unknown option"):
        make_solver(plan, precond="jacobi", precond_options={"omega": 1})
    # every name and option resolves before transport="auto" times anything
    with pytest.raises(ValueError, match="unknown solver"):
        make_solver(plan, solver="gmres", transport="auto")
    assert plan.transport == "a2a"
    pinned = make_solver(plan, solver="chebyshev",
                         options={"lmin": 1e-3, "lmax": 2.0})
    assert pinned.options == {"lmin": 1e-3, "lmax": 2.0}
    pcg = make_solver(plan, solver="pipelined_cg",
                      options={"replace_every": 25})
    assert pcg.options == {"replace_every": 25}
    assert get_solver("pipelined_cg").lossy_wire_options() == {
        "replace_every": 10}
    assert get_solver("cg").lossy_wire_options() == {}


def test_eig_bounds_bracket_the_spectrum():
    """The margins put the estimate around the true spectrum of M⁻¹A on a
    small matrix (dense eigenvalues as the oracle)."""
    A = graded_extruded_mesh_matrix(12, 3, seed=0)
    pre = get_precond("jacobi").host_apply(None, None, A)
    lmin, lmax = estimate_eig_bounds(A.matvec, pre, A.n_rows)
    d = np.sqrt(1.0 / A.diagonal())
    ev = np.linalg.eigvalsh(d[:, None] * A.to_dense() * d[None, :])
    cheb = get_solver("chebyshev")
    assert lmin * cheb.lmin_margin <= ev[0] * 1.0001
    assert lmax * cheb.lmax_margin >= ev[-1]
    assert ev[0] <= lmin * 1.001 and lmax <= ev[-1] * 1.001


def test_solver_ctx_defaults_and_protocol():
    ctx = SolverCtx(spmv=lambda v: v, precond=lambda r: r)
    assert ctx.maxiter_static == 10_000 and ctx.options == {}
    with pytest.raises(NotImplementedError, match="chunked-loop"):
        Solver().state_kinds()


def test_solver_counts_at_the_example_size(reference):
    """``examples/cg_solve.py``'s matrix and plan (18,000 rows, 4×2
    balanced sell), where the true residual is not on a plateau at tol
    1e-5: cg within ±1, pipelined_cg within ±2 (chebyshev's count is its
    budget, held to the reference's above)."""
    A = extruded_mesh_matrix(n_surface=1500, layers=12, seed=0)
    b = np.random.default_rng(1).normal(size=A.n_rows)
    plan, layout = build_spmv_plan(A, 4, 2, mode="balanced", format="sell",
                                   device="cpu")
    bd = to_dist(b, layout, plan)
    for name, slack in (("cg", 1), ("pipelined_cg", 2)):
        _, iters, rel = make_solver(plan, solver=name)(bd, tol=1e-5,
                                                       maxiter=10_000)
        want = int(reference[f"example/{name}/iters"])
        assert abs(int(iters) - want) <= slack, (name, int(iters), want)
        assert float(rel) <= 1e-5


def test_example_runs_on_the_cpu():
    """``examples/cg_solve_torch.py`` end to end at a small size: its
    closing assert holds and its JSON line has the reference example's
    keys (``examples/cg_solve.py``)."""
    res = subprocess.run(
        [sys.executable, str(HERE.parent / "examples" / "cg_solve_torch.py"),
         "--device", "cpu", "--n-surface", "120", "--layers", "4"],
        capture_output=True, text=True, timeout=600,
        env=dict(os.environ, OMP_NUM_THREADS="1"))
    assert res.returncode == 0, res.stderr[-3000:]
    results = json.loads(res.stdout.strip().splitlines()[-1])
    modes = {f"{m}/{t}" for m in ("vector", "task", "balanced")
             for t in ("unfused", "fused")}
    assert set(results) == (modes | {f"solver/{n}" for n in SOLVERS}
                            | {f"transport/{t}" for t in
                               ("a2a", "hier", "pairwise", "ring", "auto")}
                            | {"resilient/cg"})
    assert [results[f"solver/{n}"]["allreduce_per_iter"]
            for n in SOLVERS] == [2, 1, 0]
    assert results["resilient/cg"]["faulted_rollbacks"] >= 1
