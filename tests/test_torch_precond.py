"""The port's block_jacobi / two_level / faulty preconditioners and
``make_precond_apply`` against the JAX package's, on the CPU.

The reference side (``make_precond_apply`` and ``make_solver`` on 8 XLA
host devices) runs in one ``tests/torch_reference.py --precond``
subprocess.

Tolerances:
  * each apply (jacobi, block_jacobi, two_level) on the golden matrix at
    4×2, ell and sell, within 2e-5 relative of the reference's on the same
    ``r``: both are f32 products of the same f64-built, once-rounded
    operators, summed in different orders;
  * cg iteration counts with block_jacobi and two_level within ±1 of the
    reference's on each of ``precond_check``'s scaling meshes, at tol
    1e-6 (``precond_check --scaling``'s), 3e-6 and 1e-5 — except
    block_jacobi at 1e-6 on the smallest mesh, where the residual sits on
    the float32 plateau (true residual ~2e-4) and the count is set by
    rounding: reference 43 under jax 0.9.0, port 33 (ROADMAP C; at 3e-6
    and 1e-5 the two agree);
  * the Galerkin inverse against the dense triple product R·A·Rᵀ within
    1e-10 relative (both f64).
"""
import pathlib

import numpy as np
import pytest
import torch

from conftest import run_subprocess
from repro_torch.core import build_spmv_plan, from_dist, to_dist
from repro_torch.solvers import (BlockJacobiPrecond, FaultyPrecond,
                                 Preconditioner, TwoLevelPrecond,
                                 available_preconds, get_precond,
                                 make_precond_apply, make_solver,
                                 reduction_census, register_precond,
                                 resilient_solve, unregister_precond)
from repro_torch.sparse import graded_extruded_mesh_matrix
from repro_torch.testing import precond_check

HERE = pathlib.Path(__file__).resolve().parent
PRECONDS = ("jacobi", "block_jacobi", "two_level")
#: (mesh, precond, tol) on the float32 plateau: the count there is set by
#: rounding (ROADMAP C)
PLATEAU = {((48, 6), "block_jacobi", 1e-6)}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    out = tmp_path_factory.mktemp("ref") / "precond.npz"
    res = run_subprocess([str(HERE / "torch_reference.py"), str(out),
                          "--precond"], device_count=8)
    assert res.returncode == 0, res.stderr[-4000:]
    with np.load(out) as d:
        return {k: d[k] for k in d.files}


@pytest.fixture(scope="module")
def golden():
    A = graded_extruded_mesh_matrix(48, 6, seed=0)
    return A, np.random.default_rng(11).normal(size=A.n_rows)


def _plan(A, fmt, part="nnz"):
    return build_spmv_plan(A, 4, 2, mode="balanced", node_partition=part,
                           format=fmt, device="cpu")


def test_registry_holds_the_four_preconds():
    assert available_preconds() == ("block_jacobi", "jacobi", "none",
                                    "two_level")
    assert [get_precond(p).local_only for p in available_preconds()] == \
        [True, True, True, False]
    assert get_precond("two_level").reductions_per_apply == 0


@pytest.mark.parametrize("pname", PRECONDS)
@pytest.mark.parametrize("fmt", ["ell", "sell"])
def test_apply_matches_reference(fmt, pname, golden, reference):
    A, r = golden
    plan, layout = _plan(A, fmt)
    apply = make_precond_apply(plan, precond=pname, A=A, layout=layout)
    assert apply.precond == pname
    zd = apply(to_dist(r, layout, plan, space="row"))
    assert tuple(zd.shape) == plan.cg_shape
    assert torch.equal(zd * plan.mask, zd)          # padding stays 0
    z = from_dist(zd, layout, plan).astype(np.float64)
    want = reference[f"{fmt}/{pname}/z"].astype(np.float64)
    assert np.linalg.norm(z - want) <= 2e-5 * np.linalg.norm(want)


@pytest.mark.parametrize("fmt", ["ell", "sell"])
def test_two_level_kernel_and_plain_bodies_agree(fmt, golden):
    """``backend="plain"`` runs R and P through the plain versions: on the
    CPU the kernel wrappers are the same code, so the bits agree."""
    A, r = golden
    plan, layout = _plan(A, fmt)
    rd = to_dist(r, layout, plan, space="row")
    z = {b: make_precond_apply(plan, precond="two_level", A=A,
                               layout=layout, backend=b)(rd)
         for b in ("kernel", "plain")}
    assert torch.equal(z["kernel"], z["plain"])
    with pytest.raises(ValueError, match="backend"):
        make_precond_apply(plan, precond="two_level", A=A, layout=layout,
                           backend="pallas")


def test_two_level_binds_rectangular_plans_through_a_shard_body(golden):
    A, _ = golden
    plan, layout = _plan(A, "sell")
    pdata, apply_fn = get_precond("two_level").bind(plan, layout, A)
    plan_R, layout_R = apply_fn.plans["R"]
    plan_P, _ = apply_fn.plans["P"]
    nc = -(-A.n_rows // 16)
    assert (plan_R.n, plan_R.n_cols) == (nc, A.n_rows)
    assert (plan_P.n, plan_P.n_cols) == (A.n_rows, nc)
    assert plan_R.cc_pad == plan_P.rc_pad == plan.rc_pad
    assert plan_P.cc_pad == plan_R.rc_pad
    np.testing.assert_array_equal(layout_R["global_col_of"],
                                  layout["global_row_of"])
    # the redundant coarse inverse: one tensor, every shard a view of it
    assert pdata["ainv_c"].shape == (4, 2, nc, nc)
    assert pdata["ainv_c"].stride()[:2] == (0, 0)
    assert set(apply_fn.host_seconds) == {"smoother", "plans", "galerkin"}


def test_block_jacobi_blocks_are_each_cores_own(golden):
    """binv holds each bin's dense block inverse in slot order and zeros
    on padding; apply on a shard-local residual stays on the shard."""
    A, _ = golden
    plan, layout = _plan(A, "sell")
    binv = BlockJacobiPrecond().build(plan, layout, A)["binv"].numpy()
    assert binv.shape == (4, 2, plan.rc_pad, plan.rc_pad)
    mask = plan.mask.numpy() > 0
    for i in range(4):
        for c in range(2):
            pad = ~mask[i, c]
            assert not binv[i, c][pad].any() and not binv[i, c][:, pad].any()
            g = layout["global_row_of"][i, c][mask[i, c]]
            block = A.to_dense()[np.ix_(g, g)]
            inv = binv[i, c][np.ix_(mask[i, c], mask[i, c])]
            np.testing.assert_allclose(inv @ block, np.eye(len(g)),
                                       atol=1e-5)


def test_option_validation():
    tl = get_precond("two_level")
    assert tl.validate_options(None) == {"agg_size": 16,
                                         "smoother": "block_jacobi"}
    assert tl.validate_options({"agg_size": np.int64(4),
                                "smoother": "jacobi"}) == {
        "agg_size": 4, "smoother": "jacobi"}
    for bad, msg in (({"agg": 4}, "unknown option"),
                     ({"agg_size": 1}, "agg_size"),
                     ({"agg_size": 2.5}, "agg_size"),
                     ({"agg_size": True}, "agg_size"),
                     ({"smoother": "two_level"}, "smoother"),
                     ({"smoother": "bogus"}, "smoother")):
        with pytest.raises(ValueError, match=msg):
            tl.validate_options(bad)
    for name in ("jacobi", "block_jacobi", "none"):
        with pytest.raises(ValueError, match="valid options"):
            get_precond(name).validate_options({"agg_size": 8})


def test_make_solver_validates_before_any_build(golden):
    """A bad option raises before bind builds anything (no A needed)."""
    A, _ = golden
    plan, _ = _plan(A, "ell")
    with pytest.raises(ValueError, match="agg_size"):
        make_solver(plan, precond="two_level",
                    precond_options={"agg_size": 0})
    with pytest.raises(ValueError, match="host matrix and layout"):
        make_solver(plan, precond="two_level")
    with pytest.raises(ValueError, match="host matrix and layout"):
        make_solver(plan, precond="block_jacobi")


def test_two_level_refuses_rectangular_plans():
    from repro_torch.testing.rect_check import build_rect

    R = build_rect("agg", 3)
    plan, layout = build_spmv_plan(R, 2, 2, device="cpu")
    with pytest.raises(ValueError, match="square"):
        get_precond("two_level").bind(plan, layout, R)


def test_register_unregister_round_trip():
    before = available_preconds()
    register_precond(FaultyPrecond())
    assert "faulty" in available_preconds()
    assert isinstance(get_precond("faulty"), FaultyPrecond)
    with pytest.raises(ValueError, match="already registered"):
        register_precond(FaultyPrecond())
    register_precond(FaultyPrecond(), overwrite=True)
    # a registered local precond is a valid two_level smoother
    assert get_precond("two_level").validate_options(
        {"smoother": "faulty"})["smoother"] == "faulty"
    unregister_precond("faulty")
    unregister_precond("faulty")                    # idempotent
    assert available_preconds() == before
    with pytest.raises(ValueError, match="unknown preconditioner"):
        get_precond("faulty")


def test_galerkin_against_dense_triple_product(golden):
    A, _ = golden
    for agg in (2, 8, 16, 50):
        agg_of, nc = TwoLevelPrecond._aggregates(A.n_rows, agg)
        R = np.zeros((nc, A.n_rows))
        R[agg_of, np.arange(A.n_rows)] = 1.0
        Ac = R @ A.to_dense() @ R.T
        got = TwoLevelPrecond._galerkin_inverse(A, agg_of, nc)
        np.testing.assert_allclose(got @ Ac, np.eye(nc), atol=1e-10)
        np.testing.assert_allclose(got, np.linalg.inv(Ac), rtol=1e-10,
                                   atol=1e-12 * np.abs(got).max())


def test_make_solver_runs_what_bind_returns(golden):
    """make_solver applies the preconditioner through ``bind``: a
    registrant overriding it is what the loop runs."""
    A, _ = golden
    plan, layout = _plan(A, "ell")
    calls = []

    class Scaled(Preconditioner):
        name = "scaled"

        def bind(self, plan, layout=None, A=None, *, backend="kernel",
                 options=None):
            def apply_fn(P, r):
                calls.append(tuple(r.shape))
                return P["s"] * r
            return {"s": torch.tensor(0.5)}, apply_fn

    b = np.random.default_rng(7).normal(size=A.n_rows)
    solve = make_solver(plan, precond=Scaled())
    _, it, rel = solve(to_dist(b, layout, plan), tol=1e-5, maxiter=400)
    assert calls and calls[0] == (1,) + plan.cg_shape
    assert float(rel) <= 1e-5 and solve.precond == "scaled"


@pytest.mark.parametrize("pname", ["block_jacobi", "two_level"])
@pytest.mark.parametrize("solver,census", [("cg", 2), ("pipelined_cg", 1)])
def test_reduction_census_with_the_new_preconds(solver, census, pname,
                                                golden):
    A, _ = golden
    plan, layout = _plan(A, "sell")
    b = np.random.default_rng(7).normal(size=A.n_rows)
    solve = make_solver(plan, solver=solver, precond=pname, A=A,
                        layout=layout)
    assert reduction_census(solve, to_dist(b, layout, plan),
                            tol=1e-5) == census


def test_resilient_solve_with_two_level(golden):
    """The chunked driver binds the preconditioner as make_solver does:
    chunked equals monolithic bit for bit with two_level too."""
    A, _ = golden
    plan, layout = _plan(A, "ell")
    b = np.random.default_rng(1).normal(size=A.n_rows)
    solve = make_solver(plan, precond="two_level", A=A, layout=layout)
    xd, its, _ = solve(to_dist(b, layout, plan), tol=1e-5, maxiter=400)
    res = resilient_solve(plan, b, layout=layout, A=A, precond="two_level",
                          tol=1e-5, maxiter=400, check_every=7)
    assert res.converged and int(res.iters) == int(its)
    np.testing.assert_array_equal(res.x, from_dist(xd, layout, plan))


@pytest.mark.parametrize("case", precond_check.CASES)
def test_precond_check_cli_prints_ok(case, capsys):
    assert precond_check.main(["--device", "cpu", "--case", case]) == 0
    out = capsys.readouterr().out
    assert out.strip().splitlines()[-1] == "OK" and "BAD" not in out
    for p in ("block_jacobi", "jacobi", "none", "two_level"):
        assert f"PRECOND {p}" in out
    assert "cross=" in out


def test_precond_check_fails_the_faulty_precond(capsys):
    assert precond_check.main(["--device", "cpu", "--include-faulty",
                               "--formats", "ell"]) == 1
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[-1] == "FAIL"
    faulty = next(ln for ln in lines if ln.startswith("PRECOND faulty"))
    assert "host=" in faulty and "BAD" in faulty
    assert "faulty" not in available_preconds()


def test_scaling_regression_passes_on_the_port(capsys):
    assert precond_check.main(["--device", "cpu", "--scaling"]) == 0
    assert capsys.readouterr().out.strip().splitlines()[-1] == "OK"


@pytest.mark.parametrize("pname", ["block_jacobi", "two_level"])
@pytest.mark.parametrize("mesh", precond_check.SCALING_MESHES,
                         ids=lambda m: f"{m[0]}x{m[1]}")
def test_scaling_counts_match_reference(mesh, pname, reference):
    A = graded_extruded_mesh_matrix(*mesh, seed=0)
    plan, layout = _plan(A, "ell", part="rows")
    bd = to_dist(np.random.default_rng(7).normal(size=A.n_rows), layout,
                 plan)
    po = ({"agg_size": precond_check.SCALING_AGG} if pname == "two_level"
          else None)
    solve = make_solver(plan, solver="cg", precond=pname, A=A,
                        layout=layout, precond_options=po)
    for tol in (1e-6, 3e-6, 1e-5):
        _, it, rel = solve(bd, tol=tol, maxiter=400)
        assert float(rel) <= tol
        want = int(reference[f"scaling/{mesh[0]}x{mesh[1]}/{pname}/{tol:g}"])
        if (mesh, pname, tol) in PLATEAU:
            continue
        assert abs(int(it) - want) <= 1, (tol, int(it), want)
