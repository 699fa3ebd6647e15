"""The port's resilience layer against the JAX reference, on the CPU:
chunked solves equal monolithic ones bit for bit, injected faults are
caught and rolled back, checkpoints cross between the packages, and the
kill-and-resume CLI runs.

The reference side runs in one ``tests/torch_reference.py --resilient``
subprocess on ``resilience_check``'s system
(``graded_extruded_mesh_matrix(48, 6)``, RHS ``default_rng(1)``, jacobi,
tol 1e-5, check_every 10, 4×2 ell a2a): a clean chunked solve per solver,
a cg solve cut at iteration 25 that leaves its checkpoints, and two
resumes at 2×2 sell ring — from its own checkpoint and from one the port
wrote here first.

Tolerances:
  * the port's chunked solve against its own monolithic ``make_solver``
    solve: ``x`` and the count bit for bit (gated iterations after
    convergence are no-ops, and the monolithic entry is ``loop_restart``
    from ``x = 0``);
  * against the reference's chunked solve: cg's count ±1, chebyshev's
    equal; ``x`` within 1e-3·max|x| (cg, chebyshev) or 5e-2·max|x|
    (pipelined_cg, whose count is set by rounding on this plateau — see
    ``tests/test_torch_solvers.py``);
  * a resume from a checkpoint of either package: resumed at its step,
    converged, the count within ``resilience_check``'s envelope
    (2·check_every + 10) of the reference's own resume.  A resume asks for
    tol 1e-5 below this matrix's f32 floor (true residual ~1e-4), where
    the recurrence residual's last decade is noise: from the same
    checkpoint the reference itself ends at 47 on the 4×2 ell plan and 59
    on 2×2 sell, the port at 46 on both.
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
from repro_torch import checkpoint
from repro_torch.core import build_spmv_plan, from_dist, to_dist
from repro_torch.runtime.fault import (FaultInjector, StepGuard, Watchdog)
from repro_torch.solvers import (ResilientResult, Solver, SolveFailure,
                                 get_solver, make_resilient, make_solver,
                                 resilient_solve)
from repro_torch.solvers.resilient import _guard_verdict
from repro_torch.sparse import graded_extruded_mesh_matrix
from repro_torch.testing import resilience_check

HERE = pathlib.Path(__file__).resolve().parent
SOLVERS = ("cg", "pipelined_cg", "chebyshev")
X_RTOL = {"cg": 1e-3, "pipelined_cg": 5e-2, "chebyshev": 1e-3}
KW = dict(precond="jacobi", tol=1e-5, check_every=10, device="cpu")
SLACK = 2 * KW["check_every"] + 10      # resilience_check's envelope


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The shapes here are tiny: one intra-op thread runs them faster than
    a pool, and leaves the cores to the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def system():
    A = graded_extruded_mesh_matrix(48, 6, seed=0)
    b = np.random.default_rng(1).normal(size=A.n_rows)
    return A, b


@pytest.fixture(scope="module")
def plans(system):
    A, _ = system
    return {key: build_spmv_plan(A, n, c, format=f, transport=t,
                                 device="cpu")
            for key, (n, c, f, t) in {"4x2": (4, 2, "ell", "a2a"),
                                      "2x2": (2, 2, "sell", "ring"),
                                      "1x1": (1, 1, "ell", "a2a")}.items()}


@pytest.fixture(scope="module")
def reference(tmp_path_factory, system):
    A, b = system
    tmp = tmp_path_factory.mktemp("resilient")
    port_ck, ref_ck = str(tmp / "port_ck"), str(tmp / "ref_ck")
    cut = resilient_solve(A, b, solver="cg", n_node=4, n_core=2,
                          format="ell", transport="a2a", maxiter=25,
                          checkpoint_dir=port_ck, **KW)
    assert int(cut.iters) == 25 and not cut.converged
    out = tmp / "resilient.npz"
    res = run_subprocess([str(HERE / "torch_reference.py"), str(out),
                          "--resilient", port_ck, ref_ck], device_count=8)
    assert res.returncode == 0, res.stderr[-4000:]
    with np.load(out) as d:
        ref = {k: d[k] for k in d.files}
    return ref, port_ck, ref_ck


# --------------------------------------------------------------------- #
# chunked execution == monolithic execution
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("check_every", [10, 17])
@pytest.mark.parametrize("name", SOLVERS)
def test_chunked_equals_monolithic_bit_for_bit(name, check_every, system,
                                               plans):
    A, b = system
    plan, layout = plans["4x2"]
    solve = make_solver(plan, solver=name, A=A, layout=layout)
    xd, its, _ = solve(to_dist(b, layout, plan), tol=1e-5, maxiter=2000)
    res = resilient_solve(plan, b, layout=layout, A=A, solver=name,
                          precond="jacobi", tol=1e-5, maxiter=2000,
                          check_every=check_every, options=solve.options)
    assert isinstance(res, ResilientResult)
    assert int(res.iters) == int(its) and res.rollbacks == 0
    np.testing.assert_array_equal(res.x, from_dist(xd, layout, plan))
    # more than one chunk ran, so equality crossed a boundary
    assert res.chunks == -(-int(its) // check_every) > 1


@pytest.mark.parametrize("name", SOLVERS)
def test_chunked_solve_matches_reference(name, system, plans, reference):
    A, b = system
    ref, _, _ = reference
    plan, layout = plans["4x2"]
    res = resilient_solve(plan, b, layout=layout, A=A, solver=name,
                          maxiter=5000, **{k: v for k, v in KW.items()
                                           if k != "device"})
    want = int(ref[f"{name}/iters"])
    if name != "pipelined_cg":
        assert abs(int(res.iters) - want) <= (1 if name == "cg" else 0)
    assert res.converged and bool(ref[f"{name}/converged"])
    ref_x = ref[f"{name}/x"]
    np.testing.assert_allclose(res.x, ref_x,
                               atol=X_RTOL[name] * np.abs(ref_x).max())
    assert res.true_rel < resilience_check.BOUNDS[name][0]


def test_batched_resilient_solve_shapes(system, plans):
    A, b = system
    plan, layout = plans["4x2"]
    B = np.stack([b, 2 * b])
    res = resilient_solve(plan, B, layout=layout, A=A, tol=1e-5,
                          maxiter=500, check_every=20)
    one = resilient_solve(plan, b, layout=layout, A=A, tol=1e-5,
                          maxiter=500, check_every=20)
    assert res.x.shape == (2, A.n_rows) and res.iters.shape == (2,)
    assert one.x.shape == (A.n_rows,) and np.ndim(one.iters) == 0
    # the first column is solved exactly as alone
    np.testing.assert_array_equal(res.x[0], one.x)


# --------------------------------------------------------------------- #
# fault injection -> guard -> rollback -> convergence
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("name", SOLVERS)
def test_nan_injection_detected_and_rolled_back(name, system, plans):
    A, b = system
    plan, layout = plans["4x2"]
    kw = dict(layout=layout, A=A, solver=name, tol=1e-5, maxiter=3000,
              check_every=15)
    clean = resilient_solve(plan, b, **kw)
    inj = FaultInjector("nan", at_iteration=10, shard=(1, 1))
    res = resilient_solve(plan, b, injector=inj, **kw)
    assert inj.fired == 1 and res.rollbacks == 1 and res.converged
    assert res.true_rel <= clean.true_rel * 50 + 1e-4
    assert all(np.isfinite(w) for _, w in res.trajectory)


@pytest.mark.parametrize("key", ["r", "p"])
def test_nan_in_another_state_vector(key, system, plans):
    A, b = system
    plan, layout = plans["4x2"]
    res = resilient_solve(plan, b, layout=layout, A=A, tol=1e-5,
                          maxiter=2000, check_every=10,
                          injector=FaultInjector("nan", 12, state_key=key))
    assert res.rollbacks >= 1 and res.converged


def test_bitflip_chunk_caught_and_rolled_back(system, plans):
    A, b = system
    plan, layout = plans["4x2"]
    res = resilient_solve(plan, b, layout=layout, A=A, tol=1e-5,
                          maxiter=2000, check_every=10,
                          injector=FaultInjector.parse("bitflip@20"))
    assert res.rollbacks == 1 and res.converged
    assert res.true_rel < resilience_check.BOUNDS["cg"][0]


def test_persistent_corruption_exhausts_retries(system, plans):
    A, b = system
    plan, layout = plans["4x2"]
    inj = FaultInjector("nan", at_iteration=5, repeat=True)
    with pytest.raises(SolveFailure) as ei:
        resilient_solve(plan, b, layout=layout, A=A, tol=1e-5,
                        maxiter=2000, check_every=10, max_retries=2,
                        injector=inj)
    assert ei.value.reason.startswith("nonfinite")
    assert ei.value.retries == 2 and ei.value.iteration >= 0
    assert isinstance(ei.value.trajectory, list)


def test_chebyshev_budget_solve_survives_long_flat_tail(system, plans):
    A, b = system
    plan, layout = plans["1x1"]
    res = resilient_solve(plan, b, layout=layout, A=A, solver="chebyshev",
                          tol=1e-5, maxiter=2000, check_every=25,
                          stall_chunks=2)
    assert res.rollbacks == 0 and res.converged


def test_injector_validation_and_parse(system, plans):
    A, b = system
    plan, layout = plans["1x1"]
    with pytest.raises(ValueError, match="not a vector state"):
        resilient_solve(plan, b, layout=layout, A=A,
                        injector=FaultInjector("nan", 5, state_key="rz"))
    with pytest.raises(ValueError, match="kind"):
        FaultInjector("meteor", 5)
    with pytest.raises(ValueError, match="fault spec"):
        FaultInjector.parse("nan-at-5")
    inj = FaultInjector.parse("bitflip@30")
    assert inj.kind == "bitflip" and inj.at_iteration == 30
    assert not inj.crossed(0, 20)
    assert inj.crossed(20, 40)
    assert not inj.crossed(20, 40)      # once-only without repeat


def test_step_guard_and_watchdog():
    wd = Watchdog(threshold=3.0, warmup=2)
    assert [wd.observe(t) for t in (1.0, 1.0, 1.1, 10.0)] == [
        False, False, False, True]
    assert wd.stragglers == 1
    saved = []
    with pytest.raises(RuntimeError):
        with StepGuard(wd, on_emergency=lambda: saved.append(1)):
            raise RuntimeError("boom")
    assert saved == [1]


# --------------------------------------------------------------------- #
# the guard verdict, against the reference's
# --------------------------------------------------------------------- #
def _cases():
    good = {"rr": np.asarray([1e-4]), "rz": np.asarray([1e-4]),
            "pap": np.asarray([1.0])}
    return [  # (solver, state, true_rel, kwargs, port's expected verdict)
        ("cg", good, [1e-2], {}, (True, "ok")),
        ("cg", {**good, "rr": np.asarray([np.nan])}, [1e-2], {},
         (False, "nonfinite:rr")),
        ("cg", {**good, "rz": np.asarray([np.nan])}, [np.inf], {},
         (False, "nonfinite:rz")),
        ("cg", good, [np.inf], {}, (False, "nonfinite:true_residual")),
        ("cg", {**good, "pap": np.asarray([-1.0])}, [50.0],
         {"best_rel": 1e-2}, (False, "breakdown:pap")),
        ("cg", good, [50.0], {"best_rel": 1e-2}, (False, "diverged")),
        ("cg", {**good, "rr": np.asarray([1e-20])}, [0.5], {},
         (False, "mismatch")),
        ("cg", good, [1e-2], {"since_improve": 8}, (False, "stagnation")),
        ("cg", good, [1e-2], {"since_improve": 8, "done": True},
         (True, "ok")),
        ("cg", good, [5e-5], {"since_improve": 50}, (True, "ok")),
        ("pipelined_cg", {"rr": np.asarray([1e-20])}, [0.5], {},
         (False, "mismatch")),
        ("chebyshev", {}, [1e-2], {"since_improve": 50}, (True, "ok")),
        ("chebyshev", {}, [np.nan], {}, (False, "nonfinite:true_residual")),
    ]


def _verdict(fn, sol, state, true_rel, kw):
    base = dict(best_rel=1.0, tol=1e-5, since_improve=0, stall_chunks=8,
                divergence_factor=1e3, mismatch_factor=1e3)
    return fn(sol, state, np.asarray(true_rel), **{**base, **kw})


def test_guard_verdict_order_equals_the_reference():
    from repro.solvers import get_solver as ref_get_solver
    from repro.solvers.resilient import _guard_verdict as ref_verdict

    for name, state, tr, kw, want in _cases():
        got = _verdict(_guard_verdict, get_solver(name),
                       {k: torch.from_numpy(v) for k, v in state.items()},
                       tr, kw)
        assert got == want, (name, state, tr, kw)
        assert got == _verdict(ref_verdict, ref_get_solver(name), state,
                               tr, kw)


# --------------------------------------------------------------------- #
# checkpoints: across plans and across packages
# --------------------------------------------------------------------- #
def test_reference_checkpoint_resumes_in_the_port(system, plans, reference):
    A, b = system
    ref, _, ref_ck = reference
    plan, layout = plans["2x2"]
    res = resilient_solve(plan, b, layout=layout, A=A, maxiter=5000,
                          resume_from=ref_ck, **{k: v for k, v in KW.items()
                                                 if k != "device"})
    assert res.resumed_from == int(ref["ckpt/step"]) == 25
    assert res.converged
    assert abs(int(res.iters) - int(ref["resume_ref/iters"])) <= SLACK
    assert int(res.iters) - 25 < int(ref["cg/iters"]) + SLACK
    assert res.true_rel < resilience_check.BOUNDS["cg"][0]
    # the payload itself, loaded by the port's store
    gstate, extra = checkpoint.load(ref_ck, 25,
                                    {"x": np.empty((1, A.n_rows),
                                                   np.float32)})
    np.testing.assert_array_equal(gstate["x"], ref["ckpt/x"])
    assert extra["solver"] == "cg" and extra["iteration"] == [25]


def test_port_checkpoint_resumes_in_the_reference(system, reference):
    A, _ = system
    ref, port_ck, _ = reference
    assert int(ref["resume_port/resumed_from"]) == 25
    assert bool(ref["resume_port/converged"])
    assert abs(int(ref["resume_port/iters"])
               - int(ref["resume_ref/iters"])) <= SLACK
    # the JAX package's store reads the port's manifest and arrays
    import jax

    from repro.checkpoint import load as ref_load
    like = {"x": jax.ShapeDtypeStruct((1, A.n_rows), np.float32)}
    gstate, extra = ref_load(port_ck, 25, like)
    mine, _ = checkpoint.load(port_ck, 25, {"x": np.empty((1, A.n_rows),
                                                          np.float32)})
    np.testing.assert_array_equal(np.asarray(gstate["x"]), mine["x"])
    assert extra["n"] == A.n_rows and extra["nrhs"] == 1


def test_checkpoint_resume_onto_another_plan(system, plans, tmp_path):
    A, b = system
    plan, layout = plans["4x2"]
    ck = str(tmp_path / "ck")
    res = resilient_solve(plan, b, layout=layout, A=A, tol=1e-5,
                          maxiter=2000, check_every=12, checkpoint_dir=ck)
    assert res.checkpoint_dir == ck
    assert checkpoint.latest_step(ck) == int(res.iters)
    plan2, layout2 = plans["2x2"]
    res2 = resilient_solve(plan2, b, layout=layout2, A=A, tol=1e-5,
                           maxiter=2000, check_every=12, resume_from=ck)
    assert res2.resumed_from == int(res.iters) and res2.converged
    assert int(res2.iters) - int(res.iters) < int(res.iters)
    assert res2.trajectory[:len(res.trajectory)] == [
        tuple(t) for t in res.trajectory]


def test_resume_validates_problem_shape(system, plans, tmp_path):
    A, b = system
    plan, layout = plans["1x1"]
    ck = str(tmp_path / "ck")
    resilient_solve(plan, b, layout=layout, A=A, tol=1e-5, maxiter=500,
                    check_every=20, checkpoint_dir=ck)
    A2 = graded_extruded_mesh_matrix(30, 4, seed=0)
    plan2, layout2 = build_spmv_plan(A2, 1, 1, device="cpu")
    with pytest.raises(ValueError, match="shape"):
        resilient_solve(plan2, np.ones(A2.n_rows), layout=layout2, A=A2,
                        resume_from=ck)
    with pytest.raises(ValueError, match="no checkpoint"):
        resilient_solve(plan, b, layout=layout, A=A,
                        resume_from=str(tmp_path / "empty"))


def test_input_validation_and_programs_reuse(system, plans):
    A, b = system
    plan, layout = plans["1x1"]
    with pytest.raises(ValueError, match="needs layout"):
        resilient_solve(plan, b)
    with pytest.raises(ValueError, match="rows"):
        resilient_solve(plan, b[:-3], layout=layout)
    rs = make_resilient(plan, A=A, layout=layout)
    runs = [resilient_solve(plan, b, layout=layout, A=A, tol=1e-5,
                            maxiter=500, check_every=20, programs=rs)
            for _ in range(2)]
    np.testing.assert_array_equal(runs[0].x, runs[1].x)
    plan2, layout2 = plans["4x2"]
    with pytest.raises(ValueError, match="different plan"):
        resilient_solve(plan2, b, layout=layout2, programs=rs)


def test_solver_protocol_requires_x_and_k(system, plans):
    class NoK(Solver):
        name = "_resilient_test_nok"

        def state_kinds(self):
            return {"x": "vector"}

    A, _ = system
    plan, layout = plans["1x1"]
    with pytest.raises(ValueError, match="must include"):
        make_resilient(plan, solver=NoK(), A=A, layout=layout)


def test_store_round_trips_and_names_trees_as_jax_does(tmp_path):
    import jax

    trees = [{"x": np.arange(3.0)}, {"b": np.ones(2), "a": [np.zeros(1),
                                                             (np.ones(1),)]},
             (np.ones(2),), [np.ones(1), np.zeros(2)]]
    for step, tree in enumerate(trees):
        d = checkpoint.save(str(tmp_path), step, tree, extra={"s": step})
        with open(os.path.join(d, "manifest.json")) as f:
            manifest = json.load(f)
        assert manifest["treedef"] == str(jax.tree_util.tree_structure(tree))
        back, extra = checkpoint.load(str(tmp_path), step, tree)
        assert extra == {"s": step}
        for a, b in zip(jax.tree_util.tree_leaves(back),
                        jax.tree_util.tree_leaves(tree)):
            np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="tree structure"):
        checkpoint.load(str(tmp_path), 0, {"y": np.arange(3.0)})
    back, _ = checkpoint.load(str(tmp_path), 0,
                              {"x": torch.empty(3, dtype=torch.float32)},
                              device="cpu")
    assert back["x"].dtype == torch.float32
    os.makedirs(tmp_path / "step_000000099.tmp")      # a half-written save
    (tmp_path / "notes.txt").write_text("")
    assert checkpoint.latest_step(str(tmp_path)) == len(trees) - 1


def test_async_saver_keeps_the_newest(tmp_path):
    saver = checkpoint.AsyncSaver(str(tmp_path), keep=2)
    x = torch.zeros(4)
    for step in range(4):
        saver.submit(step, {"x": x})
        x.add_(1.0)               # a later in-place update never leaks in
    saver.wait()
    assert checkpoint.latest_step(str(tmp_path)) == 3
    assert sorted(os.listdir(tmp_path)) == ["step_000000002",
                                            "step_000000003"]
    back, _ = checkpoint.load(str(tmp_path), 2, {"x": np.empty(4,
                                                               np.float32)})
    np.testing.assert_array_equal(back["x"], np.full(4, 2.0, np.float32))


# --------------------------------------------------------------------- #
# kill-and-resume through the CLI
# --------------------------------------------------------------------- #
def test_kill_and_resume_cli_on_the_cpu(tmp_path):
    src = str(HERE.parent / "src")
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=src + os.pathsep + os.environ.get("PYTHONPATH", ""))
    r = subprocess.run([sys.executable, "-m",
                        "repro_torch.testing.resilience_check", "--device",
                        "cpu", "--ckpt-dir", str(tmp_path / "ck")],
                       capture_output=True, text=True, env=env, timeout=600)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "killed-by-SIGKILL ok" in r.stdout
    assert r.stdout.rstrip().endswith("OK")
