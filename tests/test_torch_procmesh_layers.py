"""The layers above the solvers on the process mesh, on gloo on the CPU:
``transport="auto"``, ``two_level``, the resilient driver with its
checkpoints, and the solve service, each against the virtual mesh (held
to the reference by ``tests/test_torch_transports.py``,
``test_torch_precond.py``, ``test_torch_resilient.py`` and
``test_torch_serve.py``) and, where the reference has the same run, the
reference itself.

Three spawns, each under ``SPAWN_TIMEOUT``:

1. 8 ranks (4x2).  On the golden ``graded_extruded_mesh_matrix(48, 6)``
   ell and sell plans: the autotuner (one winner and one table on every
   rank; a one-candidate list returns that candidate), two_level (each
   rank's R and P arrays its cut of the virtual mesh's, byte for byte;
   cg iterates bit for bit; the counts of ``precond_check``'s scaling
   meshes, all three tolerances as columns of one solve, within ±1 of the
   reference's, as ``test_torch_precond.py`` holds the virtual mesh's).  On ``graded_extruded_mesh_matrix(200,
   12)`` (71 cg iterations at 1e-5, so ``nan@60`` fires) at 4x2 sell: the
   resilient driver chunked against monolithic ``make_solver`` and with
   ``nan@60`` against the virtual mesh's rollback, bit for bit.  On
   ``resilience_check``'s system: a virtual-mesh checkpoint resumed on
   the ranks (bit for bit the virtual mesh's resume), and a solve cut at
   iteration 25 whose checkpoint the reference resumes.
2. 4 ranks (2x2): ``resilience_check``'s victim, ``preempt@25``: every
   rank is killed after the step-20 checkpoint, which the virtual mesh
   resumes.
3. 4 ranks (2x2): ``serve_check``'s case (``graded_extruded_mesh_matrix(
   48, 8)``, 16 requests through 4 slots): each request's iterations and
   rank 0's ``x`` bit for bit the virtual engine's, a splice's survivors
   bit for bit, ``recompiles == 0`` on every rank.

The reference's ``--precond`` and ``--resilient`` dumps run beside the
spawns (``tests/torch_reference.py`` on 8 XLA host devices).  The ranks
get no jax compatibility shim (nothing they import needs jax).
"""
import os
import pathlib
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from repro_torch.core import build_spmv_plan, make_spmv, to_dist
from repro_torch.core.collectives import census, record_collectives
from repro_torch.core.spmv import plan_fields
from repro_torch.core.transport import autotune_transport
from repro_torch.launch.mesh import (RanksKilled, read_plan, spawn_cg_mesh,
                                     write_plan)
from repro_torch.runtime.fault import FaultInjector
from repro_torch.serve import EngineConfig, PlanCache, SolveEngine
from repro_torch.solvers import make_solver, resilient_solve
from repro_torch.sparse import graded_extruded_mesh_matrix
from repro_torch.testing import precond_check

HERE = pathlib.Path(__file__).resolve().parent
SRC = HERE.parent / "src"
SHIM = HERE / "_jaxcompat"
SPAWN_TIMEOUT = 120.0
TOL = 3e-6
FORMATS = ("ell", "sell")
#: the reference's scaling tolerances (``tests/torch_reference.py``)
SCALING_TOLS = (1e-6, 3e-6, 1e-5)
RESILIENT = dict(precond="jacobi", tol=1e-5, check_every=10)
SLACK = 2 * RESILIENT["check_every"] + 10       # resilience_check's


def _golden():
    return graded_extruded_mesh_matrix(48, 6, seed=0)


def _row(a, mesh):
    return torch.from_numpy(np.array(
        a[mesh.node:mesh.node + 1, mesh.core:mesh.core + 1]))


def _arrays(plan) -> dict:
    """A plan's arrays as numpy (a rank-local plan's: its shard)."""
    names = plan_fields(plan) + ("diag_a", "mask", "mask_col")
    arrays = {**plan.fmt_data, "send_own": plan.send_own,
              "recv_own": plan.recv_own, "x_gather": plan.x_gather,
              "diag_a": plan.diag_a, "mask": plan.mask,
              "mask_col": plan.mask_col}
    return {k: arrays[k].numpy() for k in names}


def _bits(a):
    a = np.ascontiguousarray(a)
    return a.view(np.int64 if a.dtype == np.float64 else np.int32)


def _resilience_system():
    A = _golden()
    return A, np.random.default_rng(1).normal(size=A.n_rows)


def _long_system():
    A = graded_extruded_mesh_matrix(200, 12, seed=0)
    return A, np.random.default_rng(5).normal(size=A.n_rows)


def _serve_cfg(**kw):
    return EngineConfig(nrhs=4, n_node=2, n_core=2, check_every=20,
                        default_tol=1e-5, **kw)


def _serve_requests():
    A = graded_extruded_mesh_matrix(48, 8, seed=0)
    B = np.random.default_rng(0).normal(size=(16, A.n_rows))
    return A, B, [1e-5 * (1, 3, 10)[i % 3] for i in range(16)]


# ---------------------------------------------------------------------- #
# what the ranks run
# ---------------------------------------------------------------------- #
def _rank_layers(mesh, job):
    """Spawn 1: the autotuner, two_level and the resilient driver."""
    out = {"auto": {}, "two_level": {}, "scaling": {}}
    A = _golden()
    for fmt in FORMATS:
        case = job["golden"][fmt]
        plan = read_plan(case["dir"], mesh)
        res = autotune_transport(plan, iters=3, reps=2)
        one = autotune_transport(plan, candidates=("ring",), iters=1,
                                 reps=1)
        out["auto"][fmt] = (res.winner, res.timings_min_us, one.winner,
                            plan.transport)
        plan = read_plan(case["dir"], mesh)         # stamped a2a again
        solve = make_solver(plan, precond="two_level", A=A,
                            layout=case["layout"])
        with record_collectives() as log:
            z = solve.papply(solve.pdata, _row(case["b"], mesh)[None])
        xs, iters, _ = solve(_row(case["b"], mesh), tol=TOL, maxiter=400)
        plans = solve.papply.plans
        out["two_level"][fmt] = {
            "R": _arrays(plans["R"][0]), "P": _arrays(plans["P"][0]),
            "ainv_c": tuple(solve.pdata["ainv_c"].shape),
            "z": z.numpy(), "x": xs.numpy(), "iters": int(iters),
            "census": census(log),
            "seconds": solve.papply.host_seconds}
    for (n_surface, layers), rows in zip(precond_check.SCALING_MESHES,
                                         job["scaling"]):
        Am = graded_extruded_mesh_matrix(n_surface, layers, seed=0)
        plan = read_plan(rows["dir"], mesh)
        out["scaling"][(n_surface, layers)] = _counts_per_tol(
            plan, Am, rows["layout"], _row(rows["b"], mesh))

    A, b = _long_system()
    long = job["long"]
    plan = read_plan(long["dir"], mesh)
    solve = make_solver(plan, A=A, layout=long["layout"])
    xs, iters, _ = solve(_row(long["b"], mesh), tol=1e-5, maxiter=2000)
    out["monolithic"] = (int(iters), xs.numpy())
    kw = dict(layout=long["layout"], A=A, **RESILIENT)
    out["chunked"] = resilient_solve(plan, b, **kw)
    out["nan"] = resilient_solve(plan, b, injector=FaultInjector.parse(
        "nan@60", shard=(2, 1)), **kw)

    A, b = _resilience_system()
    rs = job["resilience"]
    plan = read_plan(rs["dir"], mesh)
    kw = dict(layout=rs["layout"], A=A, maxiter=5000, **RESILIENT)
    out["resumed"] = resilient_solve(plan, b, resume_from=rs["virtual_ck"],
                                     **kw)
    # as the virtual checkpoint was cut: the plan built here, 4x2 ell a2a
    out["cut"] = resilient_solve(
        A, b, n_node=4, n_core=2, format="ell", transport="a2a",
        maxiter=25, checkpoint_dir=rs["process_ck"], device="cpu",
        mesh=mesh, **RESILIENT)
    return out


def _counts_per_tol(plan, A, layout, bd) -> list[int]:
    """two_level cg's iterations to each of ``SCALING_TOLS`` on ``bd``:
    one solve of as many columns, each column its own tolerance (the
    resilient programs' per-column tolerances, as the solve service runs
    them; a column's iterations never depend on the others')."""
    from repro_torch.solvers import make_resilient

    rs = make_resilient(plan, solver="cg", precond="two_level", A=A,
                        layout=layout, precond_options={
                            "agg_size": precond_check.SCALING_AGG})
    k = len(SCALING_TOLS)
    b = (bd[None] * plan.mask).expand(k, *bd.shape).contiguous()
    tol = torch.tensor(SCALING_TOLS, dtype=torch.float32)
    mxd = torch.tensor(400, dtype=torch.int32)
    state = rs.restart(b, tol, mxd, torch.zeros_like(b),
                       torch.zeros(k, dtype=torch.int32))
    done = False
    while not done:
        state, done, _, _ = rs.chunk(b, tol, mxd, 16, state)
    return state["k"].tolist()


def _rank_victim(mesh, ck: str):
    """Spawn 2: ``resilience_check``'s victim at 2x2, killed at 25."""
    A, b = _resilience_system()
    resilient_solve(A, b, n_node=2, n_core=2, format="ell", transport="a2a",
                    maxiter=5000, checkpoint_dir=ck,
                    injector=FaultInjector.parse("preempt@25"),
                    device="cpu", mesh=mesh, **RESILIENT)
    return "survived"


def _serve(A, B, tols, ck: str, mesh=None) -> dict:
    """The service's drain, one splice's survivors, and an engine
    checkpointed to ``ck`` after one chunk and restored on a fresh sell
    engine (on a process ``mesh``: this rank's share)."""
    cache = PlanCache()
    engine = SolveEngine(A, _serve_cfg(), device="cpu", cache=cache,
                         mesh=mesh)
    decides = mesh is None or mesh.rank == 0
    if decides:
        for i in range(len(B)):
            engine.submit(B[i], tol=tols[i])
    recs = sorted(engine.drain(), key=lambda r: r.request.rid)

    def run(splice: bool) -> list:
        e = SolveEngine(A, _serve_cfg(), device="cpu", cache=cache,
                        mesh=mesh)
        if decides:
            for i, tol in enumerate((1e-2, 1e-5, 3e-5)):
                e.submit(B[i], tol=tol)
        snaps, added = [], False
        while not e._agree(e.idle()):
            retired = e.step()
            if splice and retired and not added:
                if decides:
                    e.submit(B[3], tol=1e-5)
                added = True
            snaps.append(e._state["x"][1:3].clone().numpy())
        return snaps

    e1 = SolveEngine(A, _serve_cfg(), device="cpu", cache=cache, mesh=mesh)
    if decides:
        e1.submit(B[0], tol=1e-5)
        e1.submit(B[1], tol=3e-5)
    e1.step()
    path = e1.checkpoint(ck)
    e2 = SolveEngine(A, _serve_cfg(format="sell"), device="cpu",
                     cache=cache, mesh=mesh)
    e2.restore(ck)
    resumed = sorted(e2.drain(), key=lambda r: r.request.rid)
    return {"rids": [r.request.rid for r in recs],
            "iters": [r.iterations for r in recs],
            "x": [r.x for r in recs], "stats": engine.stats(),
            "splice": (run(False), run(True)), "checkpoint": path,
            "resumed": [(r.request.rid, r.iterations, r.x)
                        for r in resumed]}


def _rank_serve(mesh, ck: str):
    return _serve(*_serve_requests(), ck, mesh=mesh)


# ---------------------------------------------------------------------- #
# the virtual mesh, the reference and the spawns
# ---------------------------------------------------------------------- #
def _ref_env() -> dict:
    env = dict(os.environ)
    path = [str(SRC), str(SHIM)] + [p for p in env.get(
        "PYTHONPATH", "").split(os.pathsep) if p]
    env["PYTHONPATH"] = os.pathsep.join(path)
    env["XLA_FLAGS"] = (env.get("XLA_FLAGS", "")
                        + " --xla_force_host_platform_device_count=8")
    return env


def _reference(out: pathlib.Path, *flags) -> subprocess.Popen:
    return subprocess.Popen(
        [sys.executable, str(HERE / "torch_reference.py"), str(out),
         *flags], env=_ref_env(), stdout=subprocess.DEVNULL,
        stderr=subprocess.PIPE, text=True)


def _load(proc: subprocess.Popen, out: pathlib.Path) -> dict:
    _, err = proc.communicate(timeout=600)
    assert proc.returncode == 0, err[-4000:]
    with np.load(out) as d:
        return {k: d[k] for k in d.files}


@pytest.fixture(scope="module")
def no_shim_in_the_ranks():
    mp = pytest.MonkeyPatch()
    path = [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep)
            if p and not p.rstrip("/").endswith(os.path.join("tests",
                                                            "_jaxcompat"))]
    mp.setenv("PYTHONPATH", os.pathsep.join(path))
    yield
    mp.undo()


@pytest.fixture(scope="module")
def world(tmp_path_factory, no_shim_in_the_ranks):
    """Every spawn's results, the virtual mesh's and the reference's."""
    tmp = tmp_path_factory.mktemp("layers")
    A = _golden()
    rng = np.random.default_rng(17)
    b = rng.standard_normal(A.n_rows)
    virtual = {"golden": {}, "scaling": []}
    job = {"golden": {}, "scaling": []}
    for fmt in FORMATS:
        plan, layout = build_spmv_plan(A, 4, 2, format=fmt, device="cpu")
        bd = to_dist(b, layout, plan).numpy()
        job["golden"][fmt] = {"dir": str(write_plan(plan, tmp / fmt)),
                              "layout": layout, "b": bd}
        virtual["golden"][fmt] = (plan, layout, bd)
    for n_surface, layers in precond_check.SCALING_MESHES:
        Am = graded_extruded_mesh_matrix(n_surface, layers, seed=0)
        plan, layout = build_spmv_plan(Am, 4, 2, mode="balanced",
                                       node_partition="rows", format="ell",
                                       device="cpu")
        bd = to_dist(np.random.default_rng(7).normal(size=Am.n_rows),
                     layout, plan).numpy()
        job["scaling"].append({"dir": str(write_plan(
            plan, tmp / f"scaling_{layers}")), "layout": layout, "b": bd})
    Al, bl = _long_system()
    plan, layout = build_spmv_plan(Al, 4, 2, format="sell", device="cpu")
    job["long"] = {"dir": str(write_plan(plan, tmp / "long")),
                   "layout": layout, "b": to_dist(bl, layout, plan).numpy()}
    virtual["long"] = (plan, layout)
    # resilience_check's system at 4x2 sell ring; a checkpoint the port
    # writes on the virtual mesh (cut at 25 on 4x2 ell a2a)
    Ar, br = _resilience_system()
    plan, layout = build_spmv_plan(Ar, 4, 2, format="sell",
                                   transport="ring", device="cpu")
    virtual_ck, process_ck = tmp / "virtual_ck", tmp / "process_ck"
    resilient_solve(Ar, br, n_node=4, n_core=2, format="ell",
                    transport="a2a", maxiter=25, checkpoint_dir=str(
                        virtual_ck), device="cpu", **RESILIENT)
    job["resilience"] = {"dir": str(write_plan(plan, tmp / "resilience")),
                         "layout": layout, "virtual_ck": str(virtual_ck),
                         "process_ck": str(process_ck)}
    virtual["resilience"] = (plan, layout, str(virtual_ck))

    refs = {"precond": tmp / "precond.npz", "resilient": tmp / "res.npz"}
    t0 = time.perf_counter()
    layers = spawn_cg_mesh(_rank_layers, 4, 2, "cpu", args=(job,),
                           timeout=SPAWN_TIMEOUT)
    seconds = {"layers": time.perf_counter() - t0}
    # the reference runs beside the lighter 4-rank spawns; the process
    # mesh's cut checkpoint is down, so it can resume it
    procs = {"precond": _reference(refs["precond"], "--precond"),
             "resilient": _reference(refs["resilient"], "--resilient",
                                     str(process_ck), str(tmp / "ref_ck"))}
    victim_ck = tmp / "victim_ck"
    t0 = time.perf_counter()
    try:
        spawn_cg_mesh(_rank_victim, 2, 2, "cpu", args=(str(victim_ck),),
                      timeout=SPAWN_TIMEOUT)
        killed = None
    except RanksKilled as e:
        killed = e.exitcodes
    seconds["victim"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    served = spawn_cg_mesh(_rank_serve, 2, 2, "cpu", args=(
        str(tmp / "serve_ck"),), timeout=SPAWN_TIMEOUT)
    seconds["serve"] = time.perf_counter() - t0
    return {"virtual": virtual, "layers": layers, "killed": killed,
            "victim_ck": str(victim_ck), "served": served,
            "seconds": seconds,
            "reference": {k: _load(p, refs[k]) for k, p in procs.items()}}


def _shard(a, r, n_core=2):
    n, c = divmod(r, n_core)
    return a[n, c]


# ---------------------------------------------------------------------- #
# transport="auto"
# ---------------------------------------------------------------------- #
@pytest.mark.parametrize("fmt", FORMATS)
def test_every_rank_stamps_the_same_auto_winner(fmt, world):
    got = [r["auto"][fmt] for r in world["layers"]]
    winner, table, _, stamped = got[0]
    assert winner in table and stamped == "ring"   # the last call's stamp
    assert min(table, key=table.get) == winner
    # the slowest rank's times: one table, one winner, on every rank
    assert all(g[0] == winner and g[1] == table for g in got)


@pytest.mark.parametrize("fmt", FORMATS)
def test_a_one_candidate_list_returns_that_candidate(fmt, world):
    assert [r["auto"][fmt][2] for r in world["layers"]] == ["ring"] * 8


def test_make_spmv_auto_on_a_rank_is_the_virtual_meshs_y(world):
    """The ranks' winner, rebuilt on the virtual mesh from the stamp, is
    a2a's y (every transport's, bit for bit)."""
    plan, layout, bd = world["virtual"]["golden"]["ell"]
    x = torch.from_numpy(bd)
    y = make_spmv(plan, transport=world["layers"][0]["auto"]["ell"][0])(x)
    assert torch.equal(y.view(torch.int32),
                       make_spmv(plan, transport="a2a")(x).view(torch.int32))


# ---------------------------------------------------------------------- #
# two_level
# ---------------------------------------------------------------------- #
@pytest.mark.parametrize("fmt", FORMATS)
def test_every_ranks_R_and_P_are_its_cut_of_the_virtual_meshs(fmt, world):
    plan, layout, _ = world["virtual"]["golden"][fmt]
    solve = make_solver(plan, precond="two_level", A=_golden(),
                        layout=layout)
    for which in ("R", "P"):
        want = _arrays(solve.papply.plans[which][0])
        for r, res in enumerate(world["layers"]):
            got = res["two_level"][fmt][which]
            assert got.keys() == want.keys()
            for name, a in got.items():
                assert a.shape[:2] == (1, 1), (which, name)
                assert a.dtype == want[name].dtype, (which, name)
                assert a[0, 0].tobytes() == _shard(want[name],
                                                   r).tobytes(), (which,
                                                                  name, r)
    nc = solve.pdata["ainv_c"].shape[-1]
    assert all(res["two_level"][fmt]["ainv_c"] == (1, 1, nc, nc)
               for res in world["layers"])


@pytest.mark.parametrize("fmt", FORMATS)
def test_two_level_apply_and_iterates_are_bit_for_bit_the_virtual_meshs(
        fmt, world):
    plan, layout, bd = world["virtual"]["golden"][fmt]
    solve = make_solver(plan, precond="two_level", A=_golden(),
                        layout=layout)
    b = torch.from_numpy(bd)
    z = solve.papply(solve.pdata, b[None])[0].numpy()
    xs, iters, _ = solve(b, tol=TOL, maxiter=400)
    for r, res in enumerate(world["layers"]):
        tl = res["two_level"][fmt]
        assert tl["iters"] == int(iters), r
        assert np.array_equal(_bits(tl["z"][0, 0, 0]), _bits(_shard(z, r)))
        assert np.array_equal(_bits(tl["x"][0, 0]),
                              _bits(_shard(xs.numpy(), r)))


@pytest.mark.parametrize("fmt", FORMATS)
def test_two_level_apply_gathers_and_reduces_nothing(fmt, world):
    """The coarse correction's core- then node-axis gathers, as on the
    virtual mesh; the smoother and the coarse solve reduce nothing."""
    plan, layout, bd = world["virtual"]["golden"][fmt]
    solve = make_solver(plan, precond="two_level", A=_golden(),
                        layout=layout)
    with record_collectives() as log:
        solve.papply(solve.pdata, torch.from_numpy(bd)[None])
    want = census(log)
    assert want["all-reduce"] == 0
    assert all(res["two_level"][fmt]["census"] == want
               for res in world["layers"])


@pytest.mark.parametrize("mesh", precond_check.SCALING_MESHES,
                         ids=lambda m: f"{m[0]}x{m[1]}")
def test_two_level_counts_match_the_reference_on_every_rank(mesh, world):
    """``precond_check``'s scaling meshes at 4x2 (rows partition, ell,
    agg 8) at each tol of ``SCALING_TOLS`` (on the ranks one column per
    tol): within ±1 of the reference's, as ``test_torch_precond.py`` holds
    the virtual mesh's, and equal to the virtual mesh's single solves."""
    ref = world["reference"]["precond"]
    want = [int(ref[f"scaling/{mesh[0]}x{mesh[1]}/two_level/{tol:g}"])
            for tol in SCALING_TOLS]
    got = [res["scaling"][mesh] for res in world["layers"]]
    assert all(g == got[0] for g in got), got
    A = graded_extruded_mesh_matrix(*mesh, seed=0)
    plan, layout = build_spmv_plan(A, 4, 2, mode="balanced",
                                   node_partition="rows", format="ell",
                                   device="cpu")
    bd = to_dist(np.random.default_rng(7).normal(size=A.n_rows), layout,
                 plan)
    solve = make_solver(plan, solver="cg", precond="two_level", A=A,
                        layout=layout, precond_options={
                            "agg_size": precond_check.SCALING_AGG})
    assert got[0] == [int(solve(bd, tol=tol, maxiter=400)[1])
                      for tol in SCALING_TOLS]
    assert all(abs(a - b) <= 1 for a, b in zip(got[0], want)), (got[0],
                                                                want)


# ---------------------------------------------------------------------- #
# the resilient driver
# ---------------------------------------------------------------------- #
def test_chunked_equals_monolithic_bit_for_bit_on_every_rank(world):
    """Each rank's monolithic shard is its rows of the chunked ``x``,
    which every rank holds whole."""
    _, layout = world["virtual"]["long"]
    for r, res in enumerate(world["layers"]):
        iters, xs = res["monolithic"]
        ch = res["chunked"]
        assert int(ch.iters) == iters and ch.rollbacks == 0, r
        g = layout["global_row_of"][divmod(r, 2)]
        assert np.array_equal(_bits(ch.x[g[g >= 0]]),
                              _bits(xs[0, 0][g >= 0])), r
        assert np.array_equal(_bits(ch.x),
                              _bits(world["layers"][0]["chunked"].x))


def test_nan_at_60_rolls_back_to_the_virtual_meshs_trajectory(world):
    plan, layout = world["virtual"]["long"]
    A, b = _long_system()
    want = resilient_solve(plan, b, layout=layout, A=A,
                           injector=FaultInjector.parse("nan@60",
                                                        shard=(2, 1)),
                           **RESILIENT)
    assert want.rollbacks == 1
    for res in world["layers"]:
        got = res["nan"]
        assert (got.rollbacks, got.chunks, int(got.iters)) == (
            want.rollbacks, want.chunks, int(want.iters))
        assert got.trajectory == want.trajectory
        assert np.array_equal(_bits(got.x), _bits(want.x))


def test_a_virtual_mesh_checkpoint_resumes_on_the_process_mesh(world):
    plan, layout, ck = world["virtual"]["resilience"]
    A, b = _resilience_system()
    want = resilient_solve(plan, b, layout=layout, A=A, resume_from=ck,
                           maxiter=5000, **RESILIENT)
    assert want.resumed_from == 25 and want.converged
    for res in world["layers"]:
        got = res["resumed"]
        assert got.resumed_from == 25 and int(got.iters) == int(want.iters)
        assert np.array_equal(_bits(got.x), _bits(want.x))


def test_a_process_mesh_checkpoint_is_the_virtual_meshs(world):
    from repro_torch import checkpoint
    _, _, vck = world["virtual"]["resilience"]
    pck = world["layers"][0]["cut"].checkpoint_dir
    assert checkpoint.latest_step(pck) == checkpoint.latest_step(vck) == 25
    like = {"x": np.zeros((1, _golden().n_rows), np.float32)}
    (gp, ep), (gv, ev) = (checkpoint.load(d, 25, like) for d in (pck, vck))
    assert np.array_equal(_bits(gp["x"]), _bits(gv["x"]))
    assert ep == ev


def test_the_reference_resumes_a_process_mesh_checkpoint(world):
    ref = world["reference"]["resilient"]
    assert int(ref["resume_port/resumed_from"]) == 25
    assert bool(ref["resume_port/converged"])
    assert abs(int(ref["resume_port/iters"])
               - int(ref["resume_ref/iters"])) <= SLACK


def test_preempt_kills_every_rank_and_the_virtual_mesh_resumes(world):
    from repro_torch import checkpoint
    assert world["killed"] == [-9] * 4
    ck = world["victim_ck"]
    assert checkpoint.latest_step(ck) == 20
    A, b = _resilience_system()
    plan, layout = build_spmv_plan(A, 2, 2, format="ell", device="cpu")
    # the victim's step-20 iterate is the virtual mesh's, bit for bit
    cut = resilient_solve(plan, b, layout=layout, A=A, maxiter=20,
                          **RESILIENT)
    like = {"x": np.zeros((1, A.n_rows), np.float32)}
    g, _ = checkpoint.load(ck, 20, like)
    assert np.array_equal(_bits(g["x"][0]), _bits(cut.x.astype(np.float32)))
    clean = resilient_solve(plan, b, layout=layout, A=A, maxiter=5000,
                            **RESILIENT)
    res = resilient_solve(plan, b, layout=layout, A=A, maxiter=5000,
                          resume_from=ck, **RESILIENT)
    assert res.resumed_from == 20 and res.converged
    assert int(res.iters) <= int(clean.iters) + SLACK


# ---------------------------------------------------------------------- #
# the solve service
# ---------------------------------------------------------------------- #
@pytest.fixture(scope="module")
def virtual_serve(tmp_path_factory):
    return _serve(*_serve_requests(),
                  str(tmp_path_factory.mktemp("serve_ck")))


def test_every_ranks_requests_retire_at_the_virtual_engines_iterations(
        world, virtual_serve):
    for res in world["served"]:
        assert res["rids"] == virtual_serve["rids"] == list(range(16))
        assert res["iters"] == virtual_serve["iters"]


def test_rank_0_holds_every_x_bit_for_bit_the_virtual_engines(
        world, virtual_serve):
    for got, want in zip(world["served"][0]["x"], virtual_serve["x"]):
        assert np.array_equal(_bits(got), _bits(want))
    assert all(x is None for res in world["served"][1:] for x in res["x"])


def test_a_splice_leaves_every_ranks_survivors_bit_for_bit(world):
    for res in world["served"]:
        base, spl = res["splice"]
        n = min(len(base), len(spl))
        assert n > 1
        assert all(np.array_equal(_bits(base[c]), _bits(spl[c]))
                   for c in range(n))


def test_an_engine_checkpoint_crosses_between_the_meshes(world,
                                                         virtual_serve):
    """Written by rank 0 (every rank returns its path), the same bytes as
    the virtual engine's; restored on every rank, its requests retire at
    the virtual engine's iterations, rank 0 holding the same ``x``."""
    from repro_torch import checkpoint
    paths = {res["checkpoint"] for res in world["served"]}
    assert len(paths) == 1
    d = os.path.dirname(paths.pop())
    vd = os.path.dirname(virtual_serve["checkpoint"])
    step = checkpoint.latest_step(d)
    assert step == checkpoint.latest_step(vd)
    n = _serve_requests()[0].n_rows
    like = {"x": np.zeros((4, n), np.float32),
            "b": np.zeros((4, n), np.float32)}
    (gp, ep), (gv, ev) = (checkpoint.load(p, step, like) for p in (d, vd))
    assert ep == ev
    assert all(np.array_equal(_bits(gp[k]), _bits(gv[k])) for k in gp)
    want = virtual_serve["resumed"]
    assert [w[:2] for w in want] == [(0, want[0][1]), (1, want[1][1])]
    for r, res in enumerate(world["served"]):
        assert [g[:2] for g in res["resumed"]] == [w[:2] for w in want]
        for (_, _, x), (_, _, xv) in zip(res["resumed"], want):
            assert (x is None) if r else np.array_equal(_bits(x), _bits(xv))


def test_no_rank_recompiles_while_serving(world):
    for res in world["served"]:
        assert res["stats"]["recompiles"] == 0
        assert res["stats"]["splices"] >= 16


def test_the_engine_refuses_a_mesh_of_another_shape():
    from repro_torch.launch.mesh import make_cg_mesh
    A, _, _ = _serve_requests()
    with pytest.raises(ValueError, match="config is 2x2, the mesh 4x2"):
        SolveEngine(A, _serve_cfg(), cache=PlanCache(),
                    mesh=make_cg_mesh(4, 2, device="cpu"))


def test_spawns_finish_well_inside_their_timeout(world):
    assert max(world["seconds"].values()) < SPAWN_TIMEOUT / 2, world[
        "seconds"]
