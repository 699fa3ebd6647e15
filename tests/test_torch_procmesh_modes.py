"""The three modes' schedules on the process mesh, on gloo ranks on the CPU.

On a rank-local plan with a halo, ``vector`` keeps the reference's
barrier (the exchange waited before one fused launch) while ``task`` and
``balanced`` overlap it with the diag pass (issue the exchange, gather
``x``, launch the diag pass, wait, launch the offd pass onto the diag
partial).  One spawn of 4 ranks holds every case: the 2x2 mesh it starts
and a 4x1 and a halo-free 1x4 mesh over the same group.

Held here, on the golden matrix (``graded_extruded_mesh_matrix(48, 6)``)
and its ``x`` / ``b`` (``default_rng(7)``), ell and sell:

* every transport x wire dtype: each rank's ``y`` bit for bit across
  ``vector`` and ``task`` (one rows partition) and its row of the virtual
  mesh's; ``balanced`` bit for bit its own plan's virtual mesh;
* cg + jacobi (tol 1e-5) and batched cg (nrhs 3): every iterate bit for
  bit across ``vector`` and ``task``;
* the census of one SpMV: equal across ``vector`` and ``task``, and every
  mode's equal to the virtual mesh's;
* ``body.schedule``: under ``vector`` the exchange's wait comes before any
  launch; under ``task`` / ``balanced`` the diag launch lies between the
  exchange's issue and its wait, the offd launch after it; halo-free
  plans show one launch in every mode;
* each mode's ``y`` within 2e-5·max|y| of the JAX package's ``make_spmv``
  for the same mode and plan (``tests/torch_reference.py --modes``, 8
  XLA host devices): summation orders differ, so not bit for bit.
"""
import dataclasses
import os
import pathlib
import tempfile
import time

import numpy as np
import pytest

from conftest import run_subprocess
from repro_torch.core import build_spmv_plan, make_spmv, to_dist
from repro_torch.core.collectives import census, record_collectives
from repro_torch.launch.mesh import spawn_cg_mesh, write_plan
from repro_torch.sparse import graded_extruded_mesh_matrix

HERE = pathlib.Path(__file__).resolve().parent
SPAWN_TIMEOUT = 120.0
#: the halo grids (the spawned one first) and the halo-free one
GRIDS = ((2, 2), (4, 1))
HALO_FREE = (1, 4)
FORMATS = ("ell", "sell")
MODES = ("vector", "task", "balanced")
TRANSPORTS = ("a2a", "hier", "pairwise", "ring")
WIRES = ("bf16", "f32", "int8")
NRHS = 3
TOL = 1e-5


def _partition(mode: str) -> str:
    """The plan a mode runs on: ``vector`` and ``task`` share equal
    rows; ``balanced`` balances non-zeros."""
    return "nnz" if mode == "balanced" else "rows"


def _iterates(solve, b) -> list:
    from repro_torch.testing.dist_check import cg_iterates

    return cg_iterates(solve, b, TOL, 400)


def _rank(mesh, job) -> dict:
    from repro_torch.core import make_shard_body
    from repro_torch.launch.mesh import make_cg_mesh, read_plan
    from repro_torch.solvers import make_solver, to_dist_batch

    out = {}
    for grid in (*GRIDS, HALO_FREE):
        m = mesh if grid == (mesh.n_node, mesh.n_core) else make_cg_mesh(
            *grid, device=mesh.device, backend=mesh.backend, rank=mesh.rank,
            world_size=mesh.world_size)
        for fmt in FORMATS:
            for mode in MODES:
                key = (grid, fmt, _partition(mode))
                layout = job["layouts"][key]
                plan = dataclasses.replace(
                    read_plan(job["dirs"][key], m), mode=mode)
                x = to_dist(job["x"], layout, plan)
                out[(grid, fmt, mode, "schedule")] = make_shard_body(
                    plan).schedule
                for tr in (TRANSPORTS if plan.hs else ("a2a",)):
                    for wd in WIRES:
                        spmv = make_spmv(plan, transport=tr, wire_dtype=wd)
                        with record_collectives() as log:
                            y = spmv(x)
                        out[(grid, fmt, mode, tr, wd)] = (y.numpy(),
                                                          census(log))
                if grid == HALO_FREE or mode == "balanced":
                    continue
                b = to_dist(job["b"], layout, plan)
                B = to_dist_batch(job["B"], layout, plan)
                out[(grid, fmt, mode, "cg")] = _iterates(
                    make_solver(plan, precond="jacobi"), b)
                out[(grid, fmt, mode, "cg", NRHS)] = _iterates(
                    make_solver(plan, precond="jacobi", nrhs=NRHS), B)
    return out


@pytest.fixture(scope="module")
def golden():
    A = graded_extruded_mesh_matrix(48, 6, seed=0)
    rng = np.random.default_rng(7)
    x = rng.standard_normal(A.n_rows).astype(np.float32)
    b = rng.standard_normal(A.n_rows).astype(np.float32)
    B = np.random.default_rng(11).normal(size=(NRHS, A.n_rows))
    return A, x, b, B


@pytest.fixture(scope="module")
def plans(golden):
    """The whole plans, by ``(grid, format, partition)``."""
    A = golden[0]
    out = {}
    for grid in (*GRIDS, HALO_FREE):
        for fmt in FORMATS:
            for mode in ("vector", "balanced"):
                out[(grid, fmt, _partition(mode))] = build_spmv_plan(
                    A, *grid, mode=mode, format=fmt, device="cpu")
    return out


@pytest.fixture(scope="module")
def ranks(golden, plans):
    shim = os.path.join("tests", "_jaxcompat")
    saved = os.environ.get("PYTHONPATH", "")
    os.environ["PYTHONPATH"] = os.pathsep.join(
        p for p in saved.split(os.pathsep)
        if p and not p.rstrip("/").endswith(shim))
    _, x, b, B = golden
    try:
        with tempfile.TemporaryDirectory() as d:
            job = {"x": x, "b": b, "B": B, "dirs": {}, "layouts": {}}
            for i, (key, (plan, layout)) in enumerate(plans.items()):
                job["dirs"][key] = str(write_plan(plan, f"{d}/{i}"))
                job["layouts"][key] = layout
            t0 = time.perf_counter()
            out = spawn_cg_mesh(_rank, *GRIDS[0], "cpu", args=(job,),
                                timeout=SPAWN_TIMEOUT)
            return out, time.perf_counter() - t0
    finally:
        os.environ["PYTHONPATH"] = saved


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    out = tmp_path_factory.mktemp("ref") / "modes.npz"
    res = run_subprocess([str(HERE / "torch_reference.py"), str(out),
                          "--modes"], device_count=8)
    assert res.returncode == 0, res.stderr[-4000:]
    with np.load(out) as d:
        return {k: d[k] for k in d.files}


def _virtual(plans, golden, grid, fmt, mode, tr="a2a", wd="f32"):
    """The virtual mesh's ``y`` and census of one SpMV on the mode's
    plan."""
    plan, layout = plans[(grid, fmt, _partition(mode))]
    plan = dataclasses.replace(plan, mode=mode)
    with record_collectives() as log:
        y = make_spmv(plan, transport=tr, wire_dtype=wd)(
            to_dist(golden[1], layout, plan))
    return y.numpy(), census(log)


def _rows(res, grid):
    """Rank ``r``'s shard at ``divmod(r, n_core)``."""
    return [(divmod(r, grid[1]), out) for r, out in enumerate(res)]


def _bits(a, b) -> bool:
    return np.array_equal(np.asarray(a).view(np.int32),
                          np.asarray(b).view(np.int32))


@pytest.mark.parametrize("wd", WIRES)
@pytest.mark.parametrize("tr", TRANSPORTS)
@pytest.mark.parametrize("fmt", FORMATS)
@pytest.mark.parametrize("grid", GRIDS, ids=lambda g: f"{g[0]}x{g[1]}")
def test_vector_and_task_are_the_virtual_meshs_bits(grid, fmt, tr, wd,
                                                    ranks, plans, golden):
    want, _ = _virtual(plans, golden, grid, fmt, "vector", tr, wd)
    for at, res in _rows(ranks[0], grid):
        yv, _ = res[(grid, fmt, "vector", tr, wd)]
        yt, _ = res[(grid, fmt, "task", tr, wd)]
        assert _bits(yv[0, 0], want[at]) and _bits(yt, yv)


@pytest.mark.parametrize("wd", WIRES)
@pytest.mark.parametrize("tr", TRANSPORTS)
@pytest.mark.parametrize("fmt", FORMATS)
@pytest.mark.parametrize("grid", GRIDS, ids=lambda g: f"{g[0]}x{g[1]}")
def test_balanced_is_its_own_plans_virtual_mesh(grid, fmt, tr, wd, ranks,
                                                plans, golden):
    want, _ = _virtual(plans, golden, grid, fmt, "balanced", tr, wd)
    for at, res in _rows(ranks[0], grid):
        assert _bits(res[(grid, fmt, "balanced", tr, wd)][0][0, 0],
                     want[at])


@pytest.mark.parametrize("fmt", FORMATS)
@pytest.mark.parametrize("grid", GRIDS, ids=lambda g: f"{g[0]}x{g[1]}")
def test_the_census_is_the_same_in_every_mode(grid, fmt, ranks, plans,
                                              golden):
    for mode in MODES:
        for tr in TRANSPORTS:
            for wd in WIRES:
                _, want = _virtual(plans, golden, grid, fmt, mode, tr, wd)
                for res in ranks[0]:
                    assert res[(grid, fmt, mode, tr, wd)][1] == want
                    assert (res[(grid, fmt, "task", tr, wd)][1]
                            == res[(grid, fmt, "vector", tr, wd)][1])


@pytest.mark.parametrize("nrhs", [None, NRHS], ids=["single", "batched"])
@pytest.mark.parametrize("fmt", FORMATS)
@pytest.mark.parametrize("grid", GRIDS, ids=lambda g: f"{g[0]}x{g[1]}")
def test_every_cg_iterate_is_the_same_under_vector_and_task(grid, fmt, nrhs,
                                                            ranks):
    key = (() if nrhs is None else (nrhs,))
    counts = []
    for res in ranks[0]:
        xv = res[(grid, fmt, "vector", "cg", *key)]
        xt = res[(grid, fmt, "task", "cg", *key)]
        assert len(xv) == len(xt) > 10
        assert all(_bits(a, b) for a, b in zip(xv, xt))
        counts.append(len(xv))
    assert all(n == counts[0] for n in counts)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("fmt", FORMATS)
@pytest.mark.parametrize("grid", GRIDS, ids=lambda g: f"{g[0]}x{g[1]}")
def test_the_schedule_orders_the_exchange_and_the_launches(grid, fmt, mode,
                                                           ranks):
    for res in ranks[0]:
        steps = list(res[(grid, fmt, mode, "schedule")])
        at = {s: i for i, s in enumerate(steps)}
        issue, wait = at[("issue", "exchange")], at[("wait", "exchange")]
        launches = [i for i, (verb, _) in enumerate(steps)
                    if verb == "launch"]
        assert issue < wait
        if mode == "vector":
            assert steps[launches[0]] == ("launch", "fused")
            assert len(launches) == 1 and wait < launches[0]
        else:
            assert len(launches) == 2
            assert issue < at[("launch", "diag")] < wait < at[("launch",
                                                              "offd")]


@pytest.mark.parametrize("fmt", FORMATS)
def test_halo_free_plans_keep_one_launch_in_every_mode(fmt, ranks, plans,
                                                       golden):
    for mode in MODES:
        want, _ = _virtual(plans, golden, HALO_FREE, fmt, mode)
        for at, res in _rows(ranks[0], HALO_FREE):
            steps = res[(HALO_FREE, fmt, mode, "schedule")]
            assert [s for s in steps if s[0] == "launch"] == [("launch",
                                                               "diag")]
            assert not any(what == "exchange" for _, what in steps)
            assert _bits(res[(HALO_FREE, fmt, mode, "a2a", "f32")][0][0, 0],
                         want[at])


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("fmt", FORMATS)
@pytest.mark.parametrize("grid", GRIDS, ids=lambda g: f"{g[0]}x{g[1]}")
def test_each_mode_matches_the_reference(grid, fmt, mode, ranks, reference):
    want = reference[f"modes/{fmt}/{grid[0]}x{grid[1]}/{mode}/y"]
    got = np.zeros_like(want)
    for at, res in _rows(ranks[0], grid):
        got[at] = res[(grid, fmt, mode, "a2a", "f32")][0][0, 0]
    assert np.abs(got - want).max() <= 2e-5 * np.abs(want).max()


def test_the_body_raises_on_a_collective_it_never_waited(plans, golden):
    """A transport whose finish leaves its wire unwaited: the shard body
    raises at its end (the virtual mesh's handles count as well)."""
    from repro_torch.core import make_shard_body
    from repro_torch.core.collectives import all_to_all_start, open_handles
    from repro_torch.core.transport import A2ATransport, PendingExchange

    class Leaky(A2ATransport):
        name = "leaky"

        def start(self, x, F, *, state, n_node, g_pad):
            pending = super().start(x, F, state=state, n_node=n_node,
                                    g_pad=g_pad)
            all_to_all_start(x.new_zeros((1, n_node, 1, n_node, 1)))
            return PendingExchange(pending.finish)

    plan, layout = plans[(GRIDS[0], "ell", "rows")]
    body = make_shard_body(plan, transport=Leaky())
    before = open_handles()
    with pytest.raises(RuntimeError, match="never waited.*all-to-all"):
        body(to_dist(golden[1], layout, plan))
    assert open_handles() == before


def test_the_spawn_finishes_well_inside_its_timeout(ranks):
    assert len(ranks[0]) == GRIDS[0][0] * GRIDS[0][1]
    assert ranks[1] < SPAWN_TIMEOUT / 2


# ---------------------------------------------------------------------- #
# the CLIs: each mode's schedule and exposed wire, --modes alternated
# ---------------------------------------------------------------------- #
def test_dist_check_alternates_vector_and_task_bit_for_bit(capsys):
    from repro_torch.testing import dist_check

    assert dist_check.main(["--mesh", "process", "--device", "cpu",
                            "--n-node", "2", "--n-core", "2",
                            "--modes", "vector,task"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[-1] == "OK"
    sched = {ln.split()[1]: ln.split(" ", 2)[2] for ln in lines
             if ln.startswith("SCHEDULE ")}
    assert sched == {
        "vector": "issue exchange > wait exchange > issue gather x > "
                  "wait gather x > launch fused",
        "task": "issue exchange > issue gather x > wait gather x > "
                "launch diag > wait exchange > launch offd"}
    for ln in lines:
        if ln.startswith("WIRE "):
            f = ln.split()
            assert 0.0 <= float(f[5]) <= float(f[3])
    modes = next(ln for ln in lines if ln.startswith("MODES "))
    assert modes.endswith("BITWISE ok ok") and "SPMV_BITWISE ok" in modes


@pytest.mark.parametrize("argv,msg", [
    (["--modes", "vector,task"], "--modes needs --mesh process"),
    (["--mesh", "process", "--modes", "vector,balanced"], "balanced"),
    (["--mesh", "process", "--modes", "vector,bogus"], "distinct names")])
def test_dist_check_refuses_modes_it_cannot_alternate(argv, msg, capsys):
    from repro_torch.testing import dist_check

    with pytest.raises(SystemExit) as e:
        dist_check.main(["--device", "cpu", *argv])
    assert e.value.code == 2 and msg in capsys.readouterr().err


@pytest.mark.parametrize("mode", MODES)
def test_bench_spmv_reports_the_schedule_and_the_exposed_wire(mode,
                                                              capsys):
    import json

    from repro_torch.testing import bench_spmv

    assert bench_spmv.main(["--mesh", "process", "--device", "cpu",
                            "--n-node", "2", "--n-core", "2", "--mode",
                            mode, "--n-surface", "40", "--layers", "4",
                            "--iters", "3", "--reps", "1"]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    launch = [s for s in out["schedule"] if s.startswith("launch")]
    assert launch == (["launch fused"] if mode == "vector"
                      else ["launch diag", "launch offd"])
    for w, e in zip(out["wire_us_per_spmv_by_rank"],
                    out["exposed_us_per_spmv_by_rank"]):
        assert 0.0 <= e <= w
