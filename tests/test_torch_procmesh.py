"""The process mesh against the virtual mesh, on gloo on the CPU.

One process per ``(node, core)`` shard (``repro_torch.launch.mesh``),
each holding only its shard of the plan (``read_plan`` ->
``plan_from_arrays(..., mesh=)``), against the same plan on the virtual
mesh in this process.  The virtual mesh is held to the reference's dumped
ghosts and counts by ``tests/test_torch_transports.py`` and
``tests/test_torch_solvers.py``, so these hold the process mesh to the
reference too.  Plans: the golden ``graded_extruded_mesh_matrix(48, 6)``
at 4x2 (ell and sell), ``extruded_mesh_matrix(48, 6)`` at 2x2 (sell,
equal rows per node: its shards' slices differ in width, so the CPU's
plain SELL sums each shard padded to its whole plan's widest slice,
``plain_pad``) and the golden matrix at 1x4 (ell, halo-free).

Tolerances: ghosts (real slots) and SpMV ``y`` bit for bit, every
transport x wire dtype; each rank's recorded census equal to the
transport's ``predicted_cost`` plus the shard body's one ``all_gather``;
solver iterations within ±1 of the virtual mesh's and equal on every
rank, at tol 3e-6, and (``psum`` gathers the partials and sums them as the
virtual mesh does) iterates bit for bit.  Every solver x preconditioner x
nrhs (1, 3) runs on the 4x2 golden plans (ell and sell between them) and
on the 2x2 and 1x4 plans.  Chebyshev's count at 3e-6 is its a-priori
budget, set by its bounds alone (994 with jacobi here), so it runs capped
at 64 iterations on both meshes, where its iterates are held bit for bit.

Three spawns, each with a timeout: 8 ranks (4x2), 4 ranks (2x2, then a
1x4 mesh over the same process group), and 2 ranks for the launcher's
failure path.  The children get no jax compatibility shim (nothing they
import needs jax).
"""
import os
import signal
import time

import numpy as np
import pytest
import torch

from repro_torch.core import (available_transports, available_wire_dtypes,
                              build_spmv_plan, make_exchange, make_spmv,
                              resolve_transport, to_dist)
from repro_torch.core.collectives import census, record_collectives
from repro_torch.core.spmv import shard_plan
from repro_torch.core.transport import FaultyTransport
from repro_torch.launch.mesh import (CGMesh, make_cg_mesh, read_plan,
                                     spawn_cg_mesh, write_plan)
from repro_torch.solvers import (make_solver, reduction_census,
                                 to_dist_batch)
from repro_torch.sparse import extruded_mesh_matrix, graded_extruded_mesh_matrix

SPAWN_TIMEOUT = 120.0
TOL = 3e-6
SOLVERS = ("cg", "pipelined_cg", "chebyshev")
PRECONDS = ("jacobi", "block_jacobi")
NRHS = (1, 3)
MAXITER = {"chebyshev": 64}
#: case -> (matrix, n_node, n_core, format, plan options)
CASES = {"ell/4x2": ("golden", 4, 2, "ell", {}),
         "sell/4x2": ("golden", 4, 2, "sell", {}),
         "sell/2x2": ("uniform", 2, 2, "sell", {"node_partition": "rows"}),
         "ell/1x4": ("golden", 1, 4, "ell", {})}
HALO = ("ell/4x2", "sell/4x2", "sell/2x2")
EXCHANGES = [(c, t, w) for c in HALO for t in ("a2a", "hier", "pairwise",
                                               "ring")
             for w in ("bf16", "f32", "int8")]
#: the 4x2 plans split the solver x preconditioner x nrhs product between
#: them (8 ranks cost the most per reduction); the others run all of it
SPLIT = {"ell/4x2": (("jacobi", 1), ("block_jacobi", 3)),
         "sell/4x2": (("block_jacobi", 1), ("jacobi", 3))}
SOLVES = [(c, s, p, k) for c in CASES for s in SOLVERS for p in PRECONDS
          for k in NRHS if (p, k) in SPLIT.get(c, ((p, k),))]
RANKS_OF = {8: ("ell/4x2", "sell/4x2"), 4: ("sell/2x2", "ell/1x4")}


def _matrix(name):
    if name == "golden":
        return graded_extruded_mesh_matrix(48, 6, seed=0)
    return extruded_mesh_matrix(48, 6, seed=0)


def _row(a, mesh):
    """This rank's shard of a whole ``(n_node, n_core, ...)`` array."""
    return torch.from_numpy(np.array(
        a[mesh.node:mesh.node + 1, mesh.core:mesh.core + 1]))


def _solve_kw(case, s, p, k):
    kw = dict(solver=s, precond=p, A=case["A"], layout=case["layout"],
              nrhs=None if k == 1 else k)
    if s == "chebyshev":        # the bounds the virtual mesh estimated
        kw["options"] = case["cheb"][p]
    return kw


def _solve_rhs(case, k):
    return case["b"] if k == 1 else case["B"]


# ---------------------------------------------------------------------- #
# what each rank runs
# ---------------------------------------------------------------------- #
def _rank_case(mesh, case):
    plan = read_plan(case["dir"], mesh)
    out = {"shapes": {k: tuple(v.shape) for k, v in plan.fmt_data.items()},
           "x_gather": tuple(plan.x_gather.shape), "ex": {}, "solve": {}}
    x = _row(case["x"], mesh)
    for wd in available_wire_dtypes():
        for name in available_transports():
            with record_collectives() as log:
                y = make_spmv(plan, transport=name, wire_dtype=wd)(x)
            ghost = (make_exchange(plan, name, wire_dtype=wd)(x).numpy()
                     if plan.hs else None)
            out["ex"][(name, wd)] = (ghost, y.numpy(), census(log))
    if plan.hs:
        out["faulty"] = make_exchange(plan, FaultyTransport())(x).numpy()
    for _, s, p, k in (t for t in SOLVES if t[0] == case["key"]):
        solve = make_solver(plan, **_solve_kw(case, s, p, k))
        xs, iters, _ = solve(_row(_solve_rhs(case, k), mesh), tol=TOL,
                             maxiter=MAXITER.get(s, 400))
        out["solve"][(s, p, k)] = (np.atleast_1d(iters.numpy()).tolist(),
                                   xs.numpy())
    out["reductions"] = reduction_census(make_solver(plan),
                                         _row(case["b"], mesh))
    ran = {}
    for what, run in (
            ("two_level", lambda: int(make_solver(
                plan, precond="two_level", A=case["A"],
                layout=case["layout"])(_row(case["b"], mesh), tol=TOL,
                                       maxiter=400)[1])),
            ("auto", lambda: make_spmv(plan, transport="auto").transport),
            ("resilient", lambda: __import__(
                "repro_torch.solvers.resilient",
                fromlist=["make_resilient"]).make_resilient(
                    plan).transport)):
        try:
            ran[what] = (None, run())
        except ValueError as e:
            ran[what] = (str(e), None)
    out["ran"] = ran
    return out


def _rank(mesh, cases):
    out = {key: _rank_case(mesh, cases[key])
           for key in RANKS_OF[mesh.world_size] if key in cases
           and CASES[key][1:3] == (mesh.n_node, mesh.n_core)}
    if mesh.world_size == 4:        # a second mesh over the same group
        mesh14 = make_cg_mesh(1, 4, device=mesh.device, backend="gloo",
                              rank=mesh.rank, world_size=4)
        out["ell/1x4"] = _rank_case(mesh14, cases["ell/1x4"])
    return out


def _rank_fails(mesh):
    if mesh.rank == 1:
        raise RuntimeError("rank 1 fails on purpose")
    time.sleep(60)          # the launcher must kill this rank


def _rank_preempted(mesh):
    """Rank 1 raises as a peer of a preempted rank might; rank 0 is
    SIGKILLed a moment later (a preemption)."""
    if mesh.rank == 1:
        raise RuntimeError("a peer went away")
    time.sleep(0.5)
    os.kill(os.getpid(), signal.SIGKILL)


# ---------------------------------------------------------------------- #
# the virtual mesh and the spawns
# ---------------------------------------------------------------------- #
@pytest.fixture(scope="module")
def cases(tmp_path_factory):
    mats = {"golden": _matrix("golden"), "uniform": _matrix("uniform")}
    rng = np.random.default_rng(7)
    out = {}
    for key, (mat, n_node, n_core, fmt, kw) in CASES.items():
        A = mats[mat]
        plan, layout = build_spmv_plan(A, n_node, n_core, mode="balanced",
                                       format=fmt, device="cpu", **kw)
        d = tmp_path_factory.mktemp(key.replace("/", "_"))
        write_plan(plan, d)
        x = to_dist(rng.standard_normal(A.n_rows), layout, plan).numpy()
        b = to_dist(rng.standard_normal(A.n_rows).astype(np.float32),
                    layout, plan).numpy()
        B = to_dist_batch(rng.standard_normal((3, A.n_rows)), layout,
                          plan).numpy()
        case = {"key": key, "dir": str(d), "x": x, "b": b, "B": B, "A": A,
                "layout": layout, "plan": plan}
        case["cheb"] = {p: make_solver(plan, solver="chebyshev", precond=p,
                                       A=A, layout=layout).options
                        for p in PRECONDS}
        out[key] = case
    return out


@pytest.fixture(scope="module")
def virtual(cases):
    """Every result of the ranks, on the virtual mesh."""
    out = {}
    for key, case in cases.items():
        plan, x = case["plan"], torch.from_numpy(case["x"])
        res = {"ex": {}, "solve": {}, "pred": {}}
        for wd in available_wire_dtypes():
            for name in available_transports():
                y = make_spmv(plan, transport=name, wire_dtype=wd)(x)
                ghost = (make_exchange(plan, name, wire_dtype=wd)(x).numpy()
                         if plan.hs else None)
                res["ex"][(name, wd)] = (ghost, y.numpy())
                tr, st = resolve_transport(name, plan, wire_dtype=wd)
                res["pred"][(name, wd)] = tr.predicted_cost(plan, st)
        for _, s, p, k in (t for t in SOLVES if t[0] == key):
            solve = make_solver(plan, **_solve_kw(case, s, p, k))
            xs, iters, _ = solve(torch.from_numpy(_solve_rhs(case, k)),
                                 tol=TOL, maxiter=MAXITER.get(s, 400))
            res["solve"][(s, p, k)] = (
                np.atleast_1d(iters.numpy()).tolist(), xs.numpy())
        out[key] = res
    return out


@pytest.fixture(scope="module")
def ranks(cases, monkeypatch_module):
    """Each case's per-rank results, from two spawns (8 and 4 ranks)."""
    # the children import no jax: leave the test-only shim out of their
    # start-up
    shim = os.path.join("tests", "_jaxcompat")
    path = [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep)
            if p and not p.rstrip("/").endswith(shim)]
    monkeypatch_module.setenv("PYTHONPATH", os.pathsep.join(path))
    send = {k: {f: v for f, v in c.items() if f != "plan"}
            for k, c in cases.items()}
    out, seconds = {}, {}
    for world, (n_node, n_core) in ((8, (4, 2)), (4, (2, 2))):
        t0 = time.perf_counter()
        res = spawn_cg_mesh(_rank, n_node, n_core, "cpu", args=(send,),
                            timeout=SPAWN_TIMEOUT)
        seconds[world] = time.perf_counter() - t0
        for key in res[0]:
            out[key] = [r[key] for r in res]
    out["seconds"] = seconds
    out["two_level_virtual"] = {
        key: int(make_solver(c["plan"], precond="two_level", A=c["A"],
                             layout=c["layout"])(
            torch.from_numpy(c["b"]), tol=TOL, maxiter=400)[1])
        for key, c in cases.items()}
    return out


@pytest.fixture(scope="module")
def monkeypatch_module():
    mp = pytest.MonkeyPatch()
    yield mp
    mp.undo()


def _shard(a, key, r):
    """Rank ``r``'s row of a whole ``(n_node, n_core, ...)`` array."""
    n, c = divmod(r, CASES[key][2])
    return a[n, c]


def _bits(a):
    return np.ascontiguousarray(a).view(np.int32)


# ---------------------------------------------------------------------- #
# the exchange and the SpMV
# ---------------------------------------------------------------------- #
@pytest.mark.parametrize("key,name,wd", EXCHANGES)
def test_every_ranks_ghosts_are_its_row_of_the_virtual_mesh(
        key, name, wd, cases, virtual, ranks):
    g = cases[key]["plan"].g_pad
    want = virtual[key]["ex"][(name, wd)][0]
    for r, res in enumerate(ranks[key]):
        ghost = res["ex"][(name, wd)][0]
        assert ghost.shape == (1, 1, g + 1)
        assert np.array_equal(_bits(ghost[0, 0, :g]),
                              _bits(_shard(want, key, r)[:g])), r


@pytest.mark.parametrize("key,name,wd", EXCHANGES)
def test_every_ranks_census_is_the_predicted_cost(key, name, wd, virtual,
                                                  ranks):
    """Plus the one core-axis ``all_gather`` of the shard body's ``x``
    assembly, as on the virtual mesh."""
    pred = virtual[key]["pred"][(name, wd)]
    for res in ranks[key]:
        got = res["ex"][(name, wd)][2]
        assert got["all-to-all"] == pred["all-to-all"]
        assert got["collective-permute"] == pred["collective-permute"]
        assert got["all-gather"] == pred["all-gather"] + 1
        assert got["all-reduce"] == 0


@pytest.mark.parametrize("key", sorted(CASES))
def test_spmv_is_bit_for_bit_the_virtual_mesh_for_every_exchange(
        key, virtual, ranks):
    for (name, wd), (_, want, _) in ((k, v + (None,)) for k, v in
                                     virtual[key]["ex"].items()):
        for r, res in enumerate(ranks[key]):
            y = res["ex"][(name, wd)][1]
            assert y.shape == (1, 1, want.shape[-1])
            assert np.array_equal(_bits(y[0, 0]),
                                  _bits(_shard(want, key, r))), (name, wd, r)


@pytest.mark.parametrize("key", HALO)
def test_faulty_transport_fails_on_the_process_mesh(key, cases, virtual,
                                                    ranks):
    g = cases[key]["plan"].g_pad
    want = virtual[key]["ex"][("a2a", "f32")][0]
    assert not all(
        np.array_equal(_bits(res["faulty"][0, 0, :g]),
                       _bits(_shard(want, key, r)[:g]))
        for r, res in enumerate(ranks[key]))


@pytest.mark.parametrize("key", sorted(CASES))
def test_ranks_hold_only_their_shard(key, cases, ranks):
    plan = cases[key]["plan"]
    for res in ranks[key]:
        assert res["x_gather"] == (1, 1, plan.nl_pad)
        for name, shape in res["shapes"].items():
            assert shape[:2] == (1, 1)
            assert shape[2:] == tuple(plan.fmt_data[name].shape[2:])


# ---------------------------------------------------------------------- #
# the solvers
# ---------------------------------------------------------------------- #
@pytest.mark.parametrize("key,solver,precond,nrhs", SOLVES)
def test_solver_iterations_match_the_virtual_mesh_on_every_rank(
        key, solver, precond, nrhs, virtual, ranks):
    want, _ = virtual[key]["solve"][(solver, precond, nrhs)]
    got = [res["solve"][(solver, precond, nrhs)][0] for res in ranks[key]]
    assert all(g == got[0] for g in got), got       # every rank alike
    assert len(got[0]) == nrhs
    assert all(abs(a - b) <= 1 for a, b in zip(got[0], want)), (got[0],
                                                                 want)


@pytest.mark.parametrize("key,solver,precond,nrhs", SOLVES)
def test_iterates_are_bit_for_bit_the_virtual_meshs(key, solver, precond,
                                                    nrhs, virtual, ranks):
    """``psum`` sums the gathered partials in shard order, as the virtual
    mesh does, so on the CPU every iterate is the same bits."""
    _, want = virtual[key]["solve"][(solver, precond, nrhs)]
    for r, res in enumerate(ranks[key]):
        x = res["solve"][(solver, precond, nrhs)][1]
        assert x.shape[:2] == (1, 1)
        assert np.array_equal(_bits(x[0, 0]), _bits(_shard(want, key, r)))


@pytest.mark.parametrize("key", sorted(CASES))
def test_cg_loop_body_issues_two_reductions(key, ranks):
    assert [res["reductions"] for res in ranks[key]] == [2] * len(
        ranks[key])


@pytest.mark.parametrize("what,words", [
    ("two_level", "two_level is not offered on a process mesh"),
    ("auto", "transport='auto' is not offered on a process mesh"),
    ("resilient", "resilient driver runs on the virtual mesh only")])
def test_virtual_only_entry_points_refuse_a_rank_local_plan(what, words,
                                                            ranks):
    """These entry points once refused a rank-local plan with ``words``;
    each now runs on every rank of every case, and every rank gets the
    same result: two_level cg's iterations (equal to the virtual mesh's),
    ``auto``'s winner, the resilient driver's transport."""
    for key in CASES:
        got = [res["ran"][what] for res in ranks[key]]
        errors = [err for err, _ in got if err is not None]
        assert not errors, (key, what, errors[0])
        assert all(v == got[0][1] for _, v in got), (key, what, got)
        if what == "two_level":
            assert got[0][1] == ranks["two_level_virtual"][key], key


def test_spawns_finish_well_inside_their_timeout(ranks):
    assert max(ranks["seconds"].values()) < SPAWN_TIMEOUT / 2, ranks[
        "seconds"]


# ---------------------------------------------------------------------- #
# the mesh and the launcher
# ---------------------------------------------------------------------- #
# NCCL runs one rank per card; this machine has none
_NO_CARDS = r"4 rank\(s\) need 4 card\(s\), and this host has 0 present"


@pytest.mark.parametrize("device,words", [
    ("cuda", _NO_CARDS + r" \(NCCL"),
    ("cpu", _NO_CARDS + r"; device 'cpu' is not a card")])
def test_make_cg_mesh_refuses_nccl_without_a_card_per_rank(device, words):
    import torch.distributed as dist

    with pytest.raises(ValueError, match=words):
        make_cg_mesh(2, 2, device=device, backend="nccl", rank=0,
                     world_size=4, init_method="file:///nonexistent")
    assert not dist.is_initialized()        # refused before any group


@pytest.mark.parametrize("grid,kw,words", [
    ((2, 2), dict(device="cuda", rank=0),
     r"4 rank\(s\) need 4 card\(s\), and this host has 2 present"),
    ((2, 1), dict(device="cpu", rank=0), "device 'cpu' is not a card"),
    ((2, 1), dict(device="cuda:0", rank=1),
     "NCCL rank 1 runs on cuda:1, not cuda:0")])
def test_make_cg_mesh_binds_each_nccl_rank_to_its_own_card(grid, kw, words,
                                                          monkeypatch):
    """With two cards present: four ranks are refused, a CPU device is
    refused, and rank r runs on cuda:r and no other card."""
    import torch.distributed as dist

    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    with pytest.raises(ValueError, match=words):
        make_cg_mesh(*grid, backend="nccl", world_size=grid[0] * grid[1],
                     init_method="file:///nonexistent", **kw)
    assert not dist.is_initialized()


def _never(mesh):
    raise AssertionError("a refused spawn ran a rank")


@pytest.mark.parametrize("device,backend,words", [
    ("cuda", "nccl", _NO_CARDS),
    ("cpu", "nccl", _NO_CARDS + r"; device 'cpu' is not a card"),
    ("cpu", "mpi", "backend must be one of")])
def test_spawn_cg_mesh_refuses_before_any_process_starts(device, backend,
                                                         words, monkeypatch):
    import torch.multiprocessing as mp

    started = []
    monkeypatch.setattr(mp, "start_processes",
                        lambda *a, **k: started.append(a))
    with pytest.raises(ValueError, match=words):
        spawn_cg_mesh(_never, 2, 2, device, backend=backend)
    assert not started


@pytest.mark.parametrize("kw,words", [
    (dict(backend="mpi", rank=0, world_size=4), "backend must be one of"),
    (dict(backend="gloo", rank=0, world_size=3), "world_size 3"),
    (dict(backend="gloo", rank=4, world_size=4), "rank must be in")])
def test_make_cg_mesh_refuses_inconsistent_process_arguments(kw, words):
    with pytest.raises(ValueError, match=words):
        make_cg_mesh(2, 2, device="cpu", init_method="file:///x", **kw)


def test_make_cg_mesh_without_process_arguments_is_the_virtual_mesh():
    mesh = make_cg_mesh(4, 2, device="cpu")
    assert not mesh.is_process and mesh.shard_shape == (4, 2)
    assert mesh.node is None and mesh.node_group is None


def test_shard_plan_refuses_the_virtual_mesh(cases):
    with pytest.raises(ValueError, match="process mesh"):
        shard_plan(cases["ell/4x2"]["plan"], make_cg_mesh(4, 2,
                                                          device="cpu"))


@pytest.mark.parametrize("key", sorted(CASES))
def test_shard_plan_cuts_every_array_to_one_rank(key, cases):
    """No collective is needed to cut a plan: a rank's fields are its rows
    of the whole plan's, its meta the whole plan's."""
    plan = cases[key]["plan"]
    _, n_node, n_core = CASES[key][:3]
    node, core = n_node - 1, n_core - 1
    mesh = CGMesh(n_node, n_core, torch.device("cpu"), "gloo", node, core)
    part = shard_plan(plan, mesh)
    assert part.is_rank_local and part.shard_shape == (1, 1)
    assert part.cg_shape == (1, 1, plan.rc_pad)
    for name, a in plan.fmt_data.items():
        assert torch.equal(part.fmt_data[name][0, 0], a[node, core]), name
    for name in ("send_own", "recv_own", "x_gather", "diag_a", "mask"):
        assert torch.equal(getattr(part, name)[0, 0],
                           getattr(plan, name)[node, core]), name
    assert torch.equal(part.recv_node[0], plan.recv_own[node])
    assert (part.n_node, part.n_core, part.g_pad, part.hs) == (
        plan.n_node, plan.n_core, plan.g_pad, plan.hs)


def test_a_failing_rank_ends_the_spawn_and_names_its_error(
        monkeypatch_module):
    t0 = time.perf_counter()
    with pytest.raises(Exception, match="rank 1 fails on purpose"):
        spawn_cg_mesh(_rank_fails, 1, 2, "cpu", timeout=SPAWN_TIMEOUT)
    assert time.perf_counter() - t0 < 45.0


def test_a_sigkilled_rank_is_reported_as_killed_over_a_peers_error(
        monkeypatch_module):
    """Whichever the launcher sees first, a SIGKILL among the ranks makes
    the spawn end in ``RanksKilled`` with every exit code."""
    from repro_torch.launch.mesh import RanksKilled

    with pytest.raises(RanksKilled) as e:
        spawn_cg_mesh(_rank_preempted, 1, 2, "cpu", timeout=SPAWN_TIMEOUT)
    assert e.value.exitcodes == [-signal.SIGKILL, 1]


# ---------------------------------------------------------------------- #
# ROADMAP C: a plan whose column indices exceed x is refused
# ---------------------------------------------------------------------- #
@pytest.mark.parametrize("key,field", [("ell/4x2", "diag_cols"),
                                       ("ell/4x2", "offd_cols"),
                                       ("sell/4x2", "sell_dcols"),
                                       ("sell/4x2", "sell_ocols")])
def test_a_plan_wider_than_its_x_is_refused_before_any_launch(key, field,
                                                              cases):
    plan, _ = build_spmv_plan(_matrix("golden"), 4, 2, mode="balanced",
                              format=key.split("/")[0], device="cpu")
    cols = plan.fmt_data[field]
    width = plan.nl_pad if field in ("diag_cols", "sell_dcols") \
        else plan.g_pad + 1
    make_spmv(plan)                     # as built: accepted
    cols.view(-1)[-1] = width           # one index past the buffer
    with pytest.raises(ValueError, match=f"{field}.*holds {width} entries"):
        make_spmv(plan)
