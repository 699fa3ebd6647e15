"""The port's solve service against the JAX reference, on the CPU: the
plan cache, the continuous-batching engine, the request API and the two
serve CLIs.

The reference side runs in one ``tests/torch_reference.py --serve``
subprocess (8 host devices): fingerprints, ``to_dist_batch`` on a
non-uniform partition, ``make_solver(nrhs=3)`` counts on the golden
matrix, the reference engine serving ``tests/test_serve.py``'s queue
(``graded_extruded_mesh_matrix(16, 4)``, nrhs 3, check_every 5) at 1×1
and 2×2, and engine checkpoints crossing between the packages.

Tolerances:
  * fingerprints, batched layouts and splice survivors: exact (bytes);
  * iteration counts: ±1 of the reference's (``make_solver(nrhs=3)`` at
    tol 1e-5 and the engine's per-request counts), the f32 summation
    order being the only difference;
  * served solutions: the host f64 CG oracle within ``serve_check``'s
    ``BOUNDS`` (true residual 2e-4, solution 1e-2 for cg);
  * the CLIs run with ``--device cpu``.  ``serve_check`` gets
    ``--min-speedup 0``: six test workers share this CPU, so its makespan
    ratio says nothing here; the test reads its correctness, splice,
    recompile and cache verdicts.  The 1.05 gate is held on the card
    (``chip_smoke.py`` phase ``serve``).
"""
import json
import pathlib

import numpy as np
import pytest
import torch

from conftest import run_subprocess
from repro_torch.core import build_spmv_plan, from_dist, to_dist
from repro_torch.serve import (EngineConfig, PlanCache, SolveEngine,
                               SolveService, matrix_fingerprint)
from repro_torch.solvers import SolveFailure, make_solver
from repro_torch.solvers.base import from_dist_batch, to_dist_batch
from repro_torch.sparse import graded_extruded_mesh_matrix
from repro_torch.launch import serve as serve_cli
from repro_torch.testing import serve_check
from repro_torch.testing.refine_check import host_cg

HERE = pathlib.Path(__file__).resolve().parent
TOLS = (1e-5, 3e-5, 1e-4)       # torch_reference.SERVE_TOLS
KW = dict(check_every=5, maxiter=2000, maxiter_static=2000)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Tiny shapes: one intra-op thread is faster and leaves the cores to
    the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def A():
    return graded_extruded_mesh_matrix(16, 4, seed=0)   # n = 64


@pytest.fixture(scope="module")
def cache():
    return PlanCache()                  # shared: one build per program


def _cfg(**kw):
    kw.setdefault("nrhs", 3)
    for k, v in KW.items():
        kw.setdefault(k, v)
    return EngineConfig(**kw)


def _engine(A, cache, **kw):
    return SolveEngine(A, _cfg(**kw), device="cpu", cache=cache)


def _inflight_checkpoint(A, cache, path):
    """The reference's recipe: two RHS (``default_rng(11)``) on a 1×1 ell
    engine, one chunk, checkpoint."""
    e = _engine(A, cache, nrhs=2)
    B = np.random.default_rng(11).normal(size=(2, A.n_rows))
    e.submit(B[0], tol=1e-5)
    e.submit(B[1], tol=3e-5)
    assert e.step() == []               # mid-solve, nothing retired yet
    e.checkpoint(str(path))
    return B


@pytest.fixture(scope="module")
def reference(tmp_path_factory, A, cache):
    tmp = tmp_path_factory.mktemp("serve")
    port_ck, ref_ck = tmp / "port_ck", tmp / "ref_ck"
    _inflight_checkpoint(A, cache, port_ck)
    out = tmp / "serve.npz"
    res = run_subprocess([str(HERE / "torch_reference.py"), str(out),
                          "--serve", str(port_ck), str(ref_ck)],
                         device_count=8)
    assert res.returncode == 0, res.stderr[-4000:]
    with np.load(out) as d:
        ref = {k: d[k] for k in d.files}
    return ref, port_ck, ref_ck


# --------------------------------------------------------------------- #
# fingerprints and batched layouts
# --------------------------------------------------------------------- #
def test_fingerprint_is_the_reference_and_covers_values(A, reference):
    ref, _, _ = reference
    assert matrix_fingerprint(A) == str(ref["fingerprint/graded"])
    G = graded_extruded_mesh_matrix(48, 6, seed=0)
    assert matrix_fingerprint(G) == str(ref["fingerprint/golden"])
    A2 = graded_extruded_mesh_matrix(16, 4, seed=0)
    assert matrix_fingerprint(A2) == matrix_fingerprint(A)
    A2.data[0] += 1e-9                  # same pattern, new values -> miss
    assert matrix_fingerprint(A2) != matrix_fingerprint(A)


def test_dist_batch_bytes_are_the_reference_on_nonuniform_bounds(
        A, reference):
    ref, _, _ = reference
    plan, layout = build_spmv_plan(A, 2, 2, mode="balanced",
                                   node_partition="nnz", device="cpu")
    nb = np.asarray(layout["node_bounds"])
    assert len(set(np.diff(nb).tolist())) > 1, nb
    B = np.random.default_rng(1).normal(size=(3, A.n_rows))
    bd = to_dist_batch(B, layout, plan)
    assert bd.numpy().tobytes() == ref["dist_batch/bd"].tobytes()
    back = from_dist_batch(bd, layout, plan)
    assert back.tobytes() == ref["dist_batch/back"].tobytes()
    for c in range(3):
        assert bd[:, :, c].numpy().tobytes() == \
            to_dist(B[c], layout, plan).numpy().tobytes()
        assert back[c].tobytes() == from_dist(bd[:, :, c], layout,
                                              plan).tobytes()
    assert to_dist_batch(B, layout, plan, dtype=torch.float64).dtype == \
        torch.float64


@pytest.mark.parametrize("fmt", ["ell", "sell"])
def test_batched_solve_counts_within_one_of_the_reference(fmt, reference):
    ref, _, _ = reference
    G = graded_extruded_mesh_matrix(48, 6, seed=0)
    plan, layout = build_spmv_plan(G, 4, 2, mode="balanced",
                                   node_partition="nnz", format=fmt,
                                   device="cpu")
    B = np.random.default_rng(7).normal(size=(3, G.n_rows))
    _, iters, rel = make_solver(plan, nrhs=3, A=G, layout=layout)(
        to_dist_batch(B, layout, plan), tol=1e-5, maxiter=2000)
    want = ref[f"nrhs3/{fmt}/iters"]
    assert np.all(np.abs(iters.numpy() - want) <= 1), (iters, want)
    assert bool((rel <= 1e-5).all())


# --------------------------------------------------------------------- #
# splice bit-exactness: every solver x every format
# --------------------------------------------------------------------- #
def _x_traj(A, cache, *, solver, fmt, splice):
    """Serve 3 requests (slot 0's tol is loose, so it retires first); when
    ``splice``, a 4th request enters slot 0 mid-solve.  Returns per-chunk
    byte snapshots of every slot's x column plus the per-request
    iteration counts."""
    e = _engine(A, cache, solver=solver, format=fmt)
    rng = np.random.default_rng(7)
    B = rng.normal(size=(4, A.n_rows))
    for i, tol in enumerate((2e-2, 1e-5, 3e-5)):
        e.submit(B[i], tol=tol)
    snaps, iters, added = [], {}, False
    while not e.idle():
        for rec in e.step():
            iters[rec.request.rid] = rec.iterations
            assert rec.converged
        if splice and iters and not added:
            e.submit(B[3], tol=1e-5)
            added = True
        x = e._state["x"].numpy()
        snaps.append([x[j].tobytes() for j in range(3)])
    if splice:
        assert added and 3 in iters     # the spliced request retired too
    return snaps, iters


@pytest.mark.parametrize("fmt", ["ell", "sell"])
@pytest.mark.parametrize("solver", ["cg", "chebyshev", "pipelined_cg"])
def test_splice_leaves_survivors_bitwise_unchanged(A, cache, solver, fmt):
    base, it_base = _x_traj(A, cache, solver=solver, fmt=fmt, splice=False)
    spl, it_spl = _x_traj(A, cache, solver=solver, fmt=fmt, splice=True)
    assert min(len(base), len(spl)) > 1
    # survivors (slots 1, 2) follow the identical per-chunk trajectory
    for c in range(min(len(base), len(spl))):
        for j in (1, 2):
            assert base[c][j] == spl[c][j], (solver, fmt, c, j)
    # and retire at the identical iteration count
    for rid in (0, 1, 2):
        assert it_base[rid] == it_spl[rid], (solver, fmt, rid)


# --------------------------------------------------------------------- #
# engine end-to-end: oracle and the reference engine's counts
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("grid", [(1, 1), (2, 2)], ids=["1x1", "2x2"])
def test_engine_serves_queue_against_oracle_and_reference(A, cache, grid,
                                                          reference):
    ref, _, _ = reference
    n_node, n_core = grid
    svc = SolveService(A, _cfg(n_node=n_node, n_core=n_core), cache=cache,
                       device="cpu")
    B = np.random.default_rng(3).normal(size=(9, A.n_rows))
    futs = [svc.submit(B[i], tol=TOLS[i % 3]) for i in range(9)]
    results = svc.drain()
    assert len(results) == 9
    tr_max, dx_max = serve_check.BOUNDS["cg"]
    want = ref[f"engine/{n_node}x{n_core}/iters"]
    for i, f in enumerate(futs):
        r = f.result()
        xh = host_cg(A, B[i], tol=1e-10, maxiter=20_000)
        assert np.linalg.norm(r.x - xh) / np.linalg.norm(xh) < dx_max
        assert r.residual < tr_max
        assert abs(r.iterations - int(want[i])) <= 1, (i, r.iterations,
                                                       want[i])
        assert r.solve_s >= 0 and r.queue_s >= 0
        np.testing.assert_allclose(
            r.x, ref[f"engine/{n_node}x{n_core}/x"][i],
            atol=1e-3 * np.abs(xh).max())
    st = svc.stats()
    assert st["splices"] >= 9 and st["failed"] == 0
    assert st["recompiles"] == 0
    assert st["executables"] == {"plan": 1, "programs": 1,
                                 "kernel_library": 0}


# --------------------------------------------------------------------- #
# admission policy and config validation
# --------------------------------------------------------------------- #
def test_config_validation_lists_registered_names():
    with pytest.raises(ValueError, match=r"unknown solver 'qmr'.*cg"):
        _cfg(solver="qmr").validate()
    with pytest.raises(ValueError, match="unknown precond"):
        _cfg(precond="ilu0").validate()
    with pytest.raises(ValueError, match=r"unknown format.*ell"):
        _cfg(format="bsr").validate()
    with pytest.raises(ValueError, match="unknown transport"):
        _cfg(transport="nccl").validate()
    with pytest.raises(ValueError, match="unknown wire_dtype"):
        _cfg(wire_dtype="f8").validate()
    with pytest.raises(ValueError, match=r"unknown backend 'jnp'.*kernel"):
        _cfg(backend="jnp").validate()
    with pytest.raises(ValueError, match="nrhs"):
        _cfg(nrhs=0).validate()
    with pytest.raises(ValueError, match="nrhs must be <= 16"):
        _cfg(nrhs=17).validate()
    with pytest.raises(ValueError, match="check_every"):
        _cfg(check_every=-1).validate()
    with pytest.raises(ValueError, match="default_tol"):
        _cfg(default_tol=0.0).validate()
    with pytest.raises(ValueError, match="batch_fill_timeout_s"):
        _cfg(batch_fill_timeout_s=-1.0).validate()
    assert EngineConfig().backend == "kernel"


def test_submit_rejects_malformed_and_full_queue(A, cache):
    e = _engine(A, cache, max_queue=2)
    b = np.ones(A.n_rows)
    with pytest.raises(ValueError, match="shape"):
        e.submit(np.ones(A.n_rows + 1))
    with pytest.raises(ValueError, match="tol"):
        e.submit(b, tol=-1e-5)
    with pytest.raises(ValueError, match="deadline"):
        e.submit(b, tol=1e-5, deadline_s=0.0)
    e.submit(b)
    e.submit(b)
    with pytest.raises(SolveFailure) as ei:
        e.submit(b)
    assert ei.value.reason == "queue_full"
    assert e.counters["submitted"] == 2


def test_deadline_eviction_keeps_serving(A, cache):
    svc = SolveService(A, _cfg(), cache=cache, device="cpu")
    rng = np.random.default_rng(5)
    doomed = svc.submit(rng.normal(size=A.n_rows), tol=1e-30,
                        deadline_s=1e-6)
    healthy = svc.submit(rng.normal(size=A.n_rows), tol=1e-4)
    results = svc.drain()
    with pytest.raises(SolveFailure) as ei:
        doomed.result()
    assert ei.value.reason == "deadline"
    assert [r.request_id for r in results] == [healthy.request_id]
    st = svc.stats()
    assert st["evicted"] == 1 and st["retired"] == 1
    assert st["recompiles"] == 0        # eviction re-bases, no rebuild


def test_maxiter_fails_as_a_result(A, cache):
    svc = SolveService(A, _cfg(maxiter=5), cache=cache, device="cpu")
    fut = svc.submit(np.random.default_rng(6).normal(size=A.n_rows),
                     tol=1e-30)
    assert svc.drain() == []
    with pytest.raises(SolveFailure) as ei:
        fut.result()
    assert ei.value.reason == "maxiter" and ei.value.iteration == 5


# --------------------------------------------------------------------- #
# the plan/program cache
# --------------------------------------------------------------------- #
def test_cache_hits_and_keying(A, cache):
    SolveEngine(A, _cfg(), device="cpu", cache=cache)   # warm this key
    before = cache.stats.as_dict()
    SolveEngine(A, _cfg(), device="cpu", cache=cache)
    mid = cache.stats.as_dict()
    assert mid["plan_hits"] == before["plan_hits"] + 1
    assert mid["program_hits"] == before["program_hits"] + 1
    assert mid["compile_s"] == before["compile_s"]
    SolveEngine(A, _cfg(nrhs=4), device="cpu", cache=cache)  # program key
    after = cache.stats.as_dict()
    assert after["plan_hits"] == mid["plan_hits"] + 1
    assert after["program_misses"] == mid["program_misses"] + 1
    assert after["compile_s"] > mid["compile_s"]
    key = cache.plan_key(A, n_node=1, n_core=1, device="cpu")
    assert key.device == "cpu" and key.node_partition == "nnz"
    assert key != cache.plan_key(A, n_node=1, n_core=1, device="cuda")
    assert key != cache.plan_key(A, n_node=1, n_core=1, device="cpu",
                                 format="sell")


# --------------------------------------------------------------------- #
# checkpoint / warm restore, within the port and across the packages
# --------------------------------------------------------------------- #
def _drain_sorted(e):
    recs = e.drain()
    assert all(r.converged for r in recs)
    return sorted(recs, key=lambda r: r.request.rid)


def test_checkpoint_restore_resumes_inflight(A, cache, tmp_path):
    B = _inflight_checkpoint(A, cache, tmp_path)
    # restore on a DIFFERENT layout: sell format, fresh engine
    e2 = _engine(A, cache, nrhs=2, format="sell")
    restored = e2.restore(str(tmp_path))
    assert sorted(r.rid for r in restored) == [0, 1]
    assert all(r.resumed for r in restored)
    recs = _drain_sorted(e2)
    assert len(recs) == 2
    for rec in recs:
        xh = host_cg(A, B[rec.request.rid], tol=1e-10, maxiter=20_000)
        assert np.linalg.norm(rec.x - xh) / np.linalg.norm(xh) < 1e-2
    # restore refuses a busy engine and a mismatched batch shape
    e2.submit(B[0])
    with pytest.raises(RuntimeError, match="busy"):
        e2.restore(str(tmp_path))
    e3 = _engine(A, cache, nrhs=3)
    with pytest.raises(ValueError, match="shape"):    # load's leaf check
        e3.restore(str(tmp_path))


def test_checkpoints_cross_between_the_packages(A, cache, reference):
    """The reference engine's checkpoint resumes on the port, and the
    port's on the reference: each converges, each count within ±1 of the
    package's own resume from its own checkpoint."""
    ref, port_ck, ref_ck = reference
    B = np.random.default_rng(11).normal(size=(2, A.n_rows))
    own = _engine(A, cache, nrhs=2, format="sell")
    own.restore(str(port_ck))
    own_iters = [r.iterations for r in _drain_sorted(own)]
    e = _engine(A, cache, nrhs=2, format="sell")
    assert sorted(r.rid for r in e.restore(str(ref_ck))) == [0, 1]
    recs = _drain_sorted(e)
    assert np.all(np.abs(np.asarray([r.iterations for r in recs])
                         - ref["resume_ref/iters"]) <= 1)
    for rec in recs:
        xh = host_cg(A, B[rec.request.rid], tol=1e-10, maxiter=20_000)
        assert np.linalg.norm(rec.x - xh) / np.linalg.norm(xh) < 1e-2
        assert rec.residual < serve_check.BOUNDS["cg"][0]
    assert ref["resume_port/rids"].tolist() == [0, 1]
    assert np.all(np.abs(ref["resume_port/iters"] - np.asarray(own_iters))
                  <= 1)
    assert np.all(ref["resume_port/residual"] < serve_check.BOUNDS["cg"][0])


# --------------------------------------------------------------------- #
# the CLIs
# --------------------------------------------------------------------- #
def test_serve_check_cli_on_the_cpu(capsys):
    rc = serve_check.main(["--device", "cpu", "--min-speedup", "0"])
    lines = capsys.readouterr().out.strip().splitlines()
    verdicts = {ln.split()[0]: ln.split()[-1] for ln in lines[:-1]}
    assert set(verdicts) == {"SERVED", "ORACLE", "SPLICES", "MAKESPAN",
                             "RECOMPILES", "CACHE"}
    for name in ("SERVED", "ORACLE", "SPLICES", "RECOMPILES", "CACHE"):
        assert verdicts[name] == "ok", lines
    assert rc == 0 and lines[-1] == "OK"


def test_launch_serve_cli_on_the_cpu(capsys):
    rc = serve_cli.main(["--device", "cpu", "--n-node", "2", "--n-core",
                         "2", "--requests", "8", "--tol-spread",
                         "--oracle"])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc == 0
    assert out["device"] == "cpu"
    assert out["served"] == out["converged"] == 8
    assert out["recompiles"] == 0 and out["failed"] == 0
    assert out["splices"] >= 8
    assert out["worst_oracle_err"] < serve_check.BOUNDS["cg"][1]
