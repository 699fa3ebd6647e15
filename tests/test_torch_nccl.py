"""The NCCL mesh's two halves, rehearsed on gloo on the CPU.

An NCCL mesh (``repro_torch.launch.mesh``, one rank per card) moves its
collectives card to card and its host control through a gloo side group.
This machine has no card, so each half is held here on gloo ranks:

* **host control** goes through ``CGMesh.control``: on a gloo mesh the
  world itself (every ``agree`` / ``allgather`` / ``gather_rows`` /
  ``barrier`` passes it as its group), and over a separate gloo group, as
  on an NCCL mesh, it gives the same objects;
* **the on-card wire** (``core/collectives.py``'s ``_OnCard``: payloads as
  raw bytes in the device's own memory, ``all_gather_into_tensor``, no
  staging and no sync) run over the same gloo groups, on CPU tensors, by a
  mesh that names itself ``nccl``: every transport x wire dtype's ghosts
  and ``y``, and cg's iterations and iterates, bit for bit the gloo
  wire's, with the same ``WIRE`` calls, bytes and kinds.  Its CUDA-event
  marks are host clocks here.

The same holds for the wire's issue-now, wait-later form
(``all_to_all_start`` / ``ppermute_start`` / ``all_gather_start``, the
overlapped schedule's calls), on both wires: a pending handle, waited
after local work, delivers the synchronous call's bytes; ``WIRE``'s
``exposed`` stays within each call's seconds; and a shard body that
leaves a handle unwaited raises at its end.

``WIRE`` itself (events read when it is read) is held without a spawn.
The card half, NCCL between real cards, is ``tests/test_torch_cuda.py``'s
(marked ``cuda``).  One spawn of 4 ranks (2x2); the children get no jax
compatibility shim.
"""
import dataclasses
import os
import tempfile
import time

import numpy as np
import pytest
import torch

from repro_torch.core import build_spmv_plan, to_dist
from repro_torch.core import collectives
from repro_torch.launch.mesh import spawn_cg_mesh, write_plan
from repro_torch.sparse import graded_extruded_mesh_matrix

SPAWN_TIMEOUT = 120.0
FORMATS = ("ell", "sell")
TRANSPORTS = ("a2a", "hier", "pairwise", "ring")
WIRES = ("bf16", "f32", "int8")
CONTROL_CALLS = ("broadcast_object_list", "all_gather_object",
                 "gather_object", "barrier")


class _HostMark:
    """A CUDA event's stand-in on the CPU: the host clock when made."""

    def __init__(self):
        self.t = time.perf_counter()

    def query(self):
        return True

    def synchronize(self):
        pass

    def elapsed_time(self, other):
        return (other.t - self.t) * 1e3


def _control(mesh) -> dict:
    """Every host-control call of ``mesh``: rank 0's object, every rank's,
    a host vector gathered to rank 0 and to all, then a barrier."""
    rows = np.arange(mesh.rank, 12, mesh.world_size)
    values = rows.astype(np.float32) * 0.5 + mesh.rank
    return {"agree": mesh.agree({"from": mesh.rank}),
            "allgather": mesh.allgather(mesh.rank * 10),
            "rows_0": mesh.gather_rows(values, rows, 12),
            "rows_all": mesh.gather_rows(values, rows, 12, to=None),
            "barrier": mesh.barrier()}


def _solve(mesh, plan_dirs, job) -> dict:
    """``mesh``'s ghosts, ``y`` and WIRE for every format x transport x
    wire dtype, then cg + jacobi: iterations and iterates."""
    from repro_torch.core import make_exchange, make_spmv
    from repro_torch.launch.mesh import read_plan
    from repro_torch.solvers import make_solver

    out = {}
    for fmt in FORMATS:
        plan = read_plan(plan_dirs[fmt], mesh)
        x = torch.from_numpy(np.array(job[fmt]["x"][
            mesh.node:mesh.node + 1, mesh.core:mesh.core + 1]))
        b = torch.from_numpy(np.array(job[fmt]["b"][
            mesh.node:mesh.node + 1, mesh.core:mesh.core + 1]))
        for name in TRANSPORTS:
            for wd in WIRES:
                collectives.reset_wire()
                ghost = make_exchange(plan, name, wire_dtype=wd)(x)
                y = make_spmv(plan, transport=name, wire_dtype=wd)(x)
                wire = dict(collectives.WIRE)
                out[(fmt, name, wd)] = (
                    ghost.numpy(), y.numpy(), wire["calls"], wire["bytes"],
                    sorted(wire["by_kind"]))
        xs, iters, _ = make_solver(plan, precond="jacobi")(b, tol=3e-6,
                                                         maxiter=400)
        out[(fmt, "cg")] = (int(iters), xs.numpy())
    return out


class _Leaky:
    """An a2a transport that issues one more all-to-all and never waits
    for it (built on the ranks: the class is the transport module's)."""

    @staticmethod
    def make():
        from repro_torch.core.collectives import all_to_all_start
        from repro_torch.core.transport import A2ATransport

        class Leaky(A2ATransport):
            name = "leaky"

            def start(self, x, F, *, state, n_node, g_pad):
                all_to_all_start(x.new_zeros((1, 1, 1, state["mesh"].n_node,
                                              2)), mesh=state["mesh"])
                return super().start(x, F, state=state, n_node=n_node,
                                     g_pad=g_pad)
        return Leaky()


def _async(mesh, plan_dirs, job) -> dict:
    """Each collective issued, local work queued, then waited: its result
    against the synchronous call's bytes, and ``WIRE``'s seconds and
    exposed seconds of the pending call; then a shard body that leaves a
    handle unwaited."""
    from repro_torch.core import make_shard_body
    from repro_torch.core.collectives import (WIRE, all_gather,
                                              all_gather_start, all_to_all,
                                              all_to_all_start, open_handles,
                                              ppermute, ppermute_start,
                                              reset_wire)
    from repro_torch.launch.mesh import read_plan

    n = mesh.n_node
    base = torch.arange(n * 6, dtype=torch.float32) + 100.0 * mesh.rank
    perm = [(i, (i + 1) % n) for i in range(n)]
    calls = {
        "all-to-all": (lambda: all_to_all(base.reshape(1, 1, 1, n, 6),
                                          mesh=mesh),
                       lambda: all_to_all_start(base.reshape(1, 1, 1, n, 6),
                                                mesh=mesh)),
        "all-gather": (lambda: all_gather(base.reshape(1, 1, -1), "core",
                                          mesh=mesh),
                       lambda: all_gather_start(base.reshape(1, 1, -1),
                                                "core", mesh=mesh)),
        "collective-permute": (
            lambda: ppermute(base[:6].reshape(1, 1, 1, 6), pairs=n,
                             perm=perm, mesh=mesh),
            lambda: ppermute_start(base[:6].reshape(1, 1, 1, 6), pairs=n,
                                   perm=perm, mesh=mesh))}
    out = {}
    for kind, (sync, start) in calls.items():
        want = sync()
        reset_wire()
        pending = start()
        work = sum(float((base * k).sum()) for k in range(200))  # local work
        got = pending.wait()
        wire = dict(WIRE)
        out[kind] = (np.array_equal(got.numpy().view(np.int32),
                                     want.numpy().view(np.int32)),
                     wire["calls"], wire["seconds"], wire["exposed"],
                     dict(wire["by_kind"]), dict(wire["exposed_by_kind"]),
                     work)
    plan = read_plan(plan_dirs["ell"], mesh)
    x = torch.from_numpy(np.array(job["ell"]["x"][
        mesh.node:mesh.node + 1, mesh.core:mesh.core + 1]))
    body = make_shard_body(plan, transport=_Leaky.make())
    before = open_handles()
    try:
        body(x)
        out["leak"] = None
    except RuntimeError as e:
        out["leak"] = str(e)
    out["open_after"] = open_handles() - before
    mesh.barrier()
    return out


def _rank(mesh, plan_dirs, job) -> dict:
    import torch.distributed as dist

    out = {"control_is_world": mesh.control is dist.group.WORLD}
    # every host-control call passes the mesh's control group
    seen = []
    for fn in CONTROL_CALLS:
        real = getattr(dist, fn)

        def spy(*a, _real=real, _fn=fn, **k):
            seen.append((_fn, k.get("group")))
            return _real(*a, **k)
        setattr(dist, fn, spy)
    out["world"] = _control(mesh)
    out["groups"] = [(fn, g is mesh.control) for fn, g in seen]
    # the same calls over a gloo side group, as an NCCL mesh holds them
    side = dataclasses.replace(mesh, control=dist.new_group(backend="gloo"))
    seen.clear()
    out["side"] = _control(side)
    out["side_groups"] = [(fn, g is side.control) for fn, g in seen]
    # the on-card wire over the same groups, on host tensors
    out["gloo"] = _solve(mesh, plan_dirs, job)
    out["gloo_async"] = _async(mesh, plan_dirs, job)
    marks = []
    collectives._mark = lambda device: marks.append(device) or _HostMark()
    nccl = dataclasses.replace(mesh, backend="nccl")
    out["nccl"] = _solve(nccl, plan_dirs, job)
    out["marks"] = len(marks)
    out["nccl_async"] = _async(nccl, plan_dirs, job)
    return out


@pytest.fixture(scope="module")
def ranks():
    shim = os.path.join("tests", "_jaxcompat")
    saved = os.environ.get("PYTHONPATH", "")
    os.environ["PYTHONPATH"] = os.pathsep.join(
        p for p in saved.split(os.pathsep)
        if p and not p.rstrip("/").endswith(shim))
    A = graded_extruded_mesh_matrix(48, 6, seed=0)
    rng = np.random.default_rng(7)
    x, b = rng.normal(size=A.n_rows), rng.normal(size=A.n_rows)
    try:
        with tempfile.TemporaryDirectory() as d:
            dirs, job = {}, {}
            for fmt in FORMATS:
                plan, layout = build_spmv_plan(A, 2, 2, format=fmt,
                                               device="cpu")
                dirs[fmt] = str(write_plan(plan, f"{d}/{fmt}"))
                job[fmt] = {"x": to_dist(x, layout, plan).numpy(),
                            "b": to_dist(b, layout, plan).numpy()}
            t0 = time.perf_counter()
            out = spawn_cg_mesh(_rank, 2, 2, "cpu", args=(dirs, job),
                                timeout=SPAWN_TIMEOUT)
            return out, time.perf_counter() - t0
    finally:
        os.environ["PYTHONPATH"] = saved


def test_a_gloo_meshs_control_group_is_its_world(ranks):
    assert all(r["control_is_world"] for r in ranks[0])


@pytest.mark.parametrize("key", ["groups", "side_groups"])
def test_every_host_control_call_passes_the_control_group(key, ranks):
    for r in ranks[0]:
        assert {fn for fn, _ in r[key]} == set(CONTROL_CALLS), r[key]
        assert all(ok for _, ok in r[key]), r[key]


def test_host_control_over_a_side_group_gives_the_same_objects(ranks):
    out = ranks[0]
    for r, res in enumerate(out):
        world, side = res["world"], res["side"]
        assert world["agree"] == side["agree"] == {"from": 0}
        assert world["allgather"] == side["allgather"] == [0, 10, 20, 30]
        assert np.array_equal(world["rows_all"], side["rows_all"])
        whole = np.arange(12, dtype=np.float32) * 0.5 + np.arange(12) % 4
        assert np.array_equal(side["rows_all"], whole)
        if r == 0:
            assert np.array_equal(side["rows_0"], whole)
        else:
            assert world["rows_0"] is None and side["rows_0"] is None


@pytest.mark.parametrize("wd", WIRES)
@pytest.mark.parametrize("name", TRANSPORTS)
@pytest.mark.parametrize("fmt", FORMATS)
def test_the_on_card_wire_moves_the_gloo_wires_bits(fmt, name, wd, ranks):
    for res in ranks[0]:
        g_ghost, g_y, g_calls, g_bytes, g_kinds = res["gloo"][(fmt, name,
                                                               wd)]
        n_ghost, n_y, n_calls, n_bytes, n_kinds = res["nccl"][(fmt, name,
                                                               wd)]
        assert np.array_equal(n_ghost.view(np.uint8), g_ghost.view(np.uint8))
        assert np.array_equal(n_y.view(np.int32), g_y.view(np.int32))
        assert (n_calls, n_bytes, n_kinds) == (g_calls, g_bytes, g_kinds)
        assert n_calls > 0 and n_bytes > 0


def test_the_nccl_mesh_timed_every_call_with_two_marks(ranks):
    for res in ranks[0]:
        calls = sum(v[2] for k, v in res["nccl"].items() if len(k) == 3)
        assert calls > 0 and res["marks"] >= 2 * calls


@pytest.mark.parametrize("fmt", FORMATS)
def test_cg_over_the_on_card_wire_is_the_gloo_wires(fmt, ranks):
    its = [res["nccl"][(fmt, "cg")][0] for res in ranks[0]]
    assert all(i == its[0] for i in its)
    for res in ranks[0]:
        (gi, gx), (ni, nx) = res["gloo"][(fmt, "cg")], res["nccl"][(fmt,
                                                                   "cg")]
        assert ni == gi and np.array_equal(nx.view(np.int32),
                                           gx.view(np.int32))


ASYNC_KINDS = ("all-to-all", "all-gather", "collective-permute")


@pytest.mark.parametrize("kind", ASYNC_KINDS)
@pytest.mark.parametrize("wire", ["gloo", "nccl"])
def test_a_pending_handle_delivers_the_synchronous_calls_bytes(wire, kind,
                                                               ranks):
    for res in ranks[0]:
        same, calls, seconds, exposed, by_kind, exposed_by_kind, _ = res[
            f"{wire}_async"][kind]
        assert same and calls == 1
        assert set(by_kind) == set(exposed_by_kind) == {kind}
        assert 0.0 <= exposed <= seconds


@pytest.mark.parametrize("wire", ["gloo", "nccl"])
def test_a_handle_left_unwaited_at_the_end_of_a_body_raises(wire, ranks):
    for res in ranks[0]:
        out = res[f"{wire}_async"]
        assert out["leak"] is not None
        assert "never waited" in out["leak"] and "all-to-all" in out["leak"]
        assert out["open_after"] == 0


def test_the_spawn_finishes_well_inside_its_timeout(ranks):
    assert ranks[1] < SPAWN_TIMEOUT / 2


# ---------------------------------------------------------------------- #
# WIRE: events are read when it is read
# ---------------------------------------------------------------------- #
class _Pending(_HostMark):
    def __init__(self, ms, done=True):
        self.t, self.done, self.waited = ms / 1e3, done, False

    def query(self):
        return self.done

    def synchronize(self):
        self.waited, self.done = True, True


@pytest.fixture
def wire():
    collectives.reset_wire()
    yield collectives.WIRE
    collectives.reset_wire()


def test_wire_reads_its_events_when_it_is_read(wire):
    # (kind, issue, wait, arrival): the all-to-all hid 1.5 of its 2 ms
    wire._events += [("all-to-all", _Pending(0.0), _Pending(1.5),
                      _Pending(2.0)),
                     ("all-reduce", _Pending(5.0), _Pending(5.0),
                      _Pending(5.5, False))]
    collectives._account("control", 0.25)
    snap = dict(wire)
    assert not wire._events
    assert snap["by_kind"] == pytest.approx({"all-to-all": 0.002,
                                             "all-reduce": 0.0005,
                                             "control": 0.25})
    assert snap["seconds"] == pytest.approx(0.2525)
    assert snap["exposed_by_kind"] == pytest.approx({"all-to-all": 0.0005,
                                                     "all-reduce": 0.0005,
                                                     "control": 0.25})
    assert snap["exposed"] == pytest.approx(0.251)
    assert snap["calls"] == 1           # the events' calls count at issue
    collectives.reset_wire()
    assert dict(wire) == {"calls": 0, "seconds": 0.0, "bytes": 0,
                          "by_kind": {}, "exposed": 0.0,
                          "exposed_by_kind": {}}
    assert snap["by_kind"]              # a snapshot outlives a reset


def test_wire_settles_only_finished_events_while_it_grows(wire):
    late = _Pending(3.0, False)
    wire._events += [("all-gather", _Pending(0.0), _Pending(0.5),
                      _Pending(1.0)),
                     ("all-gather", _Pending(1.0), _Pending(2.0), late),
                     ("all-gather", _Pending(3.0), _Pending(3.5),
                      _Pending(4.0))]
    wire._settle(done_only=True)
    assert len(wire._events) == 2 and not late.waited
    assert wire._d["by_kind"] == pytest.approx({"all-gather": 0.001})
