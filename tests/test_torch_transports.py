"""The port's halo-exchange layer against the JAX reference, on the CPU.

The reference side (``make_exchange`` and ``host_exchange`` of every
transport × wire dtype on the four ``repro.testing.transport_check`` cases
with halo traffic, 8 XLA host devices) runs in a subprocess,
``tests/torch_reference.py --transports``.  The port runs with
``device="cpu"``.  Host-only reference calls (plan builder, census,
transport state, codecs) run in-process.

Tolerances: none — every comparison is bit for bit:
  * ghost buffers at real slots (``[..., :g_pad]``; the dump slot
    ``g_pad`` is write-only), device and ``host_exchange``;
  * bf16/int8 payloads and round trips (``torch.round`` and ``jnp.round``
    both round half to even, and both divide in IEEE f32);
  * the census, the pairwise schedule, and the f32-wire CG iterate of
    every transport against ``a2a``'s.
"""
import dataclasses
import functools
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import run_subprocess
from repro.core import build_spmv_plan as ref_build_spmv_plan
from repro.core import resolve_transport as ref_resolve_transport
from repro.core.transport import available_transports as ref_transports
from repro.core.transport import available_wire_dtypes as ref_wire_dtypes
from repro.core.transport import get_codec as ref_get_codec
from repro.core.transport import transport_census as ref_transport_census
from repro.sparse import graded_extruded_mesh_matrix as ref_graded
from repro.testing.transport_check import build_case as ref_build_case
from repro_torch.core import (build_spmv_plan, make_exchange, make_shard_body,
                              make_spmv, resolve_transport, to_dist)
from repro_torch.core.collectives import (COLLECTIVE_OPS, census,
                                          record_collectives)
from repro_torch.core.transport import (FaultyTransport, autotune_transport,
                                        available_transports,
                                        available_wire_dtypes, get_codec,
                                        transport_census)
from repro_torch.solvers import make_solver
from repro_torch.sparse import graded_extruded_mesh_matrix
from repro_torch.testing import transport_check
from repro_torch.testing.transport_check import build_case

HERE = os.path.dirname(os.path.abspath(__file__))
HALO_CASES = ("graded", "uniform", "single", "dense")
TRANSPORTS = ("a2a", "hier", "pairwise", "ring")
WIRES = ("bf16", "f32", "int8")


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    out = tmp_path_factory.mktemp("ref") / "transports.npz"
    res = run_subprocess([os.path.join(HERE, "torch_reference.py"),
                          str(out), "--transports"], device_count=8)
    assert res.returncode == 0, res.stderr[-4000:]
    with np.load(out) as d:
        return {k: d[k] for k in d.files}


@functools.cache
def _case(case):
    A, plan, layout = build_case(case, 4, 2, "ell", "cpu")
    x = np.random.default_rng(7).normal(size=A.n_rows)
    return plan, to_dist(x, layout, plan)


def test_registries_match_the_reference():
    assert available_transports() == ref_transports() == TRANSPORTS
    assert available_wire_dtypes() == ref_wire_dtypes() == WIRES
    assert "faulty" not in available_transports()


@pytest.mark.parametrize("wd", WIRES)
@pytest.mark.parametrize("name", TRANSPORTS)
@pytest.mark.parametrize("case", HALO_CASES)
def test_ghost_and_host_exchange_bit_equal_to_reference(case, name, wd,
                                                         reference):
    plan, xd = _case(case)
    g, key = plan.g_pad, f"{case}/{name}/{wd}"
    ghost = make_exchange(plan, transport=name, wire_dtype=wd)(xd).numpy()
    want = reference[f"{key}/ghost"]
    assert ghost.shape == want.shape == (4, 2, g + 1)
    assert ghost[..., :g].tobytes() == want[..., :g].tobytes()
    tr, state = resolve_transport(name, plan, wire_dtype=wd)
    host = tr.host_exchange(xd.numpy(), plan.send_own.numpy(),
                            plan.recv_own.numpy(), g, state)
    assert host[..., :g].tobytes() == reference[f"{key}/host"][..., :g] \
        .tobytes()


@pytest.mark.parametrize("wd", WIRES)
@pytest.mark.parametrize("name", TRANSPORTS)
@pytest.mark.parametrize("case", HALO_CASES)
def test_recorded_exchange_bit_equal_to_reference(case, name, wd,
                                                  reference):
    """With a collective recorder open, every exchange still gives the
    reference's ghosts bit for bit, and records the collectives its
    ``predicted_cost`` names."""
    plan, xd = _case(case)
    g, key = plan.g_pad, f"{case}/{name}/{wd}"
    with record_collectives() as log:
        ghost = make_exchange(plan, transport=name, wire_dtype=wd)(xd)
    assert ghost.numpy()[..., :g].tobytes() == \
        reference[f"{key}/ghost"][..., :g].tobytes()
    tr, state = resolve_transport(name, plan, wire_dtype=wd)
    pred = tr.predicted_cost(plan, state)
    assert census(log) == {k: int(pred.get(k, 0)) for k in COLLECTIVE_OPS}


def _chunks():
    """Seeded chunk tables with exact zeros, an all-zero chunk, a chunk
    of one repeated value and magnitudes from 1e-30 to 1e30."""
    rng = np.random.default_rng(11)
    t = rng.standard_normal((3, 2, 4, 24)).astype(np.float32)
    t[0, 0, 0] = 0.0
    t[0, 1, 2, ::3] = 0.0
    t[1, 0, 1] = -2.5
    t[2] *= np.float32(10.0) ** rng.integers(-30, 31, (2, 4, 1))
    return t


@pytest.mark.parametrize("wd", ["bf16", "int8"])
def test_lossy_payloads_bit_equal_to_reference_codecs(wd):
    ch = _chunks()
    codec, ref = get_codec(wd), ref_get_codec(wd)
    got = codec.encode(torch.from_numpy(ch))
    want = np.asarray(ref.encode(jnp.asarray(ch)))
    if wd == "bf16":
        assert got.dtype == torch.bfloat16
        assert got.view(torch.int16).numpy().tobytes() == \
            want.view(np.int16).tobytes()
    else:
        assert got.dtype == torch.int8 and got.shape[-1] == ch.shape[-1] + 4
        assert got.numpy().tobytes() == want.tobytes()
    dec = codec.decode(got, torch.float32).numpy()
    assert dec.tobytes() == np.asarray(
        ref.decode(ref.encode(jnp.asarray(ch)), jnp.float32)).tobytes()
    assert codec.host_roundtrip(ch).tobytes() == \
        ref.host_roundtrip(ch).tobytes()
    assert codec.payload_bytes(24) == ref.payload_bytes(24)
    assert (codec.rel_bound, codec.declared_downcasts) == \
        (ref.rel_bound, ref.declared_downcasts)
    # the codec's contract, chunk by chunk, where the reference's own
    # property test holds it (|x| within 1e-3..1e3 — int8's 1e-12 scale
    # floor dominates tiny chunks); an all-zero chunk decodes to zeros
    amax = np.abs(ch).max(-1)
    err = np.abs(dec - ch).max(-1)
    held = (amax >= 1e-3) & (amax <= 1e3)
    assert held.sum() == 15
    assert (err[held] <= codec.rel_bound * amax[held]).all()
    assert (dec[0, 0, 0] == 0.0).all()


@pytest.mark.parametrize("wd", WIRES)
def test_census_equals_reference(wd):
    for case in HALO_CASES + ("halofree",):
        _, plan, layout = build_case(case, 4, 2, "ell", "cpu")
        _, rplan, rlayout = ref_build_case(case, 4, 2, "ell")
        assert transport_census(plan, wire_dtype=wd) == \
            ref_transport_census(rplan, wire_dtype=wd), case
        assert layout["neighbor_offsets"] == rlayout["neighbor_offsets"]
    rplan_w, rlay_w = ref_build_spmv_plan(ref_graded(48, 6, seed=0), 4, 2,
                                          wire_dtype=wd)
    plan_w, lay_w = build_spmv_plan(graded_extruded_mesh_matrix(48, 6),
                                    4, 2, wire_dtype=wd, device="cpu")
    assert plan_w.wire_dtype == rplan_w.wire_dtype == wd
    assert lay_w["transport_census"] == rlay_w["transport_census"]


@pytest.mark.parametrize("name", ["ring", "pairwise"])
def test_neighbor_offsets_overrides(name):
    plan, _ = _case("graded")
    _, rplan, _ = ref_build_case("graded", 4, 2, "ell")
    full = ref_resolve_transport(name, rplan)[1]["neighbor_offsets"]
    assert len(full) > 1
    assert resolve_transport(name, plan)[1]["neighbor_offsets"] == full
    with pytest.raises(ValueError, match="miss populated"):
        make_shard_body(plan, transport=name, neighbor_offsets=[full[0]])
    with pytest.raises(ValueError, match="needs neighbor_offsets"):
        make_shard_body(plan, transport=name, neighbor_offsets=[])
    # a complete superset with an alias (5 = 1 mod 4) is normalised and
    # reaches the schedule, as in the reference
    _, state = resolve_transport(name, plan, neighbor_offsets=full + [5])
    _, rstate = ref_resolve_transport(name, rplan,
                                      neighbor_offsets=full + [5])
    assert state["neighbor_offsets"] == rstate["neighbor_offsets"] == full
    if name == "pairwise":
        assert state["pairs_by_offset"] == rstate["pairs_by_offset"]
        for case in HALO_CASES:
            p, _ = _case(case)
            _, rp, _ = ref_build_case(case, 4, 2, "ell")
            assert resolve_transport(name, p)[1]["pairs_by_offset"] == \
                ref_resolve_transport(name, rp)[1]["pairs_by_offset"], case


def test_auto_is_a_deferred_stamp():
    A = graded_extruded_mesh_matrix(20, 3, seed=0)
    b = np.random.default_rng(0).normal(size=A.n_rows)
    plan, layout = build_spmv_plan(A, 2, 2, transport="auto", device="cpu")
    assert plan.transport == "auto" and plan.hs > 0
    with pytest.raises(ValueError, match="auto.*resolved by make_spmv"):
        make_shard_body(plan)
    spmv = make_spmv(plan)                         # transport=None
    assert plan.transport in available_transports()
    assert spmv.transport == plan.transport
    plan2, _ = build_spmv_plan(A, 2, 2, transport="auto", device="cpu")
    solve = make_solver(plan2)
    assert solve.transport == plan2.transport in available_transports()
    _, it, rel = solve(to_dist(b, layout, plan2), tol=1e-5, maxiter=1000)
    assert int(it) < 1000 and float(rel) <= 1e-5
    # halo-free plans stamp a2a without timing; there is nothing to probe
    plan0, layout0 = build_spmv_plan(A, 1, 2, transport="auto",
                                     device="cpu")
    res = autotune_transport(plan0)
    assert res.winner == plan0.transport == "a2a"
    assert set(res.timings_us.values()) == {0.0}
    x0 = to_dist(b, layout0, plan0)
    assert torch.equal(res.spmv(x0), make_spmv(plan0, transport="a2a")(x0))
    with pytest.raises(ValueError, match="no halo traffic"):
        make_exchange(plan0)
    for kw in ({"transport": "bogus"}, {"wire_dtype": "f16"}):
        with pytest.raises(ValueError, match="unknown"):
            build_spmv_plan(A, 2, 2, device="cpu", **kw)


def test_faulty_is_caught_and_its_host_reference_is_clean(capsys):
    argv = ["--device", "cpu", "--case", "graded", "--formats", "ell"]
    assert transport_check.main(argv) == 0
    assert transport_check.main(argv + ["--include-faulty"]) == 1
    out = capsys.readouterr().out
    assert "TRANSPORT faulty WIRE f32 ghost=BAD host=BAD" in out
    assert "spmv=BAD" in out and out.rstrip().endswith("FAIL")
    assert "faulty" not in available_transports()      # unregistered again
    plan, xd = _case("graded")
    faulty = FaultyTransport()
    _, state = resolve_transport(faulty, plan)
    args = (xd.numpy(), plan.send_own.numpy(), plan.recv_own.numpy(),
            plan.g_pad, state)
    clean = resolve_transport("a2a", plan)[0].host_exchange(*args)
    assert np.array_equal(faulty.host_exchange(*args), clean)
    g = plan.g_pad
    bad = make_exchange(plan, transport=faulty)(xd)[..., :g]
    good = make_exchange(plan)(xd)[..., :g]
    assert torch.equal(bad.view(torch.int32) ^ (1 << 30),
                       good.view(torch.int32))


@pytest.mark.parametrize("name", ["ring", "pairwise", "hier"])
@pytest.mark.parametrize("fmt", ["ell", "sell"])
def test_f32_wire_cg_bit_equal_to_a2a(fmt, name):
    A = graded_extruded_mesh_matrix(48, 6, seed=0)
    plan, layout = build_spmv_plan(A, 4, 2, format=fmt, device="cpu")
    b = to_dist(np.random.default_rng(3).standard_normal(A.n_rows),
                layout, plan)
    x0, k0, r0 = make_solver(plan, transport="a2a")(b, tol=1e-6,
                                                     maxiter=400)
    x1, k1, r1 = make_solver(plan, transport=name)(b, tol=1e-6, maxiter=400)
    assert int(k1) == int(k0) and 0 < int(k0) < 400
    assert torch.equal(x1, x0) and torch.equal(r1, r0)


def test_hier_refuses_a_real_slot_with_two_writers():
    plan, _ = _case("graded")
    recv = plan.recv_own.clone()
    # a second writer of slot 0 of node 0: another (core, src, k) entry
    # that wrote the dump slot now writes slot 0 too
    c, src, k = map(int, np.argwhere(recv[0].numpy() == plan.g_pad)[0])
    recv[0, c, src, k] = 0
    bad = dataclasses.replace(plan, recv_own=recv)
    with pytest.raises(ValueError, match="more than one writer"):
        resolve_transport("hier", bad)
    resolve_transport("a2a", bad)          # a2a sums; it does not check
