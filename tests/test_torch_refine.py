"""The port's f64 iterative refinement over lossy halo wire, on the CPU.

The reference side (``make_refine``, cg + jacobi, on 8 XLA host devices)
runs in a subprocess, ``tests/torch_reference.py --refine``:
``graded_extruded_mesh_matrix(80, 6)`` at 4×2 (``refine_check``'s size),
ell and sell, every wire dtype, ``refine_check``'s inner tolerances and
RHS.  The port runs the same with ``device="cpu"``.

Tolerances:
  * true relative residual ``<= 1e-7`` (f64, host) and ``x`` within
    ``100 · 1e-7`` of the f64 CG oracle, as ``refine_check`` holds them;
  * ``pipelined_cg`` over a lossy codec: the options ``make_refine`` hands
    the inner solver equal the reference's (``lossy_wire_options``, i.e.
    ``replace_every`` 10, merged under the caller's options).  Its cycle
    count is not compared: pipelined CG over int8 wire converges on about
    half of the RHS seeds in either package (ROADMAP C), so the count is
    set by rounding.
  * cycles within ±1 of the reference's.  Over lossy wire the reference's
    own count moves with the format (int8: 7 on ell, 6 on sell — the two
    plans are the same operator with another summation order): one
    quantised SpMV agrees with the reference's to 8e-8 here, but a last-bit
    difference can move ``x / scale`` across a rounding boundary, a whole
    step of ``scale``, so a solve's trajectory leaves the reference's within a
    few iterations.  The port's count must lie within ±1 of the range the
    reference spans over its ell and sell plans.
"""
import json
import os

import numpy as np
import pytest
import torch

from conftest import run_subprocess
from repro_torch.core import build_spmv_plan
from repro_torch.solvers import make_refine, refine_solve
from repro_torch.sparse import graded_extruded_mesh_matrix
from repro_torch.testing import refine_check

HERE = os.path.dirname(os.path.abspath(__file__))


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
    out = tmp_path_factory.mktemp("ref") / "refine.npz"
    res = run_subprocess([os.path.join(HERE, "torch_reference.py"),
                          str(out), "--refine"], device_count=8)
    assert res.returncode == 0, res.stderr[-4000:]
    with np.load(out) as d:
        return {k: d[k] for k in d.files}


@pytest.fixture(scope="module")
def system():
    A = graded_extruded_mesh_matrix(80, 6, seed=0)
    b = np.random.default_rng(1).normal(size=A.n_rows)
    xh = refine_check.host_cg(A, b, tol=1e-12, maxiter=40_000)
    return A, b, xh


@pytest.mark.parametrize("wd", ["bf16", "f32", "int8"])
@pytest.mark.parametrize("fmt", ["ell", "sell"])
def test_refine_reaches_tol_with_the_reference_cycle_count(fmt, wd, system,
                                                           reference):
    A, b, xh = system
    plan, layout = build_spmv_plan(A, 4, 2, format=fmt, wire_dtype=wd,
                                   device="cpu")
    refine = make_refine(plan, A=A, layout=layout,
                         inner_tol=refine_check.inner_tol_for(wd),
                         maxiter_inner=1000)
    assert (refine.solver, refine.wire_dtype) == ("cg", wd)
    res = refine(b, tol=1e-7)
    rel = np.linalg.norm(b - A.matvec(res.x)) / np.linalg.norm(b)
    assert res.converged and rel == pytest.approx(res.rel) and rel <= 1e-7
    assert np.linalg.norm(res.x - xh) / np.linalg.norm(xh) < 100 * 1e-7
    assert [c for c, _ in res.history] == list(range(1, res.cycles + 1))
    ref_cycles = [int(reference[f"{f}/{wd}/cycles"]) for f in ("ell", "sell")]
    assert min(ref_cycles) - 1 <= res.cycles <= max(ref_cycles) + 1, \
        (res.cycles, ref_cycles)
    if wd == "f32":             # exact wire: the reference's count itself
        assert abs(res.cycles - int(reference[f"{fmt}/f32/cycles"])) <= 1
    assert float(reference[f"{fmt}/{wd}/rel"]) <= 1e-7


def test_make_refine_rejects_missing_inputs_and_batched_rhs(system):
    A, b, _ = system
    plan, layout = build_spmv_plan(A, 2, 2, device="cpu")
    for kw in ({"A": A}, {"layout": layout}, {}):
        with pytest.raises(ValueError, match="needs A="):
            make_refine(plan, **kw)
    refine = make_refine(plan, A=A, layout=layout)
    with pytest.raises(ValueError, match="single global"):
        refine(np.stack([b, b]))
    # the inner solver is built once and carried
    assert refine.solve.transport == "a2a" and refine.transport == "a2a"


def test_refine_solve_and_refine_check_cli(system, capsys):
    A, b, _ = system
    res = refine_solve(A, b, n_node=2, n_core=2, wire_dtype="int8",
                       transport="pairwise", device="cpu")
    assert res.converged and res.rel <= 1e-7
    assert (res.transport, res.wire_dtype) == ("pairwise", "int8")
    assert refine_check.main(["--device", "cpu", "--n-surface", "40",
                              "--format", "sell", "--transport", "hier",
                              "--solvers", "cg"]) == 0
    out = capsys.readouterr().out
    assert out.count("REFINE cg WIRE") == 3 and out.rstrip().endswith("OK")
    # the resilient half: an int8-wire chunked solve, no rollback
    assert "RESILIENT cg WIRE int8" in out and "ROLLBACKS 0" in out


@pytest.mark.parametrize("wd", ["bf16", "f32", "int8"])
def test_lossy_wire_options_merge_under_the_callers(wd, system, reference):
    A, b, _ = system
    plan, layout = build_spmv_plan(A, 4, 2, wire_dtype=wd, device="cpu")
    refine = make_refine(plan, solver="pipelined_cg", A=A, layout=layout)
    want = json.loads(str(reference[f"ell/{wd}/pipelined_cg/options"]))
    assert refine.solve.options == want
    assert want == ({} if wd == "f32" else {"replace_every": 10})
    # explicit options win over the codec's defaults
    mine = make_refine(plan, solver="pipelined_cg", A=A, layout=layout,
                       options={"replace_every": 25})
    assert mine.solve.options == {"replace_every": 25}
    # an f32-wire override on an int8 plan merges nothing
    exact = make_refine(plan, solver="pipelined_cg", A=A, layout=layout,
                        wire_dtype="f32")
    assert exact.solve.options == {} and exact.wire_dtype == "f32"


def test_pipelined_cg_refines_over_int8_wire_with_the_merged_period(system):
    """The merge is all that separates the default from an explicit
    ``replace_every=10``: the same cycles and the same ``x`` (two cycles
    suffice to show it)."""
    A, b, _ = system
    plan, layout = build_spmv_plan(A, 4, 2, format="sell", wire_dtype="int8",
                                   device="cpu")
    kw = dict(solver="pipelined_cg", A=A, layout=layout, maxiter_inner=300,
              inner_tol=refine_check.inner_tol_for("int8", "pipelined_cg"))
    merged = make_refine(plan, **kw)(b, tol=1e-7, max_cycles=2)
    explicit = make_refine(plan, options={"replace_every": 10}, **kw)(
        b, tol=1e-7, max_cycles=2)
    assert merged.cycles == explicit.cycles
    np.testing.assert_array_equal(merged.x, explicit.x)
    assert np.isfinite(merged.x).all() and merged.inner_iters > 0
