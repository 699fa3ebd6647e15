"""The port's rectangular plans and plan verifier against the JAX
package's, on the CPU.

* Plans, in-process against the reference builder: the ``rect_check``
  matrices (tall 420×140, fat 140×420, the agg-16 restriction 26×416) at
  4×2 and 2×2, ``rows`` and ``nnz`` node partitions, ell and sell, free
  and pinned to their own exported spaces — every plan array, ``diag_a``,
  ``mask`` and ``mask_col`` byte-identical, the same meta, slot tables and
  exported spaces.  R and P pinned to a square plan's row space, as
  ``two_level`` builds them, likewise.
* SpMV through ``make_spmv`` against the reference's on 8 XLA host devices
  (one ``tests/torch_reference.py --rect`` subprocess) within
  ``1e-6·max|y|`` (f32, the same entries summed in the same order up to
  the gather), and ``rect_check --device cpu`` printing ``OK``.
* ``to_dist``/``from_dist`` with ``space=``; every up-front reject of
  ``tests/test_rectangular.py``; the zero-diagonal guard, which raises on
  exactly the square draws the reference raises on (ROADMAP A0).
* ``check_plan`` / ``check_kernel_streams`` reports equal to the
  reference's (codes, messages, contexts, check counts) on clean plans and
  on deterministic corruptions: a second writer for a ghost slot from
  another source node, an out-of-range local column.
"""
import dataclasses
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest

from conftest import run_subprocess
from repro.analysis import check_kernel_streams as ref_check_kernel_streams
from repro.analysis import check_plan as ref_check_plan
from repro.core import build_spmv_plan as ref_build_spmv_plan
from repro.core.spmv import plan_shard_arrays as ref_plan_shard_arrays
from repro.sparse import graded_extruded_mesh_matrix as ref_graded
from repro.sparse.csr import CSRMatrix as RefCSR
from repro.testing.square_golden import _hash
from repro_torch.analysis import (CODES, Report, Violation,
                                  check_kernel_streams, check_plan)
from repro_torch.core import build_spmv_plan, from_dist, make_spmv, to_dist
from repro_torch.core.spmv import plan_fields, plan_shard_arrays
from repro_torch.sparse import CSRMatrix, graded_extruded_mesh_matrix
from repro_torch.testing import rect_check
from repro_torch.testing.rect_check import build_rect

HERE = pathlib.Path(__file__).resolve().parent
KINDS = ("tall", "fat", "agg")
META = ("n", "n_cols", "n_node", "n_core", "rc_pad", "cc_pad", "nl_pad",
        "g_pad", "hs", "format")


def _ref(A: CSRMatrix) -> RefCSR:
    return RefCSR(indptr=A.indptr, indices=A.indices, data=A.data,
                  shape=A.shape)


def _same_plans(plan, layout, rplan, rlayout):
    """Every plan array, the meta, the slot tables and the exported
    spaces of the two packages' plans are the same bytes."""
    for name, got, want in zip(plan_fields(plan), plan_shard_arrays(plan),
                               ref_plan_shard_arrays(rplan)):
        assert _hash(got.numpy()) == _hash(np.asarray(want)), name
    for name in ("diag_a", "mask", "mask_col"):
        assert _hash(getattr(plan, name).numpy()) == \
            _hash(np.asarray(getattr(rplan, name))), name
    assert (plan.mask_col is plan.mask) == (rplan.mask_col is rplan.mask)
    for k in META:
        assert getattr(plan, k) == getattr(rplan, k), k
    for k in ("global_row_of", "global_col_of", "node_bounds"):
        np.testing.assert_array_equal(layout[k], rlayout[k])
    for space in ("row_space", "col_space"):
        got, want = layout[space], rlayout[space]
        assert got["pad"] == want["pad"]
        np.testing.assert_array_equal(got["node_bounds"],
                                      want["node_bounds"])
        for k in ("core_bounds", "lr"):
            assert len(got[k]) == len(want[k])
            for a, b in zip(got[k], want[k]):
                np.testing.assert_array_equal(a, b)
    assert layout["transport_census"] == rlayout["transport_census"]


@pytest.mark.parametrize("pinned", [False, True], ids=["free", "pinned"])
@pytest.mark.parametrize("fmt", ["ell", "sell"])
@pytest.mark.parametrize("part", ["rows", "nnz"])
@pytest.mark.parametrize("grid", [(4, 2), (2, 2)], ids=["4x2", "2x2"])
@pytest.mark.parametrize("kind", KINDS)
def test_rect_plan_matches_reference(kind, grid, part, fmt, pinned):
    A = build_rect(kind, 3)
    kw = dict(mode="balanced", node_partition=part, format=fmt)
    plan, layout = build_spmv_plan(A, *grid, device="cpu", **kw)
    rplan, rlayout = ref_build_spmv_plan(_ref(A), *grid, **kw)
    if pinned:
        plan, layout = build_spmv_plan(
            A, *grid, device="cpu", row_space=layout["row_space"],
            col_space=layout["col_space"], **kw)
        rplan, rlayout = ref_build_spmv_plan(
            _ref(A), *grid, row_space=rlayout["row_space"],
            col_space=rlayout["col_space"], **kw)
    assert (plan.n, plan.n_cols) == A.shape
    _same_plans(plan, layout, rplan, rlayout)


@pytest.mark.parametrize("fmt", ["ell", "sell"])
def test_restriction_and_prolongation_pinned_to_a_square_plan(fmt):
    """R (columns pinned to A's rows) and P = Rᵀ (rows pinned to A's,
    columns to R's), as ``two_level`` builds them, byte for byte."""
    A = graded_extruded_mesh_matrix(60, 9, seed=3, max_span=4)
    RA = ref_graded(60, 9, seed=3, max_span=4)
    _, layout_A = build_spmv_plan(A, 4, 2, format=fmt, device="cpu")
    _, rlayout_A = ref_build_spmv_plan(RA, 4, 2, format=fmt)
    n = A.n_rows
    agg = np.arange(n, dtype=np.int64) // 16
    R = CSRMatrix.from_coo(agg, np.arange(n), np.ones(n),
                           (int(agg[-1]) + 1, n))
    kw = dict(mode="balanced", node_partition="nnz", format=fmt)
    plan_R, layout_R = build_spmv_plan(R, 4, 2, device="cpu",
                                       col_space=layout_A["row_space"], **kw)
    rplan_R, rlayout_R = ref_build_spmv_plan(
        _ref(R), 4, 2, col_space=rlayout_A["row_space"], **kw)
    _same_plans(plan_R, layout_R, rplan_R, rlayout_R)
    plan_P, layout_P = build_spmv_plan(
        R.transpose(), 4, 2, device="cpu", row_space=layout_A["row_space"],
        col_space=layout_R["row_space"], verify=True, **kw)
    rplan_P, rlayout_P = ref_build_spmv_plan(
        _ref(R.transpose()), 4, 2, row_space=rlayout_A["row_space"],
        col_space=rlayout_R["row_space"], verify=True, **kw)
    _same_plans(plan_P, layout_P, rplan_P, rlayout_P)
    assert plan_P.rc_pad == layout_A["row_space"]["pad"]
    assert plan_P.cc_pad == plan_R.rc_pad


@pytest.fixture(scope="module")
def reference():
    import tempfile
    with tempfile.TemporaryDirectory() as tmp:
        out = pathlib.Path(tmp) / "rect.npz"
        res = run_subprocess([str(HERE / "torch_reference.py"), str(out),
                              "--rect"], device_count=8)
        assert res.returncode == 0, res.stderr[-4000:]
        with np.load(out) as d:
            return {k: d[k] for k in d.files}


@pytest.mark.parametrize("part", ["rows", "nnz"])
@pytest.mark.parametrize("fmt", ["ell", "sell"])
@pytest.mark.parametrize("kind", KINDS)
def test_rect_spmv_matches_reference(kind, fmt, part, reference):
    A = build_rect(kind, 3)
    x = np.random.default_rng(103).normal(size=A.n_cols)
    plan, layout = build_spmv_plan(A, 4, 2, mode="balanced",
                                   node_partition=part, format=fmt,
                                   device="cpu")
    xd = to_dist(x, layout, plan, space="col")
    assert tuple(xd.shape) == plan.x_shape
    yd = make_spmv(plan)(xd)
    assert tuple(yd.shape) == plan.cg_shape
    y = from_dist(yd, layout, plan, space="row")
    want = reference[f"{kind}/{fmt}/{part}/y"]
    np.testing.assert_allclose(y, want, rtol=0,
                               atol=1e-6 * np.abs(want).max())
    np.testing.assert_allclose(y, A.matvec(x), rtol=0,
                               atol=1e-5 * np.abs(want).max())


def test_rect_check_cli_prints_ok(capsys):
    assert rect_check.main(["--device", "cpu", "--seeds", "3"]) == 0
    out = capsys.readouterr().out
    assert out.strip().splitlines()[-1] == "OK" and "BAD" not in out
    for kind in KINDS:
        assert f"KIND {kind}" in out
    assert "PART nnz" in out and "PART rows" in out


def test_rect_to_from_dist_round_trips_both_spaces():
    A = build_rect("tall", 5)
    plan, layout = build_spmv_plan(A, 4, 2, format="sell", device="cpu")
    rng = np.random.default_rng(3)
    x = rng.normal(size=A.n_cols).astype(np.float32)
    y = rng.normal(size=A.n_rows).astype(np.float32)
    xd, yd = (to_dist(x, layout, plan, space="col"),
              to_dist(y, layout, plan, space="row"))
    assert tuple(xd.shape) == plan.x_shape != plan.cg_shape
    assert tuple(yd.shape) == plan.cg_shape
    np.testing.assert_array_equal(from_dist(xd, layout, plan, space="col"),
                                  x)
    np.testing.assert_array_equal(from_dist(yd, layout, plan), y)
    assert int(plan.mask_col.sum()) == A.n_cols
    assert int(plan.mask.sum()) == A.n_rows
    with pytest.raises(ValueError, match="space"):
        to_dist(x, layout, plan, space="cols")
    with pytest.raises(ValueError, match="space"):
        from_dist(xd, layout, plan, space="column")


def _random_rect(n_rows, n_cols, seed, per_row=4):
    """``tests/test_rectangular.py``'s draw."""
    rng = np.random.default_rng(seed)
    rows = np.repeat(np.arange(n_rows, dtype=np.int64), per_row)
    cols = rng.integers(0, n_cols, size=rows.size)
    vals = rng.standard_normal(rows.size)
    return CSRMatrix.from_coo(rows, cols, vals, (n_rows, n_cols))


def test_build_rejects_bad_shapes_and_pins():
    """Every reject of ``tests/test_rectangular.py``, with the reference's
    message."""
    cases = [
        (CSRMatrix(indptr=np.zeros(1, np.int64),
                   indices=np.zeros(0, np.int64), data=np.zeros(0),
                   shape=(0, 5)), {}, "empty row space"),
        (CSRMatrix(indptr=np.zeros(4, np.int64),
                   indices=np.zeros(0, np.int64), data=np.zeros(0),
                   shape=(3, 0)), {}, "empty column space"),
        (CSRMatrix(indptr=np.array([0, 1, 1], np.int64),
                   indices=np.array([7], np.int64),
                   data=np.array([1.0]), shape=(2, 5)), {},
         "column index out of range"),
    ]
    A = _random_rect(24, 40, seed=1)
    _, lb = build_spmv_plan(_random_rect(30, 40, seed=1), 1, 1,
                            device="cpu")
    cases.append((A, {"row_space": lb["row_space"]},
                  "row_space pin inconsistent"))
    _, lb = build_spmv_plan(_random_rect(24, 32, seed=1), 1, 1,
                            device="cpu")
    cases.append((A, {"col_space": lb["col_space"]},
                  "col_space pin inconsistent"))
    _, la = build_spmv_plan(A, 1, 1, device="cpu")
    cases.append((A, {"col_space": dict(la["col_space"], pad=1)},
                  "smaller than the largest"))
    cases.append((A, {"row_space": dict(la["row_space"], pad=1)},
                  "smaller than the largest"))
    for M, kw, msg in cases:
        with pytest.raises(ValueError, match=msg):
            build_spmv_plan(M, 1, 1, device="cpu", **kw)
        with pytest.raises(ValueError, match=msg):
            ref_build_spmv_plan(_ref(M), 1, 1, **{
                k: v for k, v in kw.items()})


@pytest.mark.parametrize("n_rows,n_cols,seed", [
    (7, 7, 0), (12, 12, 3), (30, 30, 11), (5, 5, 2), (20, 30, 4),
    (30, 20, 5), (3, 60, 6)])
def test_zero_diagonal_guard_as_the_reference(n_rows, n_cols, seed):
    """A square draw without a full diagonal raises in both packages (the
    reference's own property test trips on it, ROADMAP A0); a square draw
    with one, and every rectangular draw, builds the same plan in both."""
    A = _random_rect(n_rows, n_cols, seed)
    holes = n_rows == n_cols and np.any(A.diagonal() == 0)
    if n_rows == n_cols:
        assert holes, "the draw is meant to miss a diagonal entry"
        for build in (lambda: build_spmv_plan(A, 1, 1, device="cpu"),
                      lambda: ref_build_spmv_plan(_ref(A), 1, 1)):
            with pytest.raises(ValueError, match="zero or missing diagonal"):
                build()
        # a diagonal shift makes it plannable, the same in both
        n = n_rows
        A = CSRMatrix.from_coo(
            np.concatenate([np.repeat(np.arange(n), A.row_nnz),
                            np.arange(n)]),
            np.concatenate([A.indices, np.arange(n)]),
            np.concatenate([A.data, np.full(n, 10.0)]), A.shape)
    for fmt in ("ell", "sell"):
        plan, layout = build_spmv_plan(A, 1, 1, format=fmt, device="cpu")
        rplan, rlayout = ref_build_spmv_plan(_ref(A), 1, 1, format=fmt)
        _same_plans(plan, layout, rplan, rlayout)


# --------------------------------------------------------------------- #
# the static checker
# --------------------------------------------------------------------- #
def _reports(plan, layout, rplan, rlayout):
    return ((check_plan(plan, layout).as_dict(),
             check_kernel_streams(plan).as_dict()),
            (ref_check_plan(rplan, rlayout).as_dict(),
             ref_check_kernel_streams(rplan).as_dict()))


@pytest.mark.parametrize("fmt", ["ell", "sell"])
@pytest.mark.parametrize("kind", ["square", "halofree", *KINDS])
def test_clean_reports_equal_the_reference(kind, fmt):
    if kind in ("square", "halofree"):
        A = graded_extruded_mesh_matrix(48, 6, seed=0)
        grid = (4, 2) if kind == "square" else (1, 4)
    else:
        A, grid = build_rect(kind, 5), (4, 2)
    plan, layout = build_spmv_plan(A, *grid, format=fmt, device="cpu",
                                   verify=True)
    rplan, rlayout = ref_build_spmv_plan(_ref(A), *grid, format=fmt)
    got, want = _reports(plan, layout, rplan, rlayout)
    assert got == want
    assert got[0]["errors"] == got[1]["errors"] == 0
    assert got[0]["checks"] > 0 and got[1]["checks"] > 0


def _cross_node_second_writer(recv: np.ndarray, g_pad: int) -> np.ndarray:
    """A second writer for one real ghost slot of a destination node, from
    another source node: the first real receive entry from the lowest
    source rewritten onto the slot the first real entry of the next source
    writes (recv_own is (dst, core, src, k))."""
    recv = recv.copy()
    for dst in range(recv.shape[0]):
        real = np.argwhere(recv[dst] < g_pad)      # (core, src, k)
        srcs = np.unique(real[:, 1])
        if len(srcs) >= 2:
            a = real[real[:, 1] == srcs[0]][0]
            b = real[real[:, 1] == srcs[1]][0]
            recv[(dst, *b)] = recv[(dst, *a)]
            return recv
    raise AssertionError("no destination node receives from two sources")


@pytest.mark.parametrize("fmt", ["ell", "sell"])
@pytest.mark.parametrize("kind", ["square", "tall"])
def test_corrupted_plans_flagged_as_the_reference(kind, fmt):
    import torch

    A = (graded_extruded_mesh_matrix(48, 6, seed=0) if kind == "square"
         else build_rect(kind, 3))
    plan, layout = build_spmv_plan(A, 4, 2, format=fmt, device="cpu")
    rplan, rlayout = ref_build_spmv_plan(_ref(A), 4, 2, format=fmt)

    recv = _cross_node_second_writer(plan.recv_own.numpy(), plan.g_pad)
    mut = dataclasses.replace(plan, recv_own=torch.from_numpy(recv))
    rmut = dataclasses.replace(rplan, recv_own=jnp.asarray(recv))
    got, want = _reports(mut, layout, rmut, rlayout)
    assert got == want
    assert "P_GHOST_MULTI_WRITER" in got[0]["summary"]

    # a local column index one past the node-local x slice
    name = "diag_cols" if fmt == "ell" else "sell_dcols"
    cols = plan.fmt_data[name].numpy().copy()
    cols.reshape(-1)[0] = plan.nl_pad
    mut = dataclasses.replace(plan, fmt_data={
        **plan.fmt_data, name: torch.from_numpy(cols)})
    rmut = dataclasses.replace(rplan, fmt_data={
        **rplan.fmt_data, name: jnp.asarray(cols)})
    got, want = _reports(mut, layout, rmut, rlayout)
    assert got == want
    assert "K_INDEX_OOB" in got[1]["summary"]


def test_violation_vocabulary_is_the_reference_one():
    from repro.analysis import CODES as REF_CODES
    assert CODES == REF_CODES
    with pytest.raises(ValueError, match="unknown violation code"):
        Violation("P_NOT_A_CODE", "x")
    rep = Report()
    rep.add(Violation("K_DUMP_READ", "m", {"format": "ell"}))
    rep.add(Violation("K_UNDECLARED_FIELDS", "w"))
    assert not rep.ok() and len(rep.errors) == 1 and len(rep.warnings) == 1
    assert rep.summary() == {"K_DUMP_READ": 1, "K_UNDECLARED_FIELDS": 1}
