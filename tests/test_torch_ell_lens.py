"""ELL row lengths: the port-only arrays that let the ELL kernel skip padding.

``ELLFormat``'s ``diag_len``/``offd_len`` and ``ELLMatrix.row_lens`` hold,
per row, 1 + the last slot with an entry (``ell_row_lens``).  Checked on
the CPU:

* on the golden plans (4x2 and 1x4), each shard row's lengths are its
  diag/offd CSR nnz, 0 on the ``rc_pad`` tail;
* ``derive_aux`` gives the same arrays from the plan's ``fields`` alone,
  the port's and the JAX package's (so ``plan_from_arrays`` carries them);
* ``ELLMatrix.row_lens`` is ``row_nnz``, 0 on padded rows;
* every slot past a row's length is padding (value and column 0), so the
  plain versions over ``[0, len)`` equal the full-width ones exactly.

Exact equality throughout: these are integer counts and, for the last
point, identical inputs.
"""
import numpy as np
import pytest
import torch

from repro.core import build_spmv_plan as ref_build_spmv_plan
from repro.core.spmv import plan_fields as ref_plan_fields
from repro.core.spmv import plan_shard_arrays as ref_plan_shard_arrays
from repro.sparse import graded_extruded_mesh_matrix as ref_graded
from repro_torch.core import build_spmv_plan
from repro_torch.kernels import ops, ref
from repro_torch.sparse import (CSRMatrix, ELLMatrix, get_format,
                                graded_extruded_mesh_matrix,
                                random_spd_matrix)
from repro_torch.sparse.csr import ell_row_lens

GRIDS = [(4, 2), (1, 4)]


def _golden_plan(n_node, n_core):
    A = graded_extruded_mesh_matrix(48, 6, seed=0)
    plan, layout = build_spmv_plan(A, n_node, n_core, mode="balanced",
                                   format="ell", device="cpu")
    return A, plan, layout


def _split_nnz(A, node_bounds):
    """Per global row: its entries inside its node's column range (diag)
    and outside it (offd)."""
    nb = np.asarray(node_bounds, dtype=np.int64)
    rows = np.repeat(np.arange(A.n_rows), A.row_nnz)
    node = np.searchsorted(nb, rows, side="right") - 1
    inside = (A.indices >= nb[node]) & (A.indices < nb[node + 1])
    diag = np.bincount(rows[inside], minlength=A.n_rows)
    return diag, A.row_nnz - diag


@pytest.mark.parametrize("n_node,n_core", GRIDS)
def test_plan_row_lens_are_shard_row_nnz(n_node, n_core):
    A, plan, layout = _golden_plan(n_node, n_core)
    g = layout["global_row_of"]
    diag, offd = _split_nnz(A, layout["node_bounds"])
    for name, nnz in (("diag_len", diag), ("offd_len", offd)):
        got = plan.fmt_data[name]
        assert got.dtype == torch.int32
        assert tuple(got.shape) == (n_node, n_core, plan.rc_pad)
        want = np.where(g >= 0, nnz[np.maximum(g, 0)], 0)
        np.testing.assert_array_equal(got.numpy(), want)
    assert int(plan.fmt_data["diag_len"].sum()) + int(
        plan.fmt_data["offd_len"].sum()) == A.nnz
    # the golden-hashed fields and the stored-slot count are untouched
    assert plan.nnz_stored() == (plan.fmt_data["diag_cols"].numel()
                                 + plan.fmt_data["offd_cols"].numel())


@pytest.mark.parametrize("n_node,n_core", GRIDS)
def test_derive_aux_reproduces_row_lens_from_fields(n_node, n_core):
    _, plan, _ = _golden_plan(n_node, n_core)
    fmt = get_format("ell")
    own = fmt.derive_aux({k: plan.fmt_data[k].numpy() for k in fmt.fields},
                         plan.rc_pad)
    R = ref_graded(48, 6, seed=0)
    rplan, _ = ref_build_spmv_plan(R, n_node, n_core, mode="balanced",
                                   format="ell")
    arrays = dict(zip(ref_plan_fields(rplan), ref_plan_shard_arrays(rplan)))
    theirs = fmt.derive_aux({k: np.asarray(arrays[k]) for k in fmt.fields},
                            rplan.rc_pad)
    assert set(own) == set(theirs) == set(fmt.aux_fields)
    for k in fmt.aux_fields:
        assert own[k].dtype == theirs[k].dtype == np.int32
        np.testing.assert_array_equal(own[k], plan.fmt_data[k].numpy())
        np.testing.assert_array_equal(theirs[k], plan.fmt_data[k].numpy())


@pytest.mark.parametrize("n,nnz_per_row,pad", [(64, 5, 0), (300, 9, 13),
                                                (1024, 17, 1)])
def test_ell_matrix_row_lens_are_row_nnz(n, nnz_per_row, pad):
    A = random_spd_matrix(n, nnz_per_row=nnz_per_row, seed=n)
    for width in (None, int(A.row_nnz.max()) + 3):
        e = ELLMatrix.from_csr(A, width=width, n_rows_pad=n + pad,
                               device="cpu")
        assert e.row_lens.dtype == torch.int32
        np.testing.assert_array_equal(
            e.row_lens.numpy(), np.concatenate([A.row_nnz, np.zeros(pad)]))
    by_hand = ELLMatrix(cols=e.cols, vals=e.vals, n_rows=n, n_cols=n)
    assert by_hand.row_lens is None


def test_row_lens_stop_at_the_last_entry():
    """A stored 0.0 counts while its column is not 0 or an entry follows
    it; trailing zeros in column 0 are padding, and so cost nothing."""
    cols = np.array([[3, 0, 5, 0], [0, 0, 0, 0], [0, 2, 0, 0],
                     [4, 0, 0, 0], [1, 2, 3, 4]], dtype=np.int32)
    vals = np.array([[1.0, 0.0, 2.0, 0.0], [0.0, 0.0, 0.0, 0.0],
                     [0.0, 0.0, 0.0, 0.0], [0.0, 7.0, 0.0, 0.0],
                     [1.0, 1.0, 1.0, 1.0]])
    np.testing.assert_array_equal(ell_row_lens(cols, vals), [3, 0, 2, 2, 4])
    np.testing.assert_array_equal(
        ell_row_lens(cols[None, None], vals[None, None]), [[[3, 0, 2, 2, 4]]])
    np.testing.assert_array_equal(
        ell_row_lens(np.zeros((2, 3, 0), np.int32), np.zeros((2, 3, 0))),
        np.zeros((2, 3)))
    A = CSRMatrix(indptr=np.array([0, 2, 2, 3]), indices=np.array([1, 0, 2]),
                  data=np.array([5.0, 0.0, 1.0]), shape=(3, 3))
    # row 0 holds (0, 0.0) after (1, 5.0): the stored zero in column 0 is
    # not told from padding, and skipping it adds exactly nothing
    e = ELLMatrix.from_csr(A, device="cpu")
    np.testing.assert_array_equal(e.row_lens.numpy(), [1, 0, 1])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n_node,n_core", GRIDS)
def test_plain_versions_cut_to_row_lens_equal_full_width(n_node, n_core,
                                                         dtype):
    _, plan, _ = _golden_plan(n_node, n_core)
    F = {k: (v.to(dtype) if v.is_floating_point() else v)
         for k, v in plan.fmt_data.items()}
    rng = np.random.default_rng(5)
    xl = torch.from_numpy(rng.standard_normal((n_node, plan.nl_pad))
                          .astype(np.float32))
    xg = torch.from_numpy(rng.standard_normal((n_node, plan.g_pad + 1))
                          .astype(np.float32))
    cut = {}
    for s in ("diag", "offd"):
        vals, cols, lens = F[f"{s}_vals"], F[f"{s}_cols"], F[f"{s}_len"]
        live = torch.arange(vals.shape[-1]) < lens[..., None].long()
        cut[s] = (torch.where(live, vals, torch.zeros((), dtype=dtype)),
                  torch.where(live, cols, 0))
        # nothing but padding lies past a row's length
        assert torch.equal(cut[s][0], vals) and torch.equal(cut[s][1], cols)
    want = ref.fused_ell_spmv_ref(F["diag_vals"], F["diag_cols"],
                                  F["offd_vals"], F["offd_cols"], xl, xg)
    assert torch.equal(ref.fused_ell_spmv_ref(*cut["diag"], *cut["offd"],
                                              xl, xg), want)
    assert torch.equal(ref.ell_spmv_ref(*cut["diag"], xl),
                       ref.ell_spmv_ref(F["diag_vals"], F["diag_cols"], xl))
    # on the CPU the wrappers take the plain version, lengths or none
    fmt = get_format("ell")
    assert torch.equal(fmt.matvec_kernel(F, xl, xg, plan.rc_pad), want)
    assert torch.equal(ops.ell_spmv(F["diag_vals"], F["diag_cols"], xl,
                                    lens=F["diag_len"]),
                       fmt.matvec_plain(F, xl, None, plan.rc_pad))
