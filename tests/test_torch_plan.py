"""The port's plan builder against the JAX package's.

* All 8 entries of ``tests/golden_square_hashes.json`` (ell/sell × the
  four transports, whose plan arrays are identical): the port builds each
  entry with its own transport and must reproduce every ``plan`` hash and
  the ``meta`` — hashed with the fixture's own ``square_golden._hash``
  (dtype, shape and bytes).
* Against the reference builder in-process across modes, formats and
  grids: every plan array byte-identical, same meta, same layout maps and
  the same census of all four transports.
* ``to_dist``/``from_dist`` round trip; ``plan_from_arrays`` carries a
  plan across unchanged and re-derives the SELL slice descriptors.
* SELL slices lie back to back in their stream, as the SELL kernel needs.
"""
import functools
import json
import pathlib

import numpy as np
import pytest
import torch

from repro.core import build_spmv_plan as ref_build_spmv_plan
from repro.core.spmv import plan_fields as ref_plan_fields
from repro.core.spmv import plan_shard_arrays as ref_plan_shard_arrays
from repro.sparse import graded_extruded_mesh_matrix as ref_graded
from repro.testing.square_golden import PLAN_META, _hash
from repro_torch.core import build_spmv_plan, from_dist, plan_from_arrays
from repro_torch.core import to_dist
from repro_torch.core.spmv import PLAN_META as PORT_META
from repro_torch.core.spmv import plan_fields, plan_shard_arrays
from repro_torch.sparse import CSRMatrix, get_format
from repro_torch.sparse import graded_extruded_mesh_matrix

GOLDEN = json.loads((pathlib.Path(__file__).parent
                     / "golden_square_hashes.json").read_text())


@functools.cache
def _golden_plan(fmt, transport):
    A = graded_extruded_mesh_matrix(48, 6, seed=0)
    return build_spmv_plan(A, GOLDEN["n_node"], GOLDEN["n_core"],
                           mode="balanced", format=fmt, transport=transport,
                           device="cpu")[0]


@pytest.mark.parametrize("key", sorted(GOLDEN["entries"]))
def test_golden_plan_hashes_and_meta(key):
    want = GOLDEN["entries"][key]
    fmt, transport = key.split("/")
    plan = _golden_plan(fmt, transport)
    assert (plan.format, plan.transport) == (fmt, transport)
    assert {k: int(getattr(plan, k)) for k in PLAN_META} == want["meta"]
    got = {name: _hash(t.numpy())
           for name, t in zip(plan_fields(plan), plan_shard_arrays(plan))}
    got["mask"] = _hash(plan.mask.numpy())
    got["diag_a"] = _hash(plan.diag_a.numpy())
    assert got == want["plan"]


CASES = [("balanced", "ell", 4, 2), ("balanced", "sell", 4, 2),
         ("balanced", "ell", 1, 4), ("balanced", "sell", 1, 4),
         ("vector", "ell", 3, 2), ("task", "sell", 2, 3),
         ("balanced", "sell", 5, 1)]


@pytest.mark.parametrize("mode,fmt,n_node,n_core", CASES)
def test_plan_matches_reference_builder(mode, fmt, n_node, n_core):
    A = graded_extruded_mesh_matrix(60, 9, seed=3, max_span=4)
    R = ref_graded(60, 9, seed=3, max_span=4)
    plan, layout = build_spmv_plan(A, n_node, n_core, mode=mode, format=fmt,
                                   device="cpu")
    rplan, rlayout = ref_build_spmv_plan(R, n_node, n_core, mode=mode,
                                         format=fmt)
    assert plan_fields(plan) == ref_plan_fields(rplan)
    for name, got, want in zip(plan_fields(plan), plan_shard_arrays(plan),
                               ref_plan_shard_arrays(rplan)):
        assert _hash(got.numpy()) == _hash(want), name
    for name in ("diag_a", "mask"):
        assert _hash(getattr(plan, name).numpy()) == \
            _hash(getattr(rplan, name)), name
    for k in PORT_META:
        assert getattr(plan, k) == getattr(rplan, k), k
    np.testing.assert_array_equal(layout["global_row_of"],
                                  rlayout["global_row_of"])
    assert layout["stats"] == pytest.approx(rlayout["stats"])
    assert set(layout["transport_census"]) == {"a2a", "hier", "pairwise",
                                                "ring"}
    assert layout["transport_census"] == rlayout["transport_census"]


@pytest.mark.parametrize("fmt", ["ell", "sell"])
@pytest.mark.parametrize("n_node,n_core", [(4, 2), (1, 4)])
def test_to_dist_from_dist_round_trip(fmt, n_node, n_core):
    A = graded_extruded_mesh_matrix(48, 6, seed=0)
    plan, layout = build_spmv_plan(A, n_node, n_core, format=fmt,
                                   device="cpu")
    v = np.random.default_rng(2).standard_normal(A.n_rows).astype(np.float32)
    vd = to_dist(v, layout, plan)
    assert tuple(vd.shape) == plan.cg_shape and vd.dtype == torch.float32
    np.testing.assert_array_equal(from_dist(vd, layout, plan), v)
    # padding slots hold zeros; the mask marks exactly the real rows
    assert torch.equal(vd * plan.mask, vd)
    assert int(plan.mask.sum()) == A.n_rows


@pytest.mark.parametrize("fmt", ["ell", "sell"])
@pytest.mark.parametrize("n_node,n_core", [(4, 2), (1, 4), (5, 1)])
def test_plan_from_arrays_carries_a_plan_across(fmt, n_node, n_core):
    A = graded_extruded_mesh_matrix(60, 9, seed=3, max_span=4)
    plan, _ = build_spmv_plan(A, n_node, n_core, format=fmt, device="cpu")
    arrays = {name: t.numpy() for name, t in
              zip(plan_fields(plan), plan_shard_arrays(plan))}
    arrays.update(diag_a=plan.diag_a.numpy(), mask=plan.mask.numpy())
    meta = {k: getattr(plan, k) for k in PORT_META}
    got = plan_from_arrays(arrays, meta, device="cpu")
    fmt_obj = get_format(fmt)
    assert set(got.fmt_data) == set(fmt_obj.fields + fmt_obj.aux_fields)
    for k, t in plan.fmt_data.items():
        assert torch.equal(got.fmt_data[k], t), k
    for k in ("send_own", "recv_own", "x_gather", "diag_a", "mask"):
        assert torch.equal(getattr(got, k), getattr(plan, k)), k
    for k in PORT_META:
        assert getattr(got, k) == getattr(plan, k), k


@pytest.mark.parametrize("n_node,n_core", [(4, 2), (1, 4), (5, 1)])
def test_sell_slices_lie_back_to_back(n_node, n_core):
    """The SELL kernel reads a warp's slots as one contiguous range from its
    first slot, so every shard's slices must follow each other with no gap:
    ``start[s + 1] == start[s] + C * width[s]``, inside the stream."""
    A = graded_extruded_mesh_matrix(60, 9, seed=3, max_span=4)
    plan, _ = build_spmv_plan(A, n_node, n_core, format="sell", device="cpu")
    C = get_format("sell").slice_height
    for s in ("d", "o"):
        start = plan.fmt_data[f"sell_{s}start"].numpy().astype(np.int64)
        width = plan.fmt_data[f"sell_{s}width"].numpy().astype(np.int64)
        end = start + C * width
        assert (width >= 0).all()
        np.testing.assert_array_equal(start[..., 1:], end[..., :-1])
        assert (start[..., 0] == 0).all()
        assert (end[..., -1] <= plan.fmt_data[f"sell_{s}vals"].shape[-1]).all()


def test_build_rejects_what_it_cannot_plan():
    A = graded_extruded_mesh_matrix(48, 6, seed=0)
    # rectangular plans are planned (tests/test_torch_rect.py); a column
    # index past n_cols is not
    narrow = CSRMatrix(indptr=A.indptr, indices=A.indices, data=A.data,
                       shape=(A.n_rows, A.n_rows - 1))
    with pytest.raises(ValueError, match="column index out of range"):
        build_spmv_plan(narrow, 2, 2, device="cpu")
    zero = CSRMatrix.from_dense(np.array([[0.0, 1.0], [1.0, 2.0]]))
    with pytest.raises(ValueError, match="diagonal"):
        build_spmv_plan(zero, 1, 1, device="cpu")
    for kw in ({"transport": "bogus"}, {"wire_dtype": "f16"},
               {"format": "csr"}, {"mode": "fast"},
               {"node_partition": "cols"}):
        with pytest.raises(ValueError):
            build_spmv_plan(A, 2, 2, device="cpu", **kw)
