"""The batched shard body: k right-hand sides through one exchange and one
local matvec, column for column the single-column body bit for bit.

The JAX package batches right-hand sides by ``jax.vmap`` over its shard
body (``src/repro/solvers/base.py:419``), so each column of a batched
SpMV, exchange or preconditioner apply is that column alone.  The port
writes the batch axis out (one exchange over the batch, one batched
kernel launch on the card); these tests hold it to the same contract on
the CPU, where the wrappers run their plain versions, on the golden
matrix (``graded_extruded_mesh_matrix(48, 6)``):

  * the batched body's column j is the unbatched body on ``x_j`` bit for
    bit, for ell/sell × 4×2/1×4 × every transport × f32/bf16/int8 wire
    (int8 keeps one scale per column per chunk, as ``vmap`` gives);
  * every transport's batched exchange likewise, ghost for ghost;
  * changing the other columns of a batch leaves column j bit for bit
    unchanged through the local matvec, two_level's apply (batched R and
    P bodies and one coarse product; against the single-column apply
    within 1e-5 relative, the coarse product summing in another order),
    and a whole ``make_solver(nrhs=3)`` solve (per-RHS reductions and
    gating);
  * the wrappers take 1 to ``MAX_NRHS`` columns and refuse more, or a
    batch ``x_local``/``x_ghost`` disagree on, before any work;
  * ``ops.interleave_rhs``, the column-interleaved ``x`` the batched
    kernels read, for every k from 1 to ``MAX_NRHS``: ``xi[node, col, j]
    == x[j, node, col]`` and zeros in the pad up to the column tile, from
    a contiguous batch, a strided slice of a larger one and a batch whose
    last two axes are transposed.  Both refuse a batch of 0 or more than
    ``MAX_NRHS`` columns.

Equality is exact elsewhere: the batched paths do the same arithmetic on
each column in the same order.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import build_spmv_plan, make_shard_body, to_dist
from repro_torch.core.transport import (available_transports,
                                        available_wire_dtypes,
                                        resolve_transport)
from repro_torch.kernels import ops
from repro_torch.solvers import make_solver
from repro_torch.solvers.base import make_precond_apply, to_dist_batch
from repro_torch.sparse import get_format, graded_extruded_mesh_matrix

K = 3


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Tiny shapes: one intra-op thread is faster and leaves the cores to
    the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def golden():
    return graded_extruded_mesh_matrix(48, 6, seed=0)


@pytest.fixture(scope="module")
def plans(golden):
    return {(fmt, grid): build_spmv_plan(golden, *grid, mode="balanced",
                                         node_partition="nnz", format=fmt,
                                         device="cpu")
            for fmt in ("ell", "sell") for grid in ((4, 2), (1, 4))}


def _batch(plan, layout, seed, k=K):
    rng = np.random.default_rng(seed)
    return torch.stack([to_dist(rng.standard_normal(plan.n), layout, plan)
                        for _ in range(k)])


@pytest.mark.parametrize("wd", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("tr", ["a2a", "ring", "pairwise", "hier"])
@pytest.mark.parametrize("grid", [(4, 2), (1, 4)], ids=["4x2", "1x4"])
@pytest.mark.parametrize("fmt", ["ell", "sell"])
def test_batched_body_column_is_the_single_body(fmt, grid, tr, wd, plans):
    assert set(available_transports()) == {"a2a", "ring", "pairwise",
                                           "hier"}
    assert set(available_wire_dtypes()) == {"f32", "bf16", "int8"}
    plan, layout = plans[(fmt, grid)]
    body = make_shard_body(plan, transport=tr, wire_dtype=wd)
    X = _batch(plan, layout, seed=5)
    y = body(X)
    assert y.shape == (K,) + plan.cg_shape
    for j in range(K):
        assert torch.equal(y[j], body(X[j])), (fmt, grid, tr, wd, j)
    xl, xg = body.inputs(X)
    for j in range(K):
        xl_j, xg_j = body.inputs(X[j])
        assert torch.equal(xl[j], xl_j)
        assert (xg is None) == (xg_j is None) == (plan.hs == 0)
        if xg is not None:
            assert torch.equal(xg[j][:, :plan.g_pad], xg_j[:, :plan.g_pad])


@pytest.mark.parametrize("wd", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("tr", ["a2a", "ring", "pairwise", "hier"])
def test_batched_exchange_column_is_the_single_exchange(tr, wd, plans):
    """Ghost for ghost at every real slot; the int8 codec scales each
    column's chunks alone (a column of large values beside one of small
    ones would move the small one's bits under a shared scale)."""
    plan, layout = plans[("ell", (4, 2))]
    t, state = resolve_transport(tr, plan, wire_dtype=wd)
    F = {"send_own": plan.send_own, "recv_own": plan.recv_own,
         **t.extra_arrays(plan, state)}
    X = _batch(plan, layout, seed=9)
    X[1] *= 1e3
    g = t.exchange(X, F, state=state, n_node=plan.n_node, g_pad=plan.g_pad)
    assert g.shape == (K, plan.n_node, plan.g_pad + 1)
    for j in range(K):
        gj = t.exchange(X[j], F, state=state, n_node=plan.n_node,
                        g_pad=plan.g_pad)
        assert torch.equal(g[j, :, :plan.g_pad], gj[:, :plan.g_pad])


@pytest.mark.parametrize("fmt", ["ell", "sell"])
def test_local_matvec_column_ignores_the_other_columns(fmt, plans):
    plan, layout = plans[(fmt, (4, 2))]
    body = make_shard_body(plan)
    X = _batch(plan, layout, seed=3)
    Y = X.clone()
    Y[1:] = _batch(plan, layout, seed=4)[1:]
    assert torch.equal(body(X)[0], body(Y)[0])
    assert not torch.equal(body(X)[1], body(Y)[1])


@pytest.mark.parametrize("fmt", ["ell", "sell"])
def test_two_level_column_ignores_the_other_columns(fmt, golden, plans):
    """The coarse correction runs the batched R and P bodies and one
    coarse product for all columns; column 0 keeps its bits when the
    others change.  Against the apply on that column alone it agrees to
    f32 rounding only: one column's coarse product is a matrix-vector
    product, a batch's a matrix-matrix product, which sums in another
    order (as the JAX package's ``vmap`` of its ``mv`` does)."""
    plan, layout = plans[(fmt, (4, 2))]
    apply = make_precond_apply(plan, precond="two_level", A=golden,
                               layout=layout,
                               precond_options={"agg_size": 8})
    R = _batch(plan, layout, seed=6)
    S = R.clone()
    S[1:] = -3.0 * R[1:] + 1.0 * plan.mask
    z_r = apply.papply(apply.pdata, R)
    z_s = apply.papply(apply.pdata, S)
    assert torch.equal(z_r[0], z_s[0])
    assert not torch.equal(z_r[1], z_s[1])
    single = apply(R[0])
    assert float((z_r[0] - single).abs().max()) <= \
        1e-5 * float(single.abs().max())


def test_batched_solve_column_ignores_the_other_columns(golden, plans):
    plan, layout = plans[("sell", (4, 2))]
    rng = np.random.default_rng(12)
    B = rng.normal(size=(K, golden.n_rows))
    C = B.copy()
    C[1:] = rng.normal(size=(K - 1, golden.n_rows))
    solve = make_solver(plan, nrhs=K)
    xb, ib, _ = solve(to_dist_batch(B, layout, plan), tol=1e-5,
                      maxiter=400)
    xc, ic, _ = solve(to_dist_batch(C, layout, plan), tol=1e-5,
                      maxiter=400)
    assert torch.equal(xb[:, :, 0], xc[:, :, 0])
    assert int(ib[0]) == int(ic[0])


def test_wrappers_take_one_to_max_nrhs_columns(plans):
    plan, layout = plans[("ell", (4, 2))]
    F = plan.fmt_data
    fmt = get_format("ell")
    body = make_shard_body(plan)
    args = (F["diag_vals"], F["diag_cols"], F["offd_vals"], F["offd_cols"])
    X = _batch(plan, layout, seed=1, k=ops.MAX_NRHS)
    xl, xg = body.inputs(X)
    y = ops.fused_ell_spmv(*args, xl, xg)
    assert y.shape == (ops.MAX_NRHS,) + plan.cg_shape
    assert torch.equal(y, fmt.matvec_plain(F, xl, xg, plan.rc_pad))
    big_l = torch.cat([xl, xl[:1]])
    big_g = torch.cat([xg, xg[:1]])
    with pytest.raises(ValueError, match="1 to 16"):
        ops.fused_ell_spmv(*args, big_l, big_g)
    with pytest.raises(ValueError, match="1 to 16"):
        ops.ell_spmv(F["diag_vals"], F["diag_cols"], big_l)
    with pytest.raises(ValueError, match="differ in batch"):
        ops.fused_ell_spmv(*args, xl[:3], xg[:2])
    with pytest.raises(ValueError, match="batched x_ghost"):
        ops.fused_ell_spmv(*args, xl[0], xg[:1])
    sp, sl = plans[("sell", (4, 2))]
    G = sp.fmt_data
    sargs = (G["sell_dvals"], G["sell_dcols"], G["sell_dstart"],
             G["sell_dwidth"], G["sell_ovals"], G["sell_ocols"],
             G["sell_ostart"], G["sell_owidth"])
    sxl, sxg = make_shard_body(sp).inputs(_batch(sp, sl, seed=1, k=17))
    with pytest.raises(ValueError, match="1 to 16"):
        ops.fused_sell_spmv(*sargs, sxl, sxg, sp.rc_pad)
    with pytest.raises(ValueError, match="nrhs"):
        make_solver(plan, nrhs=17)


def test_sell_layout_is_checked_when_a_plan_is_bound(plans):
    """The SELL kernels read a warp's slots as one contiguous range, so a
    shard body refuses a plan whose slices are not back to back — on the
    host, once, before any launch."""
    plan, _ = plans[("sell", (4, 2))]
    F = plan.fmt_data
    ops.check_sell_layout(F["sell_dstart"], F["sell_dwidth"],
                          F["sell_dvals"].shape[-1])
    bad = F["sell_dstart"].clone()
    bad[0, 0, 1] += 1
    with pytest.raises(ValueError, match="back to back"):
        ops.check_sell_layout(bad, F["sell_dwidth"],
                              F["sell_dvals"].shape[-1])
    with pytest.raises(ValueError, match="back to back"):
        ops.check_sell_layout(F["sell_dstart"], F["sell_dwidth"], 0)
    plan.fmt_data = dict(F, sell_dstart=bad)
    try:
        with pytest.raises(ValueError, match="back to back"):
            make_shard_body(plan)
        make_shard_body(plan, backend="plain")      # the plain one reads any
    finally:
        plan.fmt_data = F


@pytest.mark.parametrize("k", range(1, ops.MAX_NRHS + 1))
def test_interleave_rhs_is_the_kernels_layout(k):
    rng = np.random.default_rng(100 + k)
    n_node, n = 3, 37
    kt = ops.rhs_tile(k)
    assert kt in ops.RHS_TILES and kt >= k
    assert kt == 4 or ops.RHS_TILES[ops.RHS_TILES.index(kt) - 1] < k
    big = torch.from_numpy(rng.standard_normal((2 * k, n_node, n))
                           .astype(np.float32))
    for x in (big[:k].contiguous(), big[1::2],
              big[:k].transpose(1, 2).contiguous().transpose(1, 2)):
        xi = ops.interleave_rhs(x)
        assert xi.shape == (n_node, n, kt) and xi.dtype == x.dtype
        assert xi.is_contiguous()
        for j in range(k):
            assert torch.equal(xi[:, :, j], x[j])
        assert (xi[:, :, k:] == 0).all()
        assert not torch.signbit(xi[:, :, k:]).any()


@pytest.mark.parametrize("k", [0, ops.MAX_NRHS + 1])
def test_interleave_rhs_refuses_a_batch_no_launch_takes(k):
    with pytest.raises(ValueError, match=f"1 to {ops.MAX_NRHS}"):
        ops.rhs_tile(k)
    with pytest.raises(ValueError, match=f"1 to {ops.MAX_NRHS}"):
        ops.interleave_rhs(torch.zeros((k, 2, 5)))
