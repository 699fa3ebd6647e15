"""The port's distributed SpMV against the JAX reference, on the CPU.

The reference side (``make_spmv`` / ``make_exchange`` on 8 XLA host
devices) runs in a subprocess, ``tests/torch_reference.py``, on the golden
matrix at 4×2 and on a halo-free 1×4 grid, for ell and sell.  The port runs
on the CPU, where its kernel wrappers take the plain versions.

Tolerances:
  * the ghost buffer ``[..., :g_pad]`` is bit-equal: the exchange only
    moves data (the dump slot ``g_pad`` is write-only and not compared);
  * SpMV within ``2e-5·max|y|`` of the reference's ``jnp`` and interpret-
    mode ``pallas`` outputs (``tests/test_kernels.py``'s f32 bound), both
    on the port's own plan and on the reference plan carried across with
    ``plan_from_arrays``;
  * the plain versions against ``repro.kernels.ref`` and the reference's
    interpret-mode SELL kernels: ``2e-5·max|y|`` in f32, ``2e-2·max|y|``
    with bf16 storage.
"""
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import run_subprocess
from repro.kernels import ops as ref_ops
from repro.kernels.ref import ell_spmv_ref as jax_ell_spmv_ref
from repro_torch.core import (build_spmv_plan, from_dist, make_spmv,
                              plan_from_arrays, to_dist)
from repro_torch.core.spmv import plan_fields
from repro_torch.core.transport import A2ATransport, resolve_transport
from repro_torch.kernels import ops, ref
from repro_torch.sparse import BalancedCOO, graded_extruded_mesh_matrix

HERE = os.path.dirname(os.path.abspath(__file__))
CASES = ("ell/4x2", "sell/4x2", "ell/1x4", "sell/1x4")


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    out = tmp_path_factory.mktemp("ref") / "ref.npz"
    res = run_subprocess([os.path.join(HERE, "torch_reference.py"),
                          str(out)], device_count=8)
    assert res.returncode == 0, res.stderr[-4000:]
    with np.load(out) as d:
        return {k: d[k] for k in d.files}


@pytest.fixture(scope="module")
def golden():
    A = graded_extruded_mesh_matrix(48, 6, seed=0)
    rng = np.random.default_rng(7)
    x = rng.standard_normal(A.n_rows).astype(np.float32)
    return A, x


def _plans(case, A, reference):
    fmt, grid = case.split("/")
    n_node, n_core = (int(v) for v in grid.split("x"))
    plan, layout = build_spmv_plan(A, n_node, n_core, mode="balanced",
                                   format=fmt,
                                   device="cpu")
    meta = json.loads(str(reference[f"{case}/meta"]))
    arrays = {k: reference[f"{case}/{k}"]
              for k in plan_fields(plan) + ("diag_a", "mask")}
    return plan, layout, plan_from_arrays(arrays, meta, device="cpu")


@pytest.mark.parametrize("case", CASES[:2])
def test_ghost_buffer_bit_equal(case, reference, golden):
    A, x = golden
    plan, layout, _ = _plans(case, A, reference)
    tr, state = resolve_transport(plan.transport, plan)
    xd = to_dist(x, layout, plan)
    F = {"send_own": plan.send_own, "recv_own": plan.recv_own,
         **tr.extra_arrays(plan, state)}
    ghost = tr.exchange(xd, F, state=state, n_node=plan.n_node,
                        g_pad=plan.g_pad).numpy()
    want = reference[f"{case}/ghost"]                # (n_node, n_core, g+1)
    g = plan.g_pad
    for c in range(plan.n_core):
        assert ghost[:, :g].tobytes() == want[:, c, :g].tobytes()
    host = A2ATransport().host_exchange(
        xd.numpy(), plan.send_own.numpy(), plan.recv_own.numpy(), g, state)
    assert host[..., :g].tobytes() == want[..., :g].tobytes()


@pytest.mark.parametrize("ref_backend", ["jnp", "pallas"])
@pytest.mark.parametrize("case", CASES)
def test_spmv_matches_reference(case, ref_backend, reference, golden):
    A, x = golden
    plan, layout, carried = _plans(case, A, reference)
    xd = to_dist(x, layout, plan)
    want = reference[f"{case}/y_{ref_backend}"]
    for p in (plan, carried):
        y = make_spmv(p)(xd).numpy()
        assert y.shape == want.shape
        np.testing.assert_allclose(y, want, atol=2e-5 * np.abs(want).max())
    host = A.matvec(x.astype(np.float64))
    np.testing.assert_allclose(from_dist(torch.from_numpy(y), layout, plan),
                               host, atol=2e-5 * np.abs(host).max())


def _tol(dtype):
    return 2e-2 if dtype == torch.bfloat16 else 2e-5


def _rand_ell(rng, n_node, n_core, rows, w, n, dtype):
    vals = torch.from_numpy(rng.standard_normal((n_node, n_core, rows, w))
                            .astype(np.float32)).to(dtype)
    cols = torch.from_numpy(rng.integers(0, n, (n_node, n_core, rows, w))
                            .astype(np.int32))
    return vals, cols


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ell_plain_versions_match_jax_oracle(dtype):
    rng = np.random.default_rng(3)
    n_node, n_core, rows, nl, ng = 3, 2, 40, 70, 17
    dv, dc = _rand_ell(rng, n_node, n_core, rows, 9, nl, dtype)
    ov, oc = _rand_ell(rng, n_node, n_core, rows, 4, ng, dtype)
    xl = torch.from_numpy(rng.standard_normal((n_node, nl)).astype(np.float32))
    xg = torch.from_numpy(rng.standard_normal((n_node, ng)).astype(np.float32))
    y_diag = ref.ell_spmv_ref(dv, dc, xl)
    y = ref.fused_ell_spmv_ref(dv, dc, ov, oc, xl, xg)
    assert torch.equal(ops.ell_spmv(dv, dc, xl), y_diag)
    assert torch.equal(ops.fused_ell_spmv(dv, dc, ov, oc, xl, xg), y)
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32

    def j(t):
        return jnp.asarray(t.float().numpy(), dtype=jdt)

    for i in range(n_node):
        for c in range(n_core):
            want_d = np.asarray(jax_ell_spmv_ref(j(dv[i, c]), dc[i, c].numpy(),
                                                 xl[i].numpy()))
            want = want_d + np.asarray(jax_ell_spmv_ref(
                j(ov[i, c]), oc[i, c].numpy(), xg[i].numpy()))
            scale = max(1.0, np.abs(want).max())
            np.testing.assert_allclose(y_diag[i, c].numpy(), want_d,
                                       atol=_tol(dtype) * scale)
            np.testing.assert_allclose(y[i, c].numpy(), want,
                                       atol=_tol(dtype) * scale)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("fmt_case", ["sell/4x2", "sell/1x4"])
def test_sell_plain_versions_match_pallas_interpret(fmt_case, dtype, golden):
    """The SELL plain versions on a real plan's streams against the
    reference's interpret-mode SELL kernels, shard by shard."""
    A, _ = golden
    grid = fmt_case.split("/")[1]
    n_node, n_core = (int(v) for v in grid.split("x"))
    plan, _ = build_spmv_plan(A, n_node, n_core, format="sell", device="cpu")
    F = plan.fmt_data
    rng = np.random.default_rng(4)
    xl = torch.from_numpy(rng.standard_normal((n_node, plan.nl_pad))
                          .astype(np.float32))
    xg = (torch.from_numpy(rng.standard_normal((n_node, plan.g_pad + 1))
                           .astype(np.float32)) if plan.hs else None)
    dv, ov = F["sell_dvals"].to(dtype), F["sell_ovals"].to(dtype)
    args = (dv, F["sell_dcols"], F["sell_dstart"], F["sell_dwidth"],
            ov, F["sell_ocols"], F["sell_ostart"], F["sell_owidth"])
    y = ops.fused_sell_spmv(*args, xl, xg, plan.rc_pad)
    assert torch.equal(y, ref.fused_sell_spmv_ref(*args, xl, xg,
                                                  plan.rc_pad))
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    for i in range(n_node):
        for c in range(n_core):
            want = np.asarray(ref_ops.fused_sell_spmv(
                jnp.asarray(dv[i, c].float().numpy(), dtype=jdt),
                F["sell_dcols"][i, c].numpy(), F["sell_drows"][i, c].numpy(),
                jnp.asarray(ov[i, c].float().numpy(), dtype=jdt),
                F["sell_ocols"][i, c].numpy(), F["sell_orows"][i, c].numpy(),
                xl[i].numpy(), None if xg is None else xg[i].numpy(),
                rc_pad=plan.rc_pad, interpret=True))
            scale = max(1.0, np.abs(want).max())
            np.testing.assert_allclose(y[i, c].numpy(), want,
                                       atol=_tol(dtype) * scale)


def test_wrappers_refuse_other_devices_and_types():
    v = torch.zeros((1, 1, 8, 2), device="meta")
    c = torch.zeros((1, 1, 8, 2), dtype=torch.int32, device="meta")
    x = torch.zeros((1, 4), device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        ops.ell_spmv(v, c, x)
    with pytest.raises(ValueError, match="cuda or cpu"):
        ops.fused_ell_spmv(v, c, v, c, x, x)
    b = BalancedCOO(vals=v[0, 0], cols=c[0, 0], lrows=c[0, 0],
                    bin_starts=c[0, 0, :, 0], out_gather=c[0, 0, :4, 0],
                    row_lens=c[0, 0, :4, 0], warp_map=c[0, 0, :1, :],
                    n_rows=4, n_cols=4, rows_pad=8,
                    bin_nnz=(0,) * 8)
    with pytest.raises(ValueError, match="cuda or cpu"):
        ops.balanced_spmv(b, x[0])
    assert set(ops.LAUNCHES) == {"fused_ell_spmv", "ell_spmv",
                                 "fused_sell_spmv", "sell_spmv",
                                 "balanced_spmv", "fused_ell_spmv_batched",
                                 "ell_spmv_batched",
                                 "fused_sell_spmv_batched",
                                 "sell_spmv_batched"}
