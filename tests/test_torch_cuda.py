"""The CUDA kernels on the card (marked ``cuda``; they skip without one).

Imports neither ``jax`` nor the JAX package, so it runs on a GPU machine
that has only PyTorch:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Tolerances: each kernel against its plain version on identical inputs
within ``2e-5·max(1, max|y|)``, with f32 and with bf16 storage: both
accumulate in f32 on the same values, so only the summation order differs
(``tests/test_kernels.py``'s f32 bound); golden CG iterations within ±1 of
the fixture.
"""
import json
import pathlib

import numpy as np
import pytest
import torch

from repro_torch.core import (build_spmv_plan, make_shard_body, make_spmv,
                              to_dist)
from repro_torch.kernels import LAUNCHES, ops, reset_launches
from repro_torch.solvers import make_solver
from repro_torch.sparse import get_format, graded_extruded_mesh_matrix

pytestmark = pytest.mark.cuda

GOLDEN = json.loads((pathlib.Path(__file__).parent
                     / "golden_square_hashes.json").read_text())
CASES = {"ell/4x2": "fused_ell_spmv", "sell/4x2": "fused_sell_spmv",
         "ell/1x4": "ell_spmv", "sell/1x4": "sell_spmv"}


@pytest.fixture(scope="module")
def golden():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is "
                    "False)")
    A = graded_extruded_mesh_matrix(48, 6, seed=0)
    rng = np.random.default_rng(7)
    x = rng.standard_normal(A.n_rows).astype(np.float32)
    b = rng.standard_normal(A.n_rows).astype(np.float32)
    return A, x, b


def _plan(case, A):
    fmt, grid = case.split("/")
    n_node, n_core = (int(v) for v in grid.split("x"))
    return build_spmv_plan(A, n_node, n_core, mode="balanced",
                           format=fmt, device="cuda")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", sorted(CASES))
def test_kernel_matches_plain_version(case, dtype, golden):
    A, x, _ = golden
    plan, layout = _plan(case, A)
    plan.fmt_data.update({k: v.to(dtype) for k, v in plan.fmt_data.items()
                          if v.is_floating_point()})
    xd = to_dist(x, layout, plan)
    reset_launches()
    y = make_spmv(plan)(xd)
    torch.cuda.synchronize()
    assert LAUNCHES == {k: int(k == CASES[case]) for k in LAUNCHES}
    xl, xg = make_shard_body(plan).inputs(xd)
    want = get_format(plan.format).matvec_plain(plan.fmt_data, xl, xg,
                                                plan.rc_pad)
    tol = 2e-5 * max(1.0, float(want.abs().max()))
    assert y.dtype == torch.float32 and y.shape == want.shape
    assert float((y - want).abs().max()) <= tol


@pytest.mark.parametrize("fmt", ["ell", "sell"])
def test_golden_cg_on_the_card(fmt, golden):
    A, _, b = golden
    plan, layout = _plan(f"{fmt}/4x2", A)
    _, iters, rel = make_solver(plan)(to_dist(b, layout, plan), tol=1e-6,
                                      maxiter=400)
    want = GOLDEN["entries"][f"{fmt}/a2a"]["cg"]["iters"]
    assert abs(int(iters) - want) <= 1 and float(rel) <= 1e-6


def test_wrappers_raise_on_what_the_kernel_does_not_take(golden):
    A, x, _ = golden
    plan, layout = _plan("ell/4x2", A)
    F = plan.fmt_data
    xl = torch.zeros((plan.n_node, plan.nl_pad), device="cuda")
    xg = torch.zeros((plan.n_node, plan.g_pad + 1), device="cuda")
    args = [F["diag_vals"], F["diag_cols"], F["offd_vals"], F["offd_cols"]]
    with pytest.raises(TypeError):
        ops.fused_ell_spmv(*args, xl.double(), xg)
    with pytest.raises(TypeError):
        ops.fused_ell_spmv(args[0], args[1].long(), *args[2:], xl, xg)
    with pytest.raises(TypeError):
        ops.fused_ell_spmv(args[0].half(), *args[1:], xl, xg)
    with pytest.raises(ValueError):
        ops.fused_ell_spmv(*args, xl[:, ::2], xg)
    with pytest.raises(ValueError):
        ops.fused_ell_spmv(*args, xl.cpu(), xg)
