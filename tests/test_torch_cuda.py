"""The CUDA kernels on the card (marked ``cuda``; they skip without one).

Imports neither ``jax`` nor the JAX package, so it runs on a GPU machine
that has only PyTorch:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Tolerances: each kernel against its plain version on identical inputs
within ``2e-5·max(1, max|y|)``, with f32 and with bf16 storage: both
accumulate in f32 on the same values, so only the summation order differs
(``tests/test_kernels.py``'s f32 bound); golden CG iterations within ±1 of
the fixture; rows, slots and bins with no entries exactly 0; two launches
on the same inputs, and the ELL kernel with and without row lengths,
bitwise equal (each row is summed in entry order, and the padding the
lengths skip adds exactly 0).  Rectangular plans against the host f64
matvec within 1e-5 relative, every transport bit for bit a2a; each
preconditioner's apply on the card within 2e-5 relative of the CPU's, and
cg counts with block_jacobi / two_level within ±1 of the CPU's.
"""
import dataclasses
import json
import pathlib

import numpy as np
import pytest
import torch

from repro_torch.core import (build_spmv_plan, make_shard_body, make_spmv,
                              partition_balanced, partition_equal_rows,
                              to_dist)
from repro_torch.kernels import LAUNCHES, ops, ref, reset_launches
from repro_torch.solvers import make_solver
from repro_torch.sparse import (BalancedCOO, CSRMatrix, ELLMatrix, get_format,
                                graded_extruded_mesh_matrix)
from repro_torch.util import to_device

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


# --------------------------------------------------------------------- #
# the ELL and SELL kernels: padding, empty rows, determinism, row lengths
# --------------------------------------------------------------------- #
def _random_csr(rng, n_rows, n_cols, max_nnz, empty):
    """Rows of 0..max_nnz entries (``empty`` of them none), random columns
    and values."""
    nnz = rng.integers(0, max_nnz + 1, n_rows)
    nnz[rng.choice(n_rows, empty, replace=False)] = 0
    rows = np.repeat(np.arange(n_rows), nnz)
    return CSRMatrix.from_coo(rows, rng.integers(0, n_cols, len(rows)),
                              rng.standard_normal(len(rows)),
                              (n_rows, n_cols))


@pytest.mark.parametrize("fmt_name", ["ell", "sell"])
def test_kernels_write_zeros_where_there_are_no_entries(fmt_name, golden):
    """One node of two cores, packed by the format itself: rows with no
    entries, the ``rc_pad`` tail of each core's bin, rows of up to 150
    entries (a warp stages more than one chunk) -- against the plain
    version, with every empty slot exactly 0 whatever the memory held."""
    rng = np.random.default_rng(11)
    n, n_ghost, rc_pad = 150, 7, 88
    diag = _random_csr(rng, n, n, 150, 20)
    offd = _random_csr(rng, n, n_ghost, 4, 60)
    cb = np.array([0, 70, n])
    c_of = np.searchsorted(cb, np.arange(n), side="right") - 1
    fmt = get_format(fmt_name)
    slots = fmt.slot_order(diag.row_nnz + offd.row_nnz, cb)
    F = fmt.pack([diag], [offd], [cb], [c_of], [slots], rc_pad, "cuda")
    xl = torch.from_numpy(rng.standard_normal((1, n)).astype(np.float32))
    xg = torch.from_numpy(rng.standard_normal((1, n_ghost + 1))
                          .astype(np.float32))
    xl, xg = xl.cuda(), xg.cuda()
    for ghost, nnz in ((xg, diag.row_nnz + offd.row_nnz),
                       (None, diag.row_nnz)):
        empty = np.ones((1, 2, rc_pad), dtype=bool)
        empty[0, c_of, slots] = nnz == 0
        torch.full((4 * rc_pad,), float("nan"), device="cuda")
        y = fmt.matvec_kernel(F, xl, ghost, rc_pad)
        want = fmt.matvec_plain(F, xl, ghost, rc_pad)
        assert torch.isfinite(y).all()
        assert (y[torch.from_numpy(empty).cuda()] == 0).all()
        _close_to_plain(y, want)
        assert torch.equal(fmt.matvec_kernel(F, xl, ghost, rc_pad), y)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", sorted(CASES))
def test_kernels_are_deterministic_and_zero_on_the_tail(case, dtype, golden):
    A, x, _ = golden
    plan, layout = _plan(case, A)
    F = {k: (v.to(dtype) if v.is_floating_point() else v)
         for k, v in plan.fmt_data.items()}
    fmt = get_format(plan.format)
    xl, xg = make_shard_body(plan).inputs(to_dist(x, layout, plan))
    torch.full((plan.n_node * plan.n_core * plan.rc_pad,), float("nan"),
               device="cuda")
    y = fmt.matvec_kernel(F, xl, xg, plan.rc_pad)
    assert torch.isfinite(y).all()
    assert (y[plan.mask == 0] == 0).all()
    for _ in range(2):
        assert torch.equal(fmt.matvec_kernel(F, xl, xg, plan.rc_pad), y)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ell_kernel_without_lengths_equals_with_them(dtype, golden):
    """Reading every slot gives the same bits as stopping at each row's
    length: the skipped padding adds exactly 0 to the same fmaf chain."""
    A, x, _ = golden
    for case in ("ell/4x2", "ell/1x4"):
        plan, layout = _plan(case, A)
        F = {k: (v.to(dtype) if v.is_floating_point() else v)
             for k, v in plan.fmt_data.items()}
        xl, xg = make_shard_body(plan).inputs(to_dist(x, layout, plan))
        dv, dc, dl = F["diag_vals"], F["diag_cols"], F["diag_len"]
        if xg is None:
            assert torch.equal(ops.ell_spmv(dv, dc, xl, lens=dl),
                               ops.ell_spmv(dv, dc, xl))
        else:
            args = (dv, dc, F["offd_vals"], F["offd_cols"], xl, xg)
            want = ops.fused_ell_spmv(*args)
            assert torch.equal(ops.fused_ell_spmv(
                *args, dlens=dl, olens=F["offd_len"]), want)
            assert torch.equal(ops.fused_ell_spmv(*args, dlens=dl), want)
    e = ELLMatrix.from_csr(A, dtype=dtype, device="cuda")
    xd = torch.from_numpy(x).cuda()
    y = ops.ell_spmv(e.vals, e.cols, xd, lens=e.row_lens)
    assert torch.equal(y, ops.ell_spmv(e.vals, e.cols, xd))
    _close_to_plain(y, ref.ell_spmv_ref(e.vals, e.cols, xd))


def test_ell_kernel_with_lengths_skips_padding_that_reads_a_nan_x0(golden):
    """The lengths' one departure from the plain version: padding slots
    (value 0, column 0) read ``x[0]``, so a NaN there makes every padded
    row NaN when all slots are read, and only the rows with a real entry
    in column 0 when the kernel stops at each row's length."""
    A, x, _ = golden
    e = ELLMatrix.from_csr(A, device="cuda")
    xd = torch.from_numpy(x).cuda()
    xd[0] = float("nan")
    uses_x0 = np.zeros(e.n_rows_pad, dtype=bool)
    uses_x0[A._row_of_nnz()[A.indices == 0]] = True
    padded = e.row_lens < e.width
    assert padded.any() and uses_x0.any()
    y = ops.ell_spmv(e.vals, e.cols, xd, lens=e.row_lens)
    assert torch.equal(y.isnan(), torch.from_numpy(uses_x0).cuda())
    y_all = ops.ell_spmv(e.vals, e.cols, xd)
    assert torch.equal(y_all.isnan(),
                       ref.ell_spmv_ref(e.vals, e.cols, xd).isnan())
    assert y_all[padded].isnan().all()


def test_ell_wrappers_raise_on_lengths_the_kernel_does_not_take(golden):
    A, x, _ = golden
    plan, _ = _plan("ell/4x2", A)
    F = plan.fmt_data
    xl = torch.zeros((plan.n_node, plan.nl_pad), device="cuda")
    xg = torch.zeros((plan.n_node, plan.g_pad + 1), device="cuda")
    args = (F["diag_vals"], F["diag_cols"], F["offd_vals"], F["offd_cols"],
            xl, xg)
    dl, ol = F["diag_len"], F["offd_len"]
    wide = torch.zeros(dl.shape + (2,), dtype=torch.int32, device="cuda")
    bad = {TypeError: [dl.long(), dl.float()],
           ValueError: [dl[..., :-1].contiguous(), dl.cpu(), dl[None],
                        wide[..., 0]]}
    for err, lens in bad.items():
        for t in lens:
            with pytest.raises(err):
                ops.fused_ell_spmv(*args, dlens=t, olens=ol)
            with pytest.raises(err):
                ops.fused_ell_spmv(*args, dlens=dl, olens=t)
            with pytest.raises(err):
                ops.ell_spmv(F["diag_vals"], F["diag_cols"], xl, lens=t)
    e = ELLMatrix.from_csr(A, device="cuda")
    xd = torch.from_numpy(x).cuda()
    for err, t in ((TypeError, e.row_lens.long()),
                   (ValueError, e.row_lens[:-1]),
                   (ValueError, e.row_lens.cpu()),
                   (ValueError, to_device(np.zeros((e.n_rows_pad, 2),
                                                   np.int32), "cuda")[:, 0])):
        with pytest.raises(err):
            ops.ell_spmv(e.vals, e.cols, xd, lens=t)


# --------------------------------------------------------------------- #
# the single-device path: BalancedCOO -> balanced_spmv, ELLMatrix -> ell_spmv
# --------------------------------------------------------------------- #
def _close_to_plain(y, want):
    tol = 2e-5 * max(1.0, float(want.abs().max()))
    assert y.dtype == torch.float32 and y.shape == want.shape
    assert float((y - want).abs().max()) <= tol


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kind", ["balanced", "rows"])
@pytest.mark.parametrize("nbins", [1, 4, 13, 300])
def test_balanced_spmv_matches_plain_version(nbins, kind, dtype, golden):
    A, x, _ = golden
    bounds = (partition_balanced(A.row_nnz, nbins) if kind == "balanced"
              else partition_equal_rows(A.n_rows, nbins))
    b = BalancedCOO.from_csr(A, bounds, dtype=dtype, device="cuda")
    xd = torch.from_numpy(x).cuda()
    reset_launches()
    y = ops.balanced_spmv(b, xd)
    torch.cuda.synchronize()
    assert LAUNCHES == {k: int(k == "balanced_spmv") for k in LAUNCHES}
    _close_to_plain(y, ref.balanced_spmv_ref(b, xd))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flat_ell_spmv_matches_plain_version(dtype, golden):
    A, x, _ = golden
    e = ELLMatrix.from_csr(A, dtype=dtype, device="cuda")
    for xd in (torch.from_numpy(x).cuda(),
               torch.from_numpy(x).cuda().to(torch.bfloat16)):
        reset_launches()
        y = ops.ell_spmv(e.vals, e.cols, xd, lens=e.row_lens)
        torch.cuda.synchronize()
        assert LAUNCHES == {k: int(k == "ell_spmv") for k in LAUNCHES}
        _close_to_plain(y, ref.ell_spmv_ref(e.vals, e.cols, xd))


def _ragged_rows(rng, n=400):
    """Rows of 0..70 entries, a fifth of them none, and two rows longer
    than a warp's 256-entry chunk (300 and 700 entries)."""
    nnz = rng.integers(0, 71, n)
    nnz[rng.choice(n, n // 5, replace=False)] = 0
    nnz[[37, 250]] = [300, 700]
    rows = np.repeat(np.arange(n), nnz)
    return CSRMatrix.from_coo(rows, rng.integers(0, n, len(rows)),
                              rng.standard_normal(len(rows)), (n, n))


#: bounds for ``_ragged_rows``'s 400 rows: empty bins (repeated bounds),
#: bins of 1-2 rows, and bins that leave partial warps
RAGGED_BOUNDS = {"empty bins": [0, 0, 33, 33, 33, 100, 250, 251, 400, 400],
                 "tiny bins": [0, 1, 3, 37, 38, 250, 400],
                 "one bin": [0, 400]}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", sorted(RAGGED_BOUNDS))
def test_balanced_kernel_on_empty_bins_empty_rows_and_long_rows(case, dtype,
                                                                golden):
    """Against the plain version, and two launches bit for bit equal."""
    A = _ragged_rows(np.random.default_rng(9))
    bounds = np.array(RAGGED_BOUNDS[case])
    b = BalancedCOO.from_csr(A, bounds, dtype=dtype, device="cuda")
    x = torch.from_numpy(np.random.default_rng(2).standard_normal(A.n_cols)
                         .astype(np.float32)).cuda()
    reset_launches()
    y = ops.balanced_spmv(b, x)
    torch.cuda.synchronize()
    assert LAUNCHES == {k: int(k == "balanced_spmv") for k in LAUNCHES}
    assert y.shape == (A.n_rows,)
    _close_to_plain(y, ref.balanced_spmv_ref(b, x))
    for _ in range(2):
        assert torch.equal(ops.balanced_spmv(b, x), y)


def test_balanced_spmv_writes_zeros_where_there_are_no_entries(golden):
    """Rows with no entries, in empty and non-empty bins alike, come out
    exactly 0 whatever the output's memory held before: the kernel writes
    every row of the flat ``y`` once, none twice."""
    rng = np.random.default_rng(3)
    n = 40
    rows = np.repeat(np.arange(n), 3)
    keep = ~np.isin(rows, [0, 3, 11, 12, 13, 14, 15, 39])
    A = CSRMatrix.from_coo(rows[keep], rng.integers(0, n, keep.sum()),
                           rng.standard_normal(keep.sum()), (n, n))
    b = BalancedCOO.from_csr(A, np.array([0, 0, 10, 10, 25, 40, 40]),
                             device="cuda")
    x = torch.from_numpy(rng.standard_normal(n).astype(np.float32)).cuda()
    torch.full((4 * n,), float("nan"), device="cuda")   # dirty the pool
    y = ops.balanced_spmv(b, x)
    empty = torch.from_numpy(A.row_nnz == 0).cuda()
    assert torch.isfinite(y).all()
    assert (y[empty] == 0).all() and (y[~empty] != 0).all()
    _close_to_plain(y, ref.balanced_spmv_ref(b, x))
    y_host = A.matvec(x.cpu().numpy().astype(np.float64))
    np.testing.assert_allclose(y.cpu().numpy(), y_host,
                               atol=1e-5 * max(1.0, np.abs(y_host).max()),
                               rtol=0)


def test_balanced_wrapper_raises_on_what_the_kernel_does_not_take(golden):
    A, x, _ = golden
    b = BalancedCOO.from_csr(A, partition_balanced(A.row_nnz, 4),
                             device="cuda")
    xd = torch.from_numpy(x).cuda()
    bad = {TypeError: [dict(cols=b.cols.long()),
                       dict(row_lens=b.row_lens.long()),
                       dict(warp_map=b.warp_map.long()),
                       dict(vals=b.vals.half())],
           ValueError: [dict(row_lens=b.row_lens[:-1]),
                        dict(row_lens=b.row_lens.cpu()),
                        dict(warp_map=b.warp_map[:, :2].contiguous()),
                        dict(warp_map=b.warp_map.reshape(-1)),
                        dict(warp_map=b.warp_map.t()),
                        dict(warp_map=b.warp_map.cpu())]}
    for err, fields in bad.items():
        for f in fields:
            with pytest.raises(err):
                ops.balanced_spmv(dataclasses.replace(b, **f), xd)
    with pytest.raises(TypeError):
        ops.balanced_spmv(b, xd.double())
    with pytest.raises(ValueError):
        ops.balanced_spmv(b, xd.cpu())
    with pytest.raises(ValueError):
        ops.balanced_spmv(b, xd[:-1])
    # 2 x 2**30 entries: the map's int32 entry offsets would overflow
    # (stride-0 views: nothing of that size is allocated)
    one = torch.zeros(1, dtype=torch.int32, device="cuda")
    huge = dataclasses.replace(b, vals=one.float().expand(2, 2**30),
                               cols=one.expand(2, 2**30))
    assert huge.vals.shape == (2, 2**30)
    with pytest.raises(ValueError, match="int32"):
        ops.balanced_spmv(huge, xd)


@pytest.mark.parametrize("wd", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("fmt", ["ell", "sell"])
def test_transports_bit_equal_to_a2a_on_the_card(fmt, wd, golden):
    """Every transport's SpMV and ghost buffer bit for bit a2a's at one
    wire dtype, and equal to the host reference's ghosts; ``faulty``
    differs from both."""
    from repro_torch.core import make_exchange, resolve_transport
    from repro_torch.core.transport import (FaultyTransport,
                                            available_transports)

    A, x, _ = golden
    plan, layout = _plan(f"{fmt}/4x2", A)
    xd = to_dist(x, layout, plan)
    g = plan.g_pad
    y_ref = make_spmv(plan, transport="a2a", wire_dtype=wd)(xd)
    ghost_ref = make_exchange(plan, wire_dtype=wd)(xd)[..., :g]
    for name in available_transports():
        y = make_spmv(plan, transport=name, wire_dtype=wd)(xd)
        assert torch.equal(y.view(torch.int32), y_ref.view(torch.int32)), \
            name
        ghost = make_exchange(plan, transport=name, wire_dtype=wd)(xd)
        assert torch.equal(ghost[..., :g], ghost_ref), name
        tr, state = resolve_transport(name, plan, wire_dtype=wd)
        host = tr.host_exchange(xd.cpu().numpy(), plan.send_own.cpu().numpy(),
                                plan.recv_own.cpu().numpy(), g, state)
        assert host[..., :g].tobytes() == ghost[..., :g].cpu().numpy() \
            .tobytes(), name
    faulty = FaultyTransport()
    assert not torch.equal(make_spmv(plan, transport=faulty,
                                     wire_dtype=wd)(xd), y_ref)
    assert not torch.equal(make_exchange(plan, transport=faulty,
                                         wire_dtype=wd)(xd)[..., :g],
                           ghost_ref)


@pytest.mark.parametrize("wd", ["bf16", "int8"])
def test_wire_codecs_encode_on_the_card_as_on_the_host(wd, golden):
    """The encoded payload on the card is the CPU's byte for byte (the
    int8 scale divides by a tensor: CUDA would turn a division by a
    Python scalar into a multiplication by its reciprocal)."""
    from repro_torch.core.transport import get_codec

    codec = get_codec(wd)
    rng = np.random.default_rng(5)
    ch = torch.from_numpy(rng.standard_normal((64, 8, 4, 200))
                          .astype(np.float32))
    ch[0, 0, 0] = 0.0
    host, card = codec.encode(ch), codec.encode(ch.cuda()).cpu()
    assert host.dtype == card.dtype
    as_int = torch.int16 if wd == "bf16" else torch.int8
    assert torch.equal(host.view(as_int), card.view(as_int))
    assert torch.equal(codec.decode(card.cuda()).cpu(), codec.decode(host))


@pytest.mark.parametrize("name", ["cg", "pipelined_cg", "chebyshev"])
@pytest.mark.parametrize("fmt", ["ell", "sell"])
def test_chunked_equals_monolithic_on_the_card(fmt, name, golden):
    """A chunked resilient solve from x = 0 gives the monolithic
    ``make_solver`` solve's x and count bit for bit on the card, and the
    chunked loop still launches the plan's kernel."""
    from repro_torch.core import from_dist
    from repro_torch.solvers import resilient_solve

    A, _, b = golden
    plan, layout = _plan(f"{fmt}/4x2", A)
    solve = make_solver(plan, solver=name, A=A, layout=layout)
    xd, its, _ = solve(to_dist(b, layout, plan), tol=1e-5, maxiter=2000)
    reset_launches()
    res = resilient_solve(plan, b.astype(np.float64), layout=layout, A=A,
                          solver=name, tol=1e-5, maxiter=2000,
                          check_every=17, options=solve.options)
    torch.cuda.synchronize()
    assert LAUNCHES[CASES[f"{fmt}/4x2"]] > 0
    assert int(res.iters) == int(its) and res.rollbacks == 0
    np.testing.assert_array_equal(res.x, from_dist(xd, layout, plan))


@pytest.mark.parametrize("fmt", ["ell", "sell"])
def test_reduction_census_on_the_card(fmt, golden):
    from repro_torch.solvers import get_solver, reduction_census

    A, _, b = golden
    plan, layout = _plan(f"{fmt}/4x2", A)
    bd = to_dist(b, layout, plan)
    for name in ("cg", "pipelined_cg", "chebyshev"):
        solve = make_solver(plan, solver=name, A=A, layout=layout)
        assert reduction_census(solve, bd, tol=1e-5) == \
            get_solver(name).reductions_per_iter == \
            {"cg": 2, "pipelined_cg": 1, "chebyshev": 0}[name]


@pytest.mark.parametrize("kind", ["nan@30", "bitflip@30"])
@pytest.mark.parametrize("name", ["cg", "pipelined_cg", "chebyshev"])
def test_faults_rolled_back_on_the_card(name, kind, golden):
    from repro_torch.runtime.fault import FaultInjector
    from repro_torch.solvers import resilient_solve

    A, _, b = golden
    plan, layout = _plan("sell/4x2", A)
    res = resilient_solve(plan, b.astype(np.float64), layout=layout, A=A,
                          solver=name, tol=1e-5, maxiter=3000,
                          check_every=20,
                          injector=FaultInjector.parse(kind, shard=(2, 1)))
    assert res.rollbacks >= 1 and res.converged
    assert all(np.isfinite(w) for _, w in res.trajectory)


# --------------------------------------------------------------------- #
# rectangular plans and the preconditioners on the card
# --------------------------------------------------------------------- #
RECT_KERNELS = {"ell": "fused_ell_spmv", "sell": "fused_sell_spmv"}


@pytest.mark.parametrize("fmt", ["ell", "sell"])
@pytest.mark.parametrize("kind", ["tall", "fat", "agg"])
def test_rect_plans_on_the_card(kind, fmt, golden):
    """A rectangular plan's SpMV through its kernel against the plain
    version (2e-5·max|y|) and the host f64 matvec (1e-5 relative), every
    transport bit for bit a2a, and the plan built with ``verify=True``."""
    from repro_torch.core import available_transports, from_dist
    from repro_torch.testing.rect_check import build_rect

    M = build_rect(kind, 3)
    x = np.random.default_rng(103).normal(size=M.n_cols)
    plan, layout = build_spmv_plan(M, 4, 2, mode="balanced", format=fmt,
                                   device="cuda", verify=True)
    xd = to_dist(x, layout, plan, space="col")
    reset_launches()
    y = make_spmv(plan)(xd)
    torch.cuda.synchronize()
    assert LAUNCHES[RECT_KERNELS[fmt] if plan.hs else
                    RECT_KERNELS[fmt][len("fused_"):]] == 1
    want = make_shard_body(plan, backend="plain")(xd)
    assert y.shape == want.shape == plan.cg_shape
    assert float((y - want).abs().max()) <= \
        2e-5 * max(1.0, float(want.abs().max()))
    y_host = M.matvec(x)
    got = from_dist(y, layout, plan, space="row").astype(np.float64)
    assert np.linalg.norm(got - y_host) <= 1e-5 * np.linalg.norm(y_host)
    for name in available_transports():
        assert torch.equal(make_spmv(plan, transport=name)(xd).view(
            torch.int32), y.view(torch.int32)), name


@pytest.mark.parametrize("pname", ["jacobi", "block_jacobi", "two_level"])
@pytest.mark.parametrize("fmt", ["ell", "sell"])
def test_precond_apply_on_the_card(fmt, pname, golden):
    """The card's apply against the same apply on the CPU (2e-5
    relative), the kernel shard bodies against the plain ones, and no
    reduction in two_level's apply."""
    from repro_torch.core import from_dist
    from repro_torch.solvers import count_reductions, make_precond_apply

    A, x, _ = golden
    assert not torch.backends.cuda.matmul.allow_tf32
    out = {}
    for dev in ("cpu", "cuda"):
        plan, layout = build_spmv_plan(A, 4, 2, mode="balanced", format=fmt,
                                       device=dev)
        rd = to_dist(x, layout, plan, space="row")
        for backend in ("kernel", "plain"):
            apply = make_precond_apply(plan, precond=pname, A=A,
                                       layout=layout, backend=backend)
            with count_reductions() as n:
                z = apply(rd)
            assert n[0] == 0
            out[dev, backend] = from_dist(z, layout, plan).astype(np.float64)
    ref = out["cpu", "kernel"]
    for key, z in out.items():
        assert np.linalg.norm(z - ref) <= 2e-5 * np.linalg.norm(ref), key


@pytest.mark.parametrize("fmt", ["ell", "sell"])
def test_precond_cg_on_the_card(fmt, golden):
    """cg with block_jacobi and two_level on the card: the CPU's count
    ±1 at tol 1e-5 (above the golden matrix's f32 plateau), a census of
    2 reductions per iteration, and the plan's kernel launched."""
    from repro_torch.solvers import reduction_census

    A, _, b = golden
    iters = {}
    for dev in ("cpu", "cuda"):
        plan, layout = build_spmv_plan(A, 4, 2, mode="balanced", format=fmt,
                                       device=dev)
        bd = to_dist(b, layout, plan)
        for pname in ("block_jacobi", "two_level"):
            solve = make_solver(plan, precond=pname, A=A, layout=layout)
            reset_launches()
            _, it, rel = solve(bd, tol=1e-5, maxiter=400)
            iters[dev, pname] = int(it)
            assert float(rel) <= 1e-5
            assert reduction_census(solve, bd, tol=1e-5) == 2
            if dev == "cuda":
                assert LAUNCHES[CASES[f"{fmt}/4x2"]] > 0
    for pname in ("block_jacobi", "two_level"):
        assert abs(iters["cuda", pname] - iters["cpu", pname]) <= 1


# --------------------------------------------------------------------- #
# the batched kernels (B1-B4 under vmap) and the engine on the card
# --------------------------------------------------------------------- #
def _batched_inputs(plan, layout, k, seed):
    rng = np.random.default_rng(seed)
    X = torch.stack([to_dist(rng.standard_normal(plan.n), layout, plan)
                     for _ in range(k)])
    return make_shard_body(plan).inputs(X)


@pytest.mark.parametrize("k", [1, 2, 3, 4, 5, 8, 9, 16])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", sorted(CASES))
def test_batched_kernel_columns_are_the_single_kernel(case, dtype, k,
                                                      golden):
    """Column j of one batched launch is the single-column kernel on x_j
    bit for bit, whatever the memory held (the pool is dirtied with NaN
    first), within 2e-5·max|y| of the plain version, and counted once
    under the kernel's ``_batched`` key.  The k cover every column tile
    (4, 8, 16), full and with pad columns."""
    A, _, _ = golden
    plan, layout = _plan(case, A)
    F = {kk: (v.to(dtype) if v.is_floating_point() else v)
         for kk, v in plan.fmt_data.items()}
    fmt = get_format(plan.format)
    xl, xg = _batched_inputs(plan, layout, k, seed=k)
    torch.full((k * plan.n_node * plan.n_core * plan.rc_pad,), float("nan"),
               device="cuda")
    reset_launches()
    y = fmt.matvec_kernel(F, xl, xg, plan.rc_pad)
    torch.cuda.synchronize()
    assert LAUNCHES == {kk: int(kk == f"{CASES[case]}_batched")
                        for kk in LAUNCHES}
    assert y.shape == (k,) + plan.cg_shape and torch.isfinite(y).all()
    for j in range(k):
        yj = fmt.matvec_kernel(F, xl[j], None if xg is None else xg[j],
                               plan.rc_pad)
        assert torch.equal(y[j], yj), (case, dtype, k, j)
    _close_to_plain(y, fmt.matvec_plain(F, xl, xg, plan.rc_pad))
    assert (y[:, plan.mask == 0] == 0).all()


def _every_other(x):
    return x[1::2]


def _rhs_minor(x):
    """x (k, n_node, n) as a view of an (n_node, n, k) tensor: the column
    index fastest in memory."""
    return x[:5].permute(1, 2, 0).contiguous().permute(2, 0, 1)


@pytest.mark.parametrize("view", [_every_other, _rhs_minor])
@pytest.mark.parametrize("case", sorted(CASES))
def test_batched_kernel_takes_a_strided_slice_of_a_batch(case, view, golden):
    """x_local/x_ghost as a non-contiguous view (every other column of a
    larger batch, or a batch stored column index fastest): the
    wrapper interleaves them as they lie, and each column is the
    single-column kernel on that column bit for bit."""
    A, _, _ = golden
    plan, layout = _plan(case, A)
    F, fmt = plan.fmt_data, get_format(plan.format)
    xl, xg = _batched_inputs(plan, layout, 10, seed=21)
    xl, xg = view(xl), None if xg is None else view(xg)
    assert not xl.is_contiguous() and xl.shape[0] == 5
    y = fmt.matvec_kernel(F, xl, xg, plan.rc_pad)
    for j in range(5):
        yj = fmt.matvec_kernel(F, xl[j].contiguous(),
                               None if xg is None else xg[j].contiguous(),
                               plan.rc_pad)
        assert torch.equal(y[j], yj), (case, j)
    _close_to_plain(y, fmt.matvec_plain(F, xl, xg, plan.rc_pad))


@pytest.mark.parametrize("fmt_name", ["ell", "sell"])
def test_batched_kernels_write_zeros_where_there_are_no_entries(fmt_name,
                                                                golden):
    """``test_kernels_write_zeros_where_there_are_no_entries``'s ragged
    node (rows of 0 to 150 entries, the ``rc_pad`` tail) through the
    batched kernel at k = 5: every empty slot exactly 0 in every column."""
    rng = np.random.default_rng(11)
    n, n_ghost, rc_pad, k = 150, 7, 88, 5
    diag = _random_csr(rng, n, n, 150, 20)
    offd = _random_csr(rng, n, n_ghost, 4, 60)
    cb = np.array([0, 70, n])
    c_of = np.searchsorted(cb, np.arange(n), side="right") - 1
    fmt = get_format(fmt_name)
    slots = fmt.slot_order(diag.row_nnz + offd.row_nnz, cb)
    F = fmt.pack([diag], [offd], [cb], [c_of], [slots], rc_pad, "cuda")
    xl = torch.from_numpy(rng.standard_normal((k, 1, n))
                          .astype(np.float32)).cuda()
    xg = torch.from_numpy(rng.standard_normal((k, 1, n_ghost + 1))
                          .astype(np.float32)).cuda()
    for ghost, nnz in ((xg, diag.row_nnz + offd.row_nnz),
                       (None, diag.row_nnz)):
        empty = np.ones((1, 2, rc_pad), dtype=bool)
        empty[0, c_of, slots] = nnz == 0
        torch.full((4 * k * rc_pad,), float("nan"), device="cuda")
        y = fmt.matvec_kernel(F, xl, ghost, rc_pad)
        assert torch.isfinite(y).all()
        assert (y[:, torch.from_numpy(empty).cuda()] == 0).all()
        _close_to_plain(y, fmt.matvec_plain(F, xl, ghost, rc_pad))


def test_batched_wrappers_refuse_what_the_kernel_does_not_take(golden):
    A, _, _ = golden
    plan, layout = _plan("ell/4x2", A)
    F = plan.fmt_data
    args = [F["diag_vals"], F["diag_cols"], F["offd_vals"], F["offd_cols"]]
    xl, xg = _batched_inputs(plan, layout, ops.MAX_NRHS + 1, seed=1)
    reset_launches()
    with pytest.raises(ValueError, match="1 to 16"):
        ops.fused_ell_spmv(*args, xl, xg)
    with pytest.raises(ValueError, match="1 to 16"):
        ops.ell_spmv(F["diag_vals"], F["diag_cols"], xl)
    with pytest.raises(ValueError, match="differ in batch"):
        ops.fused_ell_spmv(*args, xl[:4], xg[:3])
    with pytest.raises(ValueError):
        ops.fused_ell_spmv(*args, xl[:4].cpu(), xg[:4])
    with pytest.raises(ValueError, match="for 4 nodes"):
        ops.fused_ell_spmv(*args, xl[:4, :2], xg[:4, :2])
    sp, sl = _plan("sell/4x2", A)
    G = sp.fmt_data
    sxl, sxg = _batched_inputs(sp, sl, ops.MAX_NRHS + 1, seed=2)
    with pytest.raises(ValueError, match="1 to 16"):
        ops.fused_sell_spmv(G["sell_dvals"], G["sell_dcols"],
                            G["sell_dstart"], G["sell_dwidth"],
                            G["sell_ovals"], G["sell_ocols"],
                            G["sell_ostart"], G["sell_owidth"], sxl, sxg,
                            sp.rc_pad)
    assert sum(LAUNCHES.values()) == 0


def test_engine_on_the_card_serves_with_no_rebuild(golden):
    """A small engine on ``cuda``: every request converges against the
    host oracle, the batched kernel carries its SpMVs, and no plan,
    program or kernel library is built after warm-up."""
    from repro_torch.serve import EngineConfig, SolveService
    from repro_torch.testing.refine_check import host_cg

    A = graded_extruded_mesh_matrix(16, 4, seed=0)
    svc = SolveService(A, EngineConfig(nrhs=3, n_node=2, n_core=2,
                                       format="sell", check_every=5),
                       device="cuda")
    B = np.random.default_rng(3).normal(size=(7, A.n_rows))
    reset_launches()
    futs = [svc.submit(B[i], tol=(1e-5, 3e-5, 1e-4)[i % 3])
            for i in range(7)]
    assert len(svc.drain()) == 7
    for i, f in enumerate(futs):
        xh = host_cg(A, B[i], tol=1e-10, maxiter=20_000)
        assert np.linalg.norm(f.result().x - xh) / np.linalg.norm(xh) < 1e-2
    st = svc.stats()
    assert st["recompiles"] == 0 and st["failed"] == 0
    assert st["executables"]["kernel_library"] == 1
    assert LAUNCHES["fused_sell_spmv_batched"] > 0
