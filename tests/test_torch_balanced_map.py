"""The port's warp map of a ``BalancedCOO`` (``row_lens``, ``warp_map``), on
the CPU.

The CUDA kernel of ``ops.balanced_spmv`` reads these two port-only fields
in place of ``lrows`` and ``out_gather``: one warp per run of up to 32
consecutive rows of one bin, each row's entries found from the warp's
first entry and the lengths of the rows before it.  These tests pin the
map itself, built from the JAX package's binned arrays and from the port's
own, and walk it in numpy as the kernel does.

Tolerances: the maps are equal exactly; the numpy walk (f32 products
added in entry order) against ``ref.balanced_spmv_ref`` within
``2e-5·max(1, max|y|)``, the kernels' bound for two summation orders of
the same f32 values.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.sparse import csr as ref_csr
from repro.sparse import mesh_gen as ref_mesh_gen
from repro_torch.core.partition import (partition_balanced,
                                        partition_equal_rows)
from repro_torch.kernels import balanced_spmv, ref
from repro_torch.sparse import (BalancedCOO, CSRMatrix, balanced_warp_map,
                                extruded_mesh_matrix)

DTYPES = {"f32": (torch.float32, jnp.float32),
          "bf16": (torch.bfloat16, jnp.bfloat16)}
BOUNDS = {"balanced": lambda A, nb: partition_balanced(A.row_nnz, nb),
          "rows": lambda A, nb: partition_equal_rows(A.n_rows, nb)}


def _reference_arrays(R):
    return ({k: np.asarray(getattr(R, k)) for k in
             ("vals", "cols", "lrows", "bin_starts", "out_gather")},
            {k: getattr(R, k) for k in
             ("n_rows", "n_cols", "rows_pad", "bin_nnz")})


def _sparse_rows(seed=4, n=150):
    """Rows of 0..70 entries, a fifth of them none (so a warp's entries run
    past the kernel's 256-entry chunk), in both packages."""
    rng = np.random.default_rng(seed)
    nnz = rng.integers(0, 71, n)
    nnz[rng.choice(n, n // 5, replace=False)] = 0
    rows = np.repeat(np.arange(n), nnz)
    coo = (rows, rng.integers(0, n, len(rows)),
           rng.standard_normal(len(rows)), (n, n))
    return CSRMatrix.from_coo(*coo), ref_csr.CSRMatrix.from_coo(*coo)


#: bounds with empty bins (repeated bounds) and bins that leave partial
#: warps, for ``_sparse_rows``'s 150 rows
ODD_BOUNDS = [np.array([0, 0, 33, 33, 33, 100, 150, 150]),
              np.array([0, 1, 2, 65, 150]),
              np.array([0, 150])]


def _check_map(b: BalancedCOO, bounds: np.ndarray, row_nnz: np.ndarray):
    """What the kernel relies on: every row in exactly one warp, no warp
    across a bin, 1–32 rows per warp, each warp's first entry its bin's
    offset plus its bin's earlier rows' lengths; bins with no rows give no
    warp."""
    lens, wm = b.row_lens.numpy(), b.warp_map.numpy()
    assert np.array_equal(lens, row_nnz)
    first, count, entry = wm[:, 0], wm[:, 1], wm[:, 2]
    assert np.all((count >= 1) & (count <= 32))
    covered = np.zeros(b.n_rows, dtype=int)
    for f, c in zip(first, count):
        covered[f:f + c] += 1
    assert np.all(covered == 1)
    bin_of = np.searchsorted(bounds, first, side="right") - 1
    assert np.all(first + count <= bounds[bin_of + 1])
    before = np.concatenate([[0], np.cumsum(lens)])
    assert np.array_equal(
        entry, bin_of * b.nnz_pad + before[first] - before[bounds[bin_of]])
    n_warps = -(-np.diff(bounds) // 32)
    assert len(wm) == n_warps.sum()
    assert np.array_equal(np.bincount(bin_of, minlength=b.nbins), n_warps)


def _walk(b: BalancedCOO, x: torch.Tensor) -> np.ndarray:
    """The kernel's walk in numpy: each warp's rows lie back to back from
    its first entry; each row sums its products in entry order."""
    vals = b.vals.to(torch.float32).numpy().reshape(-1)
    cols = b.cols.numpy().reshape(-1)
    lens, xs = b.row_lens.numpy(), x.to(torch.float32).numpy()
    y = np.full(b.n_rows, np.nan, dtype=np.float32)
    for first, count, entry in b.warp_map.numpy():
        k = entry
        for r in range(first, first + count):
            acc = np.float32(0.0)
            for e in range(k, k + lens[r]):
                acc = np.float32(acc + vals[e] * xs[cols[e]])
            y[r] = acc
            k += lens[r]
    return y


@pytest.mark.parametrize("dt", sorted(DTYPES))
@pytest.mark.parametrize("kind", sorted(BOUNDS))
@pytest.mark.parametrize("nbins", [1, 4, 13, 40])
def test_map_from_csr_equals_map_from_reference_arrays(nbins, kind, dt):
    tdt, jdt = DTYPES[dt]
    A = extruded_mesh_matrix(60, 5, seed=2)
    R = ref_mesh_gen.extruded_mesh_matrix(60, 5, seed=2)
    bounds = BOUNDS[kind](A, nbins)
    b = BalancedCOO.from_csr(A, bounds, dtype=tdt, device="cpu")
    r = BalancedCOO.from_arrays(*_reference_arrays(
        ref_csr.BalancedCOO.from_csr(R, bounds, dtype=jdt)), device="cpu")
    assert r.vals.dtype == tdt
    for f in ("row_lens", "warp_map"):
        got, want = getattr(b, f), getattr(r, f)
        assert got.dtype == want.dtype == torch.int32
        assert torch.equal(got, want)
    _check_map(b, np.asarray(bounds), A.row_nnz)


@pytest.mark.parametrize("bounds", range(len(ODD_BOUNDS)))
def test_map_covers_empty_bins_and_rows_with_no_entries(bounds):
    bounds = ODD_BOUNDS[bounds]
    A, R = _sparse_rows()
    b = BalancedCOO.from_csr(A, bounds, device="cpu")
    assert (A.row_nnz == 0).any()
    _check_map(b, bounds, A.row_nnz)
    r = BalancedCOO.from_arrays(*_reference_arrays(
        ref_csr.BalancedCOO.from_csr(R, bounds)), device="cpu")
    assert torch.equal(r.warp_map, b.warp_map)
    assert torch.equal(r.row_lens, b.row_lens)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", ["mesh/13", "mesh/rows/40", "odd/0",
                                  "odd/1", "odd/2"])
def test_walk_over_the_map_reproduces_the_plain_version(case, dtype):
    if case.startswith("mesh"):
        A = extruded_mesh_matrix(30, 4, seed=1)
        nbins = int(case.rsplit("/", 1)[1])
        bounds = (partition_equal_rows(A.n_rows, nbins) if "rows" in case
                  else partition_balanced(A.row_nnz, nbins))
    else:
        A, _ = _sparse_rows()
        bounds = ODD_BOUNDS[int(case[-1])]
    b = BalancedCOO.from_csr(A, bounds, dtype=dtype, device="cpu")
    x = torch.from_numpy(np.random.default_rng(5).standard_normal(A.n_cols)
                         .astype(np.float32))
    want = ref.balanced_spmv_ref(b, x)
    assert torch.equal(balanced_spmv(b, x), want)
    y = _walk(b, x)
    assert np.isfinite(y).all()
    assert np.all(y[A.row_nnz == 0] == 0)
    tol = 2e-5 * max(1.0, float(want.abs().max()))
    np.testing.assert_allclose(y, want.numpy(), atol=tol, rtol=0)


def test_from_arrays_raises_on_a_map_the_kernel_cannot_take():
    _, R = _sparse_rows()
    arrays, meta = _reference_arrays(
        ref_csr.BalancedCOO.from_csr(R, ODD_BOUNDS[0]))
    BalancedCOO.from_arrays(arrays, meta, device="cpu")
    og = arrays["out_gather"]
    bad = {
        "out_gather off by one": dict(arrays, out_gather=og + 1),
        "out_gather rows swapped": dict(
            arrays, out_gather=og[np.r_[1, 0, 2:len(og)]]),
        "bins out of order": dict(
            arrays, bin_starts=arrays["bin_starts"][::-1].copy()),
        "bins not from row 0": dict(
            arrays, bin_starts=arrays["bin_starts"] + 1),
    }
    # bin 1 holds 33 rows of rows_pad 72: a local row 33 is in
    # [0, rows_pad) and nondecreasing, but past the bin
    lrows = arrays["lrows"].copy()
    lrows[1, meta["bin_nnz"][1] - 1] = 33
    bad["a row past its bin"] = dict(arrays, lrows=lrows)
    assert meta["rows_pad"] > 33
    for a in bad.values():
        with pytest.raises(ValueError):
            BalancedCOO.from_arrays(a, meta, device="cpu")


def test_warp_map_refuses_offsets_past_int32():
    lrows = np.zeros((1, 8), dtype=np.int32)
    with pytest.raises(ValueError):
        balanced_warp_map(np.broadcast_to(lrows, (2**16, 2**15)),
                          np.zeros(2**16, dtype=np.int64),
                          np.zeros(2**16, dtype=np.int64),
                          np.zeros(0, dtype=np.int64), 0, 8)

