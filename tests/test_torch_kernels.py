"""The port's single-device kernel path against the JAX package, on the CPU.

``ELLMatrix`` → ``ell_spmv`` and ``BalancedCOO`` → ``balanced_spmv``, at
``tests/test_kernels.py``'s sizes.  The JAX side runs in-process, its Pallas
kernels in interpret mode; the port runs on the CPU, where its wrappers
take the plain versions.  Inputs are made with numpy from a seed and handed
to both.

Tolerances:
  * host arrays (``ELLMatrix``, ``BalancedCOO``, ``CSRMatrix`` methods)
    are byte-identical, dtype and shape included;
  * SpMV within ``2e-5·max(1, max|y|)`` of the JAX functions with float32
    storage and ``2e-2·max(1, max|y|)`` with bfloat16
    (``tests/test_kernels.py``'s bounds: the two sum in another order, and
    bfloat16 ``x`` rounds the gathered values);
  * against the host float64 CSR matvec, float32 storage and ``x``: within
    ``1e-5·max(1, max|y|)`` (float32 rounding of values and ``x``, a few
    dozen terms per row).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse
import torch

from repro.core.partition import partition_balanced as ref_balanced
from repro.kernels import balanced_spmv as jax_balanced_spmv
from repro.kernels import ell_spmv as jax_ell_spmv
from repro.kernels import ref as jax_ref
from repro.sparse import csr as ref_csr
from repro.sparse import mesh_gen as ref_mesh_gen
from repro_torch.core.partition import (partition_balanced,
                                        partition_equal_rows)
from repro_torch.kernels import balanced_spmv, ell_spmv, ref
from repro_torch.sparse import (BalancedCOO, CSRMatrix, ELLMatrix,
                                extruded_mesh_matrix, random_spd_matrix)

DTYPES = {"f32": (torch.float32, jnp.float32, 2e-5),
          "bf16": (torch.bfloat16, jnp.bfloat16, 2e-2)}
JNP = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}
ELL_CASES = [(64, 5), (300, 9), (1024, 17)]
BOUNDS = {"balanced": lambda A, nb: partition_balanced(A.row_nnz, nb),
          "rows": lambda A, nb: partition_equal_rows(A.n_rows, nb)}


def _np(t: torch.Tensor) -> np.ndarray:
    """Tensor -> numpy with its bytes (bfloat16 as int16 bits)."""
    t = t.cpu()
    return (t.view(torch.int16) if t.dtype == torch.bfloat16 else t).numpy()


def _jnp(a) -> np.ndarray:
    a = np.asarray(a)
    return a.view(np.int16) if a.dtype.name == "bfloat16" else a


def _same(got: torch.Tensor, want):
    got, want = _np(got), _jnp(want)
    assert got.dtype == want.dtype and got.shape == want.shape, (
        got.dtype, want.dtype, got.shape, want.shape)
    assert got.tobytes() == want.tobytes()


def _close(got: torch.Tensor, want, tol: float):
    got = got.to(torch.float32).numpy()
    want = np.asarray(want, dtype=np.float32)
    assert got.shape == want.shape
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, atol=tol * scale, rtol=0)


def _spd(n, nnz_per_row):
    return (random_spd_matrix(n, nnz_per_row=nnz_per_row, seed=n),
            ref_mesh_gen.random_spd_matrix(n, nnz_per_row=nnz_per_row,
                                           seed=n))


def _mesh(n_surface, layers, seed):
    return (extruded_mesh_matrix(n_surface, layers, seed=seed),
            ref_mesh_gen.extruded_mesh_matrix(n_surface, layers, seed=seed))


def _x(n, seed, dtype):
    x = np.random.default_rng(seed).normal(size=n)
    return torch.tensor(x, dtype=dtype), jnp.asarray(x, dtype=JNP[dtype])


def _reference_arrays(R):
    return ({k: np.asarray(getattr(R, k)) for k in
             ("vals", "cols", "lrows", "bin_starts", "out_gather")},
            {k: getattr(R, k) for k in
             ("n_rows", "n_cols", "rows_pad", "bin_nnz")})


# --------------------------------------------------------------------- #
# host arrays
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("dt", sorted(DTYPES))
@pytest.mark.parametrize("n,nnz_per_row", ELL_CASES)
def test_ell_matrix_byte_identical(n, nnz_per_row, dt):
    tdt, jdt, _ = DTYPES[dt]
    A, R = _spd(n, nnz_per_row)
    for kw in ({}, {"width": int(A.row_nnz.max()) + 3,
                    "n_rows_pad": n + 13}):
        e = ELLMatrix.from_csr(A, dtype=tdt, device="cpu", **kw)
        r = ref_csr.ELLMatrix.from_csr(R, dtype=jdt, **kw)
        _same(e.cols, r.cols)
        _same(e.vals, r.vals)
        assert (e.width, e.n_rows_pad, e.n_rows, e.n_cols) == (
            r.width, r.n_rows_pad, r.n_rows, r.n_cols)


@pytest.mark.parametrize("dt", sorted(DTYPES))
@pytest.mark.parametrize("kind", sorted(BOUNDS))
@pytest.mark.parametrize("nbins", [1, 4, 13])
def test_balanced_coo_byte_identical(nbins, kind, dt):
    tdt, jdt, _ = DTYPES[dt]
    A, R = _mesh(60, 5, 2)
    bounds = BOUNDS[kind](A, nbins)
    b = BalancedCOO.from_csr(A, bounds, dtype=tdt, device="cpu")
    r = ref_csr.BalancedCOO.from_csr(R, bounds, dtype=jdt)
    for f in ("vals", "cols", "lrows", "bin_starts", "out_gather"):
        _same(getattr(b, f), getattr(r, f))
    assert (b.n_rows, b.n_cols, b.rows_pad, b.bin_nnz, b.nbins,
            b.nnz_pad) == (r.n_rows, r.n_cols, r.rows_pad, r.bin_nnz,
                           r.nbins, r.nnz_pad)
    assert b.row_lens.dtype == b.warp_map.dtype == torch.int32
    assert np.array_equal(b.row_lens.numpy(), A.row_nnz)
    assert b.padding_waste == r.padding_waste


def test_padding_waste_counts_stored_zeros_as_real():
    """An explicitly stored 0.0 is a real entry, not padding."""
    coo = ([0, 0, 1, 1, 2, 2, 3, 3], [0, 1, 1, 2, 2, 3, 3, 0],
           [1.0, 0.0, 2.0, 3.0, 4.0, 5.0, 6.0, 7.0], (4, 4))
    A, R = CSRMatrix.from_coo(*coo), ref_csr.CSRMatrix.from_coo(*coo)
    for align in (4, 8):
        b = BalancedCOO.from_csr(A, np.array([0, 2, 4]), nnz_align=align,
                                 rows_align=2, device="cpu")
        r = ref_csr.BalancedCOO.from_csr(R, np.array([0, 2, 4]),
                                         nnz_align=align, rows_align=2)
        assert sum(b.bin_nnz) == 8
        assert b.padding_waste == r.padding_waste == 1.0 - 8 / (2 * align)


@pytest.mark.parametrize("n_surface,layers,seed", [(60, 5, 2), (30, 4, 1)])
def test_csr_methods_byte_identical(n_surface, layers, seed):
    A, R = _mesh(n_surface, layers, seed)
    _same(torch.from_numpy(A.to_dense()), R.to_dense())
    for got, want in ((A.transpose(), R.transpose()),
                      (CSRMatrix.from_scipy(scipy.sparse.csr_matrix(
                          (A.data, A.indices, A.indptr), shape=A.shape)),
                       ref_csr.CSRMatrix.from_scipy(scipy.sparse.csr_matrix(
                           (R.data, R.indices, R.indptr), shape=R.shape)))):
        assert got.shape == want.shape
        for f in ("indptr", "indices", "data"):
            _same(torch.from_numpy(getattr(got, f)), getattr(want, f))


def test_balanced_partition_reduces_padding_waste():
    """Equal-nnz bins minimise the static-shape padding of the kernel
    input (the paper's load balance seen as padding)."""
    A = extruded_mesh_matrix(100, 6, seed=5)
    rows = BalancedCOO.from_csr(A, partition_equal_rows(A.n_rows, 16),
                                device="cpu")
    bal = BalancedCOO.from_csr(A, partition_balanced(A.row_nnz, 16),
                               device="cpu")
    assert bal.padding_waste <= rows.padding_waste + 1e-9
    assert bal.nnz_pad <= rows.nnz_pad


def test_from_arrays_rejects_what_the_kernel_cannot_take():
    A, R = _mesh(30, 4, 1)
    arrays, meta = _reference_arrays(
        ref_csr.BalancedCOO.from_csr(R, ref_balanced(R.row_nnz, 3)))
    bad = dict(arrays, lrows=arrays["lrows"][:, ::-1].copy())
    with pytest.raises(ValueError):
        BalancedCOO.from_arrays(bad, meta, device="cpu")
    bad = dict(arrays, cols=arrays["cols"] + A.n_cols)
    with pytest.raises(ValueError):
        BalancedCOO.from_arrays(bad, meta, device="cpu")


# --------------------------------------------------------------------- #
# SpMV against the JAX functions
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("dt", sorted(DTYPES))
@pytest.mark.parametrize("n,nnz_per_row", ELL_CASES)
def test_flat_ell_spmv_matches_reference(n, nnz_per_row, dt):
    tdt, jdt, tol = DTYPES[dt]
    A, R = _spd(n, nnz_per_row)
    e = ELLMatrix.from_csr(A, dtype=tdt, device="cpu")
    r = ref_csr.ELLMatrix.from_csr(R, dtype=jdt)
    xt, xj = _x(n, n, tdt)
    y = ell_spmv(e.vals, e.cols, xt)
    assert y.dtype == torch.float32 and y.shape == (e.n_rows_pad,)
    _close(y, jax_ell_spmv(r.vals, r.cols, xj), tol)
    _close(ref.ell_spmv_ref(e.vals, e.cols, xt),
           jax_ref.ell_spmv_ref(r.vals, r.cols, xj), tol)
    _close(e.matvec(xt), r.matvec(xj), 2e-2 if dt == "bf16" else tol)


@pytest.mark.parametrize("dt", sorted(DTYPES))
@pytest.mark.parametrize("nbins", [1, 4, 13])
def test_balanced_spmv_matches_reference(nbins, dt):
    tdt, jdt, tol = DTYPES[dt]
    A, R = _mesh(60, 5, 2)
    bounds = partition_balanced(A.row_nnz, nbins)
    b = BalancedCOO.from_csr(A, bounds, dtype=tdt, device="cpu")
    r = ref_csr.BalancedCOO.from_csr(R, bounds, dtype=jdt)
    xt, xj = _x(A.n_rows, 1, torch.float32)
    y = balanced_spmv(b, xt)
    assert y.dtype == torch.float32 and y.shape == (A.n_rows,)
    _close(y, jax_balanced_spmv(r, xj), tol)
    _close(ref.binned_matvec_ref(b.vals, b.cols, b.lrows, xt, b.rows_pad),
           jax_ref.binned_matvec_ref(r.vals, r.cols, r.lrows, xj,
                                     r.rows_pad), tol)


@pytest.mark.parametrize("dt", sorted(DTYPES))
@pytest.mark.parametrize("nbins", [4, 13])
def test_balanced_from_arrays_matches_reference(nbins, dt):
    """The reference's own binned matrix, carried across as numpy, gives
    the reference's ``y`` in the port."""
    _, jdt, tol = DTYPES[dt]
    _, R = _mesh(60, 5, 2)
    r = ref_csr.BalancedCOO.from_csr(R, ref_balanced(R.row_nnz, nbins),
                                     dtype=jdt)
    b = BalancedCOO.from_arrays(*_reference_arrays(r), device="cpu")
    for f in ("vals", "cols", "lrows", "bin_starts", "out_gather"):
        _same(getattr(b, f), getattr(r, f))
    xt, xj = _x(R.n_rows, 3, torch.float32)
    _close(balanced_spmv(b, xt), jax_balanced_spmv(r, xj), tol)


@pytest.mark.parametrize("n,nnz_per_row,nbins,seed",
                         [(16, 3, 1, 0), (97, 7, 5, 11), (256, 12, 8, 42),
                          (200, 4, 3, 7)])
def test_both_match_host_csr(n, nnz_per_row, nbins, seed):
    A = random_spd_matrix(n, nnz_per_row=nnz_per_row, seed=seed)
    x = np.random.default_rng(seed).normal(size=n)
    want = A.matvec(x)
    xt = torch.tensor(x, dtype=torch.float32)
    tol = 1e-5 * max(1.0, float(np.abs(want).max()))
    e = ELLMatrix.from_csr(A, device="cpu")
    np.testing.assert_allclose(ell_spmv(e.vals, e.cols, xt).numpy()[:n],
                               want, atol=tol, rtol=0)
    for kind in sorted(BOUNDS):
        b = BalancedCOO.from_csr(A, BOUNDS[kind](A, nbins), device="cpu")
        np.testing.assert_allclose(balanced_spmv(b, xt).numpy(), want,
                                   atol=tol, rtol=0)
