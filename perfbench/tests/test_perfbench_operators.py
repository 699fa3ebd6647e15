"""The benchmark's frozen operator generators."""
import numpy as np
import pytest

from perfbench.operators import generate


@pytest.mark.parametrize("n_surface,layers,seed,max_span",
                         [(300, 6, 0, None), (2000, 16, 0, None),
                          (1200, 64, 3, None), (1200, 64, 0, 53)])
def test_frozen_fluidity_matches_the_program(n_surface, layers, seed, max_span):
    """indptr and indices equal the program's, data to float64 rounding."""
    from repro_torch.sparse import graded_extruded_mesh_matrix

    A = generate({"generator": "fluidity_graded", "n_surface": n_surface,
                  "layers": layers, "seed": seed, "max_span": max_span})
    B = graded_extruded_mesh_matrix(n_surface, layers, seed=seed,
                                    max_span=max_span)
    assert A.n == B.n_rows
    np.testing.assert_array_equal(A.indptr, B.indptr)
    np.testing.assert_array_equal(A.indices, B.indices)
    np.testing.assert_allclose(A.data, B.data, rtol=1e-14,
                               atol=1e-14 * np.abs(B.data).max())


def test_hpcg_stencil_rows_and_symmetry():
    nx, ny, nz = 6, 5, 4
    A = generate({"generator": "hpcg27", "nx": nx, "ny": ny, "nz": nz})
    n = nx * ny * nz
    assert A.n == n and A.nnz == (3 * nx - 2) * (3 * ny - 2) * (3 * nz - 2)
    nnz = np.diff(A.indptr).reshape(nz, ny, nx)
    assert nnz[0, 0, 0] == 8 and nnz[-1, -1, -1] == 8       # corners
    assert nnz[0, 0, 2] == 12                               # an edge
    assert nnz[0, 2, 2] == 18                               # a face
    assert (nnz[1:-1, 1:-1, 1:-1] == 27).all()              # inside
    dense = np.zeros((n, n))
    rows = np.repeat(np.arange(n), np.diff(A.indptr))
    dense[rows, A.indices] = A.data
    np.testing.assert_array_equal(dense, dense.T)
    np.testing.assert_array_equal(np.diag(dense), 26.0)
    off = dense - np.diag(np.diag(dense))
    assert set(np.unique(off)) == {-1.0, 0.0}
    # every neighbour within one step in each axis, in lexicographic order
    z, y, x = np.unravel_index(np.arange(n), (nz, ny, nx))
    i, j = np.nonzero(off)
    assert (np.abs(x[i] - x[j]) <= 1).all() and (np.abs(z[i] - z[j]) <= 1).all()
    assert len(i) == A.nnz - n
    for r in range(n):                                      # sorted columns
        cols = A.indices[A.indptr[r]:A.indptr[r + 1]]
        assert (np.diff(cols) > 0).all()


def test_published_row_width():
    """At the configuration's span the rows hold the paper's 27.5 entries
    on average (371M nnz over 13.5M rows), where the default span gives
    fewer."""
    wide = generate({"generator": "fluidity_graded", "n_surface": 4000,
                     "layers": 64, "max_span": 53})
    narrow = generate({"generator": "fluidity_graded", "n_surface": 4000,
                       "layers": 64})
    assert abs(wide.nnz / wide.n - 371 / 13.5) < 0.1
    assert narrow.nnz / narrow.n < 23
