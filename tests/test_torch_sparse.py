"""The port's host substrate against the JAX package: same seeds, same bytes.

CSR matrices from the mesh generators, the ELL and SELL packers, the
two-level partition and the owner-split halo plan are numpy in both
packages; every array must match the reference byte for byte, dtype and
shape included.
"""
import numpy as np
import pytest

from repro.core import halo as ref_halo
from repro.core import partition as ref_partition
from repro.sparse import csr as ref_csr
from repro.sparse import mesh_gen as ref_mesh_gen
from repro_torch.core import halo, partition
from repro_torch.sparse import csr, mesh_gen

GENERATORS = [
    ("graded_extruded_mesh_matrix", (48, 6), {"seed": 0}),
    ("graded_extruded_mesh_matrix", (60, 9), {"seed": 3, "max_span": 4}),
    ("extruded_mesh_matrix", (30, 4), {"seed": 1}),
    ("random_spd_matrix", (200,), {"nnz_per_row": 7, "seed": 5}),
]


def _same(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape, (a.dtype, b.dtype,
                                                       a.shape, b.shape)
    assert a.tobytes() == b.tobytes()


def _pair(name, args, kw):
    return (getattr(mesh_gen, name)(*args, **kw),
            getattr(ref_mesh_gen, name)(*args, **kw))


@pytest.mark.parametrize("name,args,kw", GENERATORS,
                         ids=[f"{g[0]}{g[1]}" for g in GENERATORS])
def test_csr_arrays_byte_identical(name, args, kw):
    A, R = _pair(name, args, kw)
    assert A.shape == R.shape
    for f in ("indptr", "indices", "data"):
        _same(getattr(A, f), getattr(R, f))
    _same(A.diagonal(), R.diagonal())
    x = np.random.default_rng(0).standard_normal(A.n_cols)
    _same(A.matvec(x), R.matvec(x))


@pytest.mark.parametrize("name,args,kw", GENERATORS,
                         ids=[f"{g[0]}{g[1]}" for g in GENERATORS])
def test_ell_and_sell_packing_byte_identical(name, args, kw):
    A, R = _pair(name, args, kw)
    for got, want in zip(csr.ell_arrays_from_csr(A),
                         ref_csr.ell_arrays_from_csr(R)):
        _same(got, want)
    slots = np.random.default_rng(1).permutation(A.n_rows)
    for C in (1, 8, 32):
        got = csr.sell_arrays_from_csr(A, slots, C)
        want = ref_csr.sell_arrays_from_csr(R, slots, C)
        for g, w in zip(got[:3], want):
            _same(g, w)
        # the slice descriptors locate every real entry at its slot
        vals, cols, rows, starts, w = got
        q = slots[A._row_of_nnz()]
        k = np.arange(A.nnz) - np.repeat(A.indptr[:-1], A.row_nnz)
        pos = starts[q // C] + (q % C) * w[q // C] + k
        np.testing.assert_array_equal(rows[pos], q)
        assert starts[-1] == len(vals) and np.all(k < w[q // C])


def test_col_split_byte_identical():
    A, R = _pair(*GENERATORS[0])
    for lo, hi in ((0, 100), (77, 200), (0, A.n_rows)):
        for got, want in zip(A.col_split(lo, hi), R.col_split(lo, hi)):
            if isinstance(want, np.ndarray):
                _same(got, want)
            else:
                for f in ("indptr", "indices", "data"):
                    _same(getattr(got, f), getattr(want, f))


@pytest.mark.parametrize("n_node,n_core", [(4, 2), (1, 4), (3, 5)])
@pytest.mark.parametrize("how", ["nnz", "rows"])
def test_partition_and_halo_plan_byte_identical(n_node, n_core, how):
    A, _ = _pair(*GENERATORS[1])
    nb, cb = partition.partition_two_level(A.row_nnz, n_node, n_core,
                                           node_partition=how,
                                           core_partition=how)
    rnb, rcb = ref_partition.partition_two_level(A.row_nnz, n_node, n_core,
                                                 node_partition=how,
                                                 core_partition=how)
    _same(nb, rnb)
    for g, w in zip(cb, rcb):
        _same(g, w)
    assert (partition.partition_stats(A.row_nnz, nb, cb)
            == ref_partition.partition_stats(A.row_nnz, rnb, rcb))
    ghosts = [A.row_slice(int(nb[i]), int(nb[i + 1])).col_split(
        int(nb[i]), int(nb[i + 1]))[2] for i in range(n_node)]
    got = halo.build_halo_plan(ghosts, nb, n_core, core_bounds=cb)
    want = ref_halo.build_halo_plan(ghosts, rnb, n_core, core_bounds=rcb)
    _same(got.send_own, want.send_own)
    _same(got.recv_own, want.recv_own)
    assert (got.g_pad, got.h_own) == (want.g_pad, want.h_own)
    _same(halo.ghost_writer_counts(got.recv_own, got.g_pad),
          ref_halo.ghost_writer_counts(want.recv_own, want.g_pad))
    assert got.neighbor_offsets() == want.neighbor_offsets()
