"""HPCG 3.1's operator (hpcg-benchmark.org; Dongarra, Heroux and
Luszczek, SAND2013-8752): the 27-point stencil on an ``nx × ny × nz``
grid in lexicographic order (x fastest), 26 on the diagonal and -1 for
each neighbour inside the domain, as HPCG's ``GenerateProblem`` builds a
process's local block.  Rows inside have 27 entries, a corner row 8.
"""
from __future__ import annotations

import numpy as np

from perfbench.operators import Operator

__all__ = ["make"]

#: slow enough to keep once made (``perfbench.operators.generate``)
CACHE = True


def _axis(m: int) -> tuple[np.ndarray, np.ndarray]:
    """Per offset ``d`` in ``(-1, 0, 1)``: which of ``m`` grid indices have
    a neighbour at ``i + d`` — ``(3, m)`` bool — and how many do."""
    i = np.arange(m)
    ok = np.stack([(i + d >= 0) & (i + d < m) for d in (-1, 0, 1)])
    return ok, ok.sum(0)


def make(nx: int, ny: int, nz: int) -> Operator:
    n = nx * ny * nz
    okx, cx = _axis(nx)
    oky, cy = _axis(ny)
    okz, cz = _axis(nz)
    counts = (cz[:, None, None] * cy[None, :, None] * cx[None, None, :]).ravel()
    indptr = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(counts, out=indptr[1:])
    # one column per (row, offset), offsets in (dz, dy, dx) order, which
    # is ascending column order; the mask drops neighbours outside
    row = np.arange(n, dtype=np.int64).reshape(nz, ny, nx)
    cols = np.empty((nz, ny, nx, 27), dtype=np.int64)
    mask = np.empty((nz, ny, nx, 27), dtype=bool)
    vals = np.full(27, -1.0)
    vals[13] = 26.0
    k = 0
    for dz in (-1, 0, 1):
        for dy in (-1, 0, 1):
            for dx in (-1, 0, 1):
                cols[..., k] = row + dx + nx * (dy + ny * dz)
                mask[..., k] = (okz[dz + 1][:, None, None]
                                & oky[dy + 1][None, :, None]
                                & okx[dx + 1][None, None, :])
                k += 1
    indices = cols[mask]
    data = np.broadcast_to(vals, mask.shape)[mask]
    return Operator(indptr=indptr, indices=indices,
                    data=np.ascontiguousarray(data, dtype=np.float64))
