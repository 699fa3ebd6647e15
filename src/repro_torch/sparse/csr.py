"""Host-side sparse containers and packers (numpy).

``CSRMatrix`` is the host CSR matrix all assembly, partitioning and halo
planning works on; ``ell_arrays_from_csr`` / ``sell_arrays_from_csr`` pack a
CSR block into the padded ELL and sliced-ELL (SELL-C) layouts the shard
formats put on the device.  Everything here is numpy and gives the same
bytes as the JAX package's ``repro.sparse.csr`` for the same input.
"""
from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["CSRMatrix", "ell_arrays_from_csr", "sell_arrays_from_csr"]


@dataclasses.dataclass
class CSRMatrix:
    """Host-side CSR matrix (numpy arrays)."""

    indptr: np.ndarray   # (n_rows + 1,) int64
    indices: np.ndarray  # (nnz,) int32/int64 column indices
    data: np.ndarray     # (nnz,) float
    shape: tuple[int, int]

    @property
    def n_rows(self) -> int:
        return self.shape[0]

    @property
    def n_cols(self) -> int:
        return self.shape[1]

    @property
    def nnz(self) -> int:
        return int(self.indptr[-1])

    @property
    def row_nnz(self) -> np.ndarray:
        return np.diff(self.indptr)

    # ------------------------------------------------------------------ #
    # constructors
    # ------------------------------------------------------------------ #
    @classmethod
    def from_coo(cls, rows, cols, vals, shape) -> "CSRMatrix":
        rows = np.asarray(rows)
        cols = np.asarray(cols)
        vals = np.asarray(vals)
        order = np.lexsort((cols, rows))
        rows, cols, vals = rows[order], cols[order], vals[order]
        # sum duplicates
        if len(rows):
            key = rows.astype(np.int64) * shape[1] + cols.astype(np.int64)
            uniq, inv = np.unique(key, return_inverse=True)
            sums = np.zeros(len(uniq), dtype=vals.dtype)
            np.add.at(sums, inv, vals)
            rows = (uniq // shape[1]).astype(np.int64)
            cols = (uniq % shape[1]).astype(np.int64)
            vals = sums
        indptr = np.zeros(shape[0] + 1, dtype=np.int64)
        np.add.at(indptr, rows + 1, 1)
        indptr = np.cumsum(indptr)
        return cls(indptr=indptr, indices=cols.astype(np.int64), data=vals,
                   shape=tuple(shape))

    @classmethod
    def from_dense(cls, dense: np.ndarray) -> "CSRMatrix":
        rows, cols = np.nonzero(dense)
        return cls.from_coo(rows, cols, dense[rows, cols], dense.shape)

    # ------------------------------------------------------------------ #
    # host-side ops
    # ------------------------------------------------------------------ #
    def _row_of_nnz(self) -> np.ndarray:
        """(nnz,) row id of every stored entry."""
        return np.repeat(np.arange(self.n_rows, dtype=np.int64), self.row_nnz)

    def matvec(self, x: np.ndarray) -> np.ndarray:
        """Reference host SpMV, accumulated in float64 (the oracle)."""
        out_dtype = np.result_type(self.data, x)
        if self.nnz == 0:
            return np.zeros(self.n_rows, dtype=out_dtype)
        prod = self.data * np.asarray(x)[self.indices]
        return np.bincount(self._row_of_nnz(),
                           weights=prod.astype(np.float64),
                           minlength=self.n_rows).astype(out_dtype)

    def diagonal(self) -> np.ndarray:
        d = np.zeros(self.n_rows, dtype=self.data.dtype)
        if self.nnz:
            hit = self.indices == self._row_of_nnz()
            # reversed so the FIRST stored duplicate wins
            d[self.indices[hit][::-1]] = self.data[hit][::-1]
        return d

    def row_slice(self, lo: int, hi: int) -> "CSRMatrix":
        """Extract block of rows [lo, hi) (column space unchanged)."""
        s, e = self.indptr[lo], self.indptr[hi]
        return CSRMatrix(indptr=self.indptr[lo:hi + 1] - s,
                         indices=self.indices[s:e].copy(),
                         data=self.data[s:e].copy(),
                         shape=(hi - lo, self.n_cols))

    def col_split(self, lo: int, hi: int
                  ) -> tuple["CSRMatrix", "CSRMatrix", np.ndarray]:
        """Split into (inside, outside) by column range [lo, hi).

        ``inside`` has columns renumbered to 0..hi-lo.  ``outside`` keeps a
        *compressed* column space: its columns are renumbered into
        0..n_ghost-1 and the returned ``ghost_cols`` array maps them back to
        global column ids (PETSc's MPIAIJ diagonal / off-diagonal split).
        """
        inside_mask = (self.indices >= lo) & (self.indices < hi)
        n = self.n_rows
        rows = self._row_of_nnz()

        def build(mask, new_indices, n_cols):
            # boolean masking preserves the within-row entry order
            counts = np.bincount(rows[mask], minlength=n) if self.nnz else \
                np.zeros(n, dtype=np.int64)
            indptr = np.zeros(n + 1, dtype=np.int64)
            indptr[1:] = np.cumsum(counts[:n])
            return CSRMatrix(indptr=indptr,
                             indices=np.asarray(new_indices, dtype=np.int64),
                             data=self.data[mask].copy(),
                             shape=(n, n_cols))

        inside = build(inside_mask, self.indices[inside_mask] - lo, hi - lo)

        out_cols = self.indices[~inside_mask]
        ghost_cols = np.unique(out_cols) if out_cols.size else \
            np.zeros(0, dtype=np.int64)
        outside = build(~inside_mask, np.searchsorted(ghost_cols, out_cols),
                        max(1, len(ghost_cols)))
        return inside, outside, ghost_cols


# ---------------------------------------------------------------------- #
# packers
# ---------------------------------------------------------------------- #
def ell_arrays_from_csr(m: CSRMatrix, width: int | None = None,
                        n_rows_pad: int | None = None
                        ) -> tuple[np.ndarray, np.ndarray]:
    """Host-side ELL packing: returns (cols int32, vals float64) numpy."""
    rn = m.row_nnz
    w = int(width if width is not None else (rn.max() if m.n_rows else 1))
    w = max(w, 1)
    nr = int(n_rows_pad if n_rows_pad is not None else m.n_rows)
    cols = np.zeros((nr, w), dtype=np.int32)
    vals = np.zeros((nr, w), dtype=np.float64)
    if m.nnz:
        if int(rn.max()) > w:
            raise ValueError(f"max row nnz {int(rn.max())} > ELL width {w}")
        r = m._row_of_nnz()
        k = np.arange(m.nnz, dtype=np.int64) - np.repeat(m.indptr[:-1], rn)
        cols[r, k] = m.indices
        vals[r, k] = m.data
    return cols, vals


def sell_arrays_from_csr(m: CSRMatrix, slots: np.ndarray, slice_height: int
                         ) -> tuple[np.ndarray, ...]:
    """Host-side sliced-ELL (SELL-C) packing with a caller-provided row
    permutation.

    ``slots[r]`` is the storage/vector slot of row ``r`` — a permutation of
    ``0..n_rows-1``.  Slot ``q`` belongs to slice ``q // slice_height``;
    each slice is padded to ``slice_height`` rows at its *own* maximum row
    width ``w_s`` and entry ``k`` of slot ``q`` sits at
    ``starts[s] + (q - s*C)*w_s + k``, so each slot's entries are
    contiguous.

    Returns flat slice-major ``(vals float64, cols int32, rows int32)``
    — the JAX package's three arrays: ``rows`` holds the slot each entry
    accumulates into; padding entries have ``vals == 0`` (and ``cols ==
    rows == 0``) — followed by the ``(n_slices + 1,)`` int64 slice starts
    and the ``(n_slices,)`` int64 slice widths, what a kernel with one
    thread per slot needs to find a slot's entries.
    """
    nr = m.n_rows
    C = int(slice_height)
    rn = m.row_nnz
    n_slices = -(-max(nr, 0) // C) if nr else 0
    w = np.zeros(max(n_slices, 1), dtype=np.int64)
    slots = np.asarray(slots, dtype=np.int64)
    if nr:
        np.maximum.at(w, slots // C, rn)
    starts = np.zeros(n_slices + 1, dtype=np.int64)
    starts[1:] = np.cumsum(C * w[:n_slices])
    size = int(starts[-1])
    vals = np.zeros(size, dtype=np.float64)
    cols = np.zeros(size, dtype=np.int32)
    rows = np.zeros(size, dtype=np.int32)
    if m.nnz:
        r_of = m._row_of_nnz()
        k = np.arange(m.nnz, dtype=np.int64) - np.repeat(m.indptr[:-1], rn)
        q = slots[r_of]
        s = q // C
        pos = starts[s] + (q - s * C) * w[s] + k
        vals[pos] = m.data
        cols[pos] = m.indices
        rows[pos] = q
    return vals, cols, rows, starts, w[:n_slices]
