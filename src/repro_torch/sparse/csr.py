"""Sparse containers and packers.

``CSRMatrix`` is the host CSR matrix (numpy) all assembly, partitioning and
halo planning works on; ``ell_arrays_from_csr`` / ``sell_arrays_from_csr``
pack a CSR block into the padded ELL and sliced-ELL (SELL-C) layouts the
shard formats put on the device.  The packers give the same bytes as the
JAX package's ``repro.sparse.csr`` for the same input.

Two device formats hold a whole matrix for the single-device kernels of
:mod:`repro_torch.kernels.ops`, as tensors:

``ELLMatrix``
    padded row-major (ELLPACK) storage, every row padded to one width: the
    "vector-based threading" analogue, work split by *rows*
    (``ops.ell_spmv``).
``BalancedCOO``
    rows grouped into ``nbins`` contiguous bins of about equal *non-zeros*
    (greedy + diffusion, ``repro_torch.core.partition``), each bin padded
    to a common entry count: the "task-based + thread-balanced" analogue
    (``ops.balanced_spmv``).  Balancing the nnz minimises the padding.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.util import align_up, resolve_device

__all__ = ["CSRMatrix", "ELLMatrix", "BalancedCOO", "balanced_warp_map",
           "ell_arrays_from_csr", "ell_row_lens", "sell_arrays_from_csr"]


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

    @classmethod
    def from_scipy(cls, m) -> "CSRMatrix":
        m = m.tocsr()
        return cls(indptr=np.asarray(m.indptr, dtype=np.int64),
                   indices=np.asarray(m.indices, dtype=np.int64),
                   data=np.asarray(m.data),
                   shape=tuple(m.shape))

    # ------------------------------------------------------------------ #
    # host-side ops
    # ------------------------------------------------------------------ #
    def to_dense(self) -> np.ndarray:
        out = np.zeros(self.shape, dtype=self.data.dtype)
        for r in range(self.n_rows):
            lo, hi = self.indptr[r], self.indptr[r + 1]
            out[r, self.indices[lo:hi]] += self.data[lo:hi]
        return out

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

    def transpose(self) -> "CSRMatrix":
        """Aᵀ as a new CSRMatrix (host; e.g. prolongation P = Rᵀ)."""
        return CSRMatrix.from_coo(self.indices, self._row_of_nnz(),
                                  self.data, (self.n_cols, self.n_rows))

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


def ell_row_lens(cols: np.ndarray, vals: np.ndarray) -> np.ndarray:
    """Per-row entry counts of ELL arrays ``(..., w)``: 1 + the last slot
    ``k`` with ``vals != 0 or cols != 0``, 0 for a row with none; int32
    ``(...)``.  Every slot past it is padding (``vals == cols == 0``), so
    a kernel that stops there computes the same sum wherever ``x[0]`` is
    finite (a read padding slot adds ``0 * x[0]``)."""
    cols, vals = np.asarray(cols), np.asarray(vals)
    if cols.shape[-1] == 0:
        return np.zeros(cols.shape[:-1], dtype=np.int32)
    real = (cols != 0) | (vals.astype(np.float32, copy=False) != 0)
    last = real.shape[-1] - np.argmax(real[..., ::-1], axis=-1)
    return np.where(real.any(axis=-1), last, 0).astype(np.int32)


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


# ---------------------------------------------------------------------- #
# device formats of a whole matrix (the single-device kernel path)
# ---------------------------------------------------------------------- #
def _host(a: np.ndarray) -> torch.Tensor:
    """A CPU tensor on ``a``'s bytes (copied when ``a`` is read-only, as
    arrays handed over from JAX are)."""
    a = np.ascontiguousarray(a)
    return torch.from_numpy(a if a.flags.writeable else a.copy())


def _values(a: np.ndarray, dtype: torch.dtype, device) -> torch.Tensor:
    """Host values -> ``dtype`` tensor on ``device``.  float64 is rounded
    to float32 first, as the JAX package rounds it (also on the way to
    bfloat16); a bfloat16 numpy array (``ml_dtypes``) keeps its bits."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        t = _host(a.view(np.int16)).view(torch.bfloat16)
    else:
        t = _host(a.astype(np.float32, copy=False))
    return t.to(device=device, dtype=dtype)


def _index(a: np.ndarray, device) -> torch.Tensor:
    return _host(np.asarray(a).astype(np.int32, copy=False)).to(device)


@dataclasses.dataclass
class ELLMatrix:
    """Padded-row (ELLPACK) storage: ``y[r] = Σ_k vals[r,k] · x[cols[r,k]]``.

    Padding entries have ``vals == 0`` and ``cols == 0`` so they contribute
    nothing.  Equal-*rows* work splitting over this format is the
    "vector-based threading" analogue from the paper.

    ``row_lens`` is the port's own field: each row's entry count
    (``ell_row_lens``) as an int32 tensor, so that ``ops.ell_spmv`` reads
    no padding.  ``None`` (an ``ELLMatrix`` built by hand) reads every slot.
    """

    cols: torch.Tensor   # (n_rows_pad, width) int32
    vals: torch.Tensor   # (n_rows_pad, width) float32 or bfloat16
    n_rows: int
    n_cols: int
    row_lens: torch.Tensor | None = None   # (n_rows_pad,) int32

    @property
    def width(self) -> int:
        return self.cols.shape[1]

    @property
    def n_rows_pad(self) -> int:
        return self.cols.shape[0]

    @classmethod
    def from_csr(cls, m: CSRMatrix, width: int | None = None,
                 n_rows_pad: int | None = None, dtype=torch.float32,
                 device=None) -> "ELLMatrix":
        device = resolve_device(device)
        cols, vals = ell_arrays_from_csr(m, width=width, n_rows_pad=n_rows_pad)
        return cls(cols=_index(cols, device),
                   vals=_values(vals, dtype, device),
                   n_rows=m.n_rows, n_cols=m.n_cols,
                   row_lens=_index(ell_row_lens(cols, vals), device))

    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        """Plain PyTorch SpMV (padding-safe) in the storage dtype, as the
        reference's ``ELLMatrix.matvec``; the kernel is ``ops.ell_spmv``."""
        g = x[self.cols.long()].to(self.vals.dtype)
        return (self.vals * g).sum(-1)[: self.n_rows]


@dataclasses.dataclass
class BalancedCOO:
    """nnz-balanced binned COO — input format of ``ops.balanced_spmv``.

    Rows are grouped into ``nbins`` contiguous bins with ~equal nonzeros
    (the paper's greedy + diffusion thread partition).  Each bin is padded
    to ``nnz_pad`` entries and ``rows_pad`` rows so the TPU kernel's grid
    is static.  ``lrows`` holds *bin-local* row ids, nondecreasing over a
    bin's ``bin_nnz[t]`` real entries (bins are contiguous CSR row ranges);
    padding past them has ``vals == cols == lrows == 0``.  ``out_gather``
    maps the ``(nbins, rows_pad)`` output of the plain version (and of the
    JAX package's kernel) back to the flat row vector.

    ``row_lens`` and ``warp_map`` are the port's own fields, which the CUDA
    kernel reads in place of ``lrows`` and ``out_gather``
    (:func:`balanced_warp_map`): each row's entry count in global row
    order, and one ``(first row, row count, first entry)`` triple per warp
    of up to 32 consecutive rows of one bin, the entry an offset into the
    flat ``(nbins·nnz_pad)`` streams.
    """

    vals: torch.Tensor        # (nbins, nnz_pad) float32 or bfloat16
    cols: torch.Tensor        # (nbins, nnz_pad) int32 — column into x
    lrows: torch.Tensor       # (nbins, nnz_pad) int32 — bin-local row id
    bin_starts: torch.Tensor  # (nbins,) int32 — first global row of each bin
    out_gather: torch.Tensor  # (n_rows,) int32 — flat index into (nbins*rows_pad)
    row_lens: torch.Tensor    # (n_rows,) int32 — entries of each row
    warp_map: torch.Tensor    # (n_warps, 3) int32 — first row, rows, entry
    n_rows: int
    n_cols: int
    rows_pad: int
    bin_nnz: tuple            # true stored-entry count per bin (from indptr)

    @property
    def nbins(self) -> int:
        return self.vals.shape[0]

    @property
    def nnz_pad(self) -> int:
        return self.vals.shape[1]

    @classmethod
    def from_csr(cls, m: CSRMatrix, bounds: np.ndarray, dtype=torch.float32,
                 nnz_align: int = 128, rows_align: int = 8,
                 device=None) -> "BalancedCOO":
        """``bounds``: (nbins+1,) row partition from
        ``repro_torch.core.partition``."""
        bounds = np.asarray(bounds, dtype=np.int64)
        nbins = len(bounds) - 1
        rn = m.row_nnz
        bin_nnz = np.array([rn[bounds[t]:bounds[t + 1]].sum()
                            for t in range(nbins)], dtype=np.int64)
        bin_rows = np.diff(bounds)
        nnz_pad = align_up(bin_nnz.max() if nbins else 1, nnz_align)
        rows_pad = align_up(bin_rows.max() if nbins else 1, rows_align)

        vals = np.zeros((nbins, nnz_pad), dtype=np.float64)
        cols = np.zeros((nbins, nnz_pad), dtype=np.int32)
        lrows = np.zeros((nbins, nnz_pad), dtype=np.int32)
        out_gather = np.zeros(m.n_rows, dtype=np.int32)
        for t in range(nbins):
            lo_r, hi_r = bounds[t], bounds[t + 1]
            s, e = m.indptr[lo_r], m.indptr[hi_r]
            k = e - s
            vals[t, :k] = m.data[s:e]
            cols[t, :k] = m.indices[s:e]
            # bin-local row ids, repeated per nnz
            lrows[t, :k] = np.repeat(np.arange(hi_r - lo_r), rn[lo_r:hi_r])
            out_gather[lo_r:hi_r] = t * rows_pad + np.arange(hi_r - lo_r)
        return cls.from_arrays(
            {"vals": vals, "cols": cols, "lrows": lrows,
             "bin_starts": bounds[:-1], "out_gather": out_gather},
            {"n_rows": m.n_rows, "n_cols": m.n_cols, "rows_pad": rows_pad,
             "bin_nnz": bin_nnz}, dtype=dtype, device=device)

    @classmethod
    def from_arrays(cls, arrays: dict[str, np.ndarray], meta: dict,
                    dtype=None, device=None) -> "BalancedCOO":
        """A port ``BalancedCOO`` from host arrays — those of the JAX
        package's ``BalancedCOO`` handed over as numpy (``vals``, ``cols``,
        ``lrows``, ``bin_starts``, ``out_gather``) with its meta
        (``n_rows``, ``n_cols``, ``rows_pad``, ``bin_nnz``), so that both
        packages compute on the identical binned matrix; ``row_lens`` and
        ``warp_map`` are built here (:func:`balanced_warp_map`).

        ``dtype`` defaults to the values' own (float32 for float64 input).
        Raises unless what the kernel relies on holds: within each bin's
        real entries, ``lrows`` is nondecreasing and in ``[0, rows_pad)``
        and ``cols`` in ``[0, n_cols)``; and what ``balanced_warp_map``
        checks."""
        device = resolve_device(device)
        vals = np.asarray(arrays["vals"])
        cols, lrows = np.asarray(arrays["cols"]), np.asarray(arrays["lrows"])
        bin_nnz = np.asarray(meta["bin_nnz"], dtype=np.int64)
        rows_pad, n_cols = int(meta["rows_pad"]), int(meta["n_cols"])
        if not (vals.ndim == 2 and vals.shape == cols.shape == lrows.shape
                and bin_nnz.shape == (vals.shape[0],)
                and np.all(bin_nnz <= vals.shape[1])):
            raise ValueError(f"BalancedCOO arrays {vals.shape} {cols.shape} "
                             f"{lrows.shape} for bin_nnz {bin_nnz.shape}")
        live = np.arange(vals.shape[1]) < bin_nnz[:, None]
        if (np.any(np.diff(lrows, axis=1)[live[:, 1:]] < 0)
                or np.any((lrows[live] < 0) | (lrows[live] >= rows_pad))
                or np.any((cols[live] < 0) | (cols[live] >= n_cols))):
            raise ValueError("BalancedCOO: bin-local rows must be "
                             "nondecreasing in [0, rows_pad) and columns in "
                             "[0, n_cols) over each bin's entries")
        row_lens, warp_map = balanced_warp_map(
            lrows, bin_nnz, arrays["bin_starts"], arrays["out_gather"],
            int(meta["n_rows"]), rows_pad)
        if dtype is None:
            dtype = (torch.bfloat16 if vals.dtype.name == "bfloat16"
                     else torch.float32)
        return cls(vals=_values(vals, dtype, device),
                   cols=_index(cols, device), lrows=_index(lrows, device),
                   bin_starts=_index(arrays["bin_starts"], device),
                   out_gather=_index(arrays["out_gather"], device),
                   row_lens=_index(row_lens, device),
                   warp_map=_index(warp_map, device),
                   n_rows=int(meta["n_rows"]), n_cols=n_cols,
                   rows_pad=rows_pad,
                   bin_nnz=tuple(int(k) for k in bin_nnz))

    @property
    def padding_waste(self) -> float:
        """Fraction of stored entries that are padding — the balanced
        partition minimises this.

        Computed from the true per-bin stored-entry counts (``bin_nnz``,
        taken from the CSR ``indptr`` at construction), *not* from
        ``vals != 0`` — an explicitly stored zero value is a real entry the
        kernel streams, not padding."""
        if len(self.bin_nnz) != self.nbins:
            raise ValueError(f"bin_nnz has {len(self.bin_nnz)} entries for "
                             f"{self.nbins} bins")
        total = self.nbins * self.nnz_pad
        real = int(sum(self.bin_nnz))
        return 1.0 - real / max(total, 1)


def balanced_warp_map(lrows: np.ndarray, bin_nnz: np.ndarray,
                      bin_starts: np.ndarray, out_gather: np.ndarray,
                      n_rows: int, rows_pad: int
                      ) -> tuple[np.ndarray, np.ndarray]:
    """``(row_lens, warp_map)`` of a binned COO, as the CUDA kernel reads it.

    Bin ``t`` holds the global rows ``[bin_starts[t], bin_starts[t + 1])``
    (the last up to ``n_rows``) and their entries, in row order, at
    ``[0, bin_nnz[t])`` of its ``nnz_pad = lrows.shape[1]`` slots.
    ``row_lens`` (``(n_rows,)``) is each row's entry count, a per-bin
    bincount of ``lrows``.  ``warp_map`` (``(n_warps, 3)``) tiles each
    bin's rows in runs of 32 that never cross a bin: the first global row,
    the row count (1–32) and the first entry, ``t·nnz_pad`` plus the lengths
    of the bin's rows before it.  Bins with no rows give no warp; rows with
    no entries have length 0.  int64 arrays; ``from_arrays`` stores them as
    int32.

    Raises unless the bins tile ``[0, n_rows)`` in order, each bin's
    ``lrows`` are below its row count and at most ``rows_pad``,
    ``out_gather[r] == t·rows_pad + r − bin_starts[t]`` for the bin ``t``
    holding row ``r`` (the kernel writes ``y[r]`` where the plain version
    reads that slot), and the flat entry offsets fit int32."""
    nbins, nnz_pad = lrows.shape
    starts = np.asarray(bin_starts, dtype=np.int64)
    ends = np.append(starts, n_rows)[1:]
    bin_rows = ends - starts
    if (starts.shape != (nbins,) or np.any(bin_rows < 0)
            or bin_rows.sum() != n_rows or np.any(bin_rows > rows_pad)):
        raise ValueError(f"BalancedCOO: {len(starts)} bin starts for "
                         f"{nbins} bins do not tile {n_rows} rows in "
                         f"order, at most {rows_pad} each")
    if nbins * nnz_pad >= 2**31:
        raise ValueError(f"BalancedCOO: {nbins}x{nnz_pad} entries overflow "
                         f"the warp map's int32 offsets")
    live = np.arange(nnz_pad) < np.asarray(bin_nnz)[:, None]
    bin_of = np.broadcast_to(np.arange(nbins)[:, None], lrows.shape)[live]
    local = lrows[live].astype(np.int64)
    if np.any(local >= bin_rows[bin_of]):
        raise ValueError("BalancedCOO: a bin-local row past its bin's rows")
    row_lens = np.bincount(starts[bin_of] + local, minlength=n_rows)
    t_of = np.repeat(np.arange(nbins), bin_rows)
    want = t_of * rows_pad + np.arange(n_rows) - starts[t_of]
    if not np.array_equal(np.asarray(out_gather, dtype=np.int64), want):
        raise ValueError("BalancedCOO: out_gather is not each row's slot "
                         "t·rows_pad + (r − bin_starts[t]) of its bin t")
    before = np.concatenate([[0], np.cumsum(row_lens)])   # entries < row r
    n_w = -(-bin_rows // 32)
    w_bin = np.repeat(np.arange(nbins), n_w)
    j = np.arange(len(w_bin)) - np.repeat(np.cumsum(n_w) - n_w, n_w)
    first = starts[w_bin] + 32 * j
    warp_map = np.stack([first, np.minimum(32, ends[w_bin] - first),
                         w_bin * nnz_pad + before[first]
                         - before[starts[w_bin]]], axis=1)
    return row_lens, warp_map
