"""Pluggable per-shard matrix storage formats — the ``ShardFormat`` layer.

A format owns

  * the **vector-layout slot** of every row within its core bin
    (``slot_order`` — identity for ELL, σ-window nnz sorting for SELL; the
    permutation is folded into ``x_gather``/``global_row_of``/``mask``/the
    halo plan by ``build_spmv_plan``, so the layout conversion and the
    exchange need no per-format special cases);
  * the **host-side packing** of the per-(node, core) diag/offd CSR blocks
    into device tensors (``pack`` — one entry per name in ``fields`` and in
    ``aux_fields``, every tensor leading with ``(n_node, n_core)`` shard
    dims);
  * the **local two-phase matvec** over all shards at once:
    ``matvec_kernel`` (the wrappers of :mod:`repro_torch.kernels.ops`,
    which the shard body runs: the CUDA kernels on a CUDA tensor, the
    plain versions on a CPU one) and ``matvec_plain`` (the plain PyTorch
    versions of :mod:`repro_torch.kernels.ref`, which the kernels are held
    against on the card).  Both get the node-local ``x_local``
    ``(n_node, nl_pad)`` and the exchanged ``x_ghost`` ``(n_node, g_pad +
    1)`` (``None`` when the plan has no halo traffic: skip the ghost
    phase).  Real ghost slots ``< g_pad`` carry the owners' bits; the
    trailing dump slot is write-only garbage a matvec never reads (pad
    ``offd`` entries point at slot 0 with zero values instead);
  * its own storage **accounting** (``nnz_stored`` / ``padding_waste``).

``fields`` are exactly the JAX package's packed arrays (same names, bytes,
dtypes and shapes).  ``aux_fields`` are arrays the port's kernels need on
top of them (ELL row lengths, SELL slice starts and widths); they stay out
of ``fields`` so the plan's golden-hashed arrays are unchanged.

``ell``   row-padded ELLPACK, ``(rc_pad, width)`` blocks per shard.
``sell``  sliced ELL (SELL-C-σ): rows sorted by nnz within σ-row windows,
          grouped into slices of C rows, each slice padded to its own
          width and flattened slice-major.

Each format declares its gather/scatter index streams
(``index_streams``, :class:`IndexStream`) so the static checker
(``repro_torch.analysis.kernel_check``) can prove every index inside its
buffer before a kernel reads it: the kernels do no bounds checks.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.sparse.csr import (CSRMatrix, ell_arrays_from_csr,
                                    ell_row_lens, sell_arrays_from_csr)
from repro_torch.util import align_up, to_device

__all__ = ["IndexStream", "ShardFormat", "ELLFormat", "SELLFormat",
           "register_format", "get_format", "available_formats"]


@dataclasses.dataclass(frozen=True)
class IndexStream:
    """Static descriptor of one gather/scatter index stream of a format.

    ``vals``/``cols`` name entries of ``fmt_data``; ``x`` says which
    buffer ``cols`` indexes (``"local"``: the node-local ``(nl_pad,)``
    slice; ``"ghost"``: the ``(g_pad + 1,)`` exchanged buffer, whose
    trailing dump slot only zero-valued entries may read); ``rows``, when
    set, is the accumulation-slot stream into the ``(rc_pad,)`` output
    (``None`` for row-aligned layouts like ELL).
    """

    vals: str
    cols: str
    x: str
    rows: str | None = None


class ShardFormat:
    """Interface of a shard-local matrix storage format.

    Subclasses set ``name`` (registry key), ``fields`` (the packed arrays
    the JAX package also has) and ``aux_fields`` (port-only arrays derived
    from them), and implement ``pack``/``nnz_stored``/``matvec_plain``/
    ``matvec_kernel``.
    """

    name: str = ""
    fields: tuple[str, ...] = ()
    aux_fields: tuple[str, ...] = ()

    # -- vector layout ------------------------------------------------- #
    def slot_order(self, row_nnz_local: np.ndarray,
                   core_bounds: np.ndarray) -> np.ndarray:
        """Storage/vector slot of every node-local row within its core bin
        (default: slot == bin-local row id)."""
        cb = np.asarray(core_bounds, dtype=np.int64)
        ar = np.arange(len(row_nnz_local), dtype=np.int64)
        c_of = np.searchsorted(cb, ar, side="right") - 1
        return ar - cb[c_of]

    # -- host-side packing --------------------------------------------- #
    def pack(self, diag_nodes: list[CSRMatrix], offd_nodes: list[CSRMatrix],
             core_bounds: list[np.ndarray], c_of_all: list[np.ndarray],
             slots_all: list[np.ndarray], rc_pad: int,
             device) -> dict[str, torch.Tensor]:
        """Pack per-node diag/offd CSR blocks into float32/int32 tensors on
        ``device``, one per name in ``fields + aux_fields``."""
        raise NotImplementedError

    def derive_aux(self, data: dict[str, np.ndarray],
                   rc_pad: int) -> dict[str, np.ndarray]:
        """Recover ``aux_fields`` from the ``fields`` arrays alone (a plan
        carried across from the JAX package).  Default: none."""
        return {}

    # -- static contract ----------------------------------------------- #
    def index_streams(self) -> tuple[IndexStream, ...]:
        """The format's gather/scatter streams over ``fields``, for the
        static bounds checker; a field left out is flagged there."""
        return ()

    # -- accounting ---------------------------------------------------- #
    def nnz_stored(self, data: dict[str, torch.Tensor]) -> int:
        """Total value slots held on device, padding included."""
        raise NotImplementedError

    def padding_waste(self, data: dict[str, torch.Tensor],
                      nnz_true: int) -> float:
        """Fraction of stored slots holding no real matrix entry."""
        return 1.0 - nnz_true / max(self.nnz_stored(data), 1)

    # -- device-side local matvec -------------------------------------- #
    def check_kernel_layout(self, F: dict[str, torch.Tensor]) -> None:
        """Raise if ``F`` breaks a layout the kernels assume and the plan
        arrays' shapes do not show; run once when a shard body binds a
        plan.  Default: nothing to check."""

    def matvec_plain(self, F: dict[str, torch.Tensor], x_local: torch.Tensor,
                     x_ghost: torch.Tensor | None,
                     rc_pad: int) -> torch.Tensor:
        """Two-phase matvec over all shards, plain PyTorch.  A batched
        ``x_local``/``x_ghost`` (a leading ``nrhs`` axis) gives ``(nrhs,
        n_node, n_core, rc_pad)``."""
        raise NotImplementedError

    def matvec_kernel(self, F: dict[str, torch.Tensor],
                      x_local: torch.Tensor, x_ghost: torch.Tensor | None,
                      rc_pad: int) -> torch.Tensor:
        """Two-phase matvec over all shards through the kernel wrappers;
        batched as :meth:`matvec_plain`, in one launch."""
        raise NotImplementedError


def _max_width(blocks: list[CSRMatrix]) -> int:
    """Largest row nnz over the blocks — 0 when every block is empty (no
    dead ``(rc_pad, 1)`` gather for halo-free matrices)."""
    return max((int(b.row_nnz.max()) for b in blocks if b.nnz), default=0)


# --------------------------------------------------------------------- #
# ELL — the row-padded layout
# --------------------------------------------------------------------- #
@dataclasses.dataclass(frozen=True)
class ELLFormat(ShardFormat):
    """Row-padded ELLPACK blocks, ``(rc_pad, width)`` per shard.

    ``aux_fields``: each block row's entry count (``ell_row_lens``), int32
    ``(n_node, n_core, rc_pad)`` per stream, so the kernel reads no
    padding.
    """

    name = "ell"
    fields = ("diag_cols", "diag_vals", "offd_cols", "offd_vals")
    aux_fields = ("diag_len", "offd_len")

    def index_streams(self):
        # row-aligned: entry (r, k) accumulates into row r
        return (IndexStream(vals="diag_vals", cols="diag_cols", x="local"),
                IndexStream(vals="offd_vals", cols="offd_cols", x="ghost"))

    def pack(self, diag_nodes, offd_nodes, core_bounds, c_of_all, slots_all,
             rc_pad, device):
        n_node = len(diag_nodes)
        n_core = len(core_bounds[0]) - 1
        wd, wo = _max_width(diag_nodes), _max_width(offd_nodes)
        diag_cols = np.zeros((n_node, n_core, rc_pad, wd), dtype=np.int32)
        diag_vals = np.zeros((n_node, n_core, rc_pad, wd), dtype=np.float64)
        offd_cols = np.zeros((n_node, n_core, rc_pad, wo), dtype=np.int32)
        offd_vals = np.zeros((n_node, n_core, rc_pad, wo), dtype=np.float64)
        for i in range(n_node):
            c_of, lr = c_of_all[i], slots_all[i]
            if wd:
                dc, dv = ell_arrays_from_csr(diag_nodes[i], width=wd)
                diag_cols[i, c_of, lr] = dc
                diag_vals[i, c_of, lr] = dv
            if wo:
                oc, ov = ell_arrays_from_csr(offd_nodes[i], width=wo)
                offd_cols[i, c_of, lr] = oc
                offd_vals[i, c_of, lr] = ov
        arrays = {"diag_cols": diag_cols, "diag_vals": diag_vals,
                  "offd_cols": offd_cols, "offd_vals": offd_vals}
        arrays.update(self.derive_aux(arrays, rc_pad))
        return {k: to_device(a, device) for k, a in arrays.items()}

    def derive_aux(self, data, rc_pad):
        """Row lengths from the packed blocks alone (``ell_row_lens``)."""
        return {f"{s}_len": ell_row_lens(data[f"{s}_cols"], data[f"{s}_vals"])
                for s in ("diag", "offd")}

    def nnz_stored(self, data):
        return int(data["diag_cols"].numel() + data["offd_cols"].numel())

    def matvec_plain(self, F, x_local, x_ghost, rc_pad):
        from repro_torch.kernels.ref import ell_spmv_ref, fused_ell_spmv_ref
        if x_ghost is None:
            return ell_spmv_ref(F["diag_vals"], F["diag_cols"], x_local)
        return fused_ell_spmv_ref(F["diag_vals"], F["diag_cols"],
                                  F["offd_vals"], F["offd_cols"],
                                  x_local, x_ghost)

    def matvec_kernel(self, F, x_local, x_ghost, rc_pad):
        from repro_torch.kernels.ops import ell_spmv, fused_ell_spmv
        if x_ghost is None:
            return ell_spmv(F["diag_vals"], F["diag_cols"], x_local,
                            lens=F["diag_len"])
        return fused_ell_spmv(F["diag_vals"], F["diag_cols"],
                              F["offd_vals"], F["offd_cols"],
                              x_local, x_ghost, dlens=F["diag_len"],
                              olens=F["offd_len"])


# --------------------------------------------------------------------- #
# SELL — sliced ELL with σ-window row sorting (SELL-C-σ)
# --------------------------------------------------------------------- #
@dataclasses.dataclass(frozen=True)
class SELLFormat(ShardFormat):
    """Sliced ELL: per-slice widths after σ-window nnz sorting.

    ``slice_height`` is the C of SELL-C-σ; ``sigma`` the sorting window in
    rows (``None`` sorts the whole core bin); ``nnz_align`` pads the
    cross-shard flattened storage length.

    ``aux_fields``: per shard and per slice (``ceil(rc_pad / C)`` slices,
    absent ones with width 0) the first entry and the width of each
    stream's slice, int32.
    """

    slice_height: int = 8
    sigma: int | None = None
    nnz_align: int = 8

    name = "sell"
    fields = ("sell_dvals", "sell_dcols", "sell_drows",
              "sell_ovals", "sell_ocols", "sell_orows")
    aux_fields = ("sell_dstart", "sell_dwidth", "sell_ostart", "sell_owidth")

    def index_streams(self):
        return (IndexStream(vals="sell_dvals", cols="sell_dcols",
                            x="local", rows="sell_drows"),
                IndexStream(vals="sell_ovals", cols="sell_ocols",
                            x="ghost", rows="sell_orows"))

    def slot_order(self, row_nnz_local, core_bounds):
        cb = np.asarray(core_bounds, dtype=np.int64)
        row_nnz_local = np.asarray(row_nnz_local, dtype=np.int64)
        lr = np.empty(len(row_nnz_local), dtype=np.int64)
        for c in range(len(cb) - 1):
            lo, hi = int(cb[c]), int(cb[c + 1])
            nb = hi - lo
            if nb == 0:
                continue
            bl = np.arange(nb, dtype=np.int64)
            win = bl // (self.sigma if self.sigma else nb)
            # per window: heaviest rows first (ties keep mesh order)
            order = np.lexsort((bl, -row_nnz_local[lo:hi], win))
            s = np.empty(nb, dtype=np.int64)
            s[order] = bl
            lr[lo:hi] = s
        return lr

    def n_slices(self, rc_pad: int) -> int:
        return -(-int(rc_pad) // self.slice_height)

    def pack(self, diag_nodes, offd_nodes, core_bounds, c_of_all, slots_all,
             rc_pad, device):
        n_node = len(diag_nodes)
        n_core = len(core_bounds[0]) - 1
        n_sl = self.n_slices(rc_pad)
        parts: dict[tuple[int, int, str], tuple] = {}
        d_sizes, o_sizes = [0], [0]
        for i in range(n_node):
            cb = core_bounds[i]
            for c in range(n_core):
                lo, hi = int(cb[c]), int(cb[c + 1])
                sl = slots_all[i][lo:hi]
                d = sell_arrays_from_csr(diag_nodes[i].row_slice(lo, hi),
                                         sl, self.slice_height)
                o = sell_arrays_from_csr(offd_nodes[i].row_slice(lo, hi),
                                         sl, self.slice_height)
                parts[(i, c, "d")], parts[(i, c, "o")] = d, o
                d_sizes.append(len(d[0]))
                o_sizes.append(len(o[0]))
        d_pad = align_up(max(d_sizes), self.nnz_align) if max(d_sizes) else 0
        o_pad = align_up(max(o_sizes), self.nnz_align) if max(o_sizes) else 0

        def _gather(key, pad):
            vals = np.zeros((n_node, n_core, pad), dtype=np.float64)
            cols = np.zeros((n_node, n_core, pad), dtype=np.int32)
            rows = np.zeros((n_node, n_core, pad), dtype=np.int32)
            start = np.zeros((n_node, n_core, n_sl), dtype=np.int32)
            width = np.zeros((n_node, n_core, n_sl), dtype=np.int32)
            for i in range(n_node):
                for c in range(n_core):
                    v, cc, rr, st, w = parts[(i, c, key)]
                    vals[i, c, :len(v)] = v
                    cols[i, c, :len(v)] = cc
                    rows[i, c, :len(v)] = rr
                    start[i, c, :len(w)] = st[:-1]
                    start[i, c, len(w):] = st[-1]
                    width[i, c, :len(w)] = w
            return vals, cols, rows, start, width

        dv, dc, dr, dst, dw = _gather("d", d_pad)
        ov, oc, orr, ost, ow = _gather("o", o_pad)
        arrays = {"sell_dvals": dv, "sell_dcols": dc, "sell_drows": dr,
                  "sell_ovals": ov, "sell_ocols": oc, "sell_orows": orr,
                  "sell_dstart": dst, "sell_dwidth": dw,
                  "sell_ostart": ost, "sell_owidth": ow}
        return {k: to_device(a, device) for k, a in arrays.items()}

    def derive_aux(self, data, rc_pad):
        """Slice starts/widths from the packed streams alone.

        An entry is real iff its slot is nonzero or its value is (padding
        entries carry ``rows == vals == 0``).  A slice's width is the most
        real entries any of its slots has, and slices are laid out back to
        back.  Raises if the streams do not follow that layout (e.g. an
        explicitly stored zero in slot 0 shortened a slice)."""
        C = self.slice_height
        n_sl = self.n_slices(rc_pad)
        out = {}
        for key in ("d", "o"):
            vals = np.asarray(data[f"sell_{key}vals"], dtype=np.float64)
            rows = np.asarray(data[f"sell_{key}rows"]).astype(np.int64)
            n_node, n_core, length = vals.shape
            start = np.zeros((n_node, n_core, n_sl), dtype=np.int32)
            width = np.zeros((n_node, n_core, n_sl), dtype=np.int32)
            for i in range(n_node):
                for c in range(n_core):
                    real = (rows[i, c] != 0) | (vals[i, c] != 0)
                    cnt = np.bincount(rows[i, c][real],
                                      minlength=n_sl * C)[:n_sl * C]
                    w = cnt.reshape(n_sl, C).max(axis=1)
                    st = np.concatenate([[0], np.cumsum(C * w)])
                    pos = np.flatnonzero(real)
                    q = rows[i, c][pos]
                    s = q // C
                    k = pos - st[s] - (q - s * C) * w[s]
                    if (st[-1] > length or np.any(k < 0)
                            or np.any(k >= w[s])):
                        raise ValueError(
                            f"SELL stream {key} of shard ({i}, {c}) does not "
                            "follow the slice layout")
                    start[i, c] = st[:-1]
                    width[i, c] = w
            out[f"sell_{key}start"], out[f"sell_{key}width"] = start, width
        return out

    def nnz_stored(self, data):
        return int(data["sell_dvals"].numel() + data["sell_ovals"].numel())

    def check_kernel_layout(self, F):
        """Each shard's slices back to back in each stream
        (``ops.check_sell_layout``)."""
        from repro_torch.kernels.ops import check_sell_layout
        for key in ("d", "o"):
            check_sell_layout(F[f"sell_{key}start"], F[f"sell_{key}width"],
                              F[f"sell_{key}vals"].shape[-1],
                              self.slice_height)

    def _args(self, F, x_ghost):
        if x_ghost is not None and F["sell_ovals"].shape[-1] == 0:
            x_ghost = None
        return (F["sell_dvals"], F["sell_dcols"], F["sell_dstart"],
                F["sell_dwidth"], F["sell_ovals"], F["sell_ocols"],
                F["sell_ostart"], F["sell_owidth"]), x_ghost

    def matvec_plain(self, F, x_local, x_ghost, rc_pad):
        from repro_torch.kernels.ref import fused_sell_spmv_ref
        args, x_ghost = self._args(F, x_ghost)
        return fused_sell_spmv_ref(*args, x_local, x_ghost, rc_pad,
                                   self.slice_height)

    def matvec_kernel(self, F, x_local, x_ghost, rc_pad):
        from repro_torch.kernels.ops import fused_sell_spmv
        args, x_ghost = self._args(F, x_ghost)
        return fused_sell_spmv(*args, x_local, x_ghost, rc_pad,
                               self.slice_height)


# --------------------------------------------------------------------- #
# registry
# --------------------------------------------------------------------- #
_FORMATS: dict[str, ShardFormat] = {}


def register_format(fmt: ShardFormat, overwrite: bool = False) -> ShardFormat:
    """Register ``fmt`` under ``fmt.name`` for lookup by plan builders."""
    if not fmt.name or not fmt.fields:
        raise ValueError("a ShardFormat needs a non-empty name and fields")
    if fmt.name in _FORMATS and not overwrite:
        raise ValueError(f"shard format {fmt.name!r} is already registered "
                         "(pass overwrite=True to replace it)")
    _FORMATS[fmt.name] = fmt
    return fmt


def get_format(fmt: str | ShardFormat) -> ShardFormat:
    """Resolve a format name (or pass through an instance)."""
    if isinstance(fmt, ShardFormat):
        return fmt
    try:
        return _FORMATS[fmt]
    except KeyError:
        raise ValueError(f"unknown shard format {fmt!r}; available: "
                         f"{available_formats()}") from None


def available_formats() -> tuple[str, ...]:
    return tuple(sorted(_FORMATS))


register_format(ELLFormat())
register_format(SELLFormat())
