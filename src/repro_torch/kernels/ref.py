"""Plain PyTorch versions of the SpMV kernels, batched over shards.

Each function computes what its CUDA kernel in ``csrc/spmv.cu`` computes,
on the same inputs, with float32 accumulation whatever the storage dtype.
They run on any device: the CPU tests use them as the port's matvec, and
``chip_smoke.py`` holds every kernel against them on the card.

Shard layout (the plan's): matrix blocks lead with ``(n_node, n_core)``;
the node-local vectors ``x`` are ``(n_node, n)`` — one per node, shared by
the node's cores.  The single-device path (``ELLMatrix``, ``BalancedCOO``)
takes a whole matrix and a flat ``x`` ``(n,)``.

Batched right-hand sides: the shard-layout functions also take ``x``
with a leading batch axis, ``(nrhs, n_node, n)``, and return ``(nrhs,
n_node, n_core, rows)``: each column is the unbatched function on that
column, computed one column at a time, so it is the unbatched result bit
for bit.
"""
from __future__ import annotations

import torch

__all__ = ["ell_spmv_ref", "fused_ell_spmv_ref", "sell_spmv_ref",
           "fused_sell_spmv_ref", "binned_matvec_ref", "balanced_spmv_ref"]


def _take_per_node(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``out[i, ...] = x[i, idx[i, ...]]`` for ``idx`` leading with the
    node axis."""
    n_node, n = x.shape
    off = torch.arange(n_node, device=x.device, dtype=torch.int64) * n
    flat = idx.to(torch.int64) + off.view((n_node,) + (1,) * (idx.dim() - 1))
    return x.reshape(-1)[flat]


def _per_column(fn, *xs):
    """``fn`` on each column of the batched ``xs`` (``None`` passes
    through), stacked on a leading axis."""
    return torch.stack([fn(*(None if x is None else x[j] for x in xs))
                        for j in range(xs[0].shape[0])])


def ell_spmv_ref(vals: torch.Tensor, cols: torch.Tensor,
                 x: torch.Tensor) -> torch.Tensor:
    """``y[i, c, r] = Σ_k vals[i, c, r, k] · x[i, cols[i, c, r, k]]``.

    vals/cols ``(n_node, n_core, rows, w)``; x ``(n_node, n)``; returns
    ``(n_node, n_core, rows)`` float32.  The flat form, vals/cols
    ``(rows, w)`` and x ``(n,)``, returns ``(rows,)``.  Padding entries
    carry ``vals == 0``, so they contribute nothing.  A batched x
    ``(nrhs, n_node, n)`` gives ``(nrhs, n_node, n_core, rows)``.
    """
    if vals.dim() == 4 and x.dim() == 3:
        return _per_column(lambda xj: ell_spmv_ref(vals, cols, xj), x)
    g = (x[cols.long()] if x.dim() == 1
         else _take_per_node(x, cols)).to(torch.float32)
    return (vals.to(torch.float32) * g).sum(-1)


def fused_ell_spmv_ref(dvals, dcols, ovals, ocols, x_local, x_ghost):
    """Diag ELL × ``x_local`` plus offd ELL × ``x_ghost``."""
    if x_local.dim() == 3:
        return _per_column(lambda xl, xg: fused_ell_spmv_ref(
            dvals, dcols, ovals, ocols, xl, xg), x_local, x_ghost)
    return (ell_spmv_ref(dvals, dcols, x_local)
            + ell_spmv_ref(ovals, ocols, x_ghost))


def sell_spmv_ref(vals: torch.Tensor, cols: torch.Tensor,
                  start: torch.Tensor, width: torch.Tensor, x: torch.Tensor,
                  rc_pad: int, slice_height: int = 8) -> torch.Tensor:
    """Per-slot sum over one flat SELL stream.

    vals/cols ``(n_node, n_core, L)`` slice-major streams; start/width
    ``(n_node, n_core, n_slices)`` each slice's first entry and width
    (``repro_torch.sparse.csr.sell_arrays_from_csr``).  Entry ``k`` of slot
    ``q`` sits at ``start[s] + (q - s·C)·width[s] + k`` with
    ``s = q // C``; slot ``q`` sums its ``width[s]`` entries in order.
    Slots of absent slices (width 0) get 0.  Returns
    ``(n_node, n_core, rc_pad)`` float32.
    """
    n_node, n_core = vals.shape[:2]
    wmax = int(width.max()) if width.numel() else 0
    if wmax == 0 or vals.shape[-1] == 0:
        return torch.zeros((n_node, n_core, rc_pad), dtype=torch.float32,
                           device=vals.device)
    C = int(slice_height)
    q = torch.arange(rc_pad, device=vals.device)
    s = q // C
    w = width.to(torch.int64)[..., s]                      # (i, c, rc_pad)
    base = start.to(torch.int64)[..., s] + (q - s * C) * w
    k = torch.arange(wmax, device=vals.device)
    valid = k < w[..., None]                               # (i, c, rc_pad, wmax)
    pos = torch.where(valid, base[..., None] + k, 0).reshape(n_node, n_core, -1)
    v = torch.gather(vals, 2, pos).to(torch.float32)
    c = torch.gather(cols, 2, pos)
    g = _take_per_node(x, c).to(torch.float32)
    prod = torch.where(valid.reshape(pos.shape), v * g, 0.0)
    return prod.reshape(n_node, n_core, rc_pad, wmax).sum(-1)


def fused_sell_spmv_ref(dvals, dcols, dstart, dwidth, ovals, ocols, ostart,
                        owidth, x_local, x_ghost, rc_pad: int,
                        slice_height: int = 8):
    """Diag SELL stream × ``x_local``, then the offd stream × ``x_ghost``
    added onto it; ``x_ghost=None`` is the diag-only kernel."""
    if x_local.dim() == 3:
        return _per_column(lambda xl, xg: fused_sell_spmv_ref(
            dvals, dcols, dstart, dwidth, ovals, ocols, ostart, owidth, xl,
            xg, rc_pad, slice_height), x_local, x_ghost)
    y = sell_spmv_ref(dvals, dcols, dstart, dwidth, x_local, rc_pad,
                      slice_height)
    if x_ghost is None:
        return y
    return y + sell_spmv_ref(ovals, ocols, ostart, owidth, x_ghost, rc_pad,
                             slice_height)


def binned_matvec_ref(vals: torch.Tensor, cols: torch.Tensor,
                      lrows: torch.Tensor, x: torch.Tensor,
                      rows_pad: int) -> torch.Tensor:
    """nnz-binned COO SpMV: ``y[t, lrows[t, k]] += vals[t, k]·x[cols[t, k]]``.

    vals/cols/lrows ``(nbins, nnz_pad)``, x ``(n,)``; returns
    ``(nbins, rows_pad)`` float32, a scatter-add into ``t·rows_pad +
    lrows``.  Padding entries (``vals == 0``, row 0) add nothing.  On a
    CUDA tensor the scatter adds in no fixed order (atomics): there it is
    only what the kernel is compared with."""
    nbins = vals.shape[0]
    contrib = vals.to(torch.float32) * x[cols.long()].to(torch.float32)
    dest = (lrows.long() + rows_pad
            * torch.arange(nbins, device=vals.device)[:, None])
    y = torch.zeros(nbins * rows_pad, dtype=torch.float32, device=vals.device)
    return y.index_add_(0, dest.reshape(-1),
                        contrib.reshape(-1)).view(nbins, rows_pad)


def balanced_spmv_ref(bcoo, x: torch.Tensor) -> torch.Tensor:
    """Whole ``BalancedCOO`` SpMV: returns the flat ``(n_rows,)`` result."""
    y = binned_matvec_ref(bcoo.vals, bcoo.cols, bcoo.lrows, x, bcoo.rows_pad)
    return y.reshape(-1)[bcoo.out_gather.long()]
