"""Plain PyTorch versions of the SpMV kernels, batched over shards.

Each function computes what its CUDA kernel in ``csrc/spmv.cu`` computes,
on the same inputs, with float32 accumulation whatever the storage dtype.
They run on any device: the CPU tests use them as the port's matvec, and
``chip_smoke.py`` holds every kernel against them on the card.

Shard layout (the plan's): matrix blocks lead with ``(n_node, n_core)``;
the node-local vectors ``x`` are ``(n_node, n)`` — one per node, shared by
the node's cores.
"""
from __future__ import annotations

import torch

__all__ = ["ell_spmv_ref", "fused_ell_spmv_ref", "sell_spmv_ref",
           "fused_sell_spmv_ref"]


def _take_per_node(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``out[i, ...] = x[i, idx[i, ...]]`` for ``idx`` leading with the
    node axis."""
    n_node, n = x.shape
    off = torch.arange(n_node, device=x.device, dtype=torch.int64) * n
    flat = idx.to(torch.int64) + off.view((n_node,) + (1,) * (idx.dim() - 1))
    return x.reshape(-1)[flat]


def ell_spmv_ref(vals: torch.Tensor, cols: torch.Tensor,
                 x: torch.Tensor) -> torch.Tensor:
    """``y[i, c, r] = Σ_k vals[i, c, r, k] · x[i, cols[i, c, r, k]]``.

    vals/cols ``(n_node, n_core, rows, w)``; x ``(n_node, n)``; returns
    ``(n_node, n_core, rows)`` float32.  Padding entries carry
    ``vals == 0``, so they contribute nothing.
    """
    g = _take_per_node(x, cols).to(torch.float32)
    return (vals.to(torch.float32) * g).sum(-1)


def fused_ell_spmv_ref(dvals, dcols, ovals, ocols, x_local, x_ghost):
    """Diag ELL × ``x_local`` plus offd ELL × ``x_ghost``."""
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
    y = sell_spmv_ref(dvals, dcols, dstart, dwidth, x_local, rc_pad,
                      slice_height)
    if x_ghost is None:
        return y
    return y + sell_spmv_ref(ovals, ocols, ostart, owidth, x_ghost, rc_pad,
                             slice_height)
