"""Public wrappers around the SpMV kernels, dispatched by device.

For a tensor on the CPU each wrapper computes its kernel's plain PyTorch
version (:mod:`repro_torch.kernels.ref`); for a CUDA tensor it launches
the hand-written kernel (``csrc/spmv.cu``) on the current stream or raises.
There is no fallback from one to the other.

Each wrapper counts its launches in :data:`LAUNCHES`, by kernel, where it
launches and nowhere else, so a run can show that its path went through
the kernels (``reset_launches`` zeroes the counts).

Shapes follow the plan: matrix blocks lead with ``(n_node, n_core)``;
``x_local`` is ``(n_node, nl_pad)`` and ``x_ghost`` ``(n_node, g_pad + 1)``
— one per node, shared by the node's cores.  Outputs are float32
``(n_node, n_core, rows)``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ref

__all__ = ["ell_spmv", "fused_ell_spmv", "fused_sell_spmv", "LAUNCHES",
           "reset_launches"]

#: kernel name -> launches since the last ``reset_launches``
LAUNCHES: dict[str, int] = {"fused_ell_spmv": 0, "ell_spmv": 0,
                            "fused_sell_spmv": 0, "sell_spmv": 0}

_VAL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _on_cpu(t: torch.Tensor) -> bool:
    if t.device.type == "cpu":
        return True
    if t.device.type != "cuda":
        raise ValueError(f"SpMV kernels run on cuda or cpu, got {t.device}")
    return False


def _check(name: str, device, vals=(), idx=(), xs=()) -> int:
    """Validate what the kernel takes; return the storage-dtype code."""
    codes = set()
    for t in (*vals, *idx, *xs):
        if t.device != device:
            raise ValueError(f"{name}: tensors on {t.device} and {device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: non-contiguous input {tuple(t.shape)}")
    for v in vals:
        if v.dtype not in _VAL_DTYPES:
            raise TypeError(f"{name}: values must be float32 or bfloat16, "
                            f"got {v.dtype}")
        codes.add(_VAL_DTYPES[v.dtype])
    if len(codes) > 1:
        raise TypeError(f"{name}: diag and offd values differ in dtype")
    for c in idx:
        if c.dtype != torch.int32:
            raise TypeError(f"{name}: indices must be int32, got {c.dtype}")
    for x in xs:
        if x.dtype != torch.float32 or x.dim() != 2:
            raise TypeError(f"{name}: x must be float32 (n_node, n), got "
                            f"{x.dtype} {tuple(x.shape)}")
    return codes.pop()


def _raise_on(name: str, err: int) -> None:
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {err}")


def _stream(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def _ell(name, dvals, dcols, ovals, ocols, x_local, x_ghost):
    from repro_torch.kernels.spmv_cuda import library

    n_node, n_core, rows, wd = dvals.shape
    if dcols.shape != dvals.shape or x_local.shape[0] != n_node:
        raise ValueError(f"{name}: shapes {tuple(dvals.shape)} "
                         f"{tuple(dcols.shape)} x {tuple(x_local.shape)}")
    vals, idx, xs = [dvals], [dcols], [x_local]
    wo = 0
    if ovals is not None:
        wo = ovals.shape[-1]
        if (ovals.shape[:3] != dvals.shape[:3] or ocols.shape != ovals.shape
                or x_ghost.shape[0] != n_node):
            raise ValueError(f"{name}: offd shapes {tuple(ovals.shape)} "
                             f"{tuple(ocols.shape)} x {tuple(x_ghost.shape)}")
        vals, idx, xs = vals + [ovals], idx + [ocols], xs + [x_ghost]
    if n_node * n_core > 65535:
        raise ValueError(f"{name}: {n_node * n_core} shards > 65535")
    code = _check(name, dvals.device, vals, idx, xs)
    y = torch.empty((n_node, n_core, rows), dtype=torch.float32,
                    device=dvals.device)
    err = library().repro_ell_spmv(
        code, dvals.data_ptr(), dcols.data_ptr(), wd,
        ovals.data_ptr() if wo else None, ocols.data_ptr() if wo else None,
        wo, x_local.data_ptr(), x_local.shape[1],
        x_ghost.data_ptr() if wo else None,
        x_ghost.shape[1] if wo else 0, y.data_ptr(), n_node * n_core,
        n_core, rows, _stream(dvals.device))
    _raise_on(name, err)
    LAUNCHES[name] += 1
    return y


def ell_spmv(vals: torch.Tensor, cols: torch.Tensor,
             x: torch.Tensor) -> torch.Tensor:
    """Halo-free ELL SpMV over all shards: ``y = vals·x[cols]`` per row."""
    if _on_cpu(vals):
        return ref.ell_spmv_ref(vals, cols, x)
    return _ell("ell_spmv", vals, cols, None, None, x, None)


def fused_ell_spmv(dvals: torch.Tensor, dcols: torch.Tensor,
                   ovals: torch.Tensor, ocols: torch.Tensor,
                   x_local: torch.Tensor, x_ghost: torch.Tensor
                   ) -> torch.Tensor:
    """One-pass two-phase ELL SpMV: diag × x_local + offd × x_ghost, the
    diag partial kept in a register."""
    if _on_cpu(dvals):
        return ref.fused_ell_spmv_ref(dvals, dcols, ovals, ocols, x_local,
                                      x_ghost)
    return _ell("fused_ell_spmv", dvals, dcols, ovals, ocols, x_local,
                x_ghost)


def fused_sell_spmv(dvals: torch.Tensor, dcols: torch.Tensor,
                    dstart: torch.Tensor, dwidth: torch.Tensor,
                    ovals: torch.Tensor, ocols: torch.Tensor,
                    ostart: torch.Tensor, owidth: torch.Tensor,
                    x_local: torch.Tensor, x_ghost: torch.Tensor | None,
                    rc_pad: int, slice_height: int = 8) -> torch.Tensor:
    """One-pass two-phase sliced-ELL SpMV -> ``(n_node, n_core, rc_pad)``.

    Flat slice-major streams ``(n_node, n_core, L)`` with per-slice
    ``start``/``width`` ``(n_node, n_core, n_slices)``;
    ``x_ghost=None`` runs the diag-only kernel (halo-free plans)."""
    if _on_cpu(dvals):
        return ref.fused_sell_spmv_ref(dvals, dcols, dstart, dwidth, ovals,
                                       ocols, ostart, owidth, x_local,
                                       x_ghost, rc_pad, slice_height)
    from repro_torch.kernels.spmv_cuda import library

    name = "sell_spmv" if x_ghost is None else "fused_sell_spmv"
    n_node, n_core, d_len = dvals.shape
    n_slices = dstart.shape[-1]
    if (dcols.shape != dvals.shape or dstart.shape != dwidth.shape
            or dstart.shape[:2] != (n_node, n_core)
            or n_slices * slice_height < rc_pad
            or x_local.shape[0] != n_node):
        raise ValueError(f"{name}: shapes {tuple(dvals.shape)} "
                         f"{tuple(dstart.shape)} x {tuple(x_local.shape)} "
                         f"for rc_pad {rc_pad}")
    vals, idx, xs = [dvals], [dcols, dstart, dwidth], [x_local]
    has_offd = x_ghost is not None
    o_len = 0
    if has_offd:
        o_len = ovals.shape[-1]
        if (ovals.shape[:2] != (n_node, n_core) or ocols.shape != ovals.shape
                or ostart.shape != dstart.shape
                or owidth.shape != dstart.shape
                or x_ghost.shape[0] != n_node):
            raise ValueError(f"{name}: offd shapes {tuple(ovals.shape)} "
                             f"{tuple(ostart.shape)} x "
                             f"{tuple(x_ghost.shape)}")
        vals, idx, xs = (vals + [ovals], idx + [ocols, ostart, owidth],
                         xs + [x_ghost])
    if n_node * n_core > 65535:
        raise ValueError(f"{name}: {n_node * n_core} shards > 65535")
    code = _check(name, dvals.device, vals, idx, xs)
    y = torch.empty((n_node, n_core, rc_pad), dtype=torch.float32,
                    device=dvals.device)

    def ptr(t):
        return t.data_ptr() if has_offd else None

    err = library().repro_sell_spmv(
        code, dvals.data_ptr(), dcols.data_ptr(), dstart.data_ptr(),
        dwidth.data_ptr(), d_len, ptr(ovals), ptr(ocols), ptr(ostart),
        ptr(owidth), o_len, int(has_offd), n_slices, slice_height,
        x_local.data_ptr(), x_local.shape[1], ptr(x_ghost),
        x_ghost.shape[1] if has_offd else 0, y.data_ptr(), n_node * n_core,
        n_core, rc_pad, _stream(dvals.device))
    _raise_on(name, err)
    LAUNCHES[name] += 1
    return y
