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
``(n_node, n_core, rows)``.  The single-device path takes a whole matrix
and a flat ``x``: ``ell_spmv`` on an ``ELLMatrix``'s ``(rows, w)`` arrays
and ``balanced_spmv`` on a ``BalancedCOO``.

Batched right-hand sides: ``ell_spmv``, ``fused_ell_spmv`` and
``fused_sell_spmv`` also take ``x_local`` ``(nrhs, n_node, nl_pad)`` and
``x_ghost`` ``(nrhs, n_node, g_pad + 1)`` with ``1 <= nrhs <=
MAX_NRHS`` and give ``(nrhs, n_node, n_core, rows)``: one launch of the
batched kernel for all columns, counted under the kernel's name with
``_batched``.  Column ``j`` is the single-column kernel's ``y`` on column
``j`` bit for bit.  The batched kernels read ``x`` column-interleaved:
the wrapper copies each batched ``x`` into :func:`interleave_rhs`'s
``(n_node, n, KT)`` layout first, so a batched ``x`` may have any strides
(a slice of a larger batch, a transposed view).

The split two-phase SpMV (the ``task``/``balanced`` schedule on a process
mesh, ``core/spmv.py``): the diag pass is the halo-free launch
(``ell_spmv`` / ``fused_sell_spmv(x_ghost=None)`` on the diag stream),
and ``ell_spmv_onto`` / ``sell_spmv_onto`` add the offd stream × the
ghosts onto its output in place, once the exchange has arrived.  The two
launches give the fused kernel's ``y`` bit for bit, single-column and
batched (``*_onto_batched``).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ref

__all__ = ["ell_spmv", "fused_ell_spmv", "fused_sell_spmv", "balanced_spmv",
           "ell_spmv_onto", "sell_spmv_onto",
           "check_sell_layout", "interleave_rhs", "rhs_tile", "LAUNCHES",
           "MAX_NRHS", "RHS_TILES", "reset_launches"]

#: kernel name -> launches since the last ``reset_launches``
LAUNCHES: dict[str, int] = {"fused_ell_spmv": 0, "ell_spmv": 0,
                            "fused_sell_spmv": 0, "sell_spmv": 0,
                            "balanced_spmv": 0,
                            "fused_ell_spmv_batched": 0,
                            "ell_spmv_batched": 0,
                            "fused_sell_spmv_batched": 0,
                            "sell_spmv_batched": 0,
                            "ell_spmv_onto": 0, "sell_spmv_onto": 0,
                            "ell_spmv_onto_batched": 0,
                            "sell_spmv_onto_batched": 0}

#: the most right-hand sides one batched launch takes (``kMaxRhs`` in
#: ``csrc/spmv.cu``)
MAX_NRHS = 16

#: the batched kernels' column tiles (``KT`` in ``csrc/spmv.cu``)
RHS_TILES = (4, 8, 16)

_VAL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def rhs_tile(k: int) -> int:
    """The column tile of a batched launch of ``k`` columns: the smallest
    of :data:`RHS_TILES` that holds them."""
    if not 1 <= k <= MAX_NRHS:
        raise ValueError(f"{k} right-hand sides; one batched launch takes "
                         f"1 to {MAX_NRHS}")
    return next(t for t in RHS_TILES if t >= k)


def interleave_rhs(x: torch.Tensor) -> torch.Tensor:
    """A batched ``x`` ``(k, n_node, n)`` as the batched kernels read it:
    ``xi`` ``(n_node, n, KT)`` with ``xi[node, col, j] == x[j, node, col]``
    and zeros in the pad columns ``k <= j < KT`` (``KT = rhs_tile(k)``).

    One entry's ``x`` for every column is then ``KT / 4`` aligned 16-byte
    loads.  One copy from a permuted view into a new buffer (and a fill of
    the pad), on ``x``'s device; any strides."""
    k, n_node, n = x.shape
    kt = rhs_tile(k)
    xi = torch.empty((n_node, n, kt), dtype=x.dtype, device=x.device)
    xi[..., :k].copy_(x.permute(1, 2, 0))
    if kt > k:
        xi[..., k:].zero_()
    return xi


def _flat_x(name: str, x: torch.Tensor) -> torch.Tensor:
    """A flat ``x`` as the kernels take it: float32 ``(1, n)``.  bfloat16
    widens exactly, as the TPU kernels cast the gathered values."""
    if x.dim() != 1 or x.dtype not in _VAL_DTYPES:
        raise TypeError(f"{name}: x must be float32 or bfloat16 (n,), got "
                        f"{x.dtype} {tuple(x.shape)}")
    return x.to(torch.float32)[None]


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _on_cpu(t: torch.Tensor) -> bool:
    if t.device.type == "cpu":
        return True
    if t.device.type != "cuda":
        raise ValueError(f"SpMV kernels run on cuda or cpu, got {t.device}")
    return False


def _nrhs(name: str, x_local: torch.Tensor, x_ghost, n_node: int):
    """``None`` for a single-column ``x_local`` ``(n_node, n)``; the batch
    size for a batched one ``(nrhs, n_node, n)``, checked against
    ``x_ghost``'s and against :data:`MAX_NRHS`."""
    if x_local.dim() == 2:
        if x_ghost is not None and x_ghost.dim() != 2:
            raise ValueError(f"{name}: x_local {tuple(x_local.shape)} with "
                             f"batched x_ghost {tuple(x_ghost.shape)}")
        return None
    if x_local.dim() != 3:
        raise ValueError(f"{name}: x_local must be (n_node, n) or (nrhs, "
                         f"n_node, n), got {tuple(x_local.shape)}")
    k = x_local.shape[0]
    if not 1 <= k <= MAX_NRHS:
        raise ValueError(f"{name}: {k} right-hand sides; one batched launch "
                         f"takes 1 to {MAX_NRHS}")
    if x_ghost is not None and (x_ghost.dim() != 3 or x_ghost.shape[0] != k):
        raise ValueError(f"{name}: x_local {tuple(x_local.shape)} and "
                         f"x_ghost {tuple(x_ghost.shape)} differ in batch")
    if x_local.shape[1] != n_node:
        raise ValueError(f"{name}: x_local {tuple(x_local.shape)} for "
                         f"{n_node} nodes")
    return k


def _check(name: str, device, vals=(), idx=(), xs=()) -> int:
    """Validate what the kernel takes; return the storage-dtype code.  A
    batched ``x`` (3-D) may have any strides: it is copied into the
    interleaved layout before the launch."""
    codes = set()
    for t in (*vals, *idx, *xs):
        if t.device != device:
            raise ValueError(f"{name}: tensors on {t.device} and {device}")
    for t in (*vals, *idx, *(x for x in xs if x.dim() != 3)):
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
        if x.dtype != torch.float32 or x.dim() not in (2, 3):
            raise TypeError(f"{name}: x must be float32 (n_node, n) or "
                            f"(nrhs, n_node, n), got {x.dtype} "
                            f"{tuple(x.shape)}")
    return codes.pop()


def _raise_on(name: str, err: int) -> None:
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {err}")


def _stream(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def _lens(name: str, lens, vals: torch.Tensor) -> torch.Tensor:
    """Row lengths as the ELL kernel takes them: int32, contiguous, on the
    values' device, one per row of ``vals``; ``None`` gives every row the
    full width, so the kernel reads every slot."""
    if lens is None:
        return torch.full(vals.shape[:-1], vals.shape[-1],
                          dtype=torch.int32, device=vals.device)
    if lens.dtype != torch.int32:
        raise TypeError(f"{name}: row lengths must be int32, got "
                        f"{lens.dtype}")
    if lens.device != vals.device or not lens.is_contiguous():
        raise ValueError(f"{name}: row lengths must be contiguous on "
                         f"{vals.device}, got {lens.device}")
    if lens.shape != vals.shape[:-1]:
        raise ValueError(f"{name}: row lengths {tuple(lens.shape)} for "
                         f"values {tuple(vals.shape)}")
    return lens


def _ell(name, dvals, dcols, dlens, ovals, ocols, olens, x_local, x_ghost):
    from repro_torch.kernels.spmv_cuda import library

    n_node, n_core, rows, wd = dvals.shape
    k = _nrhs(name, x_local, x_ghost, n_node)
    if dcols.shape != dvals.shape or x_local.shape[-2] != n_node:
        raise ValueError(f"{name}: shapes {tuple(dvals.shape)} "
                         f"{tuple(dcols.shape)} x {tuple(x_local.shape)}")
    dlens = _lens(name, dlens, dvals)
    vals, idx, xs = [dvals], [dcols], [x_local]
    wo = 0
    if ovals is not None:
        wo = ovals.shape[-1]
        if (ovals.shape[:3] != dvals.shape[:3] or ocols.shape != ovals.shape
                or x_ghost.shape[-2] != n_node):
            raise ValueError(f"{name}: offd shapes {tuple(ovals.shape)} "
                             f"{tuple(ocols.shape)} x {tuple(x_ghost.shape)}")
        olens = _lens(name, olens, ovals)
        vals, idx, xs = vals + [ovals], idx + [ocols], xs + [x_ghost]
    if n_node * n_core > 65535:
        raise ValueError(f"{name}: {n_node * n_core} shards > 65535")
    code = _check(name, dvals.device, vals, idx, xs)
    y = torch.empty((n_node, n_core, rows) if k is None
                    else (k, n_node, n_core, rows), dtype=torch.float32,
                    device=dvals.device)

    def ptr(t):
        return None if t is None else t.data_ptr()

    if k is not None:
        x_local = interleave_rhs(x_local)
        x_ghost = interleave_rhs(x_ghost) if wo else None
    args = (code, dvals.data_ptr(), dcols.data_ptr(), dlens.data_ptr(), wd,
            ptr(ovals) if wo else None, ptr(ocols) if wo else None,
            ptr(olens) if wo else None, wo, x_local.data_ptr(),
            x_local.shape[1], ptr(x_ghost) if wo else None,
            x_ghost.shape[1] if wo else 0, y.data_ptr(), n_node * n_core,
            n_core, rows)
    # the entry points launch on the calling thread's current card
    with torch.cuda.device(dvals.device):
        if k is None:
            err = library().repro_ell_spmv(*args, _stream(dvals.device))
        else:
            name = f"{name}_batched"
            err = library().repro_ell_spmv_batched(*args, k,
                                                   _stream(dvals.device))
    _raise_on(name, err)
    LAUNCHES[name] += 1
    return y


def ell_spmv(vals: torch.Tensor, cols: torch.Tensor, x: torch.Tensor,
             lens: torch.Tensor | None = None) -> torch.Tensor:
    """Halo-free ELL SpMV: ``y = vals·x[cols]`` per row.

    Over all shards: vals/cols ``(n_node, n_core, rows, w)`` and x
    ``(n_node, n)`` give ``(n_node, n_core, rows)``; a batched x
    ``(nrhs, n_node, n)`` gives ``(nrhs, n_node, n_core, rows)`` in one
    launch (``ell_spmv_batched``).  Flat (an
    ``ELLMatrix``'s arrays): vals/cols ``(rows, w)`` and x ``(n,)`` give
    ``(rows,)``, through the same kernel as one shard.  ``lens`` (int32,
    one per row: ``ELLFormat``'s ``diag_len``, ``ELLMatrix.row_lens``)
    lets the kernel stop at each row's last entry; ``None`` reads all ``w``
    slots, as the plain version and the TPU kernel always do.  The two give
    the same result for finite ``x``; where ``x[0]`` is Inf or NaN, a read
    padding slot (value 0, column 0) makes its row NaN, and a skipped one
    does not.
    The TPU kernel's ``row_tile`` has no counterpart: a warp takes 32 rows
    and the grid covers every row, so the rows need no padding."""
    if _on_cpu(vals):
        if vals.dim() == 4:
            _nrhs("ell_spmv", x, None, vals.shape[0])
        return ref.ell_spmv_ref(vals, cols, x)
    if vals.dim() == 2:
        x = _flat_x("ell_spmv", x)
        return _ell("ell_spmv", vals[None, None], cols[None, None],
                    None if lens is None else lens[None, None], None, None,
                    None, x, None)[0, 0]
    return _ell("ell_spmv", vals, cols, lens, None, None, None, x, None)


def fused_ell_spmv(dvals: torch.Tensor, dcols: torch.Tensor,
                   ovals: torch.Tensor, ocols: torch.Tensor,
                   x_local: torch.Tensor, x_ghost: torch.Tensor,
                   dlens: torch.Tensor | None = None,
                   olens: torch.Tensor | None = None) -> torch.Tensor:
    """One-pass two-phase ELL SpMV: diag × x_local + offd × x_ghost, the
    diag partial kept in a register.  ``dlens``/``olens``: each stream's
    row lengths, as ``ell_spmv``'s ``lens``, with the same condition: the
    result equals the all-slot read's only for finite ``x_local[:, 0]``
    and ``x_ghost[:, 0]``.  Batched ``x_local``/``x_ghost`` (a leading
    ``nrhs`` axis) run all columns in one launch
    (``fused_ell_spmv_batched``)."""
    if _on_cpu(dvals):
        _nrhs("fused_ell_spmv", x_local, x_ghost, dvals.shape[0])
        return ref.fused_ell_spmv_ref(dvals, dcols, ovals, ocols, x_local,
                                      x_ghost)
    return _ell("fused_ell_spmv", dvals, dcols, dlens, ovals, ocols, olens,
                x_local, x_ghost)


def fused_sell_spmv(dvals: torch.Tensor, dcols: torch.Tensor,
                    dstart: torch.Tensor, dwidth: torch.Tensor,
                    ovals: torch.Tensor, ocols: torch.Tensor,
                    ostart: torch.Tensor, owidth: torch.Tensor,
                    x_local: torch.Tensor, x_ghost: torch.Tensor | None,
                    rc_pad: int, slice_height: int = 8,
                    plain_pad: tuple = (None, None)) -> torch.Tensor:
    """One-pass two-phase sliced-ELL SpMV -> ``(n_node, n_core, rc_pad)``.

    Flat slice-major streams ``(n_node, n_core, L)`` with per-slice
    ``start``/``width`` ``(n_node, n_core, n_slices)``;
    ``x_ghost=None`` runs the diag-only kernel (halo-free plans).  The
    kernel requires each shard's slices back to back, as
    ``sell_arrays_from_csr`` lays them: ``start[s + 1] == start[s] +
    slice_height * width[s]``.  It reads a warp's
    slots as one contiguous range from its first slot, so other starts give
    a wrong ``y``; the plain version takes any layout.  The check is
    :func:`check_sell_layout`, made on the host once when a shard body
    binds a plan (``make_shard_body``), not per launch.  Batched
    ``x_local``/``x_ghost`` (a leading ``nrhs`` axis) give ``(nrhs,
    n_node, n_core, rc_pad)`` in one launch
    (``fused_sell_spmv_batched`` / ``sell_spmv_batched``).  ``plain_pad``
    is the plain version's ``(dwmax, owmax)`` on the CPU
    (``ref.fused_sell_spmv_ref``); the kernel sums each slot alone and
    takes none."""
    if _on_cpu(dvals):
        _nrhs("fused_sell_spmv", x_local, x_ghost, dvals.shape[0])
        return ref.fused_sell_spmv_ref(dvals, dcols, dstart, dwidth, ovals,
                                       ocols, ostart, owidth, x_local,
                                       x_ghost, rc_pad, slice_height,
                                       *plain_pad)
    from repro_torch.kernels.spmv_cuda import library

    name = "sell_spmv" if x_ghost is None else "fused_sell_spmv"
    n_node, n_core, d_len = dvals.shape
    k = _nrhs(name, x_local, x_ghost, n_node)
    n_slices = dstart.shape[-1]
    if (dcols.shape != dvals.shape or dstart.shape != dwidth.shape
            or dstart.shape[:2] != (n_node, n_core)
            or n_slices * slice_height < rc_pad
            or x_local.shape[-2] != n_node):
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
                or x_ghost.shape[-2] != n_node):
            raise ValueError(f"{name}: offd shapes {tuple(ovals.shape)} "
                             f"{tuple(ostart.shape)} x "
                             f"{tuple(x_ghost.shape)}")
        vals, idx, xs = (vals + [ovals], idx + [ocols, ostart, owidth],
                         xs + [x_ghost])
    if n_node * n_core > 65535:
        raise ValueError(f"{name}: {n_node * n_core} shards > 65535")
    code = _check(name, dvals.device, vals, idx, xs)
    y = torch.empty((n_node, n_core, rc_pad) if k is None
                    else (k, n_node, n_core, rc_pad), dtype=torch.float32,
                    device=dvals.device)

    def ptr(t):
        return t.data_ptr() if has_offd else None

    if k is not None:
        x_local = interleave_rhs(x_local)
        x_ghost = interleave_rhs(x_ghost) if has_offd else None
    args = (code, dvals.data_ptr(), dcols.data_ptr(), dstart.data_ptr(),
            dwidth.data_ptr(), d_len, ptr(ovals), ptr(ocols), ptr(ostart),
            ptr(owidth), o_len, int(has_offd), n_slices, slice_height,
            x_local.data_ptr(), x_local.shape[1], ptr(x_ghost),
            x_ghost.shape[1] if has_offd else 0, y.data_ptr(),
            n_node * n_core, n_core, rc_pad)
    with torch.cuda.device(dvals.device):
        if k is None:
            err = library().repro_sell_spmv(*args, _stream(dvals.device))
        else:
            name = f"{name}_batched"
            err = library().repro_sell_spmv_batched(*args, k,
                                                    _stream(dvals.device))
    _raise_on(name, err)
    LAUNCHES[name] += 1
    return y


def _partial(name: str, y: torch.Tensor, device, shape: tuple, k) -> None:
    """The diag partial an offd pass adds onto in place: float32,
    contiguous, on ``device``, ``shape`` (with the batch ``k`` leading, if
    batched)."""
    want = shape if k is None else (k, *shape)
    if y.device != device:
        raise ValueError(f"{name}: the partial y on {y.device}, not "
                         f"{device}")
    if (y.dtype != torch.float32 or not y.is_contiguous()
            or tuple(y.shape) != tuple(want)):
        raise ValueError(f"{name}: the partial y must be a contiguous "
                         f"float32 {tuple(want)}, got {y.dtype} "
                         f"{tuple(y.shape)}")


def ell_spmv_onto(y: torch.Tensor, ovals: torch.Tensor, ocols: torch.Tensor,
                  x_ghost: torch.Tensor,
                  olens: torch.Tensor | None = None) -> torch.Tensor:
    """The offd pass of the split two-phase ELL SpMV: ``y + offd ×
    x_ghost``, ``y`` the diag pass's output (``ell_spmv`` on the diag
    stream, ``(n_node, n_core, rows)`` or batched ``(nrhs, ...)`` with
    ``x_ghost`` ``(nrhs, n_node, g_pad + 1)``).  On the card it adds in
    place and returns ``y``; the two passes are ``fused_ell_spmv`` bit for
    bit.  ``olens`` as ``fused_ell_spmv``'s.  An offd stream of width 0
    adds nothing and launches nothing."""
    name = "ell_spmv_onto"
    if _on_cpu(ovals):
        _nrhs(name, x_ghost, None, ovals.shape[0])
        return ref.ell_spmv_onto_ref(y, ovals, ocols, x_ghost)
    from repro_torch.kernels.spmv_cuda import library

    n_node, n_core, rows, wo = ovals.shape
    k = _nrhs(name, x_ghost, None, n_node)
    if ocols.shape != ovals.shape or x_ghost.shape[-2] != n_node:
        raise ValueError(f"{name}: shapes {tuple(ovals.shape)} "
                         f"{tuple(ocols.shape)} x {tuple(x_ghost.shape)}")
    if n_node * n_core > 65535:
        raise ValueError(f"{name}: {n_node * n_core} shards > 65535")
    olens = _lens(name, olens, ovals)
    code = _check(name, ovals.device, [ovals], [ocols, olens], [x_ghost])
    _partial(name, y, ovals.device, (n_node, n_core, rows), k)
    if wo == 0:
        return y
    if k is not None:
        x_ghost = interleave_rhs(x_ghost)
    args = (code, ovals.data_ptr(), ocols.data_ptr(), olens.data_ptr(), wo,
            x_ghost.data_ptr(), x_ghost.shape[1], y.data_ptr(),
            n_node * n_core, n_core, rows)
    with torch.cuda.device(ovals.device):
        if k is None:
            err = library().repro_ell_spmv_onto(*args, _stream(ovals.device))
        else:
            name = f"{name}_batched"
            err = library().repro_ell_spmv_onto_batched(
                *args, k, _stream(ovals.device))
    _raise_on(name, err)
    LAUNCHES[name] += 1
    return y


def sell_spmv_onto(y: torch.Tensor, ovals: torch.Tensor, ocols: torch.Tensor,
                   ostart: torch.Tensor, owidth: torch.Tensor,
                   x_ghost: torch.Tensor, rc_pad: int, slice_height: int = 8,
                   owmax: int | None = None) -> torch.Tensor:
    """The offd pass of the split two-phase SELL SpMV: ``y +`` the offd
    stream × ``x_ghost``, ``y`` the diag-only ``fused_sell_spmv``'s output
    ``(n_node, n_core, rc_pad)`` (batched: ``(nrhs, ...)``).  On the card
    in place, returning ``y``; the two passes are ``fused_sell_spmv`` bit
    for bit.  The stream's slices must lie back to back
    (:func:`check_sell_layout`); ``owmax`` is the plain version's pad on
    the CPU (``fused_sell_spmv``'s ``plain_pad[1]``).  An empty offd
    stream adds nothing and launches nothing."""
    name = "sell_spmv_onto"
    if _on_cpu(ovals):
        _nrhs(name, x_ghost, None, ovals.shape[0])
        return ref.sell_spmv_onto_ref(y, ovals, ocols, ostart, owidth,
                                      x_ghost, rc_pad, slice_height, owmax)
    from repro_torch.kernels.spmv_cuda import library

    n_node, n_core, o_len = ovals.shape
    k = _nrhs(name, x_ghost, None, n_node)
    n_slices = ostart.shape[-1]
    if (ocols.shape != ovals.shape or ostart.shape != owidth.shape
            or ostart.shape[:2] != (n_node, n_core)
            or n_slices * slice_height < rc_pad
            or x_ghost.shape[-2] != n_node):
        raise ValueError(f"{name}: shapes {tuple(ovals.shape)} "
                         f"{tuple(ostart.shape)} x {tuple(x_ghost.shape)} "
                         f"for rc_pad {rc_pad}")
    if n_node * n_core > 65535:
        raise ValueError(f"{name}: {n_node * n_core} shards > 65535")
    code = _check(name, ovals.device, [ovals], [ocols, ostart, owidth],
                  [x_ghost])
    _partial(name, y, ovals.device, (n_node, n_core, rc_pad), k)
    if o_len == 0:
        return y
    if k is not None:
        x_ghost = interleave_rhs(x_ghost)
    args = (code, ovals.data_ptr(), ocols.data_ptr(), ostart.data_ptr(),
            owidth.data_ptr(), o_len, n_slices, slice_height,
            x_ghost.data_ptr(), x_ghost.shape[1], y.data_ptr(),
            n_node * n_core, n_core, rc_pad)
    with torch.cuda.device(ovals.device):
        if k is None:
            err = library().repro_sell_spmv_onto(*args,
                                                 _stream(ovals.device))
        else:
            name = f"{name}_batched"
            err = library().repro_sell_spmv_onto_batched(
                *args, k, _stream(ovals.device))
    _raise_on(name, err)
    LAUNCHES[name] += 1
    return y


def check_sell_layout(start: torch.Tensor, width: torch.Tensor,
                      length: int, slice_height: int = 8) -> None:
    """Raise unless every shard's slices lie back to back in its stream,
    as the SELL kernels read them: ``start[s + 1] == start[s] +
    slice_height · width[s]``, from 0, within the stream's ``length``.
    On the host (one copy of the descriptors), once per bound plan."""
    st = start.detach().cpu().reshape(-1, start.shape[-1]).long()
    w = width.detach().cpu().reshape(-1, width.shape[-1]).long()
    end = st + slice_height * w
    if (st.numel() and (bool((st[:, 0] != 0).any())
                        or bool((st[:, 1:] != end[:, :-1]).any())
                        or bool((w < 0).any())
                        or int(end[:, -1].max()) > length)):
        raise ValueError("SELL slices are not back to back in their stream "
                         "(start[s + 1] == start[s] + slice_height * "
                         "width[s] from 0): the SELL kernels would read "
                         "other slots' entries")


def balanced_spmv(bcoo, x: torch.Tensor) -> torch.Tensor:
    """Whole ``BalancedCOO`` SpMV -> flat ``(n_rows,)`` float32.

    The kernel walks the ``BalancedCOO``'s ``warp_map`` (32 rows of one bin
    per warp, ``row_lens`` for each row) and writes each row of ``y`` once,
    so neither ``lrows`` nor ``out_gather`` is read on the card.  x
    ``(n_cols,)`` float32 or bfloat16.  The TPU kernel's ``nnz_chunk`` has
    no counterpart: each warp streams its rows' entries in chunks of the
    kernel's size."""
    if _on_cpu(bcoo.vals):
        return ref.balanced_spmv_ref(bcoo, x)
    from repro_torch.kernels.spmv_cuda import library

    name = "balanced_spmv"
    nbins, nnz_pad = bcoo.vals.shape
    xf = _flat_x(name, x)
    if (bcoo.cols.shape != bcoo.vals.shape
            or bcoo.row_lens.shape != (bcoo.n_rows,)
            or bcoo.warp_map.dim() != 2 or bcoo.warp_map.shape[1] != 3
            or xf.shape[1] != bcoo.n_cols):
        raise ValueError(f"{name}: shapes {tuple(bcoo.vals.shape)} "
                         f"{tuple(bcoo.cols.shape)} "
                         f"{tuple(bcoo.row_lens.shape)} "
                         f"{tuple(bcoo.warp_map.shape)} x {tuple(x.shape)} "
                         f"for {bcoo.n_rows} rows, {bcoo.n_cols} columns")
    if max(nbins * nnz_pad, bcoo.n_rows) >= 2**31:
        raise ValueError(f"{name}: {nbins}x{nnz_pad} entries or "
                         f"{bcoo.n_rows} rows overflow int32 offsets")
    code = _check(name, bcoo.vals.device, [bcoo.vals],
                  [bcoo.cols, bcoo.row_lens, bcoo.warp_map], [xf])
    y = torch.empty(bcoo.n_rows, dtype=torch.float32,
                    device=bcoo.vals.device)
    with torch.cuda.device(bcoo.vals.device):
        err = library().repro_balanced_spmv(
            code, bcoo.vals.data_ptr(), bcoo.cols.data_ptr(),
            bcoo.row_lens.data_ptr(), bcoo.warp_map.data_ptr(),
            bcoo.warp_map.shape[0], xf.data_ptr(), y.data_ptr(),
            _stream(bcoo.vals.device))
    _raise_on(name, err)
    LAUNCHES[name] += 1
    return y
