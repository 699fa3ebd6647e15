"""Layer 3 — static bounds verification of format index streams.

The ELL/SELL matvecs (the CUDA kernels and their plain versions alike)
read the assembled vector buffers through **static** index arrays packed
at plan-build time — there is no runtime bounds check, and on the card an
out-of-range index is an out-of-bounds access, not an exception.  Every
registered format declares its streams (``ShardFormat.index_streams``)
so this checker can prove, per plan:

* every gather index is inside its buffer extent — ``nl_pad`` for the
  node-local slice (column-keyed: the width of the local x shard, which
  differs from the row count on rectangular plans), ``g_pad + 1`` for
  the ghost buffer (``K_INDEX_OOB``);
* every scatter (accumulation-slot) index is inside ``rc_pad``
  (``K_ROW_OOB``);
* only zero-valued (pad) entries read the ghost dump slot ``g_pad``,
  which is write-only garbage by contract (``K_DUMP_READ``);
* vals/cols/rows of one stream agree in shape (``K_STREAM_SHAPE``);
* stored values are finite (``K_NONFINITE``);
* the declared streams actually cover the format's fields
  (``K_UNDECLARED_FIELDS``, advisory).
"""
from __future__ import annotations

from typing import Any

import numpy as np

from repro_torch.analysis.plan_check import host
from repro_torch.analysis.report import Report, Violation
from repro_torch.sparse.formats import IndexStream, get_format

__all__ = ["check_kernel_streams"]


def _first(bad: np.ndarray) -> tuple[int, ...]:
    return tuple(int(i) for i in np.argwhere(bad)[0])


def _check_stream(plan: Any, st: IndexStream, out: Report) -> None:
    ctx = {"format": plan.format, "field": st.cols}
    vals = host(plan.fmt_data[st.vals])
    cols = host(plan.fmt_data[st.cols])

    out.count(1)
    shapes = {st.vals: vals.shape, st.cols: cols.shape}
    rows = None
    if st.rows is not None:
        rows = host(plan.fmt_data[st.rows])
        shapes[st.rows] = rows.shape
    if len(set(shapes.values())) != 1:
        out.add(Violation("K_STREAM_SHAPE",
                          f"stream arrays disagree in shape: {shapes}",
                          ctx))
        return
    if vals.size == 0:
        return

    extent = plan.nl_pad if st.x == "local" else plan.g_pad + 1
    out.count(1)
    bad = (cols < 0) | (cols >= extent)
    if np.any(bad):
        out.add(Violation(
            "K_INDEX_OOB",
            f"{int(bad.sum())} {st.cols!r} indices outside the "
            f"{st.x} buffer [0, {extent}) (first at {_first(bad)}: "
            f"{int(cols[_first(bad)])})", ctx))

    if st.x == "ghost" and plan.g_pad > 0:
        out.count(1)
        dump = (vals != 0) & (cols == plan.g_pad)
        if np.any(dump):
            out.add(Violation(
                "K_DUMP_READ",
                f"{int(dump.sum())} nonzero entries read the write-only "
                f"dump slot {plan.g_pad} (first at {_first(dump)})", ctx))

    if rows is not None:
        out.count(1)
        bad = (rows < 0) | (rows >= plan.rc_pad)
        if np.any(bad):
            out.add(Violation(
                "K_ROW_OOB",
                f"{int(bad.sum())} {st.rows!r} accumulation slots outside "
                f"[0, {plan.rc_pad}) (first at {_first(bad)}: "
                f"{int(rows[_first(bad)])})",
                {"format": plan.format, "field": st.rows}))

    out.count(1)
    nonfinite = ~np.isfinite(vals)
    if np.any(nonfinite):
        out.add(Violation(
            "K_NONFINITE",
            f"{int(nonfinite.sum())} nonfinite stored values (first at "
            f"{_first(nonfinite)})", {"format": plan.format,
                                      "field": st.vals}))


def check_kernel_streams(plan: Any) -> Report:
    """Prove the plan's packed index streams in-bounds for the shard
    buffer extents (see module docstring).  Returns a :class:`Report`."""
    out = Report()
    fmt = get_format(plan.format)
    streams = fmt.index_streams()

    out.count(1)
    declared = {n for st in streams
                for n in (st.vals, st.cols, st.rows) if n is not None}
    undeclared = set(fmt.fields) - declared
    if undeclared or not streams:
        out.add(Violation(
            "K_UNDECLARED_FIELDS",
            f"format {plan.format!r} fields not covered by any declared "
            f"index stream: {sorted(undeclared) or 'ALL'}",
            {"format": plan.format}))

    for st in streams:
        _check_stream(plan, st, out)
    return out
