"""Layer 1 — host-side race/aliasing detection over ``SpMVPlan`` data.

Everything here is numpy over the plan's static arrays, copied to the
host: no kernel runs.  The invariants proven (codes in
``repro_torch.analysis.report``):

* every *real* ghost slot has **exactly one writer** across the whole
  receive table (``P_GHOST_MULTI_WRITER``) — the single-writer property
  is what makes the gather+add ghost assembly equal to an all-reduce
  without emitting one, so a second writer is a silent race;
* every ghost slot a nonzero off-diagonal entry *reads* is written by
  someone (``P_GHOST_STALE_READ``);
* the send/receive tables index inside their buffers (``P_SEND_OOB`` /
  ``P_RECV_OOB``);
* the folded slot order is a true permutation: ``x_gather`` maps the
  node's *columns* bijectively onto mask_col-valid vector slots and is
  replicated across the core axis (``P_SLOT_PERM``) — on square plans
  ``mask_col``/``cc_pad`` alias ``mask``/``rc_pad``, so this is the
  familiar row-space check;
* partition bounds are monotone, cover ``[0, n]`` (and, for rectangular
  plans, the column space covers ``[0, n_cols]``), and agree with the
  per-node valid counts (``P_NODE_BOUNDS``, needs ``layout``);
* the mask counts exactly ``n`` valid slots and ``mask_col`` exactly
  ``n_cols`` (``P_MASK_COUNT``);
* format storage accounting is self-consistent (``P_ACCOUNTING``);
* halo-free plans really carry no ghost machinery (``P_HALO_FREE``).
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.analysis.report import Report, Violation
from repro_torch.core.halo import ghost_writer_counts
from repro_torch.sparse.formats import get_format

__all__ = ["check_plan", "host"]


def _ctx(plan: Any, **extra: object) -> dict[str, Any]:
    return {"format": plan.format, **extra}


def host(a: Any) -> np.ndarray:
    """A plan array as numpy on the host (a tensor on any device)."""
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def _check_halo_tables(plan: Any, out: Report) -> None:
    send = host(plan.send_own)
    recv = host(plan.recv_own)
    g_pad, hs = plan.g_pad, plan.hs

    out.count(2)
    if (hs == 0) != (g_pad == 0):
        out.add(Violation("P_HALO_FREE",
                          f"hs={hs} but g_pad={g_pad}: halo-free means "
                          "both are zero", _ctx(plan)))
    if hs == 0:
        streams = get_format(plan.format).index_streams()
        for st in streams:
            vals = host(plan.fmt_data[st.vals])
            if st.x == "ghost" and vals.size and np.any(vals != 0):
                out.add(Violation(
                    "P_HALO_FREE",
                    f"halo-free plan stores nonzero off-diagonal values "
                    f"in {st.vals!r}", _ctx(plan, field=st.vals)))
        return

    out.count(2)
    # send_own gathers from the local x shard, which lives in the COLUMN
    # space (cc_pad slots; == rc_pad for square plans)
    bad_send = (send < 0) | (send >= plan.cc_pad)
    if np.any(bad_send):
        idx = tuple(int(i) for i in np.argwhere(bad_send)[0])
        out.add(Violation(
            "P_SEND_OOB",
            f"{int(bad_send.sum())} send_own entries outside "
            f"[0, {plan.cc_pad}) (first at {idx}: "
            f"{int(send[idx])})", _ctx(plan)))
    bad_recv = (recv < 0) | (recv > g_pad)
    if np.any(bad_recv):
        idx = tuple(int(i) for i in np.argwhere(bad_recv)[0])
        out.add(Violation(
            "P_RECV_OOB",
            f"{int(bad_recv.sum())} recv_own entries outside "
            f"[0, {g_pad}] (first at {idx}: {int(recv[idx])})",
            _ctx(plan)))

    # single-writer: each real slot written at most once over the whole
    # (core, src, k) receive table of its destination node
    out.count(1)
    writers = ghost_writer_counts(recv, g_pad)
    multi = np.argwhere(writers > 1)
    if multi.size:
        node, slot = (int(v) for v in multi[0])
        out.add(Violation(
            "P_GHOST_MULTI_WRITER",
            f"{len(multi)} ghost slot(s) with multiple writers (first: "
            f"node {node} slot {slot} has {int(writers[node, slot])} "
            "writers)", _ctx(plan, node=node, slot=slot)))

    # stale reads: every ghost slot a nonzero offd entry references must
    # have a writer (the format says which slots are referenced)
    out.count(1)
    for st in get_format(plan.format).index_streams():
        if st.x != "ghost":
            continue
        vals = host(plan.fmt_data[st.vals])
        cols = host(plan.fmt_data[st.cols])
        if vals.size == 0:
            continue
        for node in range(plan.n_node):
            ref = np.unique(cols[node][vals[node] != 0])
            ref = ref[(ref >= 0) & (ref < g_pad)]   # OOB is K_INDEX_OOB's job
            stale = ref[writers[node, ref] == 0]
            if stale.size:
                out.add(Violation(
                    "P_GHOST_STALE_READ",
                    f"node {node}: {stale.size} referenced ghost slot(s) "
                    f"have no writer (first: slot {int(stale[0])} via "
                    f"{st.cols!r})",
                    _ctx(plan, node=node, field=st.cols,
                         slot=int(stale[0]))))
                break


def _check_slot_maps(plan: Any, out: Report) -> None:
    xg = host(plan.x_gather)
    mask = host(plan.mask)
    # column-space mask: aliases ``mask`` on square plans, separate for
    # rectangular ones — x_gather is a permutation of COLUMN slots
    mask_col = host(plan.mask_col)

    out.count(2)
    if not np.all((mask == 0.0) | (mask == 1.0)):
        out.add(Violation("P_MASK_COUNT",
                          "mask holds values other than 0/1", _ctx(plan)))
    total = int(mask.sum())
    if total != plan.n:
        out.add(Violation(
            "P_MASK_COUNT",
            f"mask marks {total} valid slots, matrix has n={plan.n} rows",
            _ctx(plan)))
    if not np.all((mask_col == 0.0) | (mask_col == 1.0)):
        out.add(Violation("P_MASK_COUNT",
                          "mask_col holds values other than 0/1",
                          _ctx(plan)))
    total_c = int(mask_col.sum())
    if total_c != plan.n_cols:
        out.add(Violation(
            "P_MASK_COUNT",
            f"mask_col marks {total_c} valid slots, matrix has "
            f"n_cols={plan.n_cols} columns", _ctx(plan)))

    out.count(plan.n_node)
    n_slots = plan.n_core * plan.cc_pad
    for node in range(plan.n_node):
        ncl = int(mask_col[node].sum())
        if not np.all(xg[node] == xg[node, :1]):
            out.add(Violation(
                "P_SLOT_PERM",
                f"node {node}: x_gather differs across the core axis "
                "(must be replicated)", _ctx(plan, node=node)))
            continue
        e = xg[node, 0, :ncl].astype(np.int64)
        if np.any((e < 0) | (e >= n_slots)):
            out.add(Violation(
                "P_SLOT_PERM",
                f"node {node}: x_gather points outside the node's "
                f"{n_slots} vector slots", _ctx(plan, node=node)))
            continue
        if len(np.unique(e)) != ncl:
            out.add(Violation(
                "P_SLOT_PERM",
                f"node {node}: x_gather maps {ncl} columns onto "
                f"{len(np.unique(e))} distinct slots — not a permutation",
                _ctx(plan, node=node)))
            continue
        core, lr = e // plan.cc_pad, e % plan.cc_pad
        if not np.all(mask_col[node, core, lr] == 1.0):
            bad = int(np.argwhere(mask_col[node, core, lr] != 1.0)[0][0])
            out.add(Violation(
                "P_SLOT_PERM",
                f"node {node}: x_gather column {bad} targets a padding "
                f"slot (core {int(core[bad])}, slot {int(lr[bad])})",
                _ctx(plan, node=node)))


def _check_accounting(plan: Any, out: Report) -> None:
    fmt = get_format(plan.format)
    out.count(2)
    declared_vals = [st.vals for st in fmt.index_streams()]
    if declared_vals:
        stored = sum(int(host(plan.fmt_data[v]).size)
                     for v in declared_vals)
        if fmt.nnz_stored(plan.fmt_data) != stored:
            out.add(Violation(
                "P_ACCOUNTING",
                f"nnz_stored()={fmt.nnz_stored(plan.fmt_data)} but the "
                f"declared value streams hold {stored} slots",
                _ctx(plan)))
        nonzero = sum(int(np.count_nonzero(host(plan.fmt_data[v])))
                      for v in declared_vals)
        waste = fmt.padding_waste(plan.fmt_data, nonzero)
        if not 0.0 <= waste < 1.0 + 1e-12:
            out.add(Violation(
                "P_ACCOUNTING",
                f"padding_waste={waste} outside [0, 1) for "
                f"nnz_true>={nonzero}", _ctx(plan)))

    out.count(1)
    diag = host(plan.diag_a)
    mask = host(plan.mask)
    if not np.all(np.isfinite(diag)):
        out.add(Violation("P_ACCOUNTING",
                          "diag_a holds nonfinite entries",
                          _ctx(plan, field="diag_a")))
    elif np.any(diag[mask == 1.0] == 0.0):
        out.add(Violation(
            "P_ACCOUNTING",
            "diag_a is zero on a valid row — the Jacobi preconditioner "
            "would be infinite there", _ctx(plan, field="diag_a")))


def _check_bounds(plan: Any, layout: dict[str, Any], out: Report) -> None:
    nb = np.asarray(layout["node_bounds"], dtype=np.int64)
    mask = host(plan.mask)
    out.count(1)
    if len(nb) != plan.n_node + 1:
        out.add(Violation(
            "P_NODE_BOUNDS",
            f"node_bounds has {len(nb)} entries for {plan.n_node} nodes",
            _ctx(plan)))
        return
    if np.any(np.diff(nb) < 0) or int(nb[0]) != 0 or int(nb[-1]) != plan.n:
        out.add(Violation(
            "P_NODE_BOUNDS",
            f"node_bounds {nb.tolist()} is not monotone over "
            f"[0, {plan.n}]", _ctx(plan)))
        return
    for node in range(plan.n_node):
        nl = int(nb[node + 1] - nb[node])
        got = int(mask[node].sum())
        if nl != got:
            out.add(Violation(
                "P_NODE_BOUNDS",
                f"node {node}: bounds claim {nl} rows, the mask marks "
                f"{got} valid slots", _ctx(plan, node=node)))
        cb = np.asarray(layout["core_bounds"][node], dtype=np.int64)
        if (len(cb) != plan.n_core + 1 or np.any(np.diff(cb) < 0)
                or int(cb[0]) != 0 or int(cb[-1]) != nl):
            out.add(Violation(
                "P_NODE_BOUNDS",
                f"node {node}: core_bounds {cb.tolist()} does not cover "
                f"[0, {nl}]", _ctx(plan, node=node)))

    # column-space partition (rectangular plans carry their own; square
    # plans alias the row partition)
    cs = layout.get("col_space")
    if cs is None:
        return
    cnb = np.asarray(cs["node_bounds"], dtype=np.int64)
    mask_col = host(plan.mask_col)
    out.count(1)
    if (len(cnb) != plan.n_node + 1 or np.any(np.diff(cnb) < 0)
            or int(cnb[0]) != 0 or int(cnb[-1]) != plan.n_cols):
        out.add(Violation(
            "P_NODE_BOUNDS",
            f"col_space node_bounds {cnb.tolist()} is not monotone over "
            f"[0, {plan.n_cols}]", _ctx(plan)))
        return
    for node in range(plan.n_node):
        ncl = int(cnb[node + 1] - cnb[node])
        got = int(mask_col[node].sum())
        if ncl != got:
            out.add(Violation(
                "P_NODE_BOUNDS",
                f"node {node}: col_space bounds claim {ncl} columns, "
                f"mask_col marks {got} valid slots",
                _ctx(plan, node=node)))
        ccb = np.asarray(cs["core_bounds"][node], dtype=np.int64)
        if (len(ccb) != plan.n_core + 1 or np.any(np.diff(ccb) < 0)
                or int(ccb[0]) != 0 or int(ccb[-1]) != ncl):
            out.add(Violation(
                "P_NODE_BOUNDS",
                f"node {node}: col_space core_bounds {ccb.tolist()} does "
                f"not cover [0, {ncl}]", _ctx(plan, node=node)))


def check_plan(plan: Any, layout: dict[str, Any] | None = None) -> Report:
    """Run every plan-layer invariant; ``layout`` (from
    ``build_spmv_plan``) additionally enables the partition-bound
    checks.  Returns a :class:`Report` (errors gate CI)."""
    out = Report()
    _check_halo_tables(plan, out)
    _check_slot_maps(plan, out)
    _check_accounting(plan, out)
    if layout is not None:
        _check_bounds(plan, layout, out)
    return out
