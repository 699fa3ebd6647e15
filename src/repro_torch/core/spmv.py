"""Hybrid hierarchical-parallel distributed SpMV on one card.

PETSc's MPIAIJ SpMV runs in two phases (paper Sec. 1.1): the diagonal
block times the local vector while remote ("ghost") elements are gathered,
then the off-diagonal block times the ghosts, added to the partial result.
The hybrid MPI/OpenMP hierarchy is a ``(node, core)`` grid: block rows are
distributed over ``node`` with a static halo plan; rows within a node are
split over ``core`` with no halo traffic.

This port keeps the JAX package's plan (same fields, bytes and meta) and
runs the whole grid on one card as a *virtual mesh*: every plan array and
every vector leads with ``(n_node, n_core)``, one slice per shard, and the
collectives become index operations with the same semantics (see
``repro_torch.core.transport``).  The core-axis ``all_gather`` that
assembles each node's ``x`` slice is a view of the node's shards followed
by the ``x_gather`` index.  The modes ``vector``/``task``/``balanced``
differ only in the partition here: one stream has no schedule to pin, so
the ``vector`` mode's barrier has no counterpart.

Square plans only so far (``n_cols == n``); the rectangular column space
and the other transports wait for later work.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.halo import HaloPlan, build_halo_plan
from repro_torch.core.partition import partition_stats, partition_two_level
from repro_torch.core.transport import (HaloTransport, WireCodec,
                                        resolve_transport, transport_census,
                                        transport_stamp)
from repro_torch.sparse.csr import CSRMatrix
from repro_torch.sparse.formats import ShardFormat, get_format
from repro_torch.util import align_up, resolve_device, to_device

__all__ = ["SpMVPlan", "build_spmv_plan", "plan_from_arrays", "make_spmv",
           "make_shard_body", "plan_shard_arrays", "plan_fields", "to_dist",
           "from_dist", "COMMON_FIELDS", "MODES", "PLAN_META"]

MODES = ("vector", "task", "balanced")

#: shard slot counts are multiples of this (the JAX package's default)
ROWS_ALIGN = 8

#: format-independent plan fields consumed by the shard body, in order
#: (the format's own ``fields`` come first)
COMMON_FIELDS = ("send_own", "recv_own", "x_gather")

#: the plan's static meta, as the JAX package names it
PLAN_META = ("n", "n_node", "n_core", "rc_pad", "nl_pad", "g_pad", "hs",
             "mode", "format", "transport", "wire_dtype")


@dataclasses.dataclass
class SpMVPlan:
    """Device-ready distributed matrix + halo plan.

    Leading axes of every tensor are ``(n_node, n_core, ...)``.  Vectors in
    "CG layout" are ``(n_node, n_core, rc_pad)``.  Field names, dtypes,
    shapes and meta are the JAX package's ``SpMVPlan``'s, so every array
    and every vector compares slot for slot with the reference.
    """

    # format-owned local matrix blocks: the format's ``fields`` and its
    # ``aux_fields``
    fmt_data: dict[str, torch.Tensor]
    # owner-split halo plan (indices into the core's own (rc_pad,) shard)
    send_own: torch.Tensor    # (n_node, n_core, n_node, hs) int32
    recv_own: torch.Tensor    # (n_node, n_core, n_node, hs) int32 -> slot
    # vector layout maps
    x_gather: torch.Tensor    # (n_node, n_core, nl_pad) int32 (same per core)
    diag_a: torch.Tensor      # (n_node, n_core, rc_pad) diag(A), 1 at pad
    mask: torch.Tensor        # (n_node, n_core, rc_pad) 1 valid / 0 padding
    # static meta
    n: int
    n_node: int
    n_core: int
    rc_pad: int
    nl_pad: int
    g_pad: int
    hs: int
    mode: str
    format: str
    transport: str = "a2a"
    wire_dtype: str = "f32"
    # square plans: the column space is the row space
    n_cols: int = -1
    cc_pad: int = -1
    mask_col: torch.Tensor | None = None

    def __post_init__(self):
        if self.n_cols < 0:
            self.n_cols = self.n
        if self.cc_pad < 0:
            self.cc_pad = self.rc_pad
        if self.mask_col is None:
            self.mask_col = self.mask
        if self.n_cols != self.n or self.cc_pad != self.rc_pad:
            raise ValueError("only square plans are supported "
                             f"(n={self.n}, n_cols={self.n_cols})")

    @property
    def cg_shape(self) -> tuple[int, int, int]:
        return (self.n_node, self.n_core, self.rc_pad)

    @property
    def x_shape(self) -> tuple[int, int, int]:
        return (self.n_node, self.n_core, self.cc_pad)

    @property
    def device(self) -> torch.device:
        return self.mask.device

    def nnz_stored(self) -> int:
        return get_format(self.format).nnz_stored(self.fmt_data)


def plan_fields(plan: SpMVPlan) -> tuple[str, ...]:
    """Shard-body argument names: the format's fields, then the common ones
    (the JAX package's order; the golden hashes are keyed by these)."""
    return get_format(plan.format).fields + COMMON_FIELDS


def plan_shard_arrays(plan: SpMVPlan) -> tuple[torch.Tensor, ...]:
    """The plan's shard-body inputs in ``plan_fields`` order."""
    fmt = get_format(plan.format)
    return tuple(plan.fmt_data[f] for f in fmt.fields) + (
        plan.send_own, plan.recv_own, plan.x_gather)


# ---------------------------------------------------------------------- #
# host-side plan construction (one-off, cached with the matrix)
# ---------------------------------------------------------------------- #
def build_spmv_plan(A: CSRMatrix, n_node: int, n_core: int,
                    mode: str = "balanced",
                    format: str | ShardFormat = "ell",
                    transport: str | HaloTransport = "a2a", device=None
                    ) -> tuple[SpMVPlan, dict]:
    """Partition square ``A``, split diag/offdiag, pack shard blocks + halo
    plan, and place them on ``device`` (default ``cuda``) in float32.

    ``mode="balanced"`` balances non-zeros on **both** mesh axes
    (``partition_two_level``); ``vector``/``task`` use equal rows.
    ``format`` selects the shard-local storage (``"ell"`` | ``"sell"``),
    ``transport`` the halo exchange (``"a2a"``); the halo wire codec is
    the exact ``f32`` one.

    Returns ``(plan, layout)``: ``layout`` carries the host index arrays
    ``to_dist``/``from_dist`` use, the partition, the halo plan, a
    ``stats`` dict (per-axis imbalance, padding waste) and the
    ``transport_census``.  Every plan array is byte-identical to the JAX
    package's ``build_spmv_plan`` for the same arguments (its defaults
    ``rows_align=8``, ``width_align=1``, ``node_partition`` following
    ``mode``, ``dtype=float32``, ``wire_dtype="f32"``).
    """
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
    if A.n_rows < 1:
        raise ValueError("build_spmv_plan: empty row space "
                         f"(A.shape = {A.shape})")
    if A.n_cols != A.n_rows:
        raise ValueError(f"build_spmv_plan: only square matrices are "
                         f"supported, got shape {A.shape}")
    if A.indices.size:
        c_lo, c_hi = int(A.indices.min()), int(A.indices.max())
        if c_lo < 0 or c_hi >= A.n_cols:
            raise ValueError(
                "build_spmv_plan: stored column index out of range for "
                f"shape {A.shape}: indices span [{c_lo}, {c_hi}]")
    device = resolve_device(device)
    transport = transport_stamp(transport)        # fail fast on typos
    fmt = get_format(format)
    n = A.n_rows
    partition = "nnz" if mode == "balanced" else "rows"
    node_bounds, core_bounds_all = partition_two_level(
        A.row_nnz, n_node, n_core, node_partition=partition,
        core_partition=partition)

    diag_nodes: list[CSRMatrix] = []
    offd_nodes: list[CSRMatrix] = []
    ghost_cols: list[np.ndarray] = []
    for i in range(n_node):
        lo, hi = int(node_bounds[i]), int(node_bounds[i + 1])
        diag_i, offd_i, ghosts = A.row_slice(lo, hi).col_split(lo, hi)
        ghost_cols.append(ghosts)
        diag_nodes.append(diag_i)
        offd_nodes.append(offd_i)

    # uniform static shapes across every (node, core) shard
    rc_pad = align_up(max(int(np.diff(cb).max()) for cb in core_bounds_all),
                      ROWS_ALIGN)
    nl_pad = align_up(max(int(node_bounds[i + 1] - node_bounds[i])
                          for i in range(n_node)), ROWS_ALIGN)

    x_gather = np.zeros((n_node, n_core, nl_pad), dtype=np.int32)
    mask = np.zeros((n_node, n_core, rc_pad), dtype=np.float64)
    diag_a = np.ones((n_node, n_core, rc_pad), dtype=np.float64)
    global_row_of = np.full((n_node, n_core, rc_pad), -1, dtype=np.int64)
    # bin-local row id -> vector-layout slot, per shard (for the halo remap)
    slot_of = np.zeros((n_node, n_core, rc_pad), dtype=np.int32)

    diag_full = A.diagonal()
    zero_diag = np.flatnonzero(diag_full == 0)
    if zero_diag.size:
        raise ValueError(
            f"A has a zero or missing diagonal entry on {zero_diag.size} "
            f"owned row(s) (first: row {int(zero_diag[0])}); the Jacobi "
            "preconditioner 1/diag(A) would be infinite there.  Add a "
            "diagonal shift or fix the assembly.")
    c_of_all: list[np.ndarray] = []
    lr_all: list[np.ndarray] = []
    for i in range(n_node):
        lo = int(node_bounds[i])
        nl = diag_nodes[i].n_rows
        cb = core_bounds_all[i]
        ar = np.arange(nl, dtype=np.int64)
        c_of = np.searchsorted(cb, ar, side="right") - 1   # owning core
        lr = fmt.slot_order(A.row_nnz[lo:lo + nl], cb)     # slot in the bin
        c_of_all.append(c_of)
        lr_all.append(lr)
        mask[i, c_of, lr] = 1.0
        diag_a[i, c_of, lr] = diag_full[lo:lo + nl]
        global_row_of[i, c_of, lr] = lo + ar
        x_gather[i, :, :nl] = (c_of * rc_pad + lr)[None, :]
        slot_of[i, c_of, ar - cb[c_of]] = lr

    fmt_data = fmt.pack(diag_nodes, offd_nodes, core_bounds_all,
                        c_of_all, lr_all, rc_pad, device)

    halo: HaloPlan = build_halo_plan(ghost_cols, node_bounds, n_core,
                                     core_bounds=core_bounds_all)
    # halo send indices are bin-local row ids; route them through the
    # format's slot assignment (identity for ELL)
    send_own = slot_of[np.arange(n_node)[:, None, None, None],
                       np.arange(n_core)[None, :, None, None],
                       halo.send_own]

    plan = SpMVPlan(
        fmt_data=fmt_data, send_own=to_device(send_own, device),
        recv_own=to_device(halo.recv_own, device),
        x_gather=to_device(x_gather, device),
        diag_a=to_device(diag_a, device), mask=to_device(mask, device),
        n=n, n_node=n_node, n_core=n_core,
        rc_pad=rc_pad, nl_pad=nl_pad, g_pad=halo.g_pad, hs=halo.h_own,
        mode=mode, format=fmt.name, transport=transport,
        wire_dtype=WireCodec.name)
    stats = partition_stats(A.row_nnz, node_bounds, core_bounds_all)
    stats["padding_waste"] = fmt.padding_waste(fmt_data, A.nnz)
    layout = {
        "node_bounds": node_bounds,
        "core_bounds": core_bounds_all,
        "node_partition": partition,
        "format": fmt.name,
        "global_row_of": global_row_of,
        "halo": halo,
        "transport_census": transport_census(plan),
        "stats": stats,
    }
    return plan, layout


def plan_from_arrays(arrays: dict[str, np.ndarray], meta: dict,
                     device=None) -> SpMVPlan:
    """A port ``SpMVPlan`` from another builder's plan arrays (numpy).

    ``arrays`` maps ``plan_fields`` names plus ``diag_a`` and ``mask`` to
    the arrays of a plan built elsewhere — the JAX package's, handed over
    as numpy; ``meta`` holds :data:`PLAN_META`.  The format's
    ``aux_fields`` are derived from its fields
    (``ShardFormat.derive_aux``).  This carries a reference plan across
    unchanged, so SpMV and CG can be held against the reference on the
    identical plan, independently of the port's planner.
    """
    device = resolve_device(device)
    fmt = get_format(meta["format"])
    data = {k: np.asarray(arrays[k]) for k in fmt.fields}
    data.update(fmt.derive_aux(data, int(meta["rc_pad"])))

    dev = {k: to_device(np.asarray(arrays[k]), device)
           for k in COMMON_FIELDS + ("diag_a", "mask")}
    return SpMVPlan(
        fmt_data={k: to_device(v, device) for k, v in data.items()}, **dev,
        **{k: (str(meta[k]) if k in ("mode", "format", "transport",
                                     "wire_dtype") else int(meta[k]))
           for k in PLAN_META})


# ---------------------------------------------------------------------- #
# vector layout conversion (host)
# ---------------------------------------------------------------------- #
def to_dist(v: np.ndarray, layout: dict, plan: SpMVPlan) -> torch.Tensor:
    """Global vector ``(n,)`` -> distributed layout ``plan.cg_shape`` on the
    plan's device, driven by the layout's slot table."""
    g = layout["global_row_of"]
    v = np.asarray(v)
    out = np.zeros(plan.cg_shape, dtype=v.dtype)
    valid = g >= 0
    out[valid] = v[g[valid]]
    return torch.from_numpy(out).to(device=plan.device,
                                    dtype=plan.mask.dtype)


def from_dist(vd: torch.Tensor, layout: dict, plan: SpMVPlan) -> np.ndarray:
    """Distributed layout -> global vector ``(n,)`` (inverse of
    ``to_dist``)."""
    g = layout["global_row_of"]
    vd = vd.detach().cpu().numpy()
    out = np.zeros(plan.n, dtype=vd.dtype)
    valid = g >= 0
    out[g[valid]] = vd[valid]
    return out


# ---------------------------------------------------------------------- #
# the distributed SpMV body (shared by make_spmv and the solvers)
# ---------------------------------------------------------------------- #
def make_shard_body(plan: SpMVPlan):
    """Build the two-phase SpMV over the whole virtual mesh:
    ``body(x) -> y``, both ``(n_node, n_core, rc_pad)``.

    1. halo exchange through the plan's stamped transport (skipped for
       halo-free plans, ``plan.hs == 0``) -> ``x_ghost``
       ``(n_node, g_pad + 1)``;
    2. the core-axis gather of each node's slice -> ``x_local``
       ``(n_node, nl_pad)``;
    3. the format's local diag + offd matvec over all shards, through the
       kernel wrappers: the CUDA kernels on the card, their plain versions
       on the CPU.

    The body carries ``body.transport`` and ``body.wire_dtype`` (resolved
    names), and ``body.inputs(x) -> (x_local, x_ghost)``: steps 1-2 alone,
    what the local matvec gets.
    """
    n_node, n_core, rc_pad = plan.n_node, plan.n_core, plan.rc_pad
    g_pad = plan.g_pad
    has_halo = plan.hs > 0
    tr, tstate = resolve_transport(plan)
    local_matvec = get_format(plan.format).matvec_kernel
    F = dict(plan.fmt_data, send_own=plan.send_own, recv_own=plan.recv_own)
    # x_gather is replicated over the core axis: one row per node, int64
    # and offset into the node's flattened (n_core * rc_pad) view
    x_gather = plan.x_gather[:, 0, :].long()

    def inputs(x: torch.Tensor):
        """Steps 1-2: ``(x_local, x_ghost)`` for the local matvec."""
        x_ghost = (tr.exchange(x, F, state=tstate, n_node=n_node,
                               g_pad=g_pad) if has_halo else None)
        x_local = torch.gather(x.reshape(n_node, n_core * rc_pad), 1,
                               x_gather)
        return x_local, x_ghost

    def body(x: torch.Tensor) -> torch.Tensor:
        return local_matvec(F, *inputs(x), rc_pad)

    body.inputs = inputs
    body.transport = tr.name
    body.wire_dtype = tstate["wire_codec"].name
    return body


def make_spmv(plan: SpMVPlan):
    """The distributed SpMV ``plan.x_shape -> plan.cg_shape`` on the
    plan's device.  Carries ``spmv.transport`` / ``spmv.wire_dtype``."""
    body = make_shard_body(plan)

    def spmv(xd: torch.Tensor) -> torch.Tensor:
        if tuple(xd.shape) != plan.x_shape:
            raise ValueError(f"spmv: expected {plan.x_shape}, got "
                             f"{tuple(xd.shape)}")
        return body(xd)

    spmv.transport = body.transport
    spmv.wire_dtype = body.wire_dtype
    return spmv
