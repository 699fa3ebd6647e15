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
by the ``x_gather`` index.

The modes ``vector``/``task``/``balanced`` differ in partition and in
schedule.  The schedule lives on the **rank-local plan** with a halo,
where a wire exists: ``vector`` pins the exchange before the local
product, as the JAX package's ``optimization_barrier`` does (exchange,
waited; the core gather of ``x``; one fused launch), while ``task`` and
``balanced`` run the paper's communication thread — issue the exchange,
gather ``x`` and launch the diag pass while it is in flight, then wait
for the ghosts and launch the offd pass onto the diag partial.  The two
launches give the fused kernel's ``y`` bit for bit, so every mode's
result is the same bits.  The virtual mesh keeps the one fused launch in
every mode: its collectives are index operations on one stream, with no
wire to hide, and splitting the launch there would only add one.  A
halo-free plan has nothing to exchange and keeps its one launch too.

The exchange strategy is pluggable (``repro_torch.core.transport``): the
plan stamps a transport name (``a2a`` | ``ring`` | ``pairwise`` | ``hier``)
and a halo wire dtype (``f32`` | ``bf16`` | ``int8``), ``make_shard_body``
dispatches the owner-split exchange to it, and ``transport="auto"``
times the candidates on the plan's device and stamps the winner.

A **rank-local plan** (``shard_plan``, or ``plan_from_arrays(...,
mesh=)`` on a process mesh of ``repro_torch.launch.mesh``) is one shard of
a whole plan: the same fields and meta, every array cut to the rank's
``(node, core)`` with leading axes ``(1, 1)``, and ``plan.mesh`` naming
the process mesh.  The shard body, the transports and the solvers run on
it unchanged, and the collectives become ``torch.distributed`` calls
(gloo through the host, or NCCL with the plan on the rank's own card).

Plans may be rectangular (``n_cols != n``): outputs and Krylov vectors
live in the **row space** ``(n_node, n_core, rc_pad)``, SpMV inputs in the
**column space** ``(n_node, n_core, cc_pad)``, whose own partition keys
the halo plan and ``x_gather``.  A square plan with no column-space
override has one space for both, array for array the historical plan.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.collectives import (all_gather, check_waited,
                                          open_handles)
from repro_torch.core.halo import HaloPlan, build_halo_plan, pair_traffic
from repro_torch.core.partition import partition_stats, partition_two_level
from repro_torch.core.transport import (HaloTransport, get_codec,
                                        resolve_transport, transport_census,
                                        transport_stamp)
from repro_torch.sparse.csr import CSRMatrix
from repro_torch.sparse.formats import ShardFormat, get_format
from repro_torch.util import align_up, resolve_device, to_device

__all__ = ["SpMVPlan", "build_spmv_plan", "plan_from_arrays", "make_spmv",
           "make_shard_body", "plan_shard_arrays", "plan_fields", "to_dist",
           "from_dist", "shard_plan", "plan_arrays", "plan_meta",
           "COMMON_FIELDS", "MODES", "PLAN_META"]

MODES = ("vector", "task", "balanced")

#: the modes whose body overlaps the halo exchange with the diag pass on a
#: rank-local plan (the paper's communication thread); ``vector`` keeps
#: the reference's barrier
OVERLAPPED_MODES = ("task", "balanced")

#: local matvec of the shard body: the kernel wrappers or their plain
#: versions
BACKENDS = ("kernel", "plain")

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
    "CG layout" (the row space: SpMV outputs, Krylov iterates) are
    ``(n_node, n_core, rc_pad)``; SpMV inputs live in the column space,
    ``(n_node, n_core, cc_pad)`` (``x_shape``).  On a square plan with the
    default column space the two coincide (``cc_pad == rc_pad``,
    ``mask_col is mask``).  Field names, dtypes, shapes and meta are the
    JAX package's ``SpMVPlan``'s, so every array and every vector compares
    slot for slot with the reference.
    """

    # format-owned local matrix blocks: the format's ``fields`` and its
    # ``aux_fields``
    fmt_data: dict[str, torch.Tensor]
    # owner-split halo plan (indices into the core's own (cc_pad,) input
    # shard)
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
    # column-space meta (-1: the row space's, as on a square plan)
    n_cols: int = -1
    cc_pad: int = -1
    # (n_node, n_core, cc_pad) 1 valid / 0 padding in the input layout;
    # ``mask`` itself on a square plan with the default column space
    mask_col: torch.Tensor | None = None
    # a rank-local plan's process mesh (``None``: the virtual mesh), the
    # whole plan's (dst, src) pair-traffic table (host) and its node's
    # whole receive table (1, n_core, n_node, hs), which hier scatters
    # through
    mesh: object | None = None
    traffic: np.ndarray | None = None
    recv_node: torch.Tensor | None = None
    # a rank-local plan's whole-plan pads for the plain versions
    # (``ShardFormat.plain_pad``); empty: its own arrays'
    plain_pad: dict = dataclasses.field(default_factory=dict)

    def __post_init__(self):
        if self.n_cols < 0:
            self.n_cols = self.n
        if self.cc_pad < 0:
            self.cc_pad = self.rc_pad
        if self.mask_col is None:
            self.mask_col = self.mask

    @property
    def is_rank_local(self) -> bool:
        return self.mesh is not None and self.mesh.is_process

    @property
    def shard_shape(self) -> tuple[int, int]:
        """The mesh axes this plan's tensors hold: ``(n_node, n_core)``,
        or ``(1, 1)`` on a rank-local plan."""
        return (1, 1) if self.is_rank_local else (self.n_node, self.n_core)

    @property
    def cg_shape(self) -> tuple[int, int, int]:
        return (*self.shard_shape, self.rc_pad)

    @property
    def x_shape(self) -> tuple[int, int, int]:
        return (*self.shard_shape, self.cc_pad)

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
                    transport: str | HaloTransport = "a2a",
                    wire_dtype: str = "f32",
                    node_partition: str | None = None,
                    row_space: dict | None = None,
                    col_space: dict | None = None,
                    verify: bool = False, device=None
                    ) -> tuple[SpMVPlan, dict]:
    """Partition ``A``, split diag/offdiag, pack shard blocks + halo
    plan, and place them on ``device`` (default ``cuda``) in float32.

    ``mode="balanced"`` balances non-zeros on **both** mesh axes
    (``partition_two_level``); ``vector``/``task`` use equal rows.
    ``node_partition`` (``"rows"`` | ``"nnz"``) overrides the node-axis
    split independently of ``mode``.  ``format`` selects the shard-local
    storage (``"ell"`` | ``"sell"``).  ``transport`` stamps the halo
    exchange (any registered name, validated here; ``"auto"`` defers the
    choice to ``autotune_transport`` at the first ``make_spmv`` /
    ``make_solver``), ``wire_dtype`` the halo wire codec (``"f32"`` |
    ``"bf16"`` | ``"int8"``, validated here).

    ``A`` may be **rectangular** (``n_rows != n_cols``): the row partition
    keys the output slot layout, mask and diagonal, while a separate
    column-space partition (the same two-level split over per-column nnz)
    keys column ownership: the halo plan, ``x_gather`` and the input
    layout ``plan.x_shape``.  A square ``A`` with no ``col_space`` takes
    the historical square path unchanged.  ``row_space`` / ``col_space``
    pin a partition to another plan's ``layout["row_space"]`` /
    ``layout["col_space"]`` (``node_bounds``, ``core_bounds``, ``lr`` the
    per-node bin slots, ``pad`` the slot count) instead of computing one:
    how a restriction or prolongation locks onto the fine operator's exact
    slot layout, a SELL plan's σ-window permutation included.
    ``verify=True`` runs the static checker's host layers
    (``repro_torch.analysis``: plan invariants and kernel index-stream
    bounds) on the finished plan and raises ``ValueError`` on any
    error-severity violation.

    Returns ``(plan, layout)``: ``layout`` carries the host index arrays
    ``to_dist``/``from_dist`` use (``global_row_of``, ``global_col_of``),
    the partition and both exported spaces, the halo plan, a ``stats``
    dict (per-axis imbalance, padding waste), the ``transport_census`` and
    the populated ``neighbor_offsets``.  Every plan array is
    byte-identical to the JAX package's ``build_spmv_plan`` for the same
    arguments (its defaults ``rows_align=8``, ``width_align=1``,
    ``dtype=float32``).
    """
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
    if A.n_rows < 1:
        raise ValueError("build_spmv_plan: empty row space "
                         f"(A.shape = {A.shape})")
    if A.n_cols < 1:
        raise ValueError("build_spmv_plan: empty column space "
                         f"(A.shape = {A.shape})")
    if A.indices.size:
        c_lo, c_hi = int(A.indices.min()), int(A.indices.max())
        if c_lo < 0 or c_hi >= A.n_cols:
            raise ValueError(
                "build_spmv_plan: stored column index out of range for "
                f"shape {A.shape}: indices span [{c_lo}, {c_hi}] but "
                f"n_cols = {A.n_cols}")
    device = resolve_device(device)
    if transport != "auto":
        transport = transport_stamp(transport)    # fail fast on typos
    wire_dtype = get_codec(wire_dtype).name       # fail fast on typos
    core_partition = "nnz" if mode == "balanced" else "rows"
    if node_partition is None:
        node_partition = core_partition
    if node_partition not in ("rows", "nnz"):
        raise ValueError("node_partition must be 'rows' or 'nnz', got "
                         f"{node_partition!r}")
    fmt = get_format(format)
    n = A.n_rows
    if row_space is not None:
        node_bounds = np.asarray(row_space["node_bounds"], dtype=np.int64)
        core_bounds_all = [np.asarray(cb, dtype=np.int64)
                           for cb in row_space["core_bounds"]]
        if len(node_bounds) != n_node + 1 or int(node_bounds[-1]) != n:
            raise ValueError(
                f"row_space pin inconsistent with A: node_bounds covers "
                f"[0, {int(node_bounds[-1])}] over {len(node_bounds) - 1} "
                f"node(s), matrix has {n} rows on {n_node} node(s)")
    else:
        node_bounds, core_bounds_all = partition_two_level(
            A.row_nnz, n_node, n_core, node_partition=node_partition,
            core_partition=core_partition)

    # the column-space partition: the row partition itself for a square
    # A with no override (the historical plan, bit for bit), else pinned
    # or a two-level split over per-column nnz
    square_default = A.n_cols == n and col_space is None
    if square_default:
        col_node_bounds, col_core_bounds = node_bounds, core_bounds_all
    elif col_space is not None:
        col_node_bounds = np.asarray(col_space["node_bounds"],
                                     dtype=np.int64)
        col_core_bounds = [np.asarray(cb, dtype=np.int64)
                           for cb in col_space["core_bounds"]]
        if (len(col_node_bounds) != n_node + 1
                or int(col_node_bounds[-1]) != A.n_cols):
            raise ValueError(
                f"col_space pin inconsistent with A: node_bounds covers "
                f"[0, {int(col_node_bounds[-1])}] over "
                f"{len(col_node_bounds) - 1} node(s), matrix has "
                f"{A.n_cols} columns on {n_node} node(s)")
    else:
        col_nnz = np.bincount(A.indices.astype(np.int64),
                              minlength=A.n_cols)
        col_node_bounds, col_core_bounds = partition_two_level(
            col_nnz, n_node, n_core, node_partition=node_partition,
            core_partition=core_partition)

    diag_nodes: list[CSRMatrix] = []
    offd_nodes: list[CSRMatrix] = []
    ghost_cols: list[np.ndarray] = []
    for i in range(n_node):
        lo, hi = int(node_bounds[i]), int(node_bounds[i + 1])
        clo, chi = int(col_node_bounds[i]), int(col_node_bounds[i + 1])
        diag_i, offd_i, ghosts = A.row_slice(lo, hi).col_split(clo, chi)
        ghost_cols.append(ghosts)
        diag_nodes.append(diag_i)
        offd_nodes.append(offd_i)

    # uniform static shapes across every (node, core) shard
    rc_pad = align_up(max(int(np.diff(cb).max()) for cb in core_bounds_all),
                      ROWS_ALIGN)
    if row_space is not None and row_space.get("pad") is not None:
        if int(row_space["pad"]) < rc_pad:
            raise ValueError(f"row_space pad {row_space['pad']} smaller "
                             f"than the largest core bin ({rc_pad} slots)")
        rc_pad = int(row_space["pad"])
    if square_default:
        cc_pad = rc_pad
    else:
        cc_pad = align_up(max(int(np.diff(cb).max())
                              for cb in col_core_bounds), ROWS_ALIGN)
        if col_space is not None and col_space.get("pad") is not None:
            if int(col_space["pad"]) < cc_pad:
                raise ValueError(
                    f"col_space pad {col_space['pad']} smaller than the "
                    f"largest column core bin ({cc_pad} slots)")
            cc_pad = int(col_space["pad"])
    # x_gather width: the widest node-local column count
    nl_pad = align_up(max(int(col_node_bounds[i + 1] - col_node_bounds[i])
                          for i in range(n_node)), ROWS_ALIGN)

    x_gather = np.zeros((n_node, n_core, nl_pad), dtype=np.int32)
    mask = np.zeros((n_node, n_core, rc_pad), dtype=np.float64)
    diag_a = np.ones((n_node, n_core, rc_pad), dtype=np.float64)
    global_row_of = np.full((n_node, n_core, rc_pad), -1, dtype=np.int64)
    # bin-local column id -> input-layout slot, per shard (for the halo
    # remap)
    slot_of = np.zeros((n_node, n_core, cc_pad), dtype=np.int32)

    if A.n_cols == n:       # square: diag(A) exists and Jacobi needs it
        diag_full = A.diagonal()
        zero_diag = np.flatnonzero(diag_full == 0)
        if zero_diag.size:
            raise ValueError(
                f"A has a zero or missing diagonal entry on "
                f"{zero_diag.size} owned row(s) (first: row "
                f"{int(zero_diag[0])}); the Jacobi preconditioner "
                "1/diag(A) would be infinite there.  Add a diagonal shift "
                "or fix the assembly.")
    else:                   # rectangular: no diagonal; diag_a stays ones
        diag_full = None
    c_of_all: list[np.ndarray] = []
    lr_all: list[np.ndarray] = []
    for i in range(n_node):
        lo = int(node_bounds[i])
        nl = diag_nodes[i].n_rows
        cb = core_bounds_all[i]
        ar = np.arange(nl, dtype=np.int64)
        c_of = np.searchsorted(cb, ar, side="right") - 1   # owning core
        if row_space is not None and row_space.get("lr") is not None:
            lr = np.asarray(row_space["lr"][i], dtype=np.int64)  # pinned
        else:
            lr = fmt.slot_order(A.row_nnz[lo:lo + nl], cb)  # slot in bin
        c_of_all.append(c_of)
        lr_all.append(lr)
        mask[i, c_of, lr] = 1.0
        if diag_full is not None:
            diag_a[i, c_of, lr] = diag_full[lo:lo + nl]
        global_row_of[i, c_of, lr] = lo + ar
        if square_default:
            x_gather[i, :, :nl] = (c_of * rc_pad + lr)[None, :]
            slot_of[i, c_of, ar - cb[c_of]] = lr

    if square_default:
        col_lr_all = lr_all
        mask_col = None
        global_col_of = global_row_of
    else:
        col_lr_all = []
        mask_col = np.zeros((n_node, n_core, cc_pad), dtype=np.float64)
        global_col_of = np.full((n_node, n_core, cc_pad), -1,
                                dtype=np.int64)
        for i in range(n_node):
            clo = int(col_node_bounds[i])
            ncl = int(col_node_bounds[i + 1]) - clo
            ccb = col_core_bounds[i]
            ar = np.arange(ncl, dtype=np.int64)
            c_of = np.searchsorted(ccb, ar, side="right") - 1
            if col_space is not None and col_space.get("lr") is not None:
                lr = np.asarray(col_space["lr"][i], dtype=np.int64)
            else:
                lr = ar - ccb[c_of]     # identity slot order in the bin
            col_lr_all.append(lr)
            x_gather[i, :, :ncl] = (c_of * cc_pad + lr)[None, :]
            mask_col[i, c_of, lr] = 1.0
            global_col_of[i, c_of, lr] = clo + ar
            slot_of[i, c_of, ar - ccb[c_of]] = lr

    fmt_data = fmt.pack(diag_nodes, offd_nodes, core_bounds_all,
                        c_of_all, lr_all, rc_pad, device)

    halo: HaloPlan = build_halo_plan(ghost_cols, col_node_bounds, n_core,
                                     core_bounds=col_core_bounds)
    # halo send indices are bin-local column ids; route them through the
    # input layout's slot assignment (identity for ELL)
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
        wire_dtype=wire_dtype, n_cols=A.n_cols, cc_pad=cc_pad,
        mask_col=None if mask_col is None else to_device(mask_col, device))
    stats = partition_stats(A.row_nnz, node_bounds, core_bounds_all)
    stats["padding_waste"] = fmt.padding_waste(fmt_data, A.nnz)
    layout = {
        "node_bounds": node_bounds,
        "core_bounds": core_bounds_all,
        "node_partition": node_partition,
        "format": fmt.name,
        "global_row_of": global_row_of,
        "global_col_of": global_col_of,
        "halo": halo,
        "neighbor_offsets": halo.neighbor_offsets(),
        "transport_census": transport_census(plan),
        "stats": stats,
        # the spaces another plan can pin its own to
        "row_space": {"node_bounds": node_bounds,
                      "core_bounds": core_bounds_all,
                      "lr": lr_all, "pad": rc_pad},
        "col_space": {"node_bounds": col_node_bounds,
                      "core_bounds": col_core_bounds,
                      "lr": col_lr_all, "pad": cc_pad},
    }
    if verify:
        # late import: the checker sits above core
        from repro_torch.analysis import check_kernel_streams, check_plan
        rep = check_plan(plan, layout)
        rep.extend(check_kernel_streams(plan).violations)
        if rep.errors:
            raise ValueError(
                "build_spmv_plan(verify=True): plan violates "
                f"{len(rep.errors)} static contract(s):\n  "
                + "\n  ".join(str(v) for v in rep.errors))
    return plan, layout


def plan_from_arrays(arrays: dict[str, np.ndarray], meta: dict,
                     device=None, mesh=None) -> SpMVPlan:
    """A port ``SpMVPlan`` from another builder's plan arrays (numpy).

    ``arrays`` maps ``plan_fields`` names plus ``diag_a`` and ``mask`` to
    the arrays of a plan built elsewhere — the JAX package's, handed over
    as numpy; ``meta`` holds :data:`PLAN_META`.  The format's
    ``aux_fields`` are derived from its fields
    (``ShardFormat.derive_aux``); the transport stamp may be any registered
    name or ``"auto"``, the wire dtype any registered codec.  This carries
    a reference plan across unchanged, so SpMV and CG can be held against
    the reference on the identical plan, independently of the port's
    planner.  A rectangular plan adds ``n_cols``/``cc_pad`` to ``meta``
    and ``mask_col`` to ``arrays``.

    With a process ``mesh`` (``repro_torch.launch.mesh``) the result is
    this rank's rank-local plan: every array is cut to the rank's
    ``(node, core)`` before it is read (memory-mapped arrays are read
    only there) and placed on ``device`` (default: the mesh's).
    """
    rank = mesh is not None and mesh.is_process
    device = resolve_device(device if device is not None or not rank
                            else mesh.device)
    fmt = get_format(meta["format"])
    if str(meta["transport"]) != "auto":
        transport_stamp(str(meta["transport"]))
    get_codec(str(meta["wire_dtype"]))
    if rank and (int(meta["n_node"]), int(meta["n_core"])) != (
            mesh.n_node, mesh.n_core):
        raise ValueError(f"plan is {meta['n_node']}x{meta['n_core']}, the "
                         f"mesh {mesh.n_node}x{mesh.n_core}")

    def cut(a):
        if not rank:
            return np.asarray(a)
        # a copy of the rank's rows alone (of a memory map: a read of them)
        return np.array(a[mesh.node:mesh.node + 1, mesh.core:mesh.core + 1])

    data = {k: cut(arrays[k]) for k in fmt.fields}
    data.update(fmt.derive_aux(data, int(meta["rc_pad"])))
    names = COMMON_FIELDS + ("diag_a", "mask") + (
        ("mask_col",) if "mask_col" in arrays else ())
    dev = {k: to_device(cut(arrays[k]), device) for k in names}
    extra = {k: int(meta[k]) for k in ("n_cols", "cc_pad") if k in meta}
    if rank:
        recv = np.asarray(arrays["recv_own"])
        extra.update(mesh=mesh, plain_pad=dict(meta.get("plain_pad", {})),
                     traffic=pair_traffic(recv, int(meta["g_pad"])),
                     recv_node=to_device(np.array(recv[mesh.node:mesh.node
                                                       + 1]), device))
    return SpMVPlan(
        fmt_data={k: to_device(v, device) for k, v in data.items()}, **dev,
        **{k: (str(meta[k]) if k in ("mode", "format", "transport",
                                     "wire_dtype") else int(meta[k]))
           for k in PLAN_META}, **extra)


def plan_arrays(plan: SpMVPlan) -> dict[str, np.ndarray]:
    """A whole plan's arrays as numpy, as :func:`plan_from_arrays` takes
    them: the format's fields, the common fields, ``diag_a``, ``mask`` (and
    ``mask_col`` on a rectangular plan)."""
    if plan.is_rank_local:
        raise ValueError("plan_arrays: a rank-local plan holds one shard")
    names = plan_fields(plan) + ("diag_a", "mask")
    out = {k: v.cpu().numpy() for k, v in zip(
        names, plan_shard_arrays(plan) + (plan.diag_a, plan.mask))}
    if plan.mask_col is not plan.mask:
        out["mask_col"] = plan.mask_col.cpu().numpy()
    return out


def plan_meta(plan: SpMVPlan) -> dict:
    """A plan's :data:`PLAN_META` (plus ``n_cols``/``cc_pad`` and the
    plain versions' pads, ``plain_pad``) as plain values."""
    meta = {k: getattr(plan, k) for k in PLAN_META + ("n_cols", "cc_pad")}
    meta["plain_pad"] = get_format(plan.format).plain_pad(plan.fmt_data)
    return meta


def shard_plan(plan: SpMVPlan, mesh, device=None) -> SpMVPlan:
    """Cut a whole plan to the shard of this rank of the process ``mesh``:
    every plan array, ``fmt_data``, ``x_gather`` (the node's row),
    ``mask`` and ``diag_a``, leading axes ``(1, 1)``, on ``device``
    (default: the mesh's, which on NCCL is the rank's own card); ``n_node``
    / ``n_core`` stay the mesh's."""
    if mesh is None or not mesh.is_process:
        raise ValueError("shard_plan needs a process mesh "
                         "(repro_torch.launch.mesh.make_cg_mesh(..., "
                         "backend='gloo' or 'nccl', ...))")
    return plan_from_arrays(plan_arrays(plan), plan_meta(plan),
                            device=device, mesh=mesh)


# ---------------------------------------------------------------------- #
# vector layout conversion (host)
# ---------------------------------------------------------------------- #
def rank_rows(g: np.ndarray, plan: SpMVPlan) -> np.ndarray:
    """A whole plan's per-shard table ``(n_node, n_core, ...)`` as the
    plan holds it: itself, or a rank-local plan's row ``(1, 1, ...)``."""
    if not plan.is_rank_local:
        return g
    m = plan.mesh
    return g[m.node:m.node + 1, m.core:m.core + 1]


def _space(layout: dict, plan: SpMVPlan, space: str):
    """``(slot table, distributed shape, global length)`` of a space; a
    rank-local plan reads its own rows of the whole layout's tables."""
    if space == "col":
        return (rank_rows(layout["global_col_of"], plan), plan.x_shape,
                plan.n_cols)
    if space == "row":
        return (rank_rows(layout["global_row_of"], plan), plan.cg_shape,
                plan.n)
    raise ValueError(f"space must be 'row' or 'col', got {space!r}")


def to_dist(v: np.ndarray, layout: dict, plan: SpMVPlan,
            space: str = "col") -> torch.Tensor:
    """Global vector -> distributed layout on the plan's device, driven by
    the layout's slot tables.  ``space="col"`` (default) gives the SpMV
    input layout, ``(n_cols,)`` -> ``plan.x_shape``; ``space="row"`` the
    output / Krylov layout, ``(n,)`` -> ``plan.cg_shape``.  The two are
    one on a square plan.  A rank-local plan takes the whole plan's
    layout and gets its own shard."""
    g, shape, _ = _space(layout, plan, space)
    v = np.asarray(v)
    out = np.zeros(shape, dtype=v.dtype)
    valid = g >= 0
    out[valid] = v[g[valid]]
    return torch.from_numpy(out).to(device=plan.device,
                                    dtype=plan.mask.dtype)


def from_dist(vd: torch.Tensor, layout: dict, plan: SpMVPlan,
              space: str = "row") -> np.ndarray:
    """Distributed layout -> global vector (inverse of ``to_dist``;
    ``space="row"`` (default) reads ``plan.cg_shape`` outputs,
    ``space="col"`` ``plan.x_shape`` inputs).  On a rank-local plan only
    the rank's own entries are filled, the rest are 0."""
    g, _, n = _space(layout, plan, space)
    vd = vd.detach().cpu().numpy()
    out = np.zeros(n, dtype=vd.dtype)
    valid = g >= 0
    out[g[valid]] = vd[valid]
    return out


# ---------------------------------------------------------------------- #
# the distributed SpMV body (shared by make_spmv and the solvers)
# ---------------------------------------------------------------------- #
def _check_index_widths(plan: SpMVPlan, fmt: ShardFormat, nl: int,
                        has_halo: bool) -> None:
    """Raise ``ValueError`` unless every column index of the format's
    streams lies inside the buffer it reads: ``[0, nl)`` for ``x_local``,
    ``[0, g_pad + 1)`` for ``x_ghost`` (read only with a halo).  One
    min/max per stream, on the host, when a body binds the plan."""
    for st in fmt.index_streams():
        if st.x == "ghost" and not has_halo:
            continue
        cols = plan.fmt_data[st.cols]
        if cols.numel() == 0:
            continue
        width = nl if st.x == "local" else plan.g_pad + 1
        lo, hi = (int(v) for v in torch.aminmax(cols))
        if lo < 0 or hi >= width:
            raise ValueError(
                f"{fmt.name} plan: {st.cols!r} indices span [{lo}, {hi}] "
                f"but x_{st.x} holds {width} entries; the kernel would read "
                "outside it")


def make_shard_body(plan: SpMVPlan,
                    transport: str | HaloTransport | None = None,
                    neighbor_offsets: list[int] | None = None,
                    wire_dtype: str | None = None,
                    backend: str = "kernel"):
    """Build the two-phase SpMV over the whole virtual mesh:
    ``body(x) -> y``, ``x`` in ``plan.x_shape`` ``(n_node, n_core,
    cc_pad)`` and ``y`` in ``plan.cg_shape`` ``(n_node, n_core,
    rc_pad)``.

    1. halo exchange through the transport (skipped for halo-free plans,
       ``plan.hs == 0``) -> ``x_ghost`` ``(n_node, g_pad + 1)``;
    2. the core-axis gather of each node's slice -> ``x_local``
       ``(n_node, nl_pad)``;
    3. the format's local diag + offd matvec over all shards, through the
       kernel wrappers (``backend="kernel"``: the CUDA kernels on the
       card, their plain versions on the CPU) or the plain versions
       everywhere (``backend="plain"``, the yardstick).

    That order, with one fused launch, is the ``vector`` mode's schedule
    and every mode's on the virtual mesh and on halo-free plans.  On a
    rank-local plan with a halo, ``task`` and ``balanced`` overlap the
    exchange with the diag pass: ``start`` the exchange (it needs only
    this rank's own shard, not the core gather), gather ``x_local``,
    launch the diag pass, ``finish`` the exchange (waits, decodes,
    assembles the ghosts), launch the offd pass onto the diag partial
    (``ShardFormat.matvec_diag`` / ``matvec_offd_onto``).  Its ``y`` is
    the fused launch's bit for bit.  ``body.schedule`` lists the call's
    steps in order, ``(verb, what)`` with verb ``issue`` / ``wait`` /
    ``launch``, fixed when the body is bound; a collective issued in the
    call and never waited raises.

    A batch of right-hand sides, ``x`` ``(nrhs, n_node, n_core, cc_pad)``,
    runs as one: one exchange over the batch, one gather and one launch of
    the batched kernel for all ``nrhs`` columns (the JAX package's body
    under ``vmap``), ``y`` ``(nrhs, n_node, n_core, rc_pad)``.  Column
    ``j`` of ``y`` is ``body(x[j])`` bit for bit.  A batch of one runs the
    single-column kernels.

    ``transport=None`` follows ``plan.transport``, ``wire_dtype=None``
    follows ``plan.wire_dtype``; ``neighbor_offsets`` overrides the
    offsets ring/pairwise derive from the plan.  Names and overrides are
    validated here, up front; ``"auto"`` is refused (``make_spmv`` and
    ``make_solver`` resolve it).  The format's column indices are checked
    here too, once on the host: each must lie inside the buffer it reads
    (``x_local``'s ``nl_pad`` entries, ``x_ghost``'s ``g_pad + 1``), since
    the kernels do no bounds checks.

    On a rank-local plan (``plan.mesh`` a process mesh) the body runs on
    the rank's shard, ``x`` ``(1, 1, cc_pad)`` -> ``y`` ``(1, 1,
    rc_pad)``, with the same single-shard launches and the collectives as
    ``torch.distributed`` calls.  The body carries ``body.transport`` and
    ``body.wire_dtype`` (resolved names), ``body.extra`` (the transport's
    device index tensors), ``body.schedule`` and ``body.inputs(x) ->
    (x_local, x_ghost)``: steps 1-2 alone (in ``vector``'s order), what
    the local matvec gets.
    """
    # the node extent the plan's tensors hold: 1 on a rank-local plan
    n_node, rc_pad = plan.shard_shape[0], plan.rc_pad
    cc_pad, g_pad, mesh = plan.cc_pad, plan.g_pad, plan.mesh
    has_halo = plan.hs > 0
    transport = transport if transport is not None else plan.transport
    if transport == "auto":
        raise ValueError("transport='auto' is resolved by make_spmv/"
                         "make_solver (it times the candidates on the "
                         "plan's device); make_shard_body takes a concrete "
                         "transport")
    tr, tstate = resolve_transport(transport, plan,
                                   neighbor_offsets=neighbor_offsets,
                                   wire_dtype=wire_dtype)
    extra = tr.extra_arrays(plan, tstate) if has_halo else {}
    fmt = get_format(plan.format)
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got "
                         f"{backend!r}")
    _check_index_widths(plan, fmt, plan.x_gather.shape[-1], has_halo)
    if backend == "kernel":
        local_matvec = fmt.matvec_kernel
        fmt.check_kernel_layout(plan.fmt_data)
    else:
        local_matvec = fmt.matvec_plain
    F = dict(plan.fmt_data, send_own=plan.send_own, recv_own=plan.recv_own,
             **extra, **plan.plain_pad)
    # x_gather is replicated over the core axis: one row per node, int64
    # and offset into the node's flattened (n_core * cc_pad) input view
    x_gather = plan.x_gather[:, 0, :].long()

    def exchange(x: torch.Tensor):
        return tr.start(x, F, state=tstate, n_node=n_node, g_pad=g_pad)

    def local_x(x: torch.Tensor) -> torch.Tensor:
        """The core-axis all_gather of each node's slice, then the
        ``x_gather`` index: ``x_local``."""
        x_bins = all_gather(x, "core", lead=x.dim() - 3, mesh=mesh)
        flat = x_bins.reshape(x.shape[:-3] + (n_node, plan.n_core * cc_pad))
        idx = x_gather.expand(flat.shape[:-2] + x_gather.shape)
        return torch.gather(flat, flat.dim() - 1, idx)

    def inputs(x: torch.Tensor):
        """Steps 1-2: ``(x_local, x_ghost)`` for the local matvec, each
        with ``x``'s leading batch axis if it has one."""
        x_ghost = exchange(x).finish() if has_halo else None
        return local_x(x), x_ghost

    def fused(x: torch.Tensor) -> torch.Tensor:
        return local_matvec(F, *inputs(x), rc_pad)

    def overlapped(x: torch.Tensor) -> torch.Tensor:
        pending = exchange(x)
        y = fmt.matvec_diag(F, local_x(x), rc_pad, backend)
        return fmt.matvec_offd_onto(F, y, pending.finish(), rc_pad, backend)

    overlap = (has_halo and plan.is_rank_local
               and plan.mode in OVERLAPPED_MODES)
    run = overlapped if overlap else fused
    gather_x = (("issue", "gather x"), ("wait", "gather x"))
    if overlap:
        schedule = (("issue", "exchange"), *gather_x, ("launch", "diag"),
                    ("wait", "exchange"), ("launch", "offd"))
    elif has_halo:
        schedule = (("issue", "exchange"), ("wait", "exchange"), *gather_x,
                    ("launch", "fused"))
    else:
        schedule = (*gather_x, ("launch", "diag"))

    def body(x: torch.Tensor) -> torch.Tensor:
        if x.dim() == 4 and x.shape[0] == 1:
            return body(x[0])[None]
        since = open_handles()
        y = run(x)
        check_waited(since, "shard body")
        return y

    body.inputs = inputs
    body.schedule = schedule
    body.transport = tr.name
    body.wire_dtype = tstate["wire_codec"].name
    body.extra = extra
    return body


def make_spmv(plan: SpMVPlan,
              transport: str | HaloTransport | None = None,
              neighbor_offsets: list[int] | None = None,
              wire_dtype: str | None = None):
    """The distributed SpMV ``plan.x_shape -> plan.cg_shape`` on the
    plan's device.

    ``transport`` selects the halo exchange by name (``None`` follows the
    plan's stamp); ``"auto"`` runs ``autotune_transport`` on the plan's
    device, stamps the winner into the plan and returns the winner's SpMV.
    ``wire_dtype`` selects the halo wire codec (``None`` follows
    ``plan.wire_dtype``).  Carries ``spmv.transport`` /
    ``spmv.wire_dtype`` (the resolved names) and the body's
    ``spmv.schedule``."""
    transport = transport if transport is not None else plan.transport
    if transport == "auto":     # explicit, or a deferred plan stamp
        from repro_torch.core.transport import autotune_transport
        return autotune_transport(plan, neighbor_offsets=neighbor_offsets,
                                  wire_dtype=wire_dtype).spmv
    body = make_shard_body(plan, transport=transport,
                           neighbor_offsets=neighbor_offsets,
                           wire_dtype=wire_dtype)

    def spmv(xd: torch.Tensor) -> torch.Tensor:
        if tuple(xd.shape) != plan.x_shape:
            raise ValueError(f"spmv: expected {plan.x_shape}, got "
                             f"{tuple(xd.shape)}")
        return body(xd)

    spmv.transport = body.transport
    spmv.wire_dtype = body.wire_dtype
    spmv.schedule = body.schedule
    return spmv
