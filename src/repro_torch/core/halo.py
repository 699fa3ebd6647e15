"""Halo exchange plan — the PETSc ``VecScatter`` analogue.

PETSc's MPIAIJ SpMV gathers remote input-vector elements ("ghosts") while the
diagonal block multiplies local elements.  Here the gather becomes a single
``all_to_all`` over the ``node`` axis (on one card: an index permutation of
the node axis, ``repro_torch.core.transport``) driven by a *static* plan
computed on the host at matrix-assembly time — mirroring the paper's
observation that the stencil is fixed for the whole solve, so the plan is a
one-off cost cached with the matrix.

The plan is *hierarchical* and **owner-split**: each halo element is sent by
the core whose row bin owns it, indexed directly into that core's
``(rc_pad,)`` shard of the vector.  The exchange therefore launches straight
from per-core shard data — it does not wait for the intra-node ``all_gather``
that assembles the node-local vector slice (the paper's task-mode
comm/compute overlap).  On the receive side every core scatters
only its own ``(n_node, hs)`` slice into the ghost buffer; the per-core
partial buffers are combined with one intra-node gather + add instead of
``all_gather``-ing a full per-node receive table.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.util import align_up

__all__ = ["HaloPlan", "build_halo_plan", "pair_traffic",
           "populated_offsets", "ghost_writer_counts"]


def pair_traffic(recv_own: np.ndarray, g_pad: int) -> np.ndarray:
    """(n_node, n_node) bool: does node ``dst`` receive halo data from
    ``src``?  Derived purely from the receive table — a slot below the
    ``g_pad`` dump slot means a real element travels on that pair — so
    every ``HaloTransport`` can recover the neighbour structure from plan
    arrays alone, with no side-channel layout dict."""
    recv_own = np.asarray(recv_own)
    if recv_own.shape[-1] == 0:
        return np.zeros((recv_own.shape[0], recv_own.shape[0]), dtype=bool)
    return (recv_own < g_pad).any(axis=(1, 3))


def ghost_writer_counts(recv_own: np.ndarray, g_pad: int) -> np.ndarray:
    """(n_node, g_pad) int: how many (core, src, k) receive-table entries
    write each *real* ghost slot of each destination node.

    The single-writer invariant — every real slot written exactly once
    across the whole receive table — is what lets the ghost assembly be a
    gather + local add instead of an all-reduce (``_gather_add`` in
    ``repro_torch.core.transport``): the add only ever combines one value
    with zeros.  A slot with two writers is a race whose outcome depends on
    scatter ordering.  Writes to the dump slot ``g_pad`` are
    excluded — it is write-only garbage by contract.
    """
    recv_own = np.asarray(recv_own)
    n_node = recv_own.shape[0]
    counts = np.zeros((n_node, max(g_pad, 1)), dtype=np.int64)
    if g_pad == 0 or recv_own.shape[-1] == 0:
        return counts[:, :g_pad]
    for dst in range(n_node):
        slots = recv_own[dst].reshape(-1)
        counts[dst] = np.bincount(slots[slots < g_pad],
                                  minlength=g_pad)[:g_pad]
    return counts[:, :g_pad]


def populated_offsets(traffic: np.ndarray) -> list[int]:
    """Sorted ``(dst - src) mod n_node`` offsets that carry halo traffic."""
    n_node = traffic.shape[0]
    return sorted({int((dst - src) % n_node)
                   for dst, src in zip(*np.nonzero(traffic))})


@dataclasses.dataclass
class HaloPlan:
    """Static (numpy) exchange plan for one matrix + node/core partition.

    Shapes (host arrays, later stacked / device-put by the SpMV plan):
      send_own:   (n_node, n_core, n_node, Hs) int32
                  [src, core, dst, k] -> row index *into core's own
                  (rc_pad,) vector shard* to send (owner split; pad -> 0)
      recv_own:   (n_node, n_core, n_node, Hs) int32
                  [dst, core, src, k] -> ghost-buffer slot for the element
                  owned by ``core`` at ``src`` (G_pad = dump slot)
      ghost_cols: list of (G_i,) global column ids per node (diagnostics)
    """

    send_own: np.ndarray
    recv_own: np.ndarray
    ghost_cols: list[np.ndarray]
    g_pad: int
    h_own: int

    @property
    def n_node(self) -> int:
        return self.send_own.shape[0]

    @property
    def n_core(self) -> int:
        return self.send_own.shape[1]

    @property
    def total_ghosts(self) -> int:
        return int(sum(len(g) for g in self.ghost_cols))

    def comm_bytes_per_node(self, itemsize: int = 4) -> float:
        """Mean halo traffic per node per SpMV (diagnostics / roofline)."""
        return self.total_ghosts * itemsize / max(self.n_node, 1)

    def pair_traffic(self) -> np.ndarray:
        """(n_node, n_node) bool communicating-pair table (dst, src)."""
        return pair_traffic(self.recv_own, self.g_pad)

    def neighbor_offsets(self) -> list[int]:
        """Populated ``(dst - src) mod n_node`` offsets (ring/pairwise)."""
        return populated_offsets(self.pair_traffic())


def build_halo_plan(ghost_cols: list[np.ndarray], node_bounds: np.ndarray,
                    n_core: int, core_bounds: list[np.ndarray],
                    h_align: int = 8) -> HaloPlan:
    """Build the static owner-split exchange plan.

    ghost_cols[i]:  sorted global column ids node ``i`` needs but does not own.
    node_bounds:    (n_node+1,) row ownership boundaries.  May be
                    **non-uniform** (two-level nnz-balanced node splits);
                    ownership is always resolved by ``searchsorted`` against
                    these bounds, never by dividing row ids by a block size.
    core_bounds[i]: (n_core+1,) node-local row bounds of node ``i``'s core
                    bins.  Required: ``send_own`` indexes each core's own
                    vector shard, so the plan is only correct for the exact
                    core split the vectors are laid out with (an assumed
                    default would silently read the wrong rows for
                    nnz-balanced bins).
    """
    node_bounds = np.asarray(node_bounds, dtype=np.int64)
    n_node = len(node_bounds) - 1
    if np.any(np.diff(node_bounds) < 0):
        raise ValueError("node_bounds must be non-decreasing")
    if len(core_bounds) != n_node:
        raise ValueError(f"core_bounds must have one entry per node "
                         f"({n_node}), got {len(core_bounds)}")
    for i, cb in enumerate(core_bounds):
        cb = np.asarray(cb)
        nl = int(node_bounds[i + 1] - node_bounds[i])
        if int(cb[0]) != 0 or int(cb[-1]) != nl:
            raise ValueError(f"core_bounds[{i}] must cover [0, {nl}], got "
                             f"[{int(cb[0])}, {int(cb[-1])}]")

    # per-(dst, src) halo lists: entries of ghost_cols[dst] owned by src,
    # grouped by the src core whose row bin owns them
    pair_cols: dict[tuple[int, int], np.ndarray] = {}
    owner_core: dict[tuple[int, int], np.ndarray] = {}
    bin_local: dict[tuple[int, int], np.ndarray] = {}
    hs = 0
    for dst in range(n_node):
        g = np.asarray(ghost_cols[dst], dtype=np.int64)
        owner = np.searchsorted(node_bounds, g, side="right") - 1
        for src in range(n_node):
            sel = g[owner == src]                 # global ids, sorted
            if len(sel) == 0:
                continue
            pair_cols[(dst, src)] = sel
            src_local = sel - node_bounds[src]
            cb = np.asarray(core_bounds[src], dtype=np.int64)
            oc = np.searchsorted(cb, src_local, side="right") - 1
            owner_core[(dst, src)] = oc
            bin_local[(dst, src)] = src_local - cb[oc]
            hs = max(hs, int(np.bincount(oc, minlength=n_core).max()))
    # a matrix with no halo traffic at all (single node, or block-diagonal
    # under this partition) gets hs == g_pad == 0: the shard body skips the
    # exchange and the ghost phase entirely rather than shuttling dead
    # padding through the collectives
    hs = align_up(hs, h_align) if hs else 0
    n_ghost = max((len(g) for g in ghost_cols), default=0)
    g_pad = align_up(n_ghost, 8) if n_ghost else 0

    send_own = np.zeros((n_node, n_core, n_node, hs), dtype=np.int32)
    recv_own = np.full((n_node, n_core, n_node, hs), g_pad, dtype=np.int32)
    for (dst, src), sel in pair_cols.items():
        g = np.asarray(ghost_cols[dst], dtype=np.int64)
        oc = owner_core[(dst, src)]
        bl = bin_local[(dst, src)]
        slot = np.searchsorted(g, sel).astype(np.int32)
        for c in range(n_core):
            mine = oc == c
            k = int(mine.sum())
            if k == 0:
                continue
            send_own[src, c, dst, :k] = bl[mine]
            recv_own[dst, c, src, :k] = slot[mine]

    return HaloPlan(send_own=send_own, recv_own=recv_own,
                    ghost_cols=[np.asarray(g) for g in ghost_cols],
                    g_pad=g_pad, h_own=hs)
