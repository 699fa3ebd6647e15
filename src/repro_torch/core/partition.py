"""Load balancing: greedy allocation + iterative local diffusion, two-level.

Sec. 2.3 of the paper: rows are divided between workers so that each worker
owns an approximately equal number of *non-zeros* rather than an equal number
of rows.  "The method ... starts with an initial greedy allocation, where each
worker thread receives a block of continuous rows.  This is followed by an
iterative local diffusion algorithm, which further balances the number of
non-zeros allocated to each thread."

The same scheme applies on *both* mesh axes (``partition_two_level``): first
rows are split over ``node`` (the MPI-rank analogue) on total row nnz, then
each node's block is split over ``core`` (the OpenMP-thread analogue).  The
node-level balance matters beyond thread idling: every static shape
(``rc_pad``, ``nl_pad``, ELL widths) is sized by the *heaviest* node, so an
unbalanced node axis inflates the padding every shard pays.
``node_partition="rows"`` keeps PETSc's equal-rows row distribution as the
pure-MPI baseline.

The partition is computed once on the host after assembly and cached with the
matrix (the stencil never changes during a solve), so its cost is irrelevant
to the steady-state SpMV rate.
"""
from __future__ import annotations

import numpy as np

__all__ = [
    "partition_equal_rows",
    "partition_greedy_nnz",
    "diffuse_nnz",
    "partition_balanced",
    "partition_two_level",
    "partition_stats",
    "imbalance",
    "NODE_PARTITIONS",
]

#: valid node-axis strategies for ``partition_two_level`` / ``build_spmv_plan``
NODE_PARTITIONS = ("rows", "nnz")


def partition_equal_rows(n_rows: int, nbins: int) -> np.ndarray:
    """Equal-rows partition — the `omp parallel for` / vector-mode analogue.

    Returns bounds (nbins+1,) with bounds[0]==0 and bounds[-1]==n_rows.
    """
    return np.linspace(0, n_rows, nbins + 1).round().astype(np.int64)


def partition_greedy_nnz(row_nnz: np.ndarray, nbins: int) -> np.ndarray:
    """Greedy contiguous allocation: advance each boundary until the
    cumulative nnz reaches the next multiple of total/nbins."""
    row_nnz = np.asarray(row_nnz, dtype=np.int64)
    n = len(row_nnz)
    cum = np.concatenate([[0], np.cumsum(row_nnz)])
    total = cum[-1]
    bounds = np.zeros(nbins + 1, dtype=np.int64)
    bounds[-1] = n
    for t in range(1, nbins):
        target = total * t / nbins
        # first row index where cumulative nnz >= target
        bounds[t] = np.searchsorted(cum, target, side="left")
    # enforce monotonicity (degenerate rows with zero nnz)
    bounds = np.maximum.accumulate(bounds)
    bounds = np.minimum(bounds, n)
    for t in range(1, nbins + 1):  # every bin keeps >= 0 rows; clamp order
        bounds[t] = max(bounds[t], bounds[t - 1])
    return bounds


def imbalance(row_nnz: np.ndarray, bounds: np.ndarray) -> float:
    """max/mean nnz per bin — 1.0 is perfect balance."""
    row_nnz = np.asarray(row_nnz, dtype=np.int64)
    loads = np.array([row_nnz[bounds[t]:bounds[t + 1]].sum()
                      for t in range(len(bounds) - 1)], dtype=np.float64)
    mean = loads.mean() if len(loads) else 1.0
    return float(loads.max() / mean) if mean > 0 else 1.0


def diffuse_nnz(row_nnz: np.ndarray, bounds: np.ndarray,
                max_sweeps: int = 100) -> np.ndarray:
    """Iterative local diffusion: for each interior boundary, shift it by one
    row towards the heavier neighbour while that reduces the pairwise
    |nnz_left - nnz_right| difference.  Converges to a local optimum of the
    pairwise imbalance; cheap because only boundary rows move.
    """
    row_nnz = np.asarray(row_nnz, dtype=np.int64)
    bounds = np.asarray(bounds, dtype=np.int64).copy()
    nbins = len(bounds) - 1
    loads = np.array([row_nnz[bounds[t]:bounds[t + 1]].sum()
                      for t in range(nbins)], dtype=np.int64)
    for _ in range(max_sweeps):
        moved = False
        for t in range(1, nbins):
            # boundary between bin t-1 and bin t sits at row bounds[t]
            while True:
                diff = loads[t - 1] - loads[t]
                if diff > 0 and bounds[t] > bounds[t - 1]:
                    # left heavier: move last row of bin t-1 into bin t
                    w = row_nnz[bounds[t] - 1]
                    if abs(diff - 2 * w) < abs(diff):
                        bounds[t] -= 1
                        loads[t - 1] -= w
                        loads[t] += w
                        moved = True
                        continue
                elif diff < 0 and bounds[t] < bounds[t + 1]:
                    # right heavier: move first row of bin t into bin t-1
                    w = row_nnz[bounds[t]]
                    if abs(diff + 2 * w) < abs(diff):
                        bounds[t] += 1
                        loads[t - 1] += w
                        loads[t] -= w
                        moved = True
                        continue
                break
        if not moved:
            break
    return bounds


def partition_balanced(row_nnz: np.ndarray, nbins: int,
                       max_sweeps: int = 100) -> np.ndarray:
    """The paper's full scheme: greedy + diffusion."""
    bounds = partition_greedy_nnz(row_nnz, nbins)
    return diffuse_nnz(row_nnz, bounds, max_sweeps=max_sweeps)


def partition_two_level(row_nnz: np.ndarray, n_node: int, n_core: int,
                        node_partition: str = "nnz",
                        core_partition: str = "nnz",
                        max_sweeps: int = 100
                        ) -> tuple[np.ndarray, list[np.ndarray]]:
    """Hierarchical (node x core) partition of ``len(row_nnz)`` rows.

    Level 1 splits all rows over ``n_node`` bins; level 2 splits each node's
    block over ``n_core`` bins.  Each level independently uses either the
    equal-rows split (``"rows"``) or the paper's greedy+diffusion nnz balance
    (``"nnz"``).

    Returns ``(node_bounds, core_bounds)``: ``node_bounds`` is ``(n_node+1,)``
    global row boundaries; ``core_bounds[i]`` is ``(n_core+1,)`` *node-local*
    row boundaries of node ``i``.
    """
    row_nnz = np.asarray(row_nnz, dtype=np.int64)
    n = len(row_nnz)
    for name, val in (("node_partition", node_partition),
                      ("core_partition", core_partition)):
        if val not in NODE_PARTITIONS:
            raise ValueError(f"{name} must be one of {NODE_PARTITIONS}, "
                             f"got {val!r}")
    if node_partition == "nnz":
        node_bounds = partition_balanced(row_nnz, n_node,
                                         max_sweeps=max_sweeps)
    else:
        node_bounds = partition_equal_rows(n, n_node)
    core_bounds: list[np.ndarray] = []
    for i in range(n_node):
        lo, hi = int(node_bounds[i]), int(node_bounds[i + 1])
        if core_partition == "nnz":
            cb = partition_balanced(row_nnz[lo:hi], n_core,
                                    max_sweeps=max_sweeps)
        else:
            cb = partition_equal_rows(hi - lo, n_core)
        core_bounds.append(np.asarray(cb, dtype=np.int64))
    return node_bounds, core_bounds


def partition_stats(row_nnz: np.ndarray, node_bounds: np.ndarray,
                    core_bounds: list[np.ndarray]) -> dict:
    """Per-axis imbalance of a two-level partition.

    ``node_imbalance``: max/mean nnz over node bins; ``core_imbalance``:
    max/mean nnz over all (node, core) shards — both 1.0 when perfect.  The
    shard-level number is what sizes ``rc_pad`` (and hence padding waste),
    since every shard is padded to the heaviest one.
    """
    row_nnz = np.asarray(row_nnz, dtype=np.int64)
    # flatten the two levels into one global shard partition and reuse
    # imbalance() for the shard-level number
    shard_bounds = np.concatenate(
        [[0]] + [np.asarray(core_bounds[i], dtype=np.int64)[1:]
                 + int(node_bounds[i])
                 for i in range(len(node_bounds) - 1)])
    return {
        "node_imbalance": imbalance(row_nnz, node_bounds),
        "core_imbalance": imbalance(row_nnz, shard_bounds),
    }
