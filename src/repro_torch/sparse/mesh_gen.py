"""Benchmark-matrix generation — the Fluidity analogue.

The paper benchmarks pressure-solve matrices extracted from a global
baroclinic ocean simulation: a two-dimensional unstructured coastline mesh
extruded vertically with constant spacing; changing the vertical resolution
scales the problem size quasi-linearly (Sec. 3).

We reproduce that construction: a pseudo-coastline 2-D point cloud is
Delaunay-triangulated and extruded into ``layers`` sheets; the pressure
matrix is the graph Laplacian of the extruded mesh (plus a mass shift to make
it strictly SPD), which has the same stencil character (~7–30 nnz/row,
banded under extrusion-major ordering) as the paper's matrices.
"""
from __future__ import annotations

import numpy as np

from repro_torch.sparse.csr import CSRMatrix

__all__ = ["extruded_mesh_matrix", "graded_extruded_mesh_matrix",
           "random_spd_matrix", "surface_mesh_edges"]


def _coastline_points(n_surface: int, seed: int) -> np.ndarray:
    """Pseudo-coastline domain: an annulus-ish blob with ragged boundary,
    filled with quasi-uniform random interior points."""
    rng = np.random.default_rng(seed)
    # ragged boundary radius r(theta) — low-order Fourier coastline
    k = np.arange(1, 6)
    amp = rng.uniform(-0.08, 0.08, size=5)
    phase = rng.uniform(0, 2 * np.pi, size=5)

    def radius(theta):
        return 1.0 + (amp[None, :] * np.sin(np.outer(theta, k) + phase)).sum(-1)

    pts = []
    while len(pts) < n_surface:
        cand = rng.uniform(-1.2, 1.2, size=(n_surface * 2, 2))
        r = np.linalg.norm(cand, axis=1)
        th = np.arctan2(cand[:, 1], cand[:, 0])
        keep = cand[r <= radius(th)]
        pts.extend(keep.tolist())
    return np.asarray(pts[:n_surface])


def surface_mesh_edges(n_surface: int, seed: int = 0) -> tuple[np.ndarray, int]:
    """Delaunay-triangulate the coastline cloud; return unique edges.

    Vertices are renumbered with reverse Cuthill-McKee so the matrix is
    banded — matching Fluidity's locality-aware numbering (and what makes
    contiguous partitions exchange only with O(1) neighbours)."""
    from scipy.sparse import coo_matrix
    from scipy.sparse.csgraph import reverse_cuthill_mckee
    from scipy.spatial import Delaunay  # host-side only

    pts = _coastline_points(n_surface, seed)
    tri = Delaunay(pts)
    e = np.concatenate([tri.simplices[:, [0, 1]],
                        tri.simplices[:, [1, 2]],
                        tri.simplices[:, [0, 2]]], axis=0)
    e.sort(axis=1)
    e = np.unique(e, axis=0)
    n = len(pts)
    adj = coo_matrix((np.ones(2 * len(e)),
                      (np.concatenate([e[:, 0], e[:, 1]]),
                       np.concatenate([e[:, 1], e[:, 0]]))),
                     shape=(n, n)).tocsr()
    perm = reverse_cuthill_mckee(adj, symmetric_mode=True)
    inv = np.empty(n, dtype=np.int64)
    inv[perm] = np.arange(n)
    e = inv[e]
    e.sort(axis=1)
    return e, n


def _laplacian_spd(rows: np.ndarray, cols: np.ndarray, vals: np.ndarray,
                   n: int, shift: float) -> CSRMatrix:
    """Graph Laplacian from symmetric off-diagonal COO entries: diagonal =
    -sum of off-diagonals per row, plus an SPD shift."""
    diag = np.zeros(n)
    np.add.at(diag, rows, -vals)
    rows = np.concatenate([rows, np.arange(n)])
    cols = np.concatenate([cols, np.arange(n)])
    vals = np.concatenate([vals, diag + shift])
    return CSRMatrix.from_coo(rows, cols, vals, (n, n))


def extruded_mesh_matrix(n_surface: int, layers: int, seed: int = 0,
                         shift: float = 1e-3) -> CSRMatrix:
    """SPD pressure-matrix analogue on an extruded unstructured mesh.

    Node ordering is extrusion-major (all layers of a surface node are
    contiguous), matching Fluidity's vertical-column layout and giving the
    banded structure the paper's matrices have.  ``layers`` plays the role of
    the vertical resolution used in the paper to scale workload (Fig. 4 uses
    4x the layers of Fig. 3).
    """
    edges2d, n2d = surface_mesh_edges(n_surface, seed)
    L = layers
    n = n2d * L

    rows, cols, vals = [], [], []

    def add_edge(i, j, w):
        rows.extend([i, j])
        cols.extend([j, i])
        vals.extend([-w, -w])

    rng = np.random.default_rng(seed + 1)
    # horizontal (in-layer) edges, replicated per layer
    w_h = rng.uniform(0.5, 1.5, size=len(edges2d))
    for ell in range(L):
        base = ell
        for (a, b), w in zip(edges2d, w_h):
            add_edge(a * L + base, b * L + base, w)
    # vertical (extrusion) edges within each column
    for v in range(n2d):
        for ell in range(L - 1):
            add_edge(v * L + ell, v * L + ell + 1, 1.0)

    return _laplacian_spd(np.asarray(rows), np.asarray(cols),
                          np.asarray(vals, dtype=np.float64), n, shift)


def graded_extruded_mesh_matrix(n_surface: int, layers: int, seed: int = 0,
                                shift: float = 1e-3,
                                max_span: int | None = None) -> CSRMatrix:
    """Skewed pressure-matrix analogue: graded/refined vertical extrusion.

    The adapted-mesh Fluidity scenario the paper alludes to: mesh adaptivity
    concentrates resolution, so row density varies wildly across the domain
    instead of being near-uniform.  We model it with a *graded vertical
    stencil*: surface column ``v`` couples layer ``ell`` to layers
    ``ell +- 1 .. ell +- s_v`` where the span ``s_v`` grows **exponentially**
    across the (RCM-ordered, hence spatially coherent) surface index —
    ``s_v = round(max_span ** (v / (n2d-1)))`` — the wide-stencil /
    refined-column end of the domain.  Row nnz therefore varies
    exponentially from ``deg + 3`` to ``deg + 2*max_span + 1`` and the heavy
    rows are *contiguous in row index*, which is exactly the case where an
    equal-rows node split mis-sizes every shard's static shapes while the
    two-level nnz partition stays balanced.

    Same SPD graph-Laplacian construction, extrusion-major ordering and
    banded structure as ``extruded_mesh_matrix`` (``max_span`` defaults to
    ``min(layers - 1, 32)``); vertical weights fall off as ``1/d`` like a
    graded finite-difference stencil.
    """
    edges2d, n2d = surface_mesh_edges(n_surface, seed)
    L = layers
    n = n2d * L
    if max_span is None:
        max_span = min(max(L - 1, 1), 32)
    max_span = int(max(1, min(max_span, max(L - 1, 1))))

    # exponentially graded per-column span in [1, max_span]
    u = np.arange(n2d, dtype=np.float64) / max(n2d - 1, 1)
    span = np.clip(np.round(max_span ** u).astype(np.int64), 1,
                   max(L - 1, 1))

    rows_l: list[np.ndarray] = []
    cols_l: list[np.ndarray] = []
    vals_l: list[np.ndarray] = []

    def add_edges(i: np.ndarray, j: np.ndarray, w: np.ndarray):
        rows_l.append(np.concatenate([i, j]))
        cols_l.append(np.concatenate([j, i]))
        vals_l.append(np.concatenate([-w, -w]))

    rng = np.random.default_rng(seed + 1)
    # horizontal (in-layer) edges, replicated per layer
    w_h = rng.uniform(0.5, 1.5, size=len(edges2d))
    if len(edges2d):
        ells = np.arange(L, dtype=np.int64)
        a = (edges2d[:, 0, None] * L + ells[None, :]).ravel()
        b = (edges2d[:, 1, None] * L + ells[None, :]).ravel()
        add_edges(a, b, np.repeat(w_h, L))
    # graded vertical stencil: column v couples (ell, ell+d) for d <= s_v
    for d in range(1, max_span + 1):
        vs = np.flatnonzero(span >= d)
        if vs.size == 0 or L - d <= 0:
            continue
        ells = np.arange(L - d, dtype=np.int64)
        i = (vs[:, None] * L + ells[None, :]).ravel()
        add_edges(i, i + d, np.full(i.size, 1.0 / d))

    rows = np.concatenate(rows_l) if rows_l else np.zeros(0, np.int64)
    cols = np.concatenate(cols_l) if cols_l else np.zeros(0, np.int64)
    vals = np.concatenate(vals_l) if vals_l else np.zeros(0, np.float64)
    return _laplacian_spd(rows, cols, vals, n, shift)


def random_spd_matrix(n: int, nnz_per_row: int = 9, seed: int = 0,
                      dtype=np.float64) -> CSRMatrix:
    """Random diagonally-dominant SPD matrix (fast test fixture)."""
    rng = np.random.default_rng(seed)
    rows = np.repeat(np.arange(n), nnz_per_row - 1)
    cols = rng.integers(0, n, size=len(rows))
    keep = rows != cols
    rows, cols = rows[keep], cols[keep]
    vals = rng.uniform(-1.0, 0.0, size=len(rows))
    # symmetrise
    rows, cols = np.concatenate([rows, cols]), np.concatenate([cols, rows])
    vals = np.concatenate([vals, vals]) / 2.0
    diag_budget = np.zeros(n)
    np.add.at(diag_budget, rows, np.abs(vals))
    rows = np.concatenate([rows, np.arange(n)])
    cols = np.concatenate([cols, np.arange(n)])
    vals = np.concatenate([vals, diag_budget + rng.uniform(0.1, 1.0, n)])
    m = CSRMatrix.from_coo(rows, cols, vals.astype(dtype), (n, n))
    return m
