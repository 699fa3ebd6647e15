"""The paper's pressure operator in its adapted-mesh form (arXiv:1303.5275,
Sec. 3): a 2-D pseudo-coastline mesh, Delaunay-triangulated, numbered by
reverse Cuthill-McKee and extruded into ``layers`` sheets with a graded
vertical stencil whose span grows exponentially across the surface index.

A frozen copy of ``repro_torch.sparse.graded_extruded_mesh_matrix``
(``_coastline_points``, ``surface_mesh_edges`` and the graded extrusion's
entries, arithmetic for arithmetic), so that a later change to the program
cannot move the benchmark's operator.  Only the assembly differs: the
entries are written straight into their CSR slots, where the program
builds COO triplets and sorts them.  ``indptr`` and ``indices`` come out
equal to the program's and ``data`` equal to float64 rounding (the
diagonal sums its row in column order), as
``tests/test_perfbench_operators.py`` checks.
"""
from __future__ import annotations

import numpy as np

from perfbench.operators import Operator

__all__ = ["make", "surface_mesh_edges"]

#: slow enough to keep once made (``perfbench.operators.generate``)
CACHE = True


def _coastline_points(n_surface: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
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
    """Unique edges of the Delaunay-triangulated coastline cloud, vertices
    renumbered by reverse Cuthill-McKee."""
    from scipy.sparse import coo_matrix
    from scipy.sparse.csgraph import reverse_cuthill_mckee
    from scipy.spatial import Delaunay

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


def make(n_surface: int, layers: int, seed: int = 0, shift: float = 1e-3,
         max_span: int | None = None) -> Operator:
    """The SPD graph Laplacian (plus ``shift`` on the diagonal) of the
    graded extruded mesh, extrusion-major: all layers of a surface node
    are contiguous rows.  Row nnz runs from ``deg + 3`` to ``deg + 2 *
    max_span + 1``, the heavy rows contiguous at the end.

    Assembled straight into CSR: row ``r = a * L + ell`` holds, in column
    order, the horizontal neighbours ``b < a`` (column ``b * L + ell``),
    the vertical band ``r - lo .. r + hi`` with the diagonal in it, and the
    neighbours ``b > a``."""
    edges2d, n2d = surface_mesh_edges(n_surface, seed)
    L = layers
    n = n2d * L
    if max_span is None:
        max_span = min(max(L - 1, 1), 32)
    max_span = int(max(1, min(max_span, max(L - 1, 1))))
    u = np.arange(n2d, dtype=np.float64) / max(n2d - 1, 1)
    span = np.clip(np.round(max_span ** u).astype(np.int64), 1,
                   max(L - 1, 1))
    rng = np.random.default_rng(seed + 1)
    w_h = rng.uniform(0.5, 1.5, size=len(edges2d))

    # each node's horizontal neighbours, ascending, with their weights
    src = np.concatenate([edges2d[:, 0], edges2d[:, 1]])
    dst = np.concatenate([edges2d[:, 1], edges2d[:, 0]])
    w = np.concatenate([w_h, w_h])
    order = np.argsort(src * n2d + dst, kind="stable")
    src, dst, w = src[order], dst[order], w[order]
    deg = np.bincount(src, minlength=n2d)
    start = np.zeros(n2d + 1, dtype=np.int64)
    np.cumsum(deg, out=start[1:])
    k = np.arange(len(src)) - start[src]            # rank in its list
    n_left = np.bincount(src[dst < src], minlength=n2d)

    ell = np.arange(L, dtype=np.int64)
    lo = np.minimum(span[:, None], ell[None, :])             # (n2d, L)
    hi = np.minimum(span[:, None], L - 1 - ell[None, :])
    indptr = np.zeros(n + 1, dtype=np.int64)
    np.cumsum((deg[:, None] + lo + hi + 1).ravel(), out=indptr[1:])
    band = indptr[:-1].reshape(n2d, L) + n_left[:, None] + lo   # diag slot
    indices = np.empty(indptr[-1], dtype=np.int64)
    data = np.empty(indptr[-1], dtype=np.float64)

    # horizontal: after the band for b > a
    pos = indptr[:-1].reshape(n2d, L)[src] + k[:, None]
    right = (dst > src)[:, None]
    pos += np.where(right, lo[src] + hi[src] + 1, 0)
    indices[pos] = dst[:, None] * L + ell[None, :]
    data[pos] = -w[:, None]
    del pos, right
    # the vertical band, d = -hi .. hi around the diagonal
    for d in range(1, max_span + 1):
        vs = np.flatnonzero(span >= d)
        if vs.size == 0 or L - d <= 0:
            continue
        e = np.arange(L - d, dtype=np.int64)
        r = (vs[:, None] * L + e[None, :])
        up = band[vs][:, :L - d] + d            # row r, column r + d
        down = band[vs][:, d:] - d              # row r + d, column r
        indices[up], indices[down] = r + d, r
        data[up] = data[down] = -1.0 / d
    diag = band.ravel()
    indices[diag] = np.arange(n, dtype=np.int64)
    data[diag] = 0.0
    data[diag] = -np.add.reduceat(data, indptr[:-1]) + shift
    return Operator(indptr=indptr, indices=indices, data=data)
