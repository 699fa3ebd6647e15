"""Preconditioner registry: ``none``, ``jacobi``, ``block_jacobi``,
``two_level``.

A preconditioner has two lives:

  * **build time** (host, once per plan): ``bind(plan, layout, A,
    options=...)`` turns whatever host-side information it needs into
    ``(pdata, apply_fn)`` — a dict of tensors with leading ``(n_node,
    n_core)`` shard dims on the plan's device, plus the apply function
    (for simple preconditioners ``bind`` pairs ``build`` with ``apply``);
  * **solve time** (device, per iteration): ``apply_fn(pdata, r)`` maps
    the residual block ``(nrhs, n_node, n_core, rc_pad)`` to
    ``z = M^-1 r``.  Preconditioners declaring ``local_only=True`` touch
    only each shard's own slice — the PETSc block-Jacobi design point
    (PCBJACOBI applies one local solve per process and lets the Krylov
    loop do all the talking).  Non-local preconditioners (``two_level``)
    declare ``local_only=False`` plus ``reductions_per_apply``: the number
    of cross-shard reductions one apply issues, which the solvers'
    reduction census (``repro_torch.solvers.base.reduction_census``)
    counts in its loop body, so the census extends instead of breaking.

``jacobi``       1/diag(A), the paper's Sec. 3 preconditioner.
``block_jacobi`` each core's diagonal block — the rows this core's bin owns
                 restricted to its own columns — is extracted on the host,
                 densified, inverted in f64, and applied as one small
                 dense product per shard.  Strictly stronger than
                 ``jacobi`` at zero extra communication; the analogue of
                 PETSc's PCBJACOBI at subdomain size = core bin.
``two_level``    additive-Schwarz two-level: M⁻¹ = B_smoother +
                 P·A_c⁻¹·R with an unsmoothed-aggregation 0/1 restriction
                 R (contiguous aggregates of ``agg_size`` rows — vertical
                 mesh columns under the extrusion-major ordering),
                 prolongation P = Rᵀ, and the Galerkin coarse operator
                 A_c = R·A·P assembled and inverted in f64 on the host and
                 solved redundantly.  R and P run as **rectangular SpMV
                 plans through the same shard body and kernels** as A,
                 their shared spaces pinned to A's exact slot layout; the
                 coarse residual is replicated by the core- then node-axis
                 ``all_gather`` (views of the virtual mesh), so one apply
                 issues no reduction.
``none``         identity, for unpreconditioned baselines.

``host_apply`` returns a plain numpy ``(n,) -> (n,)`` application of the
same operator in *global* row ordering: for Chebyshev's host-side
eigenvalue estimate, and the oracle ``repro_torch.testing.precond_check``
holds every registered preconditioner against.  ``validate_options`` runs
before any autotune or build in ``make_solver``: an unknown option fails
fast, naming the valid ones.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from repro_torch.sparse.csr import CSRMatrix
from repro_torch.util import to_device

__all__ = ["jacobi_inverse", "jacobi_inverse_np", "Preconditioner",
           "NonePrecond", "JacobiPrecond", "BlockJacobiPrecond",
           "TwoLevelPrecond", "FaultyPrecond", "register_precond",
           "unregister_precond", "get_precond", "available_preconds"]


def jacobi_inverse(diag_a: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Safe 1/diag(A) on valid rows, 0 on padding (a zero diagonal entry
    under the mask gives 0, not ``inf``)."""
    valid = (mask > 0) & (diag_a != 0)
    return torch.where(valid, 1.0 / torch.where(valid, diag_a, 1.0), 0.0)


def jacobi_inverse_np(diag_a: np.ndarray) -> np.ndarray:
    """Numpy twin of :func:`jacobi_inverse` (host oracles, host_apply)."""
    d = np.asarray(diag_a, dtype=np.float64)
    valid = d != 0
    return np.where(valid, 1.0 / np.where(valid, d, 1.0), 0.0)


class Preconditioner:
    """Interface of a registered preconditioner (see module docstring)."""

    name: str = ""
    #: the PCBJACOBI design point as a checkable contract: ``apply`` reads
    #: and writes only each shard's own slice (``precond_check`` probes it)
    local_only: bool = True
    #: cross-shard reductions one apply issues; counted by the solvers'
    #: reduction census, so a composed preconditioner keeps it exact
    reductions_per_apply: int = 0
    #: option names ``validate_options`` accepts (default: none)
    valid_options: tuple[str, ...] = ()

    def validate_options(self, options: dict | None = None) -> dict:
        """Validate build options before any autotune or build: raises
        ``ValueError`` naming the valid options on an unknown key; returns
        the normalised option dict."""
        options = dict(options or {})
        unknown = sorted(set(options) - set(self.valid_options))
        if unknown:
            valid = list(self.valid_options) or "(none)"
            raise ValueError(
                f"{self.name or type(self).__name__}: unknown option(s) "
                f"{unknown}; valid options: {valid}")
        return options

    def build(self, plan, layout: dict | None = None, A=None
              ) -> dict[str, torch.Tensor]:
        """Host-side setup -> dict of ``(n_node, n_core, ...)`` tensors."""
        return {}

    def bind(self, plan, layout: dict | None = None, A=None, *,
             backend: str = "kernel", options: dict | None = None):
        """Host-side setup -> ``(pdata, apply_fn)``, what ``make_solver``
        runs.  Validates ``options``; the default pairs ``build`` with
        ``apply``.  ``backend`` is the shard body's (``"kernel"`` |
        ``"plain"``) for preconditioners that run SpMVs of their own."""
        self.validate_options(options)
        return self.build(plan, layout=layout, A=A), self.apply

    def apply(self, P: dict[str, torch.Tensor],
              r: torch.Tensor) -> torch.Tensor:
        """``z = M^-1 r`` on ``(nrhs, n_node, n_core, rc_pad)`` blocks."""
        raise NotImplementedError

    def host_apply(self, plan, layout: dict | None, A):
        """Numpy ``(n,) -> (n,)`` global-ordering application of M^-1."""
        raise NotImplementedError


class NonePrecond(Preconditioner):
    """Identity — unpreconditioned Krylov baselines."""

    name = "none"

    def apply(self, P, r):
        return r

    def host_apply(self, plan, layout, A):
        return lambda r: r


class JacobiPrecond(Preconditioner):
    """Point Jacobi: z = r / diag(A) (paper Sec. 3)."""

    name = "jacobi"

    def build(self, plan, layout=None, A=None):
        return {"m_inv": jacobi_inverse(plan.diag_a, plan.mask)}

    def apply(self, P, r):
        return P["m_inv"] * r      # (n_node, n_core, rc_pad) broadcasts

    def host_apply(self, plan, layout, A):
        inv = jacobi_inverse_np(A.diagonal())
        return lambda r: inv * r


def _core_block_inverses(layout: dict, A):
    """Dense f64 inverse of every core bin's diagonal block of ``A``.

    Yields ``(i, c, rows, inv)`` per non-empty bin: ``rows`` the bin's
    global row range (two-level partitions keep bins contiguous) and
    ``inv`` the inverse in ascending-global-row order.  Each block is a
    principal submatrix of A, so SPD inputs stay invertible.
    """
    if layout is None or A is None:
        raise ValueError("block_jacobi needs the host matrix and layout: "
                         "make_solver(..., A=A, layout=layout)")
    node_bounds = np.asarray(layout["node_bounds"], dtype=np.int64)
    for i, cb in enumerate(layout["core_bounds"]):
        lo = int(node_bounds[i])
        for c in range(len(cb) - 1):
            blo, bhi = lo + int(cb[c]), lo + int(cb[c + 1])
            nb = bhi - blo
            if nb == 0:
                continue
            block = np.zeros((nb, nb))
            for bl in range(nb):
                s, e = A.indptr[blo + bl], A.indptr[blo + bl + 1]
                cols = A.indices[s:e]
                m = (cols >= blo) & (cols < bhi)
                block[bl, cols[m] - blo] += A.data[s:e][m]
            yield i, c, (blo, bhi), np.linalg.inv(block)


class BlockJacobiPrecond(Preconditioner):
    """Shard-local dense inverse of each core's diagonal block (PCBJACOBI).

    ``build`` stores ``binv`` as ``(n_node, n_core, rc_pad, rc_pad)`` in the
    plan's slot ordering (format row permutations folded in via
    ``layout["global_row_of"]``), rounded once from f64 to f32; padding
    rows and columns are zero, so padding slots stay exactly 0.  The apply
    is one batched dense product over the shards.
    """

    name = "block_jacobi"

    def build(self, plan, layout=None, A=None):
        g_of = np.asarray(layout["global_row_of"]) if layout else None
        binv = np.zeros((plan.n_node, plan.n_core, plan.rc_pad, plan.rc_pad))
        for i, c, (blo, bhi), inv in _core_block_inverses(layout, A):
            slots = np.flatnonzero(g_of[i, c] >= 0)
            bl = g_of[i, c, slots] - blo      # bin-local row of each slot
            binv[i, c, slots[:, None], slots[None, :]] = inv[np.ix_(bl, bl)]
        return {"binv": to_device(binv, plan.device)}

    def apply(self, P, r):
        return torch.einsum("icjk,nick->nicj", P["binv"], r)

    def host_apply(self, plan, layout, A):
        blocks = [(rows, inv)
                  for _, _, rows, inv in _core_block_inverses(layout, A)]

        def apply(r):
            z = np.zeros_like(r, dtype=np.float64)
            for (blo, bhi), inv in blocks:
                z[blo:bhi] = inv @ r[blo:bhi]
            return z

        return apply


class TwoLevelPrecond(Preconditioner):
    """Two-level additive Schwarz: M⁻¹ = B_smoother + P·A_c⁻¹·R.

    R is unsmoothed aggregation — a 0/1 restriction summing contiguous
    runs of ``agg_size`` fine rows; P = Rᵀ.  Both run as **rectangular
    ELL plans through the same shard body and kernels** as A: R's column
    space and P's row space are pinned to A's exact row layout
    (``layout["row_space"]``, σ-permutations and all), and P's column
    space to R's row space so the coarse layouts coincide.  A_c = R·A·P is
    assembled on the host in f64 (Galerkin, SPD for SPD A since R has full
    row rank), inverted densely and rounded once to f32.

    One apply = smoother apply (shard-local) + R SpMV + the core- and
    node-axis ``all_gather`` of the coarse residual (a view of the virtual
    mesh) + the redundant coarse solve + P SpMV.  Every shard holds the
    same inverse and the same gathered residual, so the coarse product is
    made once and its result read by every shard: each shard's copy is the
    same bits.  Gathers only — **zero reductions**
    (``reductions_per_apply = 0``).

    Options: ``agg_size`` (int >= 2, default 16) — fine rows per
    aggregate; ``smoother`` — name of any registered *local*
    preconditioner (default ``block_jacobi``).
    """

    name = "two_level"
    local_only = False
    reductions_per_apply = 0
    valid_options = ("agg_size", "smoother")

    DEFAULT_AGG_SIZE = 16
    DEFAULT_SMOOTHER = "block_jacobi"

    def validate_options(self, options=None):
        opts = super().validate_options(options)
        agg = opts.setdefault("agg_size", self.DEFAULT_AGG_SIZE)
        if not isinstance(agg, (int, np.integer)) or isinstance(agg, bool) \
                or agg < 2:
            raise ValueError(f"two_level: agg_size must be an int >= 2, "
                             f"got {agg!r}")
        sm = opts.setdefault("smoother", self.DEFAULT_SMOOTHER)
        local = [p for p in available_preconds()
                 if _PRECONDS[p].local_only and p != self.name]
        if sm not in local:
            raise ValueError(f"two_level: smoother must be a registered "
                             f"local preconditioner, one of {local}; "
                             f"got {sm!r}")
        opts["agg_size"] = int(agg)
        return opts

    # ------------------------------------------------------------------ #
    @staticmethod
    def _aggregates(n: int, agg_size: int) -> tuple[np.ndarray, int]:
        agg_of = np.arange(n, dtype=np.int64) // agg_size
        return agg_of, int(agg_of[-1]) + 1

    @staticmethod
    def _galerkin_inverse(A, agg_of: np.ndarray, nc: int) -> np.ndarray:
        """Dense f64 (R A Rᵀ)⁻¹ — A_c[a, b] = Σ A[i, j] over aggregate
        pairs; SPD for SPD A, so the dense inverse is safe."""
        rows_of = np.repeat(np.arange(A.n_rows, dtype=np.int64), A.row_nnz)
        Ac = np.zeros((nc, nc))
        np.add.at(Ac, (agg_of[rows_of], agg_of[A.indices]),
                  A.data.astype(np.float64))
        return np.linalg.inv(Ac)

    def bind(self, plan, layout=None, A=None, *, backend="kernel",
             options=None):
        """``(pdata, apply_fn)``; ``apply_fn.host_seconds`` holds the
        seconds of each host step (smoother build, R and P plans,
        Galerkin inverse) and ``apply_fn.plans`` the R and P
        ``(plan, layout)`` pairs."""
        opts = self.validate_options(options)
        if layout is None or A is None:
            raise ValueError("two_level needs the host matrix and layout: "
                             "make_solver(..., A=A, layout=layout)")
        if plan.n_cols != plan.n:
            raise ValueError("two_level preconditions square operators; "
                             f"got plan shape ({plan.n}, {plan.n_cols})")
        # late import: solvers sits above core in the layering
        from repro_torch.core.spmv import build_spmv_plan, make_shard_body

        seconds = {}
        t0 = time.perf_counter()
        smoother = _PRECONDS[opts["smoother"]]
        pdata = dict(smoother.build(plan, layout=layout, A=A))
        seconds["smoother"] = time.perf_counter() - t0

        n, n_node, n_core = plan.n, plan.n_node, plan.n_core
        device = plan.device
        agg_of, nc = self._aggregates(n, opts["agg_size"])
        t0 = time.perf_counter()
        R = CSRMatrix.from_coo(agg_of, np.arange(n, dtype=np.int64),
                               np.ones(n, dtype=np.float64), (nc, n))
        # R: coarse rows freely partitioned, columns pinned to A's rows.
        # P = Rᵀ: rows pinned to A's rows (the apply's output layout),
        # columns pinned to R's rows (the shared coarse layout).
        plan_R, layout_R = build_spmv_plan(
            R, n_node, n_core, mode="balanced", node_partition="nnz",
            format="ell", transport="a2a", col_space=layout["row_space"],
            device=device)
        plan_P, layout_P = build_spmv_plan(
            R.transpose(), n_node, n_core, mode="balanced",
            node_partition="nnz", format="ell", transport="a2a",
            row_space=layout["row_space"], col_space=layout_R["row_space"],
            device=device)
        seconds["plans"] = time.perf_counter() - t0

        t0 = time.perf_counter()
        ainv = self._galerkin_inverse(A, agg_of, nc)
        # one f32 inverse on the card, every shard's copy a view of it
        pdata["ainv_c"] = to_device(ainv, device).expand(n_node, n_core,
                                                         nc, nc)
        seconds["galerkin"] = time.perf_counter() - t0

        # global coarse id -> flat slot of the core+node-gathered R output
        gR = np.asarray(layout_R["global_row_of"])
        ii, cc, ss = np.nonzero(gR >= 0)
        coarse_gather = np.zeros(nc, dtype=np.int64)
        coarse_gather[gR[ii, cc, ss]] = (ii * n_core + cc) * plan_R.rc_pad + ss
        pdata["coarse_gather"] = torch.from_numpy(coarse_gather).to(
            device).expand(n_node, n_core, nc)
        # per-shard map from the replicated coarse vector into P's input
        # (column-space) layout; padding slots read an appended zero
        gPc = np.asarray(layout_P["global_col_of"])
        pdata["p_col_map"] = torch.from_numpy(
            np.where(gPc >= 0, gPc, nc)).to(device)

        body_R = make_shard_body(plan_R, backend=backend)
        body_P = make_shard_body(plan_P, backend=backend)
        s_apply = smoother.apply

        def coarse_correction(P, r):
            # one batched R and P body for all columns of r
            k = r.shape[0]
            rc = body_R(r)                      # (k, n_node, n_core, rc_R)
            # the core- then node-axis all_gather: the flat view
            r_c = rc.reshape(k, -1)[:, P["coarse_gather"][0, 0]]  # (k, nc)
            ainv = P["ainv_c"][0, 0]
            # the redundant solve; each column's product reads only its own
            # residual, so the other columns do not move its bits
            y_c = (torch.mv(ainv, r_c[0])[None] if k == 1
                   else r_c @ ainv.T)
            y_ext = torch.cat([y_c, y_c.new_zeros(k, 1)], dim=1)
            return body_P(y_ext[:, P["p_col_map"]])  # (k, n_node, n_core, rc)

        def apply_fn(P, r):
            return s_apply(P, r) + coarse_correction(P, r)

        apply_fn.host_seconds = seconds
        apply_fn.plans = {"R": (plan_R, layout_R), "P": (plan_P, layout_P)}
        return pdata, apply_fn

    def host_apply(self, plan, layout, A, options: dict | None = None):
        opts = self.validate_options(options)
        smoother = _PRECONDS[opts["smoother"]].host_apply(plan, layout, A)
        agg_of, nc = self._aggregates(A.n_rows, opts["agg_size"])
        ainv = self._galerkin_inverse(A, agg_of, nc)

        def apply(r):
            z = np.asarray(smoother(r), dtype=np.float64)
            rc = np.bincount(agg_of, weights=np.asarray(r, np.float64),
                             minlength=nc)
            return z + (ainv @ rc)[agg_of]

        return apply


class FaultyPrecond(JacobiPrecond):
    """Deliberately broken preconditioner — **not** registered by default.

    Claims to be plain Jacobi (``local_only=True``, symmetric
    ``host_apply``) but its device ``apply`` negates the result, making
    M⁻¹ indefinite and device/host inconsistent.  Registering it must
    make ``repro_torch.testing.precond_check`` fail (``--include-faulty``
    exits 1): the proof the harness catches a broken registrant rather
    than trusting declarations.
    """

    name = "faulty"

    def apply(self, P, r):
        return -(P["m_inv"] * r)


# --------------------------------------------------------------------- #
# registry
# --------------------------------------------------------------------- #
_PRECONDS: dict[str, Preconditioner] = {}


def register_precond(pre: Preconditioner,
                     overwrite: bool = False) -> Preconditioner:
    """Register ``pre`` under ``pre.name`` for lookup by name."""
    if not pre.name:
        raise ValueError("a Preconditioner needs a non-empty name")
    if pre.name in _PRECONDS and not overwrite:
        raise ValueError(f"preconditioner {pre.name!r} is already "
                         "registered (pass overwrite=True to replace it)")
    _PRECONDS[pre.name] = pre
    return pre


def unregister_precond(name: str) -> None:
    """Remove a registered preconditioner (the conformance harness
    registers and unregisters the faulty exemplar around its sweep)."""
    _PRECONDS.pop(name, None)


def get_precond(pre: str | Preconditioner) -> Preconditioner:
    """Resolve a preconditioner name (or pass through an instance)."""
    if isinstance(pre, Preconditioner):
        return pre
    try:
        return _PRECONDS[pre]
    except KeyError:
        raise ValueError(f"unknown preconditioner {pre!r}; available: "
                         f"{available_preconds()}") from None


def available_preconds() -> tuple[str, ...]:
    return tuple(sorted(_PRECONDS))


register_precond(NonePrecond())
register_precond(JacobiPrecond())
register_precond(BlockJacobiPrecond())
register_precond(TwoLevelPrecond())
