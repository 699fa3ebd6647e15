"""Preconditioner registry: ``none`` and ``jacobi`` (so far).

A preconditioner has two lives:

  * **build time** (host, once per plan): ``build(plan, layout, A)``
    returns a dict of tensors with leading ``(n_node, n_core)`` shard dims
    on the plan's device;
  * **solve time** (device, per iteration): ``apply(P, r)`` maps the
    residual block ``(nrhs, n_node, n_core, rc_pad)`` to ``z = M^-1 r``,
    each shard touching only its own slice.

``jacobi``  1/diag(A), the paper's Sec. 3 preconditioner.
``none``    identity, for unpreconditioned baselines.

``host_apply`` returns a plain numpy ``(n,) -> (n,)`` application of the
same operator in *global* row ordering, for Chebyshev's host-side
eigenvalue estimate.  ``validate_options`` runs before any autotune or
build in ``make_solver``: an unknown option fails fast, naming the valid
ones.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["jacobi_inverse", "jacobi_inverse_np", "Preconditioner",
           "NonePrecond",
           "JacobiPrecond", "register_precond", "get_precond",
           "available_preconds"]


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
    #: option names ``validate_options`` accepts (default: none)
    valid_options: tuple[str, ...] = ()

    def validate_options(self, options: dict | None = None) -> dict:
        """Validate build options before any autotune or build: raises
        ``ValueError`` naming the valid options on an unknown key; returns
        the option dict."""
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
