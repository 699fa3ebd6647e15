"""The plain reference: the operator's matvec and Jacobi-preconditioned CG
in plain PyTorch, from the benchmark's own CSR (``perfbench.operators``).

It imports nothing of the program.  It reads the program's outputs only
to judge them: :func:`true_residual` is ``‖b − A x‖₂ / ‖b‖₂`` in float64
for the ``x`` a timed solve returned.  :func:`pcg` is the control put in
the program's place (``perfbench/control.py``): the same algorithm as the
program's ``cg`` + ``jacobi`` (x₀ = 0, stop on the recursive residual),
in whatever precision it is given.
"""
from __future__ import annotations

import dataclasses

import torch

__all__ = ["DeviceCSR", "pcg", "true_residual"]


@dataclasses.dataclass
class DeviceCSR:
    """The operator as COO triplets on a device, in ``dtype``."""

    rows: torch.Tensor
    cols: torch.Tensor
    vals: torch.Tensor
    n: int

    @classmethod
    def of(cls, op, device, dtype=torch.float64) -> "DeviceCSR":
        indptr = torch.from_numpy(op.indptr).to(device)
        rows = torch.repeat_interleave(
            torch.arange(op.n, device=device), indptr.diff())
        return cls(rows=rows, cols=torch.from_numpy(op.indices).to(device),
                   vals=torch.from_numpy(op.data).to(device=device,
                                                     dtype=dtype), n=op.n)

    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        y = torch.zeros(self.n, dtype=self.vals.dtype, device=x.device)
        return y.index_add_(0, self.rows, self.vals * x[self.cols])

    def diagonal(self) -> torch.Tensor:
        d = torch.zeros(self.n, dtype=self.vals.dtype, device=self.vals.device)
        on = self.rows == self.cols
        return d.index_add_(0, self.rows[on], self.vals[on])


def true_residual(A: DeviceCSR, b: torch.Tensor, x: torch.Tensor) -> float:
    """``‖b − A x‖₂ / ‖b‖₂`` in float64 (``A`` in float64)."""
    b64, x64 = b.to(torch.float64), x.to(torch.float64)
    return float(torch.linalg.vector_norm(b64 - A.matvec(x64))
                 / torch.linalg.vector_norm(b64))


def pcg(A: DeviceCSR, b: torch.Tensor, rtol: float, maxiter: int,
        check_every: int = 16) -> tuple[torch.Tensor, int]:
    """Jacobi-preconditioned CG from x₀ = 0 in ``A.vals.dtype``: values,
    vectors and dots all in that type.  Stops at the first check (every
    ``check_every`` iterations) that finds ‖r‖ ≤ rtol·‖b‖, or at
    ``maxiter``.  Returns ``(x, iterations)``."""
    dt = A.vals.dtype
    b = b.to(dt)
    minv = 1.0 / A.diagonal()
    x = torch.zeros_like(b)
    r = b.clone()
    z = minv * r
    p = z.clone()
    rz = torch.dot(r, z)
    stop = (rtol * torch.linalg.vector_norm(b.float())) ** 2
    k = 0
    while k < maxiter:
        if k % check_every == 0 and float(torch.dot(r, r).float()) <= stop:
            break
        ap = A.matvec(p)
        alpha = rz / torch.dot(p, ap)
        x = x + alpha * p
        r = r - alpha * ap
        z = minv * r
        rz_new = torch.dot(r, z)
        p = z + (rz_new / rz) * p
        rz = rz_new
        k += 1
    return x, k
