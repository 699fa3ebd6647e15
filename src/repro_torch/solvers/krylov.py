"""The shipped Krylov solvers: ``cg``, ``pipelined_cg``, ``chebyshev``.

Three points on the synchronisation-cost axis:

``cg``           preconditioned CG, two cross-shard reductions per
                 iteration (p·Ap, then the stacked [r·z, r·r]).
``pipelined_cg`` Ghysels–Vanroose reordering: every dot the iteration needs
                 ([γ=r·u, δ=w·u, r·r]) is one stacked reduction issued
                 before the preconditioner and SpMV it is data-independent
                 of — the paper's communication/computation overlap applied
                 to the Krylov layer.
``chebyshev``    no reduction at all per iteration: given eigenvalue bounds
                 of M⁻¹A the three-term recurrence needs nothing but the
                 SpMV.  Bounds come from ``options={"lmin": .., "lmax":
                 ..}`` or are estimated at build time by a host f64
                 PCG-Lanczos sweep (:func:`estimate_eig_bounds`) through the
                 preconditioner's ``host_apply``.

All three run on ``(nrhs, n_node, n_core, rc_pad)`` blocks with per-RHS
freezing: a converged column's state is carried through bit-unchanged
while the rest iterate, so a batched solve equals its columns solved one
at a time.  All three implement the chunked-loop hooks (``loop_aux`` /
``loop_restart`` / ``loop_body`` / ``loop_finish``) that the resilient
driver (``repro_torch.solvers.resilient``) runs in bounded chunks.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch.solvers.base import (Solver, SolverCtx, pdot, pdot_stack,
                                      register_solver)

__all__ = ["CGSolver", "PipelinedCGSolver", "ChebyshevSolver",
           "estimate_eig_bounds", "chebyshev_iters_for_tol"]


def _gate(active, new, old):
    """Freeze converged RHS columns: keep ``old`` where ``active`` is off."""
    a = active.reshape(active.shape + (1,) * (new.dim() - active.dim()))
    return torch.where(a, new, old)


def _col(v: torch.Tensor) -> torch.Tensor:
    """A per-RHS ``(nrhs,)`` scalar broadcast over a vector block."""
    return v[:, None, None, None]


def _cap(ctx: SolverCtx, maxiter: torch.Tensor) -> torch.Tensor:
    return torch.clamp(maxiter, max=ctx.maxiter_static)


def _tol2(tol: torch.Tensor, bnorm: torch.Tensor) -> torch.Tensor:
    return (tol * torch.clamp(bnorm, min=1e-30)) ** 2


class CGSolver(Solver):
    """Preconditioned CG (2 cross-shard reductions per iteration).

    The state carries ``pap``, the last p·Ap denominator, out of the
    reduction the iteration already pays for, so the resilient guard can
    flag SPD breakdown (p·Ap ≤ 0 or r·z ≤ 0) with no extra reduction.
    """

    name = "cg"
    reductions_per_iter = 2
    positive_scalars = ("rz", "pap")

    def state_kinds(self):
        return {"k": "scalar", "x": "vector", "r": "vector", "p": "vector",
                "rz": "scalar", "rr": "scalar", "pap": "scalar"}

    def loop_aux(self, ctx: SolverCtx, b, tol, maxiter):
        bnorm = torch.sqrt(pdot(b, b))
        return {"cap": _cap(ctx, maxiter), "bnorm": bnorm,
                "tol2": _tol2(tol, bnorm)}

    def loop_restart(self, ctx: SolverCtx, aux, b, x, k):
        # true-residual recompute + fresh direction (β-chain reset):
        # r = b − Ax, p = z = M⁻¹r.  From x = 0, A·0 is exactly 0
        r = b - ctx.spmv(x)
        z = ctx.precond(r)
        s = pdot_stack((r, z), (r, r))
        return {"k": k, "x": x, "r": r, "p": z, "rz": s[0], "rr": s[1],
                "pap": torch.ones_like(s[0])}

    def loop_active(self, ctx: SolverCtx, aux, state):
        return (state["k"] < aux["cap"]) & (state["rr"] > aux["tol2"])

    def loop_body(self, ctx: SolverCtx, aux, state):
        k, x, r, p = state["k"], state["x"], state["r"], state["p"]
        rz, rr = state["rz"], state["rr"]
        active = (k < aux["cap"]) & (rr > aux["tol2"])
        ap = ctx.spmv(p)
        den = pdot(p, ap)                      # reduction 1
        alpha = _col(rz / den)
        x = _gate(active, x + alpha * p, x)
        r = _gate(active, r - alpha * ap, r)
        z = ctx.precond(r)
        s = pdot_stack((r, z), (r, r))         # reduction 2: [r·z, r·r]
        beta = _col(s[0] / rz)
        p = _gate(active, z + beta * p, p)
        return {"k": k + active.to(k.dtype), "x": x, "r": r, "p": p,
                "rz": _gate(active, s[0], rz), "rr": _gate(active, s[1], rr),
                "pap": _gate(active, den, state["pap"])}

    def loop_finish(self, ctx: SolverCtx, aux, state):
        rel = torch.sqrt(state["rr"]) / torch.clamp(aux["bnorm"], min=1e-30)
        return state["x"], state["k"], rel

    def guard_scalars(self, state):
        return {"rr": state["rr"], "rz": state["rz"], "pap": state["pap"]}


class PipelinedCGSolver(Solver):
    """Ghysels–Vanroose pipelined PCG — one stacked reduction per iteration.

    The iteration's dots ([r·u, w·u, r·r]) are issued first; the
    preconditioner and the SpMV ``n = A M⁻¹ w`` do not depend on them, so
    on a real mesh the all-reduce overlaps the halo exchange and matvec.
    The price: three extra vector recurrences (z, q, s) and a residual
    check that lags one iteration.

    In f32 the recurrences drift from their true values, so every
    ``replace_every`` iterations (option, default 50) the residual system
    is restarted: r = b − Ax, u = M⁻¹r, w = Au from their definitions and
    the direction recurrences (z, q, s, p) reset — 2 SpMVs, 1
    preconditioner application and no reduction.  γ_prev := +inf makes
    the next β exactly 0, a fresh first iteration from the current x.
    ``loop_restart`` (rollback, resume) is the same idiom.

    The trip counter ``t`` that times the restart counts every body call
    and is a host ``int``: the restart is a Python branch, with no device
    read per iteration.  Every vector it replaces stays gated by
    ``active``.
    """

    name = "pipelined_cg"
    #: the one stacked reduction; the drift restart reduces nothing
    reductions_per_iter = 1

    def lossy_wire_options(self):
        # a quantised halo makes the SpMV a different perturbed operator
        # on every call; the vector recurrences amplify that far faster
        # than f32 round-off (restart-25 and -50 diverge over int8 wire in
        # the JAX package's measurements, restart-10 converges)
        return {"replace_every": 10}

    def state_kinds(self):
        return {"t": "scalar", "k": "scalar",
                "x": "vector", "r": "vector", "u": "vector", "w": "vector",
                "z": "vector", "q": "vector", "s": "vector", "p": "vector",
                "g_prev": "scalar", "a_prev": "scalar", "rr": "scalar"}

    def loop_aux(self, ctx: SolverCtx, b, tol, maxiter):
        bnorm = torch.sqrt(pdot(b, b))
        # the drift restart inside loop_body needs b: carry it in aux
        return {"cap": _cap(ctx, maxiter), "bnorm": bnorm,
                "tol2": _tol2(tol, bnorm), "b": b}

    def loop_restart(self, ctx: SolverCtx, aux, b, x, k):
        r = b - ctx.spmv(x)
        u = ctx.precond(r)
        w = ctx.spmv(u)
        rr = pdot(r, r)
        zeros = torch.zeros_like(x)
        return {"t": 0, "k": k, "x": x, "r": r, "u": u, "w": w,
                "z": zeros, "q": zeros, "s": zeros, "p": zeros,
                "g_prev": torch.full_like(rr, math.inf),
                "a_prev": torch.ones_like(rr), "rr": rr}

    def loop_active(self, ctx: SolverCtx, aux, state):
        return (state["k"] < aux["cap"]) & (state["rr"] > aux["tol2"])

    def loop_body(self, ctx: SolverCtx, aux, state):
        b = aux["b"]
        replace_every = int(ctx.options.get("replace_every", 50))
        t, k = state["t"], state["k"]
        x, r, u, w = state["x"], state["r"], state["u"], state["w"]
        z, q, s, p = state["z"], state["q"], state["s"], state["p"]
        g_prev, a_prev, rr = state["g_prev"], state["a_prev"], state["rr"]
        active = (k < aux["cap"]) & (rr > aux["tol2"])
        first = k == 0
        if t > 0 and t % replace_every == 0:
            # periodic drift correction: 2 SpMVs, 1 precond, 0 reductions
            r_t = b - ctx.spmv(x)
            u_t = ctx.precond(r_t)
            w_t = ctx.spmv(u_t)
            zv = torch.zeros_like(x)
            r, u, w = (_gate(active, r_t, r), _gate(active, u_t, u),
                       _gate(active, w_t, w))
            z, q, s, p = (_gate(active, zv, v) for v in (z, q, s, p))
            g_prev = _gate(active, torch.full_like(g_prev, math.inf), g_prev)
        # the ONE stacked reduction; the preconditioner and SpMV below do
        # not depend on it
        S = pdot_stack((r, u), (w, u), (r, r))      # [γ, δ, r·r]
        m = ctx.precond(w)
        n = ctx.spmv(m)
        gamma, delta = S[0], S[1]
        beta = torch.where(first, 0.0, gamma / g_prev)
        alpha = torch.where(first, gamma / delta,
                            gamma / (delta - beta * gamma / a_prev))
        z = _gate(active, n + _col(beta) * z, z)
        q = _gate(active, m + _col(beta) * q, q)
        s_v = _gate(active, w + _col(beta) * s, s)
        p = _gate(active, u + _col(beta) * p, p)
        x = _gate(active, x + _col(alpha) * p, x)
        r = _gate(active, r - _col(alpha) * s_v, r)
        u = _gate(active, u - _col(alpha) * q, u)
        w = _gate(active, w - _col(alpha) * z, w)
        return {"t": t + 1, "k": k + active.to(k.dtype),
                "x": x, "r": r, "u": u, "w": w,
                "z": z, "q": q, "s": s_v, "p": p,
                "g_prev": _gate(active, gamma, g_prev),
                "a_prev": _gate(active, alpha, a_prev),
                "rr": _gate(active, S[2], rr)}

    def loop_finish(self, ctx: SolverCtx, aux, state):
        rr = pdot(state["r"], state["r"])      # fresh ‖r‖, post-loop
        rel = torch.sqrt(rr) / torch.clamp(aux["bnorm"], min=1e-30)
        return state["x"], state["k"], rel

    def guard_scalars(self, state):
        # g_prev is legitimately +inf right after a restart; the driver's
        # true-residual probe covers the drifting vector recurrences
        return {"rr": state["rr"]}


class ChebyshevSolver(Solver):
    """Three-term Chebyshev iteration — no reduction per iteration.

    Needs eigenvalue bounds ``[lmin, lmax]`` of M⁻¹A (``prepare``
    estimates them from ``A`` when not given).  Every iteration is SpMV +
    AXPYs.  The count that meets ``tol`` is known a priori from the error
    bound, so the loop runs ``min(maxiter, need)`` steps and measures the
    residual once, after the loop.

    The recurrence is residual-free: no state scalar reflects corruption,
    so ``guard_scalars`` is empty and the resilient driver's true-residual
    probe is the only detector.  The state carries ``kb``, the iteration
    of the last restart: the budget ``need`` counts from ``kb``, and the
    first-step special case keys off ``k == kb``.
    """

    name = "chebyshev"
    reductions_per_iter = 0
    #: the budget fixes the trip count and the f32 floor usually sits above
    #: the guard's 10·tol stagnation threshold; a rollback would re-arm the
    #: budget (kb := k) forever
    stagnation_guard = False

    #: safety margins on the Lanczos Ritz estimates (which sit inside the
    #: spectrum): widen the interval so no eigenvalue escapes it
    lmax_margin: float = 1.05
    lmin_margin: float = 0.9

    def prepare(self, plan, precond, pdata, A=None, layout=None,
                options=None):
        opts = dict(options or {})
        if "lmin" not in opts or "lmax" not in opts:
            if A is None:
                raise ValueError(
                    "chebyshev needs eigenvalue bounds: pass "
                    "options={'lmin': .., 'lmax': ..} or the host matrix "
                    "A= (with layout=) to estimate them")
            lmin, lmax = estimate_eig_bounds(
                A.matvec, precond.host_apply(plan, layout, A), A.n_rows)
            opts.setdefault("lmin", lmin * self.lmin_margin)
            opts.setdefault("lmax", lmax * self.lmax_margin)
        return opts

    def _coeffs(self, ctx: SolverCtx):
        lmin = float(ctx.options["lmin"])
        lmax = float(ctx.options["lmax"])
        return (lmax + lmin) / 2.0, (lmax - lmin) / 2.0

    def state_kinds(self):
        return {"k": "scalar", "x": "vector", "r": "vector", "p": "vector",
                "a_prev": "scalar", "kb": "scalar"}

    def loop_aux(self, ctx: SolverCtx, b, tol, maxiter):
        lmin = float(ctx.options["lmin"])
        lmax = float(ctx.options["lmax"])
        bnorm = torch.sqrt(pdot(b, b))
        # a-priori trip count from the error bound, in f32 on the f32 tol
        # as the JAX package computes it (a quotient by a tensor: 2.0 / t
        # would be a reciprocal times 2)
        sigma = (math.sqrt(lmax / lmin) - 1.0) / (math.sqrt(lmax / lmin) + 1.0)
        ratio = torch.full_like(tol, 2.0) / torch.clamp(tol, min=1e-30)
        need = torch.ceil(torch.log(torch.clamp(ratio, min=1.0))
                          * (1.2 / -math.log(sigma))).to(torch.int32) + 5
        return {"cap": _cap(ctx, maxiter), "need": need, "bnorm": bnorm}

    def loop_restart(self, ctx: SolverCtx, aux, b, x, k):
        d, _ = self._coeffs(ctx)
        r = b - ctx.spmv(x)
        return {"k": k, "x": x, "r": r, "p": torch.zeros_like(x),
                "a_prev": torch.full(k.shape, 1.0 / d, dtype=torch.float32,
                                     device=x.device), "kb": k}

    def loop_active(self, ctx: SolverCtx, aux, state):
        k, kb = state["k"], state["kb"]
        return (k < aux["cap"]) & ((k - kb) < aux["need"])

    def loop_body(self, ctx: SolverCtx, aux, state):
        d, c = self._coeffs(ctx)
        k, x, r, p = state["k"], state["x"], state["r"], state["p"]
        a_prev, kb = state["a_prev"], state["kb"]
        # a column past its budget holds its state bit for bit; with one
        # shared budget every gate is where(True, new, old) == new
        active = (k < aux["cap"]) & ((k - kb) < aux["need"])
        z = ctx.precond(r)
        beta = torch.where(k == kb, 0.0, (c * a_prev / 2.0) ** 2)
        alpha = torch.where(k == kb, 1.0 / d, 1.0 / (d - beta / a_prev))
        p = _gate(active, z + _col(beta) * p, p)
        x = _gate(active, x + _col(alpha) * p, x)
        r = _gate(active, r - _col(alpha) * ctx.spmv(p), r)
        return {"k": k + active.to(k.dtype), "x": x, "r": r, "p": p,
                "a_prev": _gate(active, alpha, a_prev), "kb": kb}

    def loop_finish(self, ctx: SolverCtx, aux, state):
        rr = pdot(state["r"], state["r"])      # one reduction, post-loop
        rel = torch.sqrt(rr) / torch.clamp(aux["bnorm"], min=1e-30)
        return state["x"], state["k"], rel


def chebyshev_iters_for_tol(lmin: float, lmax: float, tol: float) -> int:
    """Iterations the Chebyshev error bound needs for a relative ``tol``."""
    sigma = (math.sqrt(lmax / lmin) - 1.0) / (math.sqrt(lmax / lmin) + 1.0)
    return int(math.ceil(math.log(2.0 / tol) * (1.2 / -math.log(sigma)))) + 5


def estimate_eig_bounds(matvec, precond_apply, n: int,
                        iters: int = 96, seed: int = 0
                        ) -> tuple[float, float]:
    """Extremal eigenvalue estimates of M⁻¹A via host PCG-Lanczos (f64).

    Runs preconditioned CG on a seeded random RHS and diagonalises the
    Lanczos tridiagonal its α/β coefficients define (PETSc's
    ``KSPChebyshevEstEig``).  Ritz values sit inside the true spectrum, so
    callers widen the interval (``ChebyshevSolver``'s margins).
    """
    rng = np.random.default_rng(seed)
    r = rng.normal(size=n)
    z = np.asarray(precond_apply(r), dtype=np.float64)
    p = z.copy()
    rz = float(r @ z)
    alphas: list[float] = []
    betas: list[float] = []
    for _ in range(min(iters, n - 1)):
        ap = np.asarray(matvec(p), dtype=np.float64)
        pap = float(p @ ap)
        if pap <= 0 or rz <= 0:
            break
        alpha = rz / pap
        r = r - alpha * ap
        z = np.asarray(precond_apply(r), dtype=np.float64)
        rz_new = float(r @ z)
        alphas.append(alpha)
        betas.append(rz_new / rz)
        if rz_new < 1e-28:
            break
        p = z + (rz_new / rz) * p
        rz = rz_new
    m = len(alphas)
    if m == 0:
        raise ValueError("eigenvalue estimation failed: operator or "
                         "preconditioner is not SPD on the probe vector")
    T = np.zeros((m, m))
    for j in range(m):
        T[j, j] = 1.0 / alphas[j] + (betas[j - 1] / alphas[j - 1] if j else 0.0)
        if j + 1 < m:
            T[j, j + 1] = T[j + 1, j] = math.sqrt(betas[j]) / alphas[j]
    ev = np.linalg.eigvalsh(T)
    return float(ev[0]), float(ev[-1])


register_solver(CGSolver())
register_solver(PipelinedCGSolver())
register_solver(ChebyshevSolver())
