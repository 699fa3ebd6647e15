"""Faults planted underneath the timed path, for
``test_perfbench_faults.py``: each is a function the harness calls (its
``plant`` argument, ``module:function``) before the program solves."""
from __future__ import annotations


def unchanged_state():
    """A CG step that returns its state unchanged."""
    from repro_torch.solvers.krylov import CGSolver

    CGSolver.loop_body = lambda self, ctx, aux, state: state


def altered_answer():
    """One entry of every solve's answer negated where the solve returns
    it (the row of the answer's largest entry)."""
    from repro_torch import solvers

    make = solvers.make_solver

    def make_solver(*args, **kw):
        solve = make(*args, **kw)

        def altered(b, tol=1e-8, maxiter=10_000):
            x, it, rel = solve(b, tol=tol, maxiter=maxiter)
            x = x.clone()
            flat = x.view(-1)
            j = int(flat.abs().argmax())
            flat[j] = -flat[j]
            return x, it, rel
        return altered
    solvers.make_solver = make_solver
