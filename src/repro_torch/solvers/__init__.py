from repro_torch.solvers.base import (Solver, SolverCtx, available_solvers,
                                      from_dist_batch, get_solver,
                                      local_dot, make_solver, pdot,
                                      pdot_stack, register_solver,
                                      to_dist_batch)
from repro_torch.solvers.krylov import CGSolver
from repro_torch.solvers.refine import RefineResult, make_refine, refine_solve
from repro_torch.solvers.precond import (JacobiPrecond, NonePrecond,
                                         Preconditioner, available_preconds,
                                         get_precond, jacobi_inverse,
                                         register_precond)

__all__ = ["Solver", "SolverCtx", "available_solvers", "from_dist_batch",
           "get_solver", "local_dot", "make_solver", "pdot", "pdot_stack",
           "register_solver", "to_dist_batch", "CGSolver", "JacobiPrecond",
           "NonePrecond", "Preconditioner", "available_preconds",
           "get_precond", "jacobi_inverse", "register_precond",
           "RefineResult", "make_refine", "refine_solve"]
