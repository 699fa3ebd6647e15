from repro_torch.solvers.base import (Solver, SolverCtx, available_solvers,
                                      count_reductions, from_dist_batch,
                                      gather_dist_batch, get_solver, local_dot,
                                      make_precond_apply, make_solver,
                                      pdot, pdot_stack, reduction_census,
                                      register_solver, to_dist_batch)
from repro_torch.solvers.krylov import (CGSolver, ChebyshevSolver,
                                        PipelinedCGSolver,
                                        chebyshev_iters_for_tol,
                                        estimate_eig_bounds)
from repro_torch.solvers.refine import RefineResult, make_refine, refine_solve
from repro_torch.solvers.precond import (BlockJacobiPrecond, FaultyPrecond,
                                         JacobiPrecond, NonePrecond,
                                         Preconditioner, TwoLevelPrecond,
                                         available_preconds, get_precond,
                                         jacobi_inverse, jacobi_inverse_np,
                                         register_precond,
                                         unregister_precond)
from repro_torch.solvers.resilient import (ResilientResult, SolveFailure,
                                           make_resilient, resilient_solve)

__all__ = ["Solver", "SolverCtx", "available_solvers", "from_dist_batch",
           "gather_dist_batch",
           "get_solver", "local_dot", "make_solver", "pdot", "pdot_stack",
           "register_solver", "to_dist_batch", "count_reductions",
           "make_precond_apply", "BlockJacobiPrecond", "TwoLevelPrecond",
           "FaultyPrecond", "unregister_precond",
           "reduction_census", "CGSolver", "PipelinedCGSolver",
           "ChebyshevSolver", "estimate_eig_bounds",
           "chebyshev_iters_for_tol", "JacobiPrecond", "NonePrecond",
           "Preconditioner", "available_preconds", "get_precond",
           "jacobi_inverse", "jacobi_inverse_np", "register_precond",
           "RefineResult", "make_refine", "refine_solve",
           "ResilientResult", "SolveFailure", "make_resilient",
           "resilient_solve"]
