"""Quickstart on the PyTorch/CUDA port: the paper's contribution in ~50 lines.

The port's counterpart of ``examples/quickstart.py``.  Builds a
Fluidity-style extruded-mesh pressure matrix, distributes it with the
three SpMV algorithms from the paper, and solves it with
Jacobi-preconditioned CG, on one device (default ``cuda``).

    PYTHONPATH=src python examples/quickstart_torch.py [--device cpu]
"""
import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import numpy as np  # noqa: E402

from repro_torch.core import (build_spmv_plan, from_dist, make_cg,  # noqa: E402
                              make_spmv, to_dist)
from repro_torch.core.partition import (imbalance, partition_balanced,  # noqa: E402
                                        partition_equal_rows)
from repro_torch.solvers import make_solver  # noqa: E402
from repro_torch.sparse import extruded_mesh_matrix  # noqa: E402

ap = argparse.ArgumentParser()
ap.add_argument("--device", default="cuda")
args = ap.parse_args()

# 1. a pressure-solve matrix from an extruded pseudo-coastline mesh (Sec. 3)
A = extruded_mesh_matrix(n_surface=400, layers=8, seed=0)
print(f"matrix: {A.n_rows} DoF, {A.nnz} nnz ({A.nnz / A.n_rows:.1f} nnz/row)")

# 2. the paper's thread-level load balance (Sec. 2.3): nnz, not rows
eq = imbalance(A.row_nnz, partition_equal_rows(A.n_rows, 8))
bal = imbalance(A.row_nnz, partition_balanced(A.row_nnz, 8))
print(f"8-way imbalance (max/mean nnz): equal-rows {eq:.3f} -> balanced "
      f"{bal:.3f}")

# 3. hybrid distributed SpMV on a 1x1 mesh; a node x core grid is the
#    same code (see repro_torch/testing/dist_check.py)
x = np.random.default_rng(0).normal(size=A.n_rows)
for mode in ("vector", "task", "balanced"):
    plan, layout = build_spmv_plan(A, 1, 1, mode=mode, device=args.device)
    y = from_dist(make_spmv(plan)(to_dist(x, layout, plan)), layout, plan)
    err = np.abs(y - A.matvec(x)).max()
    print(f"mode={mode:9s} SpMV max err vs host CSR: {err:.2e}")

# 4. CG + Jacobi (Sec. 3: tol-limited, iteration cap 10k)
plan, layout = build_spmv_plan(A, 1, 1, mode="balanced", device=args.device)
solve = make_cg(plan)
b = np.random.default_rng(1).normal(size=A.n_rows)
xd, iters, rel = solve(to_dist(b, layout, plan), tol=1e-8, maxiter=10_000)
xs = from_dist(xd, layout, plan)
true_rel = np.linalg.norm(A.matvec(xs) - b) / np.linalg.norm(b)
print(f"CG: {int(iters)} iterations, rel residual {float(rel):.2e} "
      f"(true {true_rel:.2e})")

# 5. the Krylov registry (repro_torch.solvers): solvers and
#    preconditioners are selected by name — pipelined_cg fuses the
#    iteration's reductions into one, chebyshev needs none at all
for name in ("cg", "pipelined_cg", "chebyshev"):
    s = make_solver(plan, solver=name, precond="jacobi", A=A, layout=layout)
    xd, iters, rel = s(to_dist(b, layout, plan), tol=1e-5, maxiter=10_000)
    xs = from_dist(xd, layout, plan)
    true_rel = np.linalg.norm(A.matvec(xs) - b) / np.linalg.norm(b)
    print(f"solver={name:13s}: {int(iters):4d} iterations, "
          f"true rel {true_rel:.2e}")
