"""Static contract verification of the port's plans — prove the
invariants on the host before a kernel runs.

The JAX package's three layers; the first two are numpy over the plan's
arrays:

``plan_check``    race/aliasing detection over ``SpMVPlan`` data:
                  single-writer ghost slots, slot-map permutations,
                  partition-bound consistency, storage accounting.
``kernel_check``  bounds of the formats' static gather/scatter index
                  streams against the plan's buffer extents: an
                  out-of-bounds index is flagged here, not left to be a
                  fault on the card.
``trace_pass``    traced runs of the shard body, the exchange and each
                  solver's loop body under the collective recorder
                  (``repro_torch.core.collectives``) and an aten op
                  recorder — the counterpart of the reference's
                  ``jaxpr_pass``: zero-all-reduce SpMV, census ==
                  ``predicted_cost``, derived wire bytes, payload and
                  numeric lints, reductions per iteration and per apply.

All three report through ``report``'s closed violation vocabulary (the JAX
package's codes), so the two packages' reports on one plan compare equal.
``build_spmv_plan(verify=True)`` runs the first two on every plan it
builds.
"""
from repro_torch.analysis.kernel_check import check_kernel_streams
from repro_torch.analysis.plan_check import check_plan
from repro_torch.analysis.report import CODES, Report, Violation
from repro_torch.analysis.trace_pass import (check_precond_static,
                                             check_solver_static,
                                             check_spmv_static)

__all__ = ["CODES", "Report", "Violation", "check_plan",
           "check_kernel_streams", "check_spmv_static",
           "check_solver_static", "check_precond_static"]
