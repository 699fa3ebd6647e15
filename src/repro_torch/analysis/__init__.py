"""Static contract verification of the port's plans — prove the
invariants on the host before a kernel runs.

Two of the JAX package's three layers, numpy over the plan's arrays:

``plan_check``    race/aliasing detection over ``SpMVPlan`` data:
                  single-writer ghost slots, slot-map permutations,
                  partition-bound consistency, storage accounting.
``kernel_check``  bounds of the formats' static gather/scatter index
                  streams against the plan's buffer extents: an
                  out-of-bounds index is flagged here, not left to be a
                  fault on the card.

Both report through ``report``'s closed violation vocabulary (the JAX
package's codes), so the two packages' reports on one plan compare equal.
``build_spmv_plan(verify=True)`` runs both on every plan it builds.
"""
from repro_torch.analysis.kernel_check import check_kernel_streams
from repro_torch.analysis.plan_check import check_plan
from repro_torch.analysis.report import CODES, Report, Violation

__all__ = ["CODES", "Report", "Violation", "check_plan",
           "check_kernel_streams"]
