from repro_torch.core.cg import cg_solve, make_cg
from repro_torch.core.halo import HaloPlan, build_halo_plan
from repro_torch.core.partition import (partition_balanced,
                                        partition_equal_rows,
                                        partition_two_level)
from repro_torch.core.sharded_cg import make_fused_cg
from repro_torch.core.spmv import (SpMVPlan, build_spmv_plan, from_dist,
                                   make_shard_body, make_spmv,
                                   plan_from_arrays, to_dist)
from repro_torch.core.transport import (available_transports,
                                        get_transport, transport_census)

__all__ = ["cg_solve", "make_cg", "HaloPlan", "build_halo_plan",
           "partition_balanced", "partition_equal_rows",
           "partition_two_level", "make_fused_cg", "SpMVPlan",
           "build_spmv_plan", "from_dist", "make_shard_body", "make_spmv",
           "plan_from_arrays", "to_dist", "available_transports",
           "get_transport", "transport_census"]
