from repro_torch.core.cg import cg_solve, make_cg
from repro_torch.core.halo import HaloPlan, build_halo_plan
from repro_torch.core.partition import (partition_balanced,
                                        partition_equal_rows,
                                        partition_two_level)
from repro_torch.core.sharded_cg import make_fused_cg
from repro_torch.core.spmv import (SpMVPlan, build_spmv_plan, from_dist,
                                   make_shard_body, make_spmv,
                                   plan_from_arrays, to_dist)
from repro_torch.core.transport import (HaloTransport, autotune_transport,
                                        available_transports,
                                        available_wire_dtypes, get_codec,
                                        get_transport, make_exchange,
                                        register_transport,
                                        resolve_transport, transport_census,
                                        unregister_transport)

__all__ = ["cg_solve", "make_cg", "HaloPlan", "build_halo_plan",
           "partition_balanced", "partition_equal_rows",
           "partition_two_level", "make_fused_cg", "SpMVPlan",
           "build_spmv_plan", "from_dist", "make_shard_body", "make_spmv",
           "plan_from_arrays", "to_dist", "available_transports",
           "get_transport", "transport_census", "HaloTransport",
           "autotune_transport", "available_wire_dtypes", "get_codec",
           "make_exchange", "register_transport", "resolve_transport",
           "unregister_transport"]
