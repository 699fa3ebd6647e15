from repro_torch.sparse.csr import (BalancedCOO, CSRMatrix, ELLMatrix,
                                    balanced_warp_map, ell_arrays_from_csr,
                                    sell_arrays_from_csr)
from repro_torch.sparse.formats import (ELLFormat, IndexStream, SELLFormat,
                                        ShardFormat, available_formats,
                                        get_format, register_format)
from repro_torch.sparse.mesh_gen import (extruded_mesh_matrix,
                                         graded_extruded_mesh_matrix,
                                         random_spd_matrix,
                                         surface_mesh_edges)

__all__ = ["CSRMatrix", "ELLMatrix", "BalancedCOO", "balanced_warp_map",
           "ell_arrays_from_csr",
           "sell_arrays_from_csr", "IndexStream", "ShardFormat", "ELLFormat",
           "SELLFormat", "register_format", "get_format",
           "available_formats", "extruded_mesh_matrix",
           "graded_extruded_mesh_matrix", "random_spd_matrix",
           "surface_mesh_edges"]
