from repro_torch.sparse.csr import (CSRMatrix, ell_arrays_from_csr,
                                    sell_arrays_from_csr)
from repro_torch.sparse.formats import (ELLFormat, SELLFormat, ShardFormat,
                                        available_formats, get_format,
                                        register_format)
from repro_torch.sparse.mesh_gen import (extruded_mesh_matrix,
                                         graded_extruded_mesh_matrix,
                                         random_spd_matrix,
                                         surface_mesh_edges)

__all__ = ["CSRMatrix", "ell_arrays_from_csr", "sell_arrays_from_csr",
           "ShardFormat", "ELLFormat", "SELLFormat", "register_format",
           "get_format", "available_formats", "extruded_mesh_matrix",
           "graded_extruded_mesh_matrix", "random_spd_matrix",
           "surface_mesh_edges"]
