"""SpMV kernels: hand-written CUDA (``csrc/spmv.cu``, built at first use by
``spmv_cuda``), their public wrappers (``ops``) and plain PyTorch
versions (``ref``)."""
from repro_torch.kernels.ops import (LAUNCHES, balanced_spmv, ell_spmv,
                                     fused_ell_spmv, fused_sell_spmv,
                                     reset_launches)

__all__ = ["LAUNCHES", "balanced_spmv", "ell_spmv", "fused_ell_spmv",
           "fused_sell_spmv", "reset_launches"]
