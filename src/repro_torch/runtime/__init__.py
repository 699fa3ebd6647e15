from repro_torch.runtime.compression import (compress_int8, compress_topk,
                                             decompress_int8,
                                             ef_compress_tree)
from repro_torch.runtime.fault import (FAULT_KINDS, FaultInjector, StepGuard,
                                       Watchdog)

__all__ = ["compress_int8", "decompress_int8", "compress_topk",
           "ef_compress_tree", "FAULT_KINDS",
           "FaultInjector", "StepGuard", "Watchdog"]
