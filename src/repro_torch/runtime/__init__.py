from repro_torch.runtime.compression import compress_int8, decompress_int8
from repro_torch.runtime.fault import (FAULT_KINDS, FaultInjector, StepGuard,
                                       Watchdog)

__all__ = ["compress_int8", "decompress_int8", "FAULT_KINDS",
           "FaultInjector", "StepGuard", "Watchdog"]
