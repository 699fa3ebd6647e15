from repro_torch.runtime.compression import compress_int8, decompress_int8

__all__ = ["compress_int8", "decompress_int8"]
