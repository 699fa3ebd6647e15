"""Absmax-scaled int8 quantisation — the halo wire's int8 codec.

The JAX package's ``runtime.compression`` also carries top-k and
error-feedback codecs for LM training; only the int8 pair that the halo
wire codec (``repro_torch.core.transport.Int8WireCodec``) uses is here.
"""
from __future__ import annotations

import torch

__all__ = ["compress_int8", "decompress_int8"]


def compress_int8(x: torch.Tensor, axis=None, keepdims: bool = False):
    """Absmax-scaled int8 quantisation: ``(q, scale)``.

    ``axis=None`` gives one scalar scale for the whole tensor; the halo
    wire codec passes ``axis=-1, keepdims=True`` for one scale per chunk.
    ``scale = max|x| / 127 + 1e-12`` and ``q = clip(round(x / scale),
    ±127)`` in float32, rounding half to even, as the JAX package computes
    them.  Both divisions divide by a tensor on ``x``'s device: on CUDA a
    division by a Python scalar becomes a multiplication by its reciprocal,
    which can differ from the quotient in the last bit.
    """
    dims = tuple(range(x.dim())) if axis is None else axis
    amax = x.abs().amax(dim=dims, keepdim=keepdims)
    scale = amax / torch.full_like(amax, 127.0) + 1e-12
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def decompress_int8(q: torch.Tensor, scale: torch.Tensor,
                    dtype=torch.float32) -> torch.Tensor:
    return q.to(dtype) * scale
