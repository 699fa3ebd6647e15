"""Feed-forward blocks: SwiGLU (llama family) and GELU (whisper).

The port of ``src/repro/models/mlp.py``.  Weights are ``(in, out)`` in
float32, cast to the activation's dtype at each product as the reference
casts them.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.models.common import new_param
from repro_torch.util import resolve_device

__all__ = ["SwiGLU", "GeluMLP", "init_swiglu", "swiglu", "init_gelu_mlp",
           "gelu_mlp"]


class SwiGLU(nn.Module):
    def __init__(self, d: int, d_ff: int, device=None,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.w_gate = new_param((d, d_ff), device, generator)
        self.w_up = new_param((d, d_ff), device, generator)
        self.w_down = new_param((d_ff, d), device, generator,
                                1.0 / d_ff ** 0.5)


class GeluMLP(nn.Module):
    def __init__(self, d: int, d_ff: int, device=None,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.w_up = new_param((d, d_ff), device, generator)
        self.b_up = new_param((d_ff,), device, generator, "zeros")
        self.w_down = new_param((d_ff, d), device, generator,
                                1.0 / d_ff ** 0.5)
        self.b_down = new_param((d,), device, generator, "zeros")


def init_swiglu(generator: torch.Generator | None, d: int, d_ff: int,
                device=None) -> SwiGLU:
    """Drawn from ``generator`` as the reference draws it, or left empty
    without one (``params_from_reference`` fills it); likewise every
    ``init_*`` of the models."""
    return SwiGLU(d, d_ff, resolve_device(device), generator)


def swiglu(p: SwiGLU, x: torch.Tensor) -> torch.Tensor:
    dt = x.dtype
    g = F.silu(x @ p.w_gate.to(dt))
    u = x @ p.w_up.to(dt)
    return (g * u) @ p.w_down.to(dt)


def init_gelu_mlp(generator: torch.Generator | None, d: int, d_ff: int,
                  device=None) -> GeluMLP:
    return GeluMLP(d, d_ff, resolve_device(device), generator)


def gelu_mlp(p: GeluMLP, x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu``'s default is the tanh approximation, so this is
    ``approximate="tanh"`` (PyTorch's default is the exact form)."""
    dt = x.dtype
    h = F.gelu(x @ p.w_up.to(dt) + p.b_up.to(dt), approximate="tanh")
    return h @ p.w_down.to(dt) + p.b_down.to(dt)
