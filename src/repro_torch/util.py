"""Small shared helpers used across core/, kernels/ and sparse/."""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["align_up", "resolve_device", "device_name", "to_device"]


def align_up(v: int, a: int) -> int:
    """Round ``v`` up to the next multiple of ``a`` (at least ``a``)."""
    return int(max(a, -(-int(v) // a) * a))


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller names
    another.  Never falls back: a missing card fails at the first tensor
    placed on it."""
    return torch.device("cuda" if device is None else device)


def device_name(device) -> str:
    """What a result names its device by: the card's name
    (``torch.cuda.get_device_name``), else the device type."""
    device = torch.device(device)
    if device.type == "cuda":
        return torch.cuda.get_device_name(device)
    return device.type


def to_device(a: np.ndarray, device) -> torch.Tensor:
    """Host array -> tensor on ``device``; float64 is rounded to float32
    as numpy's ``astype`` rounds it, integers keep their dtype."""
    if a.dtype == np.float64:
        a = a.astype(np.float32)
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)
