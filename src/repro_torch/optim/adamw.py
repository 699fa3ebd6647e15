"""AdamW + gradient clipping + warmup-cosine schedule.

The port of ``src/repro/optim/adamw.py``.  The parameters, gradients and
moments are dicts of tensors under the port's parameter names
(``dict(model.named_parameters())``); the parameters and the moments
are updated in place.  Every scalar of the schedule and the bias
corrections is a float32 tensor on the parameters' device, as the
reference's traced arithmetic is: ``step / max(warmup, 1)``, the cosine,
``b1 ** step``.

Decoupled weight decay follows the rank of the *reference's* leaf
(``p.ndim >= 2`` there): a layer of a stacked subtree is one dim short of
its leaf, so every parameter inside a layer stack decays (norm weights,
biases, ``a_log``, ``dt_bias``, ``d_skip`` too), and outside a stack only
matrices do.  The caller must pass those ranks (``ref_ndim``;
``models.model.reference_ndim`` gives them): a tensor's own rank is the
wrong rule for a layer of a stack.
"""
from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import torch

__all__ = ["AdamWConfig", "OptState", "init_opt", "apply_updates",
           "warmup_cosine", "global_norm"]


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1


class OptState(NamedTuple):
    """First and second moments (float32, by parameter name) and the
    number of steps taken, a 0-d int32 tensor."""
    m: dict
    v: dict
    step: torch.Tensor


def init_opt(params: dict) -> OptState:
    """Zero moments beside ``params`` and step 0."""
    z = {k: torch.zeros_like(p, dtype=torch.float32)
         for k, p in params.items()}
    dev = next(iter(params.values())).device
    return OptState(m=z, v={k: t.clone() for k, t in z.items()},
                    step=torch.zeros((), dtype=torch.int32, device=dev))


def _f32(x: float, like: torch.Tensor) -> torch.Tensor:
    """``x`` as a 0-d float32 tensor on ``like``'s device (a fill, not a
    copy from the host)."""
    return like.new_full((), x, dtype=torch.float32)


def warmup_cosine(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """The learning rate at ``step`` (an int tensor), a float32 tensor:
    linear warmup to ``lr``, then a cosine down to ``min_lr_frac·lr`` at
    ``total_steps``."""
    s = step.to(torch.float32)
    one = _f32(1.0, s)
    warm = torch.minimum(s / max(cfg.warmup_steps, 1), one)
    t = torch.clamp((s - cfg.warmup_steps)
                    / max(cfg.total_steps - cfg.warmup_steps, 1), 0, 1)
    cos = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * 0.5 * (
        1 + torch.cos(_f32(math.pi, s) * t))
    return cfg.lr * warm * cos


def global_norm(tree: dict) -> torch.Tensor:
    """sqrt of the sum of every tensor's float32 sum of squares, summed in
    the dict's order."""
    total = None
    for x in tree.values():
        sq = torch.sum(torch.square(x.to(torch.float32)))
        total = sq if total is None else total + sq
    return torch.sqrt(total)


@torch.no_grad()
def apply_updates(cfg: AdamWConfig, params: dict, grads: dict,
                  opt: OptState, ref_ndim: dict,
                  gnorm: torch.Tensor | None = None):
    """One AdamW step: ``params`` and the moments updated in place (a
    second copy of the moments would not fit beside a 3B model's on one
    card).  ``ref_ndim`` maps every name to its reference leaf's rank,
    which decides the decay.  ``gnorm``: the gradients' global norm when
    the caller computed it (over a mesh's blocks,
    ``runtime.sharded.global_norm``); else ``global_norm(grads)``.  Returns ``(params, new_opt, metrics)``
    with metrics ``grad_norm`` and ``lr`` (0-d float32 tensors)."""
    if gnorm is None:
        gnorm = global_norm(grads)
    scale = torch.minimum(_f32(1.0, gnorm), cfg.clip_norm / torch.maximum(
        gnorm, _f32(1e-9, gnorm)))
    step = opt.step + 1
    lr = warmup_cosine(cfg, step)
    sf = step.to(torch.float32)
    b1c = 1 - torch.pow(_f32(cfg.b1, sf), sf)
    b2c = 1 - torch.pow(_f32(cfg.b2, sf), sf)
    for name, p in params.items():
        g = grads[name].to(torch.float32) * scale
        # in place, the same roundings as b1 * m + (1 - b1) * g
        m = opt.m[name].mul_(cfg.b1).add_((1 - cfg.b1) * g)
        v = opt.v[name].mul_(cfg.b2).add_((1 - cfg.b2) * g * g)
        u = (m / b1c) / (torch.sqrt(v / b2c) + cfg.eps)
        if ref_ndim[name] >= 2:  # decoupled decay: the reference's matrices
            u = u + cfg.weight_decay * p.to(torch.float32)
        p.copy_((p.to(torch.float32) - lr * u).to(p.dtype))
    return params, OptState(opt.m, opt.v, step), \
        {"grad_norm": gnorm, "lr": lr}
