"""Meta-device stand-ins for every model input, parameter, optimizer
state and cache — the rules never allocate memory for the full configs.
``launch.dryrun`` builds a rank's real arguments on fake tensors instead,
and its tests count that rank's argument bytes from these stand-ins and
the rules' ``shard_shape``; ``runtime.sharded.init_cache_sharded`` reads
``init_cache``'s tree on ``meta`` the same way.

The port of ``src/repro/launch/specs.py``: where the reference traces
``init_params`` / ``init_opt`` / ``init_cache`` under ``jax.eval_shape``,
the port builds them on the ``meta`` device (shapes and dtypes, no
storage), in the reference's nested layout (a stack's layers along a
leading ``L`` dim), as ``launch.train.checkpoint_like`` builds its
restore template.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig, ShapeConfig
from repro_torch.models.model import Model, init_cache, reference_like
from repro_torch.optim.adamw import OptState

__all__ = ["input_specs", "param_specs", "opt_specs", "cache_specs"]


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(tuple(int(s) for s in shape), dtype=dtype,
                       device="meta")


def input_specs(cfg: ArchConfig, shape: ShapeConfig) -> dict:
    b, s = shape.global_batch, shape.seq_len
    if shape.kind in ("train", "prefill"):
        out = {"tokens": _meta((b, s), torch.int32)}
        if cfg.is_encdec:
            out["frames"] = _meta((b, cfg.n_audio_frames, cfg.d_model),
                                  torch.bfloat16)
        return out
    if shape.kind == "decode":
        # scalar position: synchronized decode wave (uniform lengths)
        return {"tokens": _meta((b, 1), torch.int32),
                "pos": _meta((), torch.int32)}
    raise ValueError(shape.kind)


def param_specs(cfg: ArchConfig) -> dict:
    """``init_params``' tree in the reference's layout, on ``meta``."""
    return reference_like(dict(Model(cfg, "meta").named_parameters()))


def opt_specs(param_tree: dict) -> OptState:
    """``init_opt``'s state for ``param_tree`` (nested or by name):
    float32 moments of each leaf's shape and a 0-d int32 step."""
    def like(tree):
        return {k: like(v) if isinstance(v, dict)
                else _meta(v.shape, torch.float32) for k, v in tree.items()}
    return OptState(m=like(param_tree), v=like(param_tree),
                    step=_meta((), torch.int32))


def cache_specs(cfg: ArchConfig, shape: ShapeConfig) -> dict:
    return init_cache(cfg, shape.global_batch, shape.seq_len, device="meta")
