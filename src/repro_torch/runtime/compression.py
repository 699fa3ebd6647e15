"""Gradient / update compression with error feedback.

The port of ``src/repro/runtime/compression.py``.  Two codecs, both with
residual (error-feedback) accumulation so that compression noise does not
bias training:

  * ``int8``  — absmax-scaled int8 quantisation (one scale per leaf, or
    per chunk for the halo wire codec,
    ``repro_torch.core.transport.Int8WireCodec``);
  * ``topk``  — magnitude top-k sparsification (``k`` a fraction of the
    leaf), as a dense mask.

``ef_compress_tree`` applies either (or ``none``) over a tree of tensors
(nested dicts, as the trainer keeps its parameters), carrying the
residual into the next round; ``runtime.localsgd.pod_sync`` uses it on
the parameter delta that crosses the ``pod`` axis.
"""
from __future__ import annotations

import torch

__all__ = ["compress_int8", "decompress_int8", "compress_topk",
           "ef_compress_tree"]


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


def compress_topk(x: torch.Tensor, frac: float = 0.05):
    """Keep the values whose ``|x|`` is at least the ``k``-th largest,
    ``k = max(1, int(numel·frac))``: ``(kept, mask)``, ``kept`` zero
    elsewhere.  Every tie of the threshold is kept, so the mask (and the
    kept values, the same bits as ``x``'s) is the JAX package's."""
    flat = x.reshape(-1)
    k = max(1, int(flat.numel() * frac))
    thresh = torch.topk(flat.abs(), k).values[-1]
    mask = x.abs() >= thresh
    return torch.where(mask, x, torch.zeros_like(x)), mask


def _map(fn, tree, *rest):
    """``fn`` over the leaves of nested dicts (``rest``: trees of the same
    structure)."""
    if isinstance(tree, dict):
        return {k: _map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


def ef_compress_tree(grads, residual, codec: str = "int8",
                     topk_frac: float = 0.05):
    """Error-feedback compression over a tree (nested dicts of tensors).

    Returns ``(compressed, new_residual)``, both float32:
    ``g' = C(g + r)``, ``r' = (g + r) - g'`` for ``codec`` ``int8``,
    ``topk`` or ``none``; any other codec raises ``ValueError``."""
    if codec not in ("int8", "topk", "none"):
        raise ValueError(codec)

    def one(g, r):
        g = g.to(torch.float32) + r
        if codec == "int8":
            d = decompress_int8(*compress_int8(g))
        elif codec == "topk":
            d = compress_topk(g, topk_frac)[0]
        else:
            d = g
        return d, g - d

    out = _map(one, grads, residual)

    def pick(tree, i):
        return {k: pick(v, i) for k, v in tree.items()} \
            if isinstance(tree, dict) else tree[i]
    return pick(out, 0), pick(out, 1)
