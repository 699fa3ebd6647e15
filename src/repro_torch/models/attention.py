"""GQA attention layer (multi-query / grouped-query, RoPE, optional QK-norm,
optional QKV bias) with train / prefill / decode entry points.

The port of ``src/repro/models/attention.py``.  Weights are stored 2-D with
heads fused into the output dim, ``(in, out)``, as in the reference.  The
KV cache is a pair of ``(B, max_len, KV, dh)`` tensors per layer that
``attention_prefill`` and ``attention_decode`` write in place (the
reference returns new arrays; the port keeps one buffer) and return.
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.models.common import (decode_attention, flash_attention,
                                       new_param, rms_norm, rope)
from repro_torch.util import resolve_device

__all__ = ["Attention", "init_attention", "attention_train",
           "attention_prefill", "attention_decode", "init_cache_layer"]


class Attention(nn.Module):
    """``wq``, ``wk``, ``wv``, ``wo``; ``bq``/``bk``/``bv`` with
    ``qkv_bias`` (never on cross-attention); ``q_norm``/``k_norm`` with
    ``qk_norm``.  An absent parameter is ``None``."""

    def __init__(self, cfg, cross: bool = False, device=None,
                 generator: torch.Generator | None = None):
        super().__init__()
        d, dh = cfg.d_model, cfg.d_head
        nq, nkv = cfg.n_heads, cfg.n_kv_heads
        self.wq = new_param((d, nq * dh), device, generator)
        self.wk = new_param((d, nkv * dh), device, generator)
        self.wv = new_param((d, nkv * dh), device, generator)
        self.wo = new_param((nq * dh, d), device, generator,
                            1.0 / (nq * dh) ** 0.5)
        bias = cfg.qkv_bias and not cross
        for name, n in (("bq", nq * dh), ("bk", nkv * dh), ("bv", nkv * dh)):
            self.register_parameter(name, new_param(
                (n,), device, generator, "zeros") if bias else None)
        for name in ("q_norm", "k_norm"):
            self.register_parameter(name, new_param(
                (dh,), device, generator, "ones") if cfg.qk_norm else None)


def init_attention(generator: torch.Generator | None, cfg, cross: bool = False,
                   device=None) -> Attention:
    return Attention(cfg, cross, resolve_device(device), generator)


def _project_qkv(p: Attention, cfg, x, positions, use_rope=True):
    B, S, _ = x.shape
    dh, nq, nkv = cfg.d_head, cfg.n_heads, cfg.n_kv_heads
    dt = x.dtype
    q = x @ p.wq.to(dt)
    k = x @ p.wk.to(dt)
    v = x @ p.wv.to(dt)
    if p.bq is not None:
        q = q + p.bq.to(dt)
        k = k + p.bk.to(dt)
        v = v + p.bv.to(dt)
    q = q.reshape(B, S, nq, dh)
    k = k.reshape(B, S, nkv, dh)
    v = v.reshape(B, S, nkv, dh)
    if cfg.qk_norm:
        q = rms_norm(q, p.q_norm, cfg.norm_eps)
        k = rms_norm(k, p.k_norm, cfg.norm_eps)
    if use_rope:
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
    return q, k, v


def attention_train(p: Attention, cfg, x, *, causal: bool = True,
                    use_rope: bool = True, kv_source=None,
                    chunk_q: int | None = None, chunk_k: int | None = None):
    """Full-sequence attention (training / encoder).  x: (B, S, d).

    ``kv_source``: if given, keys/values come from this tensor instead
    (cross-attention, not causal); no RoPE is applied to cross-attention."""
    B, S, _ = x.shape
    positions = torch.arange(S, device=x.device)[None, :]
    if kv_source is None:
        q, k, v = _project_qkv(p, cfg, x, positions, use_rope)
    else:
        q, _, _ = _project_qkv(p, cfg, x, positions, use_rope=False)
        Sk = kv_source.shape[1]
        kpos = torch.arange(Sk, device=x.device)[None, :]
        _, k, v = _project_qkv(p, cfg, kv_source, kpos, use_rope=False)
        causal = False
    out = flash_attention(q, k, v, causal=causal,
                          chunk_q=chunk_q or cfg.attn_chunk_q or S,
                          chunk_k=chunk_k or cfg.attn_chunk_k or k.shape[1])
    return out.reshape(B, S, -1) @ p.wo.to(x.dtype)


def init_cache_layer(cfg, batch: int, max_len: int, dtype=torch.bfloat16,
                     device=None) -> dict:
    dh, nkv = cfg.d_head, cfg.n_kv_heads
    device = resolve_device(device)
    return {
        "k": torch.zeros((batch, max_len, nkv, dh), dtype=dtype,
                         device=device),
        "v": torch.zeros((batch, max_len, nkv, dh), dtype=dtype,
                         device=device),
    }


def attention_prefill(p: Attention, cfg, x, cache, *, chunk_q=None,
                      chunk_k=None):
    """Prefill: run causal attention AND write the KV cache's first S
    slots (in place)."""
    B, S, _ = x.shape
    positions = torch.arange(S, device=x.device)[None, :]
    q, k, v = _project_qkv(p, cfg, x, positions)
    out = flash_attention(q, k, v, causal=True,
                          chunk_q=chunk_q or cfg.attn_chunk_q or S,
                          chunk_k=chunk_k or cfg.attn_chunk_k or S)
    cache["k"][:, :S] = k.to(cache["k"].dtype)
    cache["v"][:, :S] = v.to(cache["v"].dtype)
    y = out.reshape(B, S, -1) @ p.wo.to(x.dtype)
    return y, cache


def _write(buf: torch.Tensor, new: torch.Tensor, pos) -> None:
    """Write ``new`` (B, 1, KV, dh) into ``buf`` (B, S, KV, dh) at slot
    ``pos`` of every row (an int or a 0-d tensor), or at ``pos[b]`` of row
    ``b`` (a (B,) tensor)."""
    new = new[:, 0].to(buf.dtype)
    if isinstance(pos, int):
        buf[:, pos] = new
    elif pos.ndim == 0:
        buf.index_copy_(1, pos.reshape(1), new[:, None])
    else:
        buf[torch.arange(buf.shape[0], device=buf.device), pos] = new


def attention_decode(p: Attention, cfg, x, cache, pos, *, cross_kv=None):
    """One-token decode step.  x: (B, 1, d); pos: the write position, one
    for every row (an int or a 0-d tensor) or (B,) per row; both forms
    write the same values and give the same bits.

    With ``cross_kv`` (precomputed (B, Sk, KV, dh) pair) this is a
    cross-attention read: no cache update."""
    B = x.shape[0]
    dev = x.device
    if cross_kv is not None:
        q, _, _ = _project_qkv(p, cfg, x,
                               torch.zeros((B, 1), dtype=torch.int32,
                                           device=dev), use_rope=False)
        k, v = cross_kv
        Sk = k.shape[1]
        out = decode_attention(q, k, v, torch.full((B,), Sk,
                                                   dtype=torch.int32,
                                                   device=dev))
        return out.reshape(B, 1, -1) @ p.wo.to(x.dtype), cache

    pos_vec = torch.as_tensor(pos, dtype=torch.int32, device=dev)
    if pos_vec.ndim == 0:
        pos_vec = pos_vec.expand(B)
    q, k, v = _project_qkv(p, cfg, x, pos_vec[:, None])
    _write(cache["k"], k, pos)
    _write(cache["v"], v, pos)
    out = decode_attention(q, cache["k"], cache["v"], pos_vec + 1)
    return out.reshape(B, 1, -1) @ p.wo.to(x.dtype), cache
