"""GQA attention layer (multi-query / grouped-query, RoPE, optional QK-norm,
optional QKV bias) with train / prefill / decode entry points.

The port of ``src/repro/models/attention.py``.  Weights are stored 2-D with
heads fused into the output dim, ``(in, out)``, as in the reference.  The
KV cache is a pair of ``(B, max_len, KV, dh)`` tensors per layer that
``attention_prefill`` and ``attention_decode`` write in place (the
reference returns new arrays; the port keeps one buffer) and return.

**Sequence-split caches** (sharded serving, ``runtime.sharding.
cache_pspecs``: distributed flash-decode).  A layer's cache dict may carry
``"split"``, a :class:`SeqSplit`: its ``k`` / ``v`` are then this rank's
slice of the slots, ``[index·n, (index+1)·n)`` of the whole cache, and the
other slices lie on the ranks of ``group``.  Prefill computes the prompt's
attention on the rank's whole rows as before and keeps only its slice of
``k`` / ``v``; decode writes the new token's ``k`` / ``v`` on the rank
whose slice holds ``pos`` only, attends over its own slots with its own
running max ``m``, sum ``l`` and output ``o`` (a slice with no valid slot
gives ``m = -inf, l = 0, o = 0``), and combines them over the group by
one all-gather of ``(o, m, l)`` (B × heads × (dh + 2), float32), each
partial rescaled by ``exp(m_r - m)``, summed in rank order, so every rank
holds the same bits.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch
from torch import nn

from repro_torch.models.common import (decode_attention, flash_attention,
                                       new_param, rms_norm, rope)
from repro_torch.util import resolve_device

__all__ = ["Attention", "init_attention", "attention_train",
           "attention_prefill", "attention_decode", "init_cache_layer",
           "SeqSplit", "seq_split", "split_decode_attention",
           "write_slice"]


@dataclasses.dataclass(frozen=True, eq=False)
class SeqSplit:
    """A cache split along its sequence over a process ``group`` of
    ``mesh`` in ``parts`` slices: this rank holds slice ``index``."""

    mesh: Any
    group: Any
    parts: int
    index: int


def seq_split(placement) -> SeqSplit | None:
    """The :class:`SeqSplit` of a stacked KV leaf's placement (``(L, B, S,
    KV, dh)``, ``runtime.sharding.NamedSharding``), or ``None`` when its
    sequence is whole on this rank."""
    for d, axes in placement.splits:
        if d == 2:
            group = placement.mesh.group(axes)
            if group is None:
                return None
            return SeqSplit(placement.mesh, group, placement.parts(axes),
                            placement.part_index(axes))
    return None


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
    split = cache.get("split")
    if split is None:
        cache["k"][:, :S] = k.to(cache["k"].dtype)
        cache["v"][:, :S] = v.to(cache["v"].dtype)
    else:
        write_slice(cache["k"], k, split)
        write_slice(cache["v"], v, split)
    y = out.reshape(B, S, -1) @ p.wo.to(x.dtype)
    return y, cache


def write_slice(buf: torch.Tensor, new: torch.Tensor,
                split: SeqSplit) -> None:
    """Write the part of ``new`` (B, S, ...: slots ``[0, S)`` of the whole
    sequence) that falls in this rank's slice into ``buf`` (B, n, ...)."""
    n = buf.shape[1]
    lo = split.index * n
    hi = min(lo + n, new.shape[1])
    if hi > lo:
        buf[:, :hi - lo] = new[:, lo:hi].to(buf.dtype)


def _write(buf: torch.Tensor, new: torch.Tensor, pos) -> None:
    """Write ``new`` (B, 1, KV, dh) into ``buf`` (B, S, KV, dh) at slot
    ``pos`` of every row (an int or a 0-d tensor), or at ``pos[b]`` of row
    ``b`` (a (B,) tensor)."""
    new = new[:, 0].to(buf.dtype)
    if isinstance(pos, int):
        buf[:, pos] = new
    elif pos.ndim == 0:
        buf.index_copy_(1, pos.reshape(1).to(torch.int64), new[:, None])
    else:
        buf[torch.arange(buf.shape[0], device=buf.device), pos] = new


def _write_split(buf: torch.Tensor, new: torch.Tensor, pos,
                 split: SeqSplit) -> None:
    """:func:`_write` on this rank's slice of the slots: only the slot
    ``pos`` falls in is written (a tensor ``pos`` by a masked write, so
    the host never waits for it)."""
    n = buf.shape[1]
    lo = split.index * n
    if isinstance(pos, int):
        if lo <= pos < lo + n:
            _write(buf, new, pos - lo)
        return
    new = new[:, 0].to(buf.dtype)
    local = pos.to(torch.int64) - lo
    inside = (local >= 0) & (local < n)
    idx = local.clamp(0, n - 1)
    if pos.ndim == 0:
        cur = buf.index_select(1, idx.reshape(1))[:, 0]
        buf.index_copy_(1, idx.reshape(1),
                        torch.where(inside, new, cur)[:, None])
    else:
        rows = torch.arange(buf.shape[0], device=buf.device)
        cur = buf[rows, idx]
        buf[rows, idx] = torch.where(inside.reshape(-1, *[1] * (new.ndim - 1)),
                                     new, cur)


def split_decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                           v_cache: torch.Tensor, lengths: torch.Tensor,
                           split: SeqSplit, *,
                           soft_cap: float | None = None) -> torch.Tensor:
    """``common.decode_attention`` over a sequence-split cache: this rank's
    slice ``k_cache`` / ``v_cache`` (B, n, KV, dh) of slots ``[index·n,
    (index+1)·n)``, keys at or past ``lengths`` (B,) masked.  The partial
    ``(o, m, l)`` of the slice (float32) is all-gathered over the split's
    group and combined in rank order: ``out = Σ o_r e^{m_r - m} / Σ l_r
    e^{m_r - m}`` with ``m = max m_r``."""
    from repro_torch.runtime.sharded import all_gather_dim

    B, one, H, dh = q.shape
    _, n, KV, _ = k_cache.shape
    G = H // KV
    qf = q.reshape(B, KV, G, dh).float() * dh ** -0.5
    s = torch.einsum("bvgd,bsvd->bvgs", qf, k_cache.float())   # (B,KV,G,n)
    if soft_cap is not None:
        s = soft_cap * torch.tanh(s / soft_cap)
    slot = split.index * n + torch.arange(n, device=q.device)
    mask = slot[None] < lengths[:, None]                        # (B, n)
    s = torch.where(mask[:, None, None], s, float("-inf"))
    m = s.amax(dim=-1)                                          # (B,KV,G)
    # a slice with no valid slot: m = -inf, p = 0, l = 0, o = 0
    p = torch.exp(s - torch.where(torch.isfinite(m), m, 0.0)[..., None])
    l = p.sum(dim=-1)
    o = torch.einsum("bvgs,bsvd->bvgd", p, v_cache.float())
    stats = torch.cat([o, m[..., None], l[..., None]], dim=-1)
    every = all_gather_dim(stats[None], split.mesh, split.group,
                           split.parts, 0)              # (parts,B,KV,G,dh+2)
    m_all = every[..., dh]
    w = torch.exp(m_all - m_all.amax(dim=0))
    out = (every[..., :dh] * w[..., None]).sum(dim=0) \
        / (every[..., dh + 1] * w).sum(dim=0)[..., None]
    return out.reshape(B, 1, H, dh).to(q.dtype)


def attention_decode(p: Attention, cfg, x, cache, pos, *, cross_kv=None,
                     cross_split: SeqSplit | None = None):
    """One-token decode step.  x: (B, 1, d); pos: the write position, one
    for every row (an int or a 0-d tensor) or (B,) per row; both forms
    write the same values and give the same bits.

    With ``cross_kv`` (precomputed (B, Sk, KV, dh) pair) this is a
    cross-attention read: no cache update (``cross_split``: the pair is
    this rank's slice of the frames).  A ``cache`` with a ``"split"``
    holds this rank's slice of the slots (the module docstring)."""
    B = x.shape[0]
    dev = x.device
    if cross_kv is not None:
        q, _, _ = _project_qkv(p, cfg, x,
                               torch.zeros((B, 1), dtype=torch.int32,
                                           device=dev), use_rope=False)
        k, v = cross_kv
        Sk = k.shape[1]
        if cross_split is None:
            out = decode_attention(q, k, v, torch.full(
                (B,), Sk, dtype=torch.int32, device=dev))
        else:
            out = split_decode_attention(q, k, v, torch.full(
                (B,), Sk * cross_split.parts, dtype=torch.int32,
                device=dev), cross_split)
        return out.reshape(B, 1, -1) @ p.wo.to(x.dtype), cache

    pos_vec = torch.as_tensor(pos, dtype=torch.int32, device=dev)
    if pos_vec.ndim == 0:
        pos_vec = pos_vec.expand(B)
    q, k, v = _project_qkv(p, cfg, x, pos_vec[:, None])
    split = cache.get("split")
    if split is None:
        _write(cache["k"], k, pos)
        _write(cache["v"], v, pos)
        out = decode_attention(q, cache["k"], cache["v"], pos_vec + 1)
    else:
        _write_split(cache["k"], k, pos, split)
        _write_split(cache["v"], v, pos, split)
        out = split_decode_attention(q, cache["k"], cache["v"], pos_vec + 1,
                                     split)
    return out.reshape(B, 1, -1) @ p.wo.to(x.dtype), cache
