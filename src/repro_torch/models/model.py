"""Model assembly: init / train forward / loss / prefill / decode for the
attention families.

The port of ``src/repro/models/model.py`` for two of its families:

``attn``   uniform decoder-only stacks (dense, VLM, MoE);
``encdec`` whisper: encoder (bidirectional, stub audio frames in) + decoder
           (causal self-attn + cross-attn).

The recurrent families (``xlstm``, ``zamba``) raise ``NotImplementedError``:
they are ROADMAP's next item, A14b-2.

Parameters are ``nn.Module``s named as the reference's nested dicts name
them; a layer stack is an ``nn.ModuleList`` walked by a Python loop where
the reference scans over a leading ``L`` dim.  The reference's ``_remat``
belongs to training and has no counterpart yet.  Caches are dicts of
tensors laid out as the reference's (a leading ``L`` dim); ``prefill`` and
``decode_step`` write them in place and return them.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch
from torch import nn

from repro_torch.configs.base import ArchConfig
from repro_torch.models import attention as attn
from repro_torch.models.common import cdtype, layer_norm, new_param, rms_norm
from repro_torch.models.mlp import (gelu_mlp, init_gelu_mlp, init_swiglu,
                                    swiglu)
from repro_torch.models.moe import init_moe, moe_apply
from repro_torch.util import resolve_device

__all__ = ["Model", "init_params", "params_from_reference", "forward_train",
           "loss_fn", "init_cache", "prefill", "decode_step"]


def _require_attention(cfg: ArchConfig) -> None:
    if not cfg.is_encdec and cfg.block_pattern != "attn":
        raise NotImplementedError(
            f"{cfg.name}: block pattern {cfg.block_pattern!r} is not ported "
            "yet (ROADMAP A14b-2: models/xlstm.py, models/mamba2.py and the "
            "xlstm / zamba branches of model.py)")


# --------------------------------------------------------------------- #
# blocks
# --------------------------------------------------------------------- #
class AttnBlock(nn.Module):
    """``ln1``, ``attn``; with an FFN ``ln2`` and ``ffn`` (``MoE`` with
    ``cfg.moe``, else ``SwiGLU`` when ``d_ff``; ``None`` otherwise)."""

    def __init__(self, cfg, with_ffn=True, device=None, generator=None):
        super().__init__()
        d = cfg.d_model
        self.ln1 = new_param((d,), device, generator, "ones")
        self.attn = attn.init_attention(generator, cfg, device=device)
        self.ln2 = (new_param((d,), device, generator, "ones")
                    if with_ffn else None)
        ffn = None
        if with_ffn and cfg.moe is not None:
            ffn = init_moe(generator, cfg, device)
        elif with_ffn and cfg.d_ff:
            ffn = init_swiglu(generator, d, cfg.d_ff, device)
        self.ffn = ffn


def _init_attn_block(generator, cfg: ArchConfig, with_ffn=True,
                     device=None) -> AttnBlock:
    """A block drawn from ``generator`` (left empty without one)."""
    return AttnBlock(cfg, with_ffn, resolve_device(device), generator)


def _ffn(p: AttnBlock, cfg, h):
    """The block's FFN on its pre-normed input: ``(y, aux)``."""
    z = rms_norm(h, p.ln2, cfg.norm_eps)
    if cfg.moe is not None:
        return moe_apply(p.ffn, cfg, z)
    return swiglu(p.ffn, z), {}


def _attn_block_train(p: AttnBlock, cfg, x):
    h = x + attn.attention_train(p.attn, cfg,
                                 rms_norm(x, p.ln1, cfg.norm_eps))
    aux = {}
    if p.ffn is not None:
        y, aux = _ffn(p, cfg, h)
        h = h + y
    return h, aux


def _attn_block_prefill(p: AttnBlock, cfg, x, cache):
    y, cache = attn.attention_prefill(p.attn, cfg,
                                      rms_norm(x, p.ln1, cfg.norm_eps),
                                      cache)
    h = x + y
    if p.ffn is not None:
        h = h + _ffn(p, cfg, h)[0]
    return h, cache


def _attn_block_decode(p: AttnBlock, cfg, x, cache, pos):
    y, cache = attn.attention_decode(p.attn, cfg,
                                     rms_norm(x, p.ln1, cfg.norm_eps),
                                     cache, pos)
    h = x + y
    if p.ffn is not None:
        h = h + _ffn(p, cfg, h)[0]
    return h, cache


# --------------------------------------------------------------------- #
# whisper blocks (LayerNorm + biases, GELU MLP; learned positions on the
# encoder, RoPE in the decoder's self-attention as in the reference)
# --------------------------------------------------------------------- #
class WhisperEncBlock(nn.Module):
    def __init__(self, cfg, device=None, generator=None):
        super().__init__()
        d = cfg.d_model
        self.ln1_w = new_param((d,), device, generator, "ones")
        self.ln1_b = new_param((d,), device, generator, "zeros")
        self.attn = attn.init_attention(generator, cfg, device=device)
        self.ln2_w = new_param((d,), device, generator, "ones")
        self.ln2_b = new_param((d,), device, generator, "zeros")
        self.ffn = init_gelu_mlp(generator, d, cfg.d_ff, device)


class WhisperDecBlock(nn.Module):
    def __init__(self, cfg, device=None, generator=None):
        super().__init__()
        d = cfg.d_model
        self.ln1_w = new_param((d,), device, generator, "ones")
        self.ln1_b = new_param((d,), device, generator, "zeros")
        self.self_attn = attn.init_attention(generator, cfg, device=device)
        self.ln2_w = new_param((d,), device, generator, "ones")
        self.ln2_b = new_param((d,), device, generator, "zeros")
        self.cross_attn = attn.init_attention(generator, cfg, cross=True,
                                              device=device)
        self.ln3_w = new_param((d,), device, generator, "ones")
        self.ln3_b = new_param((d,), device, generator, "zeros")
        self.ffn = init_gelu_mlp(generator, d, cfg.d_ff, device)


def _whisper_encode(params: "Model", cfg, frames):
    """frames: (B, n_audio_frames, d), the conv frontend stub's output."""
    dt = cdtype(cfg)
    x = frames.to(dt) + params.enc_pos.to(dt)
    for bp in params.enc_blocks:
        h = x + attn.attention_train(
            bp.attn, cfg, layer_norm(x, bp.ln1_w, bp.ln1_b, cfg.norm_eps),
            causal=False, use_rope=False)
        x = h + gelu_mlp(bp.ffn, layer_norm(h, bp.ln2_w, bp.ln2_b,
                                            cfg.norm_eps))
    return layer_norm(x, params.enc_norm_w, params.enc_norm_b, cfg.norm_eps)


def _whisper_dec_block_train(bp: WhisperDecBlock, cfg, x, enc_out):
    h = x + attn.attention_train(
        bp.self_attn, cfg,
        layer_norm(x, bp.ln1_w, bp.ln1_b, cfg.norm_eps), causal=True)
    h = h + attn.attention_train(
        bp.cross_attn, cfg,
        layer_norm(h, bp.ln2_w, bp.ln2_b, cfg.norm_eps),
        kv_source=enc_out)
    return h + gelu_mlp(bp.ffn,
                        layer_norm(h, bp.ln3_w, bp.ln3_b, cfg.norm_eps))


# --------------------------------------------------------------------- #
# the model
# --------------------------------------------------------------------- #
class Model(nn.Module):
    """``embed`` (vocab_padded, d), ``final_norm``, ``lm_head`` (d,
    vocab_padded) unless embeddings are tied; ``blocks`` for the ``attn``
    pattern; for whisper ``enc_pos``, ``enc_blocks``, ``enc_norm_w``/
    ``_b``, ``dec_blocks`` and ``final_norm_b``.  Without a ``generator``
    every parameter is left empty (``params_from_reference`` fills it)."""

    def __init__(self, cfg: ArchConfig, device=None, generator=None):
        super().__init__()
        _require_attention(cfg)
        d, vp, L = cfg.d_model, cfg.vocab_padded, cfg.n_layers
        # fan-in scaled so tied-embedding heads produce O(1) logits
        self.embed = new_param((vp, d), device, generator, d ** -0.5)
        self.final_norm = new_param((d,), device, generator, "ones")
        self.lm_head = (None if cfg.tie_embeddings
                        else new_param((d, vp), device, generator))
        if cfg.is_encdec:
            self.enc_pos = new_param((cfg.n_audio_frames, d), device,
                                     generator, 0.02)
            self.enc_blocks = nn.ModuleList(
                WhisperEncBlock(cfg, device, generator) for _ in range(L))
            self.enc_norm_w = new_param((d,), device, generator, "ones")
            self.enc_norm_b = new_param((d,), device, generator, "zeros")
            self.dec_blocks = nn.ModuleList(
                WhisperDecBlock(cfg, device, generator) for _ in range(L))
            self.final_norm_b = new_param((d,), device, generator, "zeros")
        else:
            self.blocks = nn.ModuleList(
                _init_attn_block(generator, cfg, device=device)
                for _ in range(L))


def init_params(cfg: ArchConfig, generator: torch.Generator,
                device=None) -> Model:
    """A model of ``cfg`` with weights drawn from ``generator`` (on its own
    device) as the reference draws them: ``dense_init``'s truncated normal
    times each weight's scale, norms at one, biases at zero."""
    return Model(cfg, resolve_device(device), generator)


#: the reference's layer-stacked subtrees and the port's module lists
_STACKS = ("blocks", "enc_blocks", "dec_blocks")


def _flatten(tree: dict, prefix: str = ""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flatten(v, f"{prefix}{k}.")
        else:
            yield f"{prefix}{k}", v


def params_from_reference(cfg: ArchConfig, tree: dict,
                          device=None) -> Model:
    """The port's model holding the numbers of the JAX package's
    ``init_params`` tree (nested dicts of numpy arrays; a leaf under
    ``blocks``/``enc_blocks``/``dec_blocks`` carries a leading ``L`` dim,
    layer ``i`` going to ``<stack>.<i>.<rest>``).  Every leaf must map onto
    one port parameter of the same shape and every port parameter must be
    filled: anything left over on either side raises."""
    model = Model(cfg, resolve_device(device))
    params = dict(model.named_parameters())
    filled: set[str] = set()

    def put(name: str, a: np.ndarray) -> None:
        if name not in params:
            raise KeyError(f"reference leaf {name} has no port parameter")
        t = params[name]
        if tuple(a.shape) != tuple(t.shape) or name in filled:
            raise ValueError(f"{name}: reference {a.shape}, port "
                             f"{tuple(t.shape)}, filled {name in filled}")
        t.copy_(torch.from_numpy(np.array(a, dtype=np.float32)))
        filled.add(name)

    for path, leaf in _flatten(tree):
        leaf = np.asarray(leaf)
        head, _, rest = path.partition(".")
        if head in _STACKS:
            for i in range(leaf.shape[0]):
                put(f"{head}.{i}.{rest}", leaf[i])
        else:
            put(path, leaf)
    missing = sorted(set(params) - filled)
    if missing:
        raise KeyError(f"port parameters with no reference leaf: {missing}")
    return model


# --------------------------------------------------------------------- #
# training forward and loss (values; the gradient comes with training)
# --------------------------------------------------------------------- #
def _embed(params: Model, cfg, tokens):
    dt = cdtype(cfg)
    x = params.embed[tokens].to(dt)
    return x * torch.tensor(cfg.d_model ** 0.5, dtype=dt, device=x.device)


def _unembed(params: Model, cfg, x):
    x = rms_norm(x, params.final_norm, cfg.norm_eps) \
        if not cfg.is_encdec else \
        layer_norm(x, params.final_norm, params.final_norm_b, cfg.norm_eps)
    w = params.embed.T if cfg.tie_embeddings else params.lm_head
    return x @ w.to(x.dtype)


def _zero(x) -> torch.Tensor:
    return torch.zeros((), dtype=torch.float32, device=x.device)


def forward_train(params: Model, cfg: ArchConfig, tokens, frames=None):
    """tokens: (B, S) int -> logits (B, S, vocab_padded) in the compute
    dtype; plus the MoE aux losses averaged over the layers."""
    _require_attention(cfg)
    x = _embed(params, cfg, tokens)
    if cfg.is_encdec:
        enc_out = _whisper_encode(params, cfg, frames)
        for bp in params.dec_blocks:
            x = _whisper_dec_block_train(bp, cfg, x, enc_out)
        return _unembed(params, cfg, x), {"load_balance_loss": _zero(x),
                                          "router_z_loss": _zero(x)}
    lb, rz = _zero(x), _zero(x)
    for bp in params.blocks:
        x, aux = _attn_block_train(bp, cfg, x)
        if aux:
            lb = lb + aux["load_balance_loss"]
            rz = rz + aux["router_z_loss"]
    return _unembed(params, cfg, x), {"load_balance_loss": lb / cfg.n_layers,
                                      "router_z_loss": rz / cfg.n_layers}


def loss_fn(params: Model, cfg: ArchConfig, batch: dict,
            z_loss_coef: float = 1e-4, moe_coef: float = 1e-2):
    """``(loss, metrics)``: next-token cross-entropy with the gold logit
    picked by an iota mask in float32, plus the z-loss (and the MoE aux
    losses), as the reference computes them."""
    tokens = batch["tokens"]
    logits, aux = forward_train(params, cfg, tokens,
                                frames=batch.get("frames"))
    logits = logits[:, :-1].float()
    targets = tokens[:, 1:]
    lmax = logits.amax(dim=-1, keepdim=True).detach()
    shifted = logits - lmax
    lse = torch.log(torch.sum(torch.exp(shifted), dim=-1)) + lmax[..., 0]
    vocab_ids = torch.arange(logits.shape[-1], device=logits.device)
    gold = torch.sum(torch.where(vocab_ids == targets[..., None], logits,
                                 0.0), dim=-1)
    nll = (lse - gold).mean()
    zl = (lse ** 2).mean()
    loss = nll + z_loss_coef * zl
    metrics: dict[str, Any] = {"nll": nll, "z_loss": zl}
    if cfg.moe is not None:
        loss = loss + moe_coef * aux["load_balance_loss"] \
            + z_loss_coef * aux["router_z_loss"]
        metrics.update(aux)
    return loss, metrics


# --------------------------------------------------------------------- #
# serving: cache init / prefill / decode
# --------------------------------------------------------------------- #
def init_cache(cfg: ArchConfig, batch: int, max_len: int,
               kv_dtype=torch.bfloat16, device=None) -> dict:
    """Zeroed caches in ``kv_dtype`` (bfloat16 whatever the compute
    dtype, as in the reference): ``{"kv": {"k", "v"}}`` of (L, B, max_len,
    KV, dh), or for whisper ``{"self": ..., "cross_k", "cross_v"}`` with
    the cross pair over ``n_audio_frames``."""
    _require_attention(cfg)
    device = resolve_device(device)

    def zeros(n, s):
        return torch.zeros((n, batch, s, cfg.n_kv_heads, cfg.d_head),
                           dtype=kv_dtype, device=device)

    L = cfg.n_layers
    if cfg.is_encdec:
        return {"self": {"k": zeros(L, max_len), "v": zeros(L, max_len)},
                "cross_k": zeros(L, cfg.n_audio_frames),
                "cross_v": zeros(L, cfg.n_audio_frames)}
    return {"kv": {"k": zeros(L, max_len), "v": zeros(L, max_len)}}


def _layer(kv: dict, i: int) -> dict:
    """Layer ``i``'s views of a stacked ``{"k", "v"}`` cache."""
    return {"k": kv["k"][i], "v": kv["v"][i]}


def prefill(params: Model, cfg: ArchConfig, tokens, cache, frames=None):
    """Run the full prompt, writing the caches in place.  Returns
    ``(cache, last_logits)`` with last_logits (B, 1, vocab_padded)."""
    _require_attention(cfg)
    x = _embed(params, cfg, tokens)
    if cfg.is_encdec:
        enc_out = _whisper_encode(params, cfg, frames)
        B, Sk, _ = enc_out.shape
        dt = enc_out.dtype
        for i, bp in enumerate(params.dec_blocks):
            y, _ = attn.attention_prefill(
                bp.self_attn, cfg,
                layer_norm(x, bp.ln1_w, bp.ln1_b, cfg.norm_eps),
                _layer(cache["self"], i))
            h = x + y
            h = h + attn.attention_train(
                bp.cross_attn, cfg,
                layer_norm(h, bp.ln2_w, bp.ln2_b, cfg.norm_eps),
                kv_source=enc_out)
            x = h + gelu_mlp(bp.ffn, layer_norm(h, bp.ln3_w, bp.ln3_b,
                                                cfg.norm_eps))
            # the cross K/V, computed once here, in the cache's dtype
            for name, w in (("cross_k", bp.cross_attn.wk),
                            ("cross_v", bp.cross_attn.wv)):
                cache[name][i] = (enc_out @ w.to(dt)).reshape(
                    B, Sk, cfg.n_kv_heads, cfg.d_head).to(cache[name].dtype)
        return cache, _unembed(params, cfg, x[:, -1:])
    for i, bp in enumerate(params.blocks):
        x, _ = _attn_block_prefill(bp, cfg, x, _layer(cache["kv"], i))
    return cache, _unembed(params, cfg, x[:, -1:])


def decode_step(params: Model, cfg: ArchConfig, tokens, cache, pos):
    """One-token step.  tokens: (B, 1) int; pos: the write position, an
    int or 0-d tensor for every row, or a (B,) tensor per row (the two give
    the same bits).  Writes the caches in place; returns (logits (B,
    vocab_padded), cache)."""
    _require_attention(cfg)
    x = _embed(params, cfg, tokens)
    if cfg.is_encdec:
        for i, bp in enumerate(params.dec_blocks):
            y, _ = attn.attention_decode(
                bp.self_attn, cfg,
                layer_norm(x, bp.ln1_w, bp.ln1_b, cfg.norm_eps),
                _layer(cache["self"], i), pos)
            h = x + y
            y2, _ = attn.attention_decode(
                bp.cross_attn, cfg,
                layer_norm(h, bp.ln2_w, bp.ln2_b, cfg.norm_eps),
                None, pos, cross_kv=(cache["cross_k"][i],
                                     cache["cross_v"][i]))
            h = h + y2
            x = h + gelu_mlp(bp.ffn, layer_norm(h, bp.ln3_w, bp.ln3_b,
                                                cfg.norm_eps))
        return _unembed(params, cfg, x)[:, 0], cache
    for i, bp in enumerate(params.blocks):
        x, _ = _attn_block_decode(bp, cfg, x, _layer(cache["kv"], i), pos)
    return _unembed(params, cfg, x)[:, 0], cache
