"""Model assembly: init / train forward / loss / prefill / decode for every
family.

The port of ``src/repro/models/model.py``:

``attn``   uniform decoder-only stacks (dense, VLM, MoE);
``xlstm``  period-8 pattern: 7 mLSTM blocks + 1 sLSTM block per period;
``zamba``  Mamba2 backbone with one *shared* attention block (and its
           SwiGLU) applied after every 5 mamba blocks, each application
           with its own KV-cache layer, then a mamba tail;
``encdec`` whisper: encoder (bidirectional, stub audio frames in) + decoder
           (causal self-attn + cross-attn).

Parameters are ``nn.Module``s named as the reference's nested dicts name
them; a layer stack is an ``nn.ModuleList`` walked by a Python loop where
the reference scans over a leading ``L`` dim (``params_from_reference``
and ``params_to_reference`` convert).  While a gradient is recorded each
block runs under ``_remat``, the reference's ``jax.checkpoint`` as
``torch.utils.checkpoint``.  Caches are dicts of tensors laid out as the
reference's (a leading ``L`` dim); ``prefill`` and ``decode_step`` write
them in place, record no graph, and return them.  The recurrent
families' prefill is their training forward that also writes each
layer's final state, so the two run the same arithmetic.

**On a mesh** (sharded serving): a model from
``runtime.sharded.init_sharded(..., serving=True)`` holds its blocks and
gathers each weight where it is read; a cache from
``runtime.sharded.init_cache_sharded`` is a dict of this rank's blocks
with ``placements`` (``cache_pspecs``), and the tokens are the rank's
rows (``batch_pspecs``).  Attention KV caches (and whisper's cross pair)
hold the rank's slice of the sequence and are never gathered
(``attention.SeqSplit``: a partial attention per slice, combined by one
small all-gather of the softmax statistics).  A recurrent state split
over ``model`` is gathered where a layer reads it and cut back to the
block after the layer (every rank of the group computes the layer whole:
duplicated compute, as training's).  A cache whose every group has one
member runs the code of a whole cache: a 1×1 mesh gives the one-device
bits.
"""
from __future__ import annotations

import functools
from typing import Any

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts,
                                    noop_context_fn)

from repro_torch.configs.base import ArchConfig
from repro_torch.models import attention as attn
from repro_torch.models import mamba2 as m2
from repro_torch.models import xlstm as xl
from repro_torch.models.common import (cdtype, constrain_batch, layer_norm,
                                       new_param, rms_norm)
from repro_torch.models.mlp import (gelu_mlp, init_gelu_mlp, init_swiglu,
                                    swiglu)
from repro_torch.models.moe import init_moe, moe_apply
from repro_torch.util import resolve_device

__all__ = ["Model", "init_params", "params_from_reference",
           "params_to_reference", "to_reference", "named_from_reference",
           "reference_like", "reference_ndim", "load_named",
           "forward_train", "loss_fn", "init_cache", "prefill",
           "decode_step"]


# --------------------------------------------------------------------- #
# rematerialisation (the reference's _remat)
# --------------------------------------------------------------------- #
#: the products whose outputs the ``dots`` policy keeps, as
#: ``jax.checkpoint_policies.checkpoint_dots`` keeps every dot's
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
         torch.ops.aten.addmm.default, torch.ops.aten.baddbmm.default)


def _dots_policy(ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op in _DOTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _remat(cfg, fn):
    """``fn`` as the reference's ``_remat`` wraps a block: under
    ``torch.utils.checkpoint`` (non-reentrant) recomputing the whole
    block in the backward (``remat_policy`` ``full``), or all but the
    products' outputs (``dots``); unwrapped with ``remat`` off or policy
    ``none``.  The wrap applies only while a gradient is recorded through
    a tensor argument (the residual stream): serving and value-only
    calls run ``fn`` as it is."""
    if not cfg.remat or cfg.remat_policy == "none":
        return fn
    if cfg.remat_policy == "dots":
        context_fn = functools.partial(create_selective_checkpoint_contexts,
                                       _dots_policy)
    elif cfg.remat_policy == "full":
        context_fn = noop_context_fn
    else:
        raise ValueError(f"remat_policy {cfg.remat_policy!r}")

    def wrapped(*args):
        if not (torch.is_grad_enabled() and any(
                isinstance(a, torch.Tensor) and a.requires_grad
                for a in args)):
            return fn(*args)
        return checkpoint(fn, *args, use_reentrant=False,
                          context_fn=context_fn)
    return wrapped


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
    return constrain_batch(h, dp=cfg.shard_strategy == "dp"), aux


def _attn_block_prefill(p: AttnBlock, cfg, x, cache):
    y, cache = attn.attention_prefill(p.attn, cfg,
                                      rms_norm(x, p.ln1, cfg.norm_eps),
                                      cache)
    h = x + y
    if p.ffn is not None:
        h = h + _ffn(p, cfg, h)[0]
    return constrain_batch(h, dp=cfg.shard_strategy == "dp"), cache


def _attn_block_decode(p: AttnBlock, cfg, x, cache, pos):
    y, cache = attn.attention_decode(p.attn, cfg,
                                     rms_norm(x, p.ln1, cfg.norm_eps),
                                     cache, pos)
    h = x + y
    if p.ffn is not None:
        h = h + _ffn(p, cfg, h)[0]
    return constrain_batch(h, dp=cfg.shard_strategy == "dp"), cache


# --------------------------------------------------------------------- #
# the recurrent families: blocks and their order
# --------------------------------------------------------------------- #
class MixBlock(nn.Module):
    """``ln`` and ``mix``: a recurrent mixer (``MLSTM``, ``SLSTM`` or
    ``Mamba2``) behind its pre-norm, with a residual around both."""

    def __init__(self, cfg, init_mix, device=None, generator=None):
        super().__init__()
        self.ln = new_param((cfg.d_model,), device, generator, "ones")
        self.mix = init_mix(generator, cfg, device)


def _xlstm_counts(cfg):
    n_s = sum(1 for i in range(cfg.n_layers) if cfg.block_kind(i) == "slstm")
    return cfg.n_layers - n_s, n_s


def _zamba_counts(cfg):
    n_attn = sum(1 for i in range(cfg.n_layers)
                 if cfg.block_kind(i) == "attn_shared")
    return cfg.n_layers - n_attn, n_attn


#: zamba: mamba blocks per shared-attention application
_ZAMBA_PER = 5


def _recurrent_order(cfg):
    """The layers in the reference's order, as ``(kind, index)``: index
    ``i`` of ``<kind>_blocks`` and of the cache's ``kind`` group, or the
    ``i``-th application of the shared attention (``"attn"``, KV layer
    ``i``)."""
    if cfg.block_pattern == "xlstm":
        n_m, n_s = _xlstm_counts(cfg)
        per = n_m // n_s if n_s else n_m
        for j in range(max(n_s, 1)):
            yield from (("mlstm", i) for i in range(j * per, (j + 1) * per))
            if n_s:
                yield "slstm", j
    else:
        n_m, n_a = _zamba_counts(cfg)
        for j in range(n_a):
            yield from (("mamba", i) for i in range(j * _ZAMBA_PER,
                                                    (j + 1) * _ZAMBA_PER))
            yield "attn", j
        yield from (("mamba", i) for i in range(_ZAMBA_PER * n_a, n_m))


#: kind -> (whole sequence, returning the final state; one-token step)
_MIXERS = {
    "mlstm": (xl.mlstm_prefill, xl.mlstm_decode),
    "slstm": (xl.slstm_prefill, xl.slstm_decode),
    "mamba": (m2.mamba2_prefill, m2.mamba2_decode),
}


def _mix_block_train(kind: str, bp: MixBlock, cfg, x):
    h = x + _MIXERS[kind][0](bp.mix, cfg,
                             rms_norm(x, bp.ln, cfg.norm_eps))[0]
    # the reference pins the mLSTM and Mamba blocks' outputs, not sLSTM's
    return h if kind == "slstm" else constrain_batch(
        h, dp=cfg.shard_strategy == "dp")


def _shared_attn_train(p: AttnBlock, cfg, x):
    return _attn_block_train(p, cfg, x)[0]


def _recurrent_seq(params: "Model", cfg, x, cache: dict | None = None):
    """The xlstm / zamba stack over a whole sequence: ``forward_train``
    (each block under ``_remat``), and ``prefill`` with ``cache``, where
    each layer's final state (and each shared-attention application's KV
    layer) is written."""
    if cache is None:
        mix, attn_block = (_remat(cfg, _mix_block_train),
                           _remat(cfg, _shared_attn_train))
    for kind, i in _recurrent_order(cfg):
        if kind == "attn":
            if cache is None:
                x = attn_block(params.shared_attn, cfg, x)
            else:
                x, _ = _attn_block_prefill(params.shared_attn, cfg, x,
                                           _kv_layer(cache, "attn_kv", i))
            continue
        bp = getattr(params, f"{kind}_blocks")[i]
        if cache is None:
            x = mix(kind, bp, cfg, x)
            continue
        y, st = _MIXERS[kind][0](bp.mix, cfg,
                                 rms_norm(x, bp.ln, cfg.norm_eps))
        x = x + y
        placed = _placed(cache, kind)
        for key, t in st.items():
            cache[kind][key][i].copy_(
                t if placed is None else _cut_state(t, placed[key]))
    return x


def _recurrent_decode(params: "Model", cfg, x, cache: dict, pos):
    """One token through the xlstm / zamba stack, each layer's state
    written in place; ``pos`` reaches only the shared attention."""
    for kind, i in _recurrent_order(cfg):
        if kind == "attn":
            x, _ = _attn_block_decode(params.shared_attn, cfg, x,
                                      _kv_layer(cache, "attn_kv", i), pos)
            continue
        bp = getattr(params, f"{kind}_blocks")[i]
        state, placed = _layer(cache[kind], i), _placed(cache, kind)
        whole = _whole_state(state, placed)
        y, _ = _MIXERS[kind][1](bp.mix, cfg, rms_norm(x, bp.ln, cfg.norm_eps),
                                whole)
        if whole is not state:          # the layer's blocks, cut back
            for key, t in whole.items():
                state[key].copy_(_cut_state(t, placed[key]))
        x = x + y
    return x


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


def _whisper_enc_block(bp: WhisperEncBlock, cfg, x):
    h = x + attn.attention_train(
        bp.attn, cfg, layer_norm(x, bp.ln1_w, bp.ln1_b, cfg.norm_eps),
        causal=False, use_rope=False)
    h = h + gelu_mlp(bp.ffn, layer_norm(h, bp.ln2_w, bp.ln2_b,
                                        cfg.norm_eps))
    return constrain_batch(h, dp=cfg.shard_strategy == "dp")


def _whisper_encode(params: "Model", cfg, frames):
    """frames: (B, n_audio_frames, d), the conv frontend stub's output."""
    dt = cdtype(cfg)
    x = frames.to(dt) + params.enc_pos.to(dt)
    block = _remat(cfg, _whisper_enc_block)
    for bp in params.enc_blocks:
        x = block(bp, cfg, x)
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
    pattern; ``mlstm_blocks`` and ``slstm_blocks`` for ``xlstm``;
    ``mamba_blocks`` and the one ``shared_attn`` (an ``AttnBlock`` with
    its FFN) for ``zamba``; for whisper ``enc_pos``, ``enc_blocks``,
    ``enc_norm_w``/``_b``, ``dec_blocks`` and ``final_norm_b``.  Without
    a ``generator`` every parameter is left empty
    (``params_from_reference`` fills it)."""

    def __init__(self, cfg: ArchConfig, device=None, generator=None):
        super().__init__()
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
        elif cfg.block_pattern == "attn":
            self.blocks = nn.ModuleList(
                _init_attn_block(generator, cfg, device=device)
                for _ in range(L))
        elif cfg.block_pattern == "xlstm":
            n_m, n_s = _xlstm_counts(cfg)
            self.mlstm_blocks = nn.ModuleList(
                MixBlock(cfg, xl.init_mlstm, device, generator)
                for _ in range(n_m))
            self.slstm_blocks = nn.ModuleList(
                MixBlock(cfg, xl.init_slstm, device, generator)
                for _ in range(n_s))
        elif cfg.block_pattern == "zamba":
            n_m, _ = _zamba_counts(cfg)
            self.mamba_blocks = nn.ModuleList(
                MixBlock(cfg, m2.init_mamba2, device, generator)
                for _ in range(n_m))
            self.shared_attn = _init_attn_block(generator, cfg, device=device)
        else:
            raise ValueError(cfg.block_pattern)


def init_params(cfg: ArchConfig, generator: torch.Generator,
                device=None, trainable: bool = False) -> Model:
    """A model of ``cfg`` with weights drawn from ``generator`` (on its own
    device) as the reference draws them: ``dense_init``'s truncated normal
    times each weight's scale, norms at one, biases at zero.  Every
    parameter keeps a gradient with ``trainable``."""
    return Model(cfg, resolve_device(device), generator).requires_grad_(
        trainable)


#: the reference's layer-stacked subtrees and the port's module lists
_STACKS = ("blocks", "enc_blocks", "dec_blocks", "mlstm_blocks",
           "slstm_blocks", "mamba_blocks")


def _flatten(tree: dict, prefix: str = ""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flatten(v, f"{prefix}{k}.")
        else:
            yield f"{prefix}{k}", v


def named_from_reference(tree: dict) -> dict[str, np.ndarray]:
    """A tree in the reference's layout (nested dicts; a leaf under one
    of ``_STACKS`` carries a leading ``L`` dim) as the port's parameter
    names: layer ``i`` of ``<stack>.<rest>`` goes to
    ``<stack>.<i>.<rest>``."""
    out: dict[str, np.ndarray] = {}
    for path, leaf in _flatten(tree):
        leaf = np.asarray(leaf)
        head, _, rest = path.partition(".")
        if head in _STACKS:
            out.update((f"{head}.{i}.{rest}", leaf[i])
                       for i in range(leaf.shape[0]))
        else:
            out[path] = leaf
    return out


def _nest(named: dict, leaf, stack) -> dict:
    """The port's parameter names to the reference's nested layout:
    ``leaf`` converts each value, ``stack`` makes one leaf of a stack's
    layers (in layer order)."""
    tree: dict = {}
    stacks: dict[str, dict[int, object]] = {}
    for name, t in named.items():
        head, _, rest = name.partition(".")
        if head in _STACKS:
            i, _, rest = rest.partition(".")
            stacks.setdefault(f"{head}.{rest}", {})[int(i)] = leaf(t)
        else:
            stacks[name] = {-1: leaf(t)}
    for path, layers in stacks.items():
        a = (layers[-1] if -1 in layers
             else stack([layers[i] for i in range(len(layers))]))
        *parents, key = path.split(".")
        node = tree
        for p in parents:
            node = node.setdefault(p, {})
        node[key] = a
    return tree


def to_reference(named: dict) -> dict:
    """The inverse of ``named_from_reference``: tensors (or arrays) under
    the port's parameter names as numpy leaves in the reference's nested
    layout, each stack's layers restacked along a leading ``L`` dim."""
    def host(t):
        return (t.detach().cpu().numpy() if isinstance(t, torch.Tensor)
                else np.asarray(t))
    return _nest(named, host, np.stack)


def reference_like(named: dict) -> dict:
    """The structure of ``to_reference(named)`` (tensors by name) with
    meta-device leaves of its shapes and dtypes: a restore template that
    copies no number."""
    return _nest(named, lambda t: torch.empty(t.shape, dtype=t.dtype,
                                              device="meta"),
                 lambda ls: ls[0].new_empty((len(ls), *ls[0].shape)))


def params_to_reference(model: Model) -> dict:
    """The model's parameters as the JAX package's ``init_params`` tree
    (numpy float32 leaves, stacks restacked): what a checkpoint holds."""
    return to_reference(dict(model.named_parameters()))


def reference_ndim(name: str, t: torch.Tensor) -> int:
    """The rank of the reference leaf that parameter ``name`` belongs to:
    a layer of a stack is one dim short of its stacked leaf."""
    return t.ndim + (name.partition(".")[0] in _STACKS)


def params_from_reference(cfg: ArchConfig, tree: dict, device=None,
                          trainable: bool = False) -> Model:
    """The port's model holding the numbers of the JAX package's
    ``init_params`` tree (nested dicts of numpy arrays; a leaf under one
    of ``_STACKS`` carries a leading ``L`` dim, layer ``i`` going to
    ``<stack>.<i>.<rest>``; zamba's ``shared_attn`` is one block).  Every
    leaf must map onto one port parameter of the same shape and every
    port parameter must be filled: anything left over on either side
    raises.  Every parameter keeps a gradient with ``trainable``."""
    model = Model(cfg, resolve_device(device))
    load_named(model, named_from_reference(tree))
    return model.requires_grad_(trainable)


def load_named(model: Model, named: dict) -> None:
    """Copy ``named`` (the port's parameter names to arrays) into the
    model's parameters; every name must match one parameter of the same
    shape, and every parameter must be filled."""
    params = dict(model.named_parameters())
    extra = sorted(set(named) - set(params))
    if extra:
        raise KeyError(f"reference leaves with no port parameter: {extra}")
    missing = sorted(set(params) - set(named))
    if missing:
        raise KeyError(f"port parameters with no reference leaf: {missing}")
    with torch.no_grad():
        for name, a in named.items():
            t = params[name]
            a = np.asarray(a)
            if tuple(a.shape) != tuple(t.shape):
                raise ValueError(f"{name}: reference {a.shape}, port "
                                 f"{tuple(t.shape)}")
            t.copy_(torch.from_numpy(np.array(a, dtype=np.float32)))


# --------------------------------------------------------------------- #
# training forward and loss
# --------------------------------------------------------------------- #
def _embed(params: Model, cfg, tokens):
    dt = cdtype(cfg)
    x = params.embed[tokens].to(dt)
    x = x * torch.tensor(cfg.d_model ** 0.5, dtype=dt, device=x.device)
    return constrain_batch(x, dp=cfg.shard_strategy == "dp")


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
    dtype; plus the MoE aux losses averaged over the layers (zero
    without MoE)."""
    x = _embed(params, cfg, tokens)
    if cfg.is_encdec:
        enc_out = _whisper_encode(params, cfg, frames)
        block = _remat(cfg, _whisper_dec_block_train)
        for bp in params.dec_blocks:
            x = block(bp, cfg, x, enc_out)
        return _unembed(params, cfg, x), {"load_balance_loss": _zero(x),
                                          "router_z_loss": _zero(x)}
    lb, rz = _zero(x), _zero(x)
    if cfg.block_pattern != "attn":
        return _unembed(params, cfg, _recurrent_seq(params, cfg, x)), {
            "load_balance_loss": lb, "router_z_loss": rz}
    block = _remat(cfg, _attn_block_train)
    for bp in params.blocks:
        x, aux = block(bp, cfg, x)
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
    """Zeroed caches, the KV pairs in ``kv_dtype`` (bfloat16 whatever the
    compute dtype, as in the reference): ``{"kv": {"k", "v"}}`` of (L, B,
    max_len, KV, dh); for whisper ``{"self": ..., "cross_k", "cross_v"}``
    with the cross pair over ``n_audio_frames``; for xlstm ``{"mlstm":
    {"C", "n", "m"}, "slstm": {"c", "n", "m", "h"}}`` in float32; for
    zamba ``{"mamba": {"h" float32, "conv" bfloat16}, "attn_kv": {"k",
    "v"}}`` with one KV layer per shared-attention application.  Every
    state carries a leading layer dim."""
    device = resolve_device(device)

    def zeros(n, s):
        return torch.zeros((n, batch, s, cfg.n_kv_heads, cfg.d_head),
                           dtype=kv_dtype, device=device)

    def stacked(n, init_state):
        # a layer's shapes and dtypes, read off a state on the meta device
        return {k: torch.zeros((n, *t.shape), dtype=t.dtype, device=device)
                for k, t in init_state(cfg, batch, "meta").items()}

    L = cfg.n_layers
    if cfg.block_pattern == "xlstm":
        n_m, n_s = _xlstm_counts(cfg)
        return {"mlstm": stacked(n_m, xl.init_mlstm_state),
                "slstm": stacked(n_s, xl.init_slstm_state)}
    if cfg.block_pattern == "zamba":
        n_m, n_a = _zamba_counts(cfg)
        return {"mamba": stacked(n_m, m2.init_mamba2_state),
                "attn_kv": {"k": zeros(n_a, max_len),
                            "v": zeros(n_a, max_len)}}
    if cfg.is_encdec:
        return {"self": {"k": zeros(L, max_len), "v": zeros(L, max_len)},
                "cross_k": zeros(L, cfg.n_audio_frames),
                "cross_v": zeros(L, cfg.n_audio_frames)}
    return {"kv": {"k": zeros(L, max_len), "v": zeros(L, max_len)}}


def _layer(group: dict, i: int) -> dict:
    """Layer ``i``'s views of a stacked cache group (``{"k", "v"}`` or a
    recurrent state)."""
    return {k: t[i] for k, t in group.items()}


def _placed(cache, *path):
    """The placements of ``cache[path]`` when the cache is held as blocks
    on a mesh (``runtime.sharded.init_cache_sharded``), else ``None``."""
    out = getattr(cache, "placements", None)
    for k in path:
        if out is None:
            return None
        out = out[k]
    return out


def _kv_layer(cache, key: str, i: int) -> dict:
    """Layer ``i``'s views of the KV group ``cache[key]``, with its
    sequence split when the group is held as slices over a mesh."""
    out = _layer(cache[key], i)
    placed = _placed(cache, key)
    split = None if placed is None else attn.seq_split(placed["k"])
    if split is not None:
        out["split"] = split
    return out


def _state_splits(placement) -> list:
    """A recurrent state's splits in a layer's view, ``(dim, axes)``: the
    stacked leaf's splits past its layer and batch dims (the batch is the
    rank's rows, as the activations are)."""
    return [(d - 1, axes) for d, axes in placement.splits
            if d >= 2 and placement.parts(axes) > 1]


def _whole_state(state: dict, placed: dict | None) -> dict:
    """Layer views of a recurrent state, each gathered whole along the
    dims its placement splits (``state`` itself when nothing is split)."""
    if placed is None or not any(_state_splits(placed[k]) for k in state):
        return state
    from repro_torch.runtime.sharded import all_gather_dim

    out = {}
    for k, t in state.items():
        pl = placed[k]
        for d, axes in reversed(_state_splits(pl)):
            t = all_gather_dim(t, pl.mesh, pl.mesh.group(axes),
                               pl.parts(axes), d)
        out[k] = t
    return out


def _cut_state(t: torch.Tensor, placement) -> torch.Tensor:
    """This rank's block of a layer's whole state ``t``."""
    for d, axes in _state_splits(placement):
        size = t.shape[d] // placement.parts(axes)
        t = t.narrow(d, placement.part_index(axes) * size, size)
    return t


def _check_rows(cache, x) -> None:
    """A cache held as blocks must hold the rows the activations hold."""
    if _placed(cache) is None:
        return
    b = next(_leaves(cache)).shape[1]
    if b != x.shape[0]:
        raise ValueError(f"the cache blocks hold {b} rows, the tokens "
                         f"{x.shape[0]}: tokens and caches must split "
                         "the batch alike (batch_pspecs, cache_pspecs)")


def _leaves(tree: dict):
    for v in tree.values():
        yield from _leaves(v) if isinstance(v, dict) else (v,)


@torch.no_grad()
def prefill(params: Model, cfg: ArchConfig, tokens, cache, frames=None):
    """Run the full prompt, writing the caches in place.  Returns
    ``(cache, last_logits)`` with last_logits (B, 1, vocab_padded)."""
    x = _embed(params, cfg, tokens)
    _check_rows(cache, x)
    if cfg.is_encdec:
        enc_out = _whisper_encode(params, cfg, frames)
        B, Sk, _ = enc_out.shape
        dt = enc_out.dtype
        cross = _cross_split(cache)
        for i, bp in enumerate(params.dec_blocks):
            y, _ = attn.attention_prefill(
                bp.self_attn, cfg,
                layer_norm(x, bp.ln1_w, bp.ln1_b, cfg.norm_eps),
                _kv_layer(cache, "self", i))
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
                kv = (enc_out @ w.to(dt)).reshape(
                    B, Sk, cfg.n_kv_heads, cfg.d_head).to(cache[name].dtype)
                if cross is None:
                    cache[name][i] = kv
                else:
                    attn.write_slice(cache[name][i], kv, cross)
        return cache, _unembed(params, cfg, x[:, -1:])
    if cfg.block_pattern != "attn":
        x = _recurrent_seq(params, cfg, x, cache)
        return cache, _unembed(params, cfg, x[:, -1:])
    for i, bp in enumerate(params.blocks):
        x, _ = _attn_block_prefill(bp, cfg, x, _kv_layer(cache, "kv", i))
    return cache, _unembed(params, cfg, x[:, -1:])


def _cross_split(cache):
    """Whisper's cross pair's sequence split (``None``: whole)."""
    placed = _placed(cache, "cross_k")
    return None if placed is None else attn.seq_split(placed)


@torch.no_grad()
def decode_step(params: Model, cfg: ArchConfig, tokens, cache, pos):
    """One-token step.  tokens: (B, 1) int; pos: the write position, an
    int or 0-d tensor for every row, or a (B,) tensor per row (the two give
    the same bits; xlstm has no position and ignores it).  Writes the
    caches in place; returns (logits (B, vocab_padded), cache)."""
    x = _embed(params, cfg, tokens)
    _check_rows(cache, x)
    if cfg.is_encdec:
        cross = _cross_split(cache)
        for i, bp in enumerate(params.dec_blocks):
            y, _ = attn.attention_decode(
                bp.self_attn, cfg,
                layer_norm(x, bp.ln1_w, bp.ln1_b, cfg.norm_eps),
                _kv_layer(cache, "self", i), pos)
            h = x + y
            y2, _ = attn.attention_decode(
                bp.cross_attn, cfg,
                layer_norm(h, bp.ln2_w, bp.ln2_b, cfg.norm_eps),
                None, pos, cross_kv=(cache["cross_k"][i],
                                     cache["cross_v"][i]),
                cross_split=cross)
            h = h + y2
            x = h + gelu_mlp(bp.ffn, layer_norm(h, bp.ln3_w, bp.ln3_b,
                                                cfg.norm_eps))
        return _unembed(params, cfg, x)[:, 0], cache
    if cfg.block_pattern != "attn":
        x = _recurrent_decode(params, cfg, x, cache, pos)
        return _unembed(params, cfg, x)[:, 0], cache
    for i, bp in enumerate(params.blocks):
        x, _ = _attn_block_decode(bp, cfg, x, _kv_layer(cache, "kv", i), pos)
    return _unembed(params, cfg, x)[:, 0], cache
