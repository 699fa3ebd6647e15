"""Shared model components: norms, RoPE, initialisers, blockwise attention.

The port of ``src/repro/models/common.py``.  The math is plain functions on
tensors; parameters live in the ``nn.Module``s of ``mlp``, ``attention``,
``moe`` and ``model``.  Each function keeps the reference's casts, so the
port rounds where the reference rounds: norms and RoPE in float32 and back,
attention scores and ``P·V`` accumulated in float32 from tiles kept in the
storage dtype.

``flash_attention``'s backward is the reference's ``_flash_bwd``, a
``torch.autograd.Function`` that recomputes each score tile (no S² state
is kept); ``prefix_sum`` is the scans' ``cumsum`` in a form that is
deterministic on the card.

``constrain_batch`` is the reference's layout hint at the same seven
places of the model: it changes no value, and without an ambient mesh
(:func:`use_mesh`) it returns its input as it is.  Under a mesh it works
out the batch axes the reference pins the activation to, with the
reference's fall-back when the batch does not divide them, and records
them for a :func:`record_constraints` block.  The port's activations are
already the rank's rows of the batch (the mesh trainer split it), so
nothing moves.
"""
from __future__ import annotations

import contextlib
import math

import torch
from torch import nn

__all__ = ["rms_norm", "layer_norm", "rope", "dense_init", "new_param",
           "flash_attention", "decode_attention", "cdtype", "pad_seq",
           "prefix_sum", "constrain_batch", "use_mesh", "ambient_mesh",
           "record_constraints", "on_new_param"]

#: the meshes of the enclosing ``use_mesh`` blocks (innermost last), each
#: with the number of shards its trainer split the batch into
_MESHES: list = []
#: the open ``record_constraints`` logs
_LOGS: list = []
#: the enclosing ``on_new_param`` hooks (innermost last)
_MADE: list = []


@contextlib.contextmanager
def use_mesh(mesh, batch_shards: int = 1):
    """``mesh`` is the ambient mesh inside the block; the model's
    activations hold ``1/batch_shards`` of the global batch's rows."""
    _MESHES.append((mesh, batch_shards))
    try:
        yield mesh
    finally:
        _MESHES.pop()


@contextlib.contextmanager
def on_new_param(hook):
    """Inside the block every parameter :func:`new_param` makes, drawn
    and whole, goes through ``hook(param) -> param`` before the module
    keeps it, in the order they are drawn (a rank keeps its block of each
    leaf and frees the leaf before the next is drawn)."""
    _MADE.append(hook)
    try:
        yield
    finally:
        _MADE.pop()


def ambient_mesh():
    """The mesh of the innermost ``use_mesh`` block, or None."""
    return _MESHES[-1][0] if _MESHES else None


@contextlib.contextmanager
def record_constraints():
    """A list of ``(activation shape, batch axes)``, one per
    ``constrain_batch`` under a mesh inside the block."""
    log: list = []
    _LOGS.append(log)
    try:
        yield log
    finally:
        _LOGS.remove(log)


def constrain_batch(x: torch.Tensor, batch_axis: int = 0,
                    dp: bool = False) -> torch.Tensor:
    """Pin the batch dim of an activation to the data-parallel mesh axes
    (a layout hint: ``x`` is returned as it is).

    The identity when no mesh is ambient.  Under one, the axes are
    ``(pod, data)`` (with ``dp`` also ``model``) present on the mesh,
    dropped from the front until the global batch divides them (none when
    it divides none, e.g. global_batch=1 long-context decode), as the
    reference drops them; they are recorded for
    :func:`record_constraints`."""
    if not _MESHES:
        return x
    m, shards = _MESHES[-1]
    names = ("pod", "data", "model") if dp else ("pod", "data")
    bax = tuple(a for a in names if a in m.axis_names)
    n = x.shape[batch_axis] * shards
    while bax and n % math.prod(m.shape[a] for a in bax):
        bax = bax[1:]
    for log in _LOGS:
        log.append((tuple(x.shape), bax))
    return x


def cdtype(cfg) -> torch.dtype:
    """The compute dtype a config names (``"bfloat16"`` → ``torch.bfloat16``)."""
    return getattr(torch, cfg.compute_dtype)


def dense_init(generator: torch.Generator, shape, scale: float | None = None,
               dtype=torch.float32, device=None) -> torch.Tensor:
    """Truncated-normal fan-in init: a standard normal cut to ±2, times
    ``scale`` (default ``1/sqrt(shape[0])``), drawn from ``generator`` on
    its own device and placed on ``device`` (the generator's when
    ``None``)."""
    fan_in = shape[0]
    s = scale if scale is not None else 1.0 / math.sqrt(fan_in)
    t = torch.empty(shape, dtype=torch.float32, device=generator.device)
    torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=generator)
    return (t * s).to(device=device, dtype=dtype)


def new_param(shape, device, generator: torch.Generator | None = None,
              init: str | float | torch.Tensor | None = None
              ) -> nn.Parameter:
    """A float32 parameter of ``shape`` on ``device``: left empty without
    a ``generator`` (``params_from_reference`` fills it), else ``init``
    ``"ones"``, ``"zeros"``, a tensor of fixed values (the recurrent
    blocks' gate biases and decay rates), or ``dense_init`` with ``init``
    as its scale (``None``: the fan-in scale).  Serving needs no gradient,
    so none is kept: a trainer turns it on (``init_params(...,
    trainable=True)``)."""
    if isinstance(init, torch.Tensor) and generator is not None:
        assert tuple(init.shape) == tuple(shape), (init.shape, shape)
        t = init.to(device=device, dtype=torch.float32)
    elif generator is None or init == "ones" or init == "zeros":
        t = torch.empty(shape, dtype=torch.float32, device=device)
        if generator is not None:
            t.fill_(1.0 if init == "ones" else 0.0)
    else:
        t = dense_init(generator, shape, scale=init, device=device)
    p = nn.Parameter(t, requires_grad=False)
    return _MADE[-1](p) if _MADE else p


def prefix_sum(x: torch.Tensor, dim: int) -> torch.Tensor:
    """The inclusive prefix sum of ``x`` along ``dim``, as a float64
    product with a lower-triangular matrix of ones, rounded once to
    ``x``'s dtype.  The scans' ``cumsum`` in this form is deterministic on
    the card (CUDA's float ``cumsum`` has no deterministic kernel, so a
    deterministic trainer refuses it), is never TF32, and its gradient is
    the transposed product."""
    n = x.shape[dim]
    tri = torch.tril(torch.ones((n, n), dtype=torch.float64,
                                device=x.device))
    y = tri @ x.movedim(dim, -2).double()
    return y.to(x.dtype).movedim(-2, dim)


def pad_seq(t: torch.Tensor, pad: int, value: float = 0.0) -> torch.Tensor:
    """``t`` with ``pad`` steps of ``value`` appended along dim 1 (the
    recurrent scans pad a sequence to a whole number of chunks)."""
    return torch.cat([t, t.new_full((t.shape[0], pad, *t.shape[2:]),
                                    value)], 1)


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-5):
    dt = x.dtype
    x = x.float()
    x = x * torch.rsqrt((x * x).mean(dim=-1, keepdim=True) + eps)
    return (x * w.float()).to(dt)


def layer_norm(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
               eps: float = 1e-5):
    dt = x.dtype
    x = x.float()
    mu = x.mean(dim=-1, keepdim=True)
    var = ((x - mu) ** 2).mean(dim=-1, keepdim=True)
    x = (x - mu) * torch.rsqrt(var + eps)
    return (x * w.float() + b.float()).to(dt)


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float):
    """Rotary embedding.  x: (..., S, H, dh); positions: (..., S)."""
    dh = x.shape[-1]
    half = dh // 2
    freqs = torch.pow(torch.tensor(theta, dtype=torch.float32,
                                   device=x.device),
                      -torch.arange(0, half, dtype=torch.float32,
                                    device=x.device) / half)
    ang = positions[..., None].float() * freqs            # (..., S, half)
    cos = torch.cos(ang)[..., None, :]                     # (..., S, 1, half)
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# --------------------------------------------------------------------- #
# blockwise (flash) attention: O(S * chunk) memory, a custom backward
# that recomputes score tiles instead of storing them
# --------------------------------------------------------------------- #
def _tile_state(i, j, cq, ck, q_offset, causal):
    """Static causal classification of a (q-chunk i, kv-chunk j) tile:
    'skip' (fully masked), 'full' (no mask needed), or 'edge'."""
    if not causal:
        return "full"
    q_lo = q_offset + i * cq
    q_hi = q_lo + cq - 1
    k_lo = j * ck
    k_hi = k_lo + ck - 1
    if q_hi < k_lo:
        return "skip"
    if q_lo >= k_hi:
        return "full"
    return "edge"


def _acc(dtype: torch.dtype) -> torch.dtype:
    """The accumulation dtype of tiles stored in ``dtype``: float32, or
    float64 for float64 tiles (``gradcheck``)."""
    return torch.promote_types(dtype, torch.float32)


def _f32_einsum(eq: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``einsum`` of two tiles in their storage dtype with a float32
    result, as the reference's ``preferred_element_type=float32``: the
    widening is exact, so each product is the tile's and the sum is
    float32's (float64's for float64 tiles)."""
    dt = _acc(a.dtype)
    return torch.einsum(eq, a.to(dt), b.to(dt))


def _flash_fwd_impl(q, k, v, causal, q_offset, cq, ck):
    """The tile loops of the reference, unrolled in Python with the fully
    masked causal tiles skipped.  Returns ``(out, lse)``."""
    B, Sq, H, dh = q.shape
    _, Sk, KV, _ = k.shape
    G = H // KV
    nq, nk = Sq // cq, Sk // ck
    scale = dh ** -0.5
    neg = -1e30
    dev, acc_dt = q.device, _acc(q.dtype)
    qs = q.reshape(B, nq, cq, KV, G, dh)
    ks = k.reshape(B, nk, ck, KV, dh)
    vs = v.reshape(B, nk, ck, KV, dh)

    outs, lses = [], []
    for i in range(nq):
        # the scale is rounded to the storage dtype and the tile scaled there
        qi = qs[:, i] * torch.tensor(scale, dtype=qs.dtype, device=dev)
        qpos = q_offset + i * cq + torch.arange(cq, device=dev)
        m = torch.full((B, KV, G, cq), neg, dtype=acc_dt, device=dev)
        l = torch.zeros((B, KV, G, cq), dtype=acc_dt, device=dev)
        acc = torch.zeros((B, KV, G, cq, dh), dtype=acc_dt, device=dev)
        for j in range(nk):
            state = _tile_state(i, j, cq, ck, q_offset, causal)
            if state == "skip":
                continue
            kj = ks[:, j]                                  # (B,ck,KV,dh)
            vj = vs[:, j]
            s = _f32_einsum("bqvgd,bkvd->bvgqk", qi, kj)
            if state == "edge":
                kpos = j * ck + torch.arange(ck, device=dev)
                mask = qpos[:, None] >= kpos[None, :]
                s = torch.where(mask[None, None, None], s, neg)
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1)
            acc = acc * corr[..., None] + _f32_einsum(
                "bvgqk,bkvd->bvgqd", p.to(vj.dtype), vj)
            m = m_new
        l = torch.clamp_min(l, 1e-30)
        outs.append((acc / l[..., None]).permute(0, 3, 1, 2, 4))
        lses.append(m + torch.log(l))
    out = torch.cat(outs, dim=1).reshape(B, Sq, H, dh)
    lse = torch.cat(lses, dim=-1)                          # (B,KV,G,Sq)
    return out.to(q.dtype), lse


def _flash_bwd(causal, q_offset, cq, ck, res, dout):
    """The reference's ``_flash_bwd``: recompute each (cq, ck) score tile
    from ``lse``, skip the fully masked causal tiles, store no S² state.
    ``delta = Σ dout·out`` in float32; ``ds`` and ``p`` rounded to the
    storage dtype before their products; float32 accumulation, ``dq``
    scaled by the softmax scale; the results in the inputs' dtypes."""
    q, k, v, out, lse = res
    B, Sq, H, dh = q.shape
    _, Sk, KV, _ = k.shape
    G = H // KV
    nq, nk = Sq // cq, Sk // ck
    scale = dh ** -0.5
    dev, acc_dt = q.device, _acc(q.dtype)
    qs = q.reshape(B, nq, cq, KV, G, dh)
    ks = k.reshape(B, nk, ck, KV, dh)
    vs = v.reshape(B, nk, ck, KV, dh)
    dos = dout.reshape(B, nq, cq, KV, G, dh)
    lses = lse.reshape(B, KV, G, nq, cq)
    # delta = sum_d dout * out  (B, KV, G, Sq)
    delta = (dout.to(acc_dt) * out.to(acc_dt)).sum(-1).permute(
        0, 2, 1).reshape(B, KV, G, nq, cq)

    dqs = []
    dks = [torch.zeros((B, ck, KV, dh), dtype=acc_dt, device=dev)
           for _ in range(nk)]
    dvs = [torch.zeros((B, ck, KV, dh), dtype=acc_dt, device=dev)
           for _ in range(nk)]
    for i in range(nq):
        qi = qs[:, i] * torch.tensor(scale, dtype=qs.dtype, device=dev)
        doi = dos[:, i]                                    # (B,cq,KV,G,dh)
        li = lses[:, :, :, i]
        di = delta[:, :, :, i]
        qpos = q_offset + i * cq + torch.arange(cq, device=dev)
        dq_i = torch.zeros((B, cq, KV, G, dh), dtype=acc_dt, device=dev)
        for j in range(nk):
            state = _tile_state(i, j, cq, ck, q_offset, causal)
            if state == "skip":
                continue
            kj = ks[:, j]
            vj = vs[:, j]
            s = _f32_einsum("bqvgd,bkvd->bvgqk", qi, kj)
            if state == "edge":
                kpos = j * ck + torch.arange(ck, device=dev)
                mask = (qpos[:, None] >= kpos[None, :])[None, None, None]
                s = torch.where(mask, s, -1e30)
            p = torch.exp(s - li[..., None])               # (B,KV,G,cq,ck)
            dp = _f32_einsum("bqvgd,bkvd->bvgqk", doi, vj)
            ds = p * (dp - di[..., None])
            dsl = ds.to(kj.dtype)
            pl = p.to(doi.dtype)
            dq_i = dq_i + _f32_einsum("bvgqk,bkvd->bqvgd", dsl, kj) * scale
            dks[j] = dks[j] + _f32_einsum("bvgqk,bqvgd->bkvd", dsl, qi)
            dvs[j] = dvs[j] + _f32_einsum("bvgqk,bqvgd->bkvd", pl, doi)
        dqs.append(dq_i)
    dq = torch.cat(dqs, dim=1).reshape(B, Sq, H, dh)
    dk = torch.cat(dks, dim=1).reshape(B, Sk, KV, dh)
    dv = torch.cat(dvs, dim=1).reshape(B, Sk, KV, dh)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


class _Flash(torch.autograd.Function):
    """``_flash_fwd_impl`` forward, saving ``q, k, v, out, lse``;
    ``_flash_bwd`` backward."""

    @staticmethod
    def forward(ctx, q, k, v, causal, q_offset, cq, ck):
        out, lse = _flash_fwd_impl(q, k, v, causal, q_offset, cq, ck)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.tiles = (causal, q_offset, cq, ck)
        return out

    @staticmethod
    def backward(ctx, dout):
        dq, dk, dv = _flash_bwd(*ctx.tiles, ctx.saved_tensors, dout)
        return dq, dk, dv, None, None, None, None


def _pick_chunk(S: int, want: int) -> int:
    """The chunk for a length-``S`` axis: the largest divisor of ``S`` at
    or below ``min(max(want, S // 8), S)`` (513 → 171, whisper's 1500 →
    500), so the tile count stays near 8 × 8 at any length."""
    want = min(max(want, S // 8), S)
    for c in range(want, 0, -1):
        if S % c == 0:
            return c
    return S


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, q_offset: int = 0,
                    chunk_q: int = 512, chunk_k: int = 1024) -> torch.Tensor:
    """Chunked softmax attention with running max/sum renormalisation.

    q: (B, Sq, H, dh);  k, v: (B, Sk, KV, dh) with H % KV == 0 (GQA).
    Never materialises the (Sq, Sk) score matrix, only (chunk_q, chunk_k)
    tiles, in the forward and in the backward (``_flash_bwd``).
    """
    cq = _pick_chunk(q.shape[1], chunk_q)
    ck = _pick_chunk(k.shape[1], chunk_k)
    return _Flash.apply(q, k, v, causal, int(q_offset), cq, ck)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, pos: torch.Tensor, *,
                     soft_cap: float | None = None) -> torch.Tensor:
    """Single-step attention against a (B, S, KV, dh) cache, read whole in
    float32.  ``pos``: (B,) current lengths; keys at index >= pos are
    masked with -1e30."""
    B, one, H, dh = q.shape
    _, S, KV, _ = k_cache.shape
    G = H // KV
    scale = dh ** -0.5
    qf = q.reshape(B, KV, G, dh).float() * scale
    kf = k_cache.float()
    s = torch.einsum("bvgd,bsvd->bvgs", qf, kf)           # (B,KV,G,S)
    if soft_cap is not None:
        s = soft_cap * torch.tanh(s / soft_cap)
    mask = torch.arange(S, device=q.device)[None] < pos[:, None]   # (B,S)
    s = torch.where(mask[:, None, None], s, -1e30)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bvgs,bsvd->bvgd", p, v_cache.float())
    return out.reshape(B, 1, H, dh).to(q.dtype)
