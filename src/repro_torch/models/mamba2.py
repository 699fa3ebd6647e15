"""Mamba2 (SSD, state-space duality) mixer in its chunked parallel form.

The port of ``src/repro/models/mamba2.py``, used by the zamba2 hybrid.
Intra-chunk work is local and dense; inter-chunk information moves
through a small carried state, so a long sequence costs O(S), not O(S^2).
Shapes follow the Mamba2 reference: d_inner = 2 * d_model, heads of size
``HEADDIM``, one B/C pair of size ``d_state`` (ngroups = 1).

The reference's three-operand einsums are written here as two-operand
products in a fixed order, so the sum runs in the same order whether or
not ``opt_einsum`` is installed, and no intermediate outgrows
(B, chunks, Q, Q, H) or (B, chunks, Q, H, P).  The chunk recurrence is a
Python loop over the chunks where the reference scans.  The decode step
writes its state in place and returns it, as the attention layers write
their KV caches.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.models.common import (new_param, pad_seq, prefix_sum,
                                       rms_norm)
from repro_torch.util import resolve_device

__all__ = ["Mamba2", "init_mamba2", "mamba2_train", "mamba2_prefill",
           "mamba2_decode", "init_mamba2_state", "mamba2_ref_scan",
           "HEADDIM", "CONV_W"]

HEADDIM = 64
CONV_W = 4


def _dims(cfg):
    d_in = 2 * cfg.d_model
    n_heads = d_in // HEADDIM
    return d_in, n_heads, cfg.ssm_state


class Mamba2(nn.Module):
    """``w_in`` (d, 2·d_in + 2·N + H), the fused input projection [z, x,
    B, C, dt]; ``conv_w`` (CONV_W, d_in + 2·N) and ``conv_b``; ``a_log``
    (A = -exp(a_log), log of 1..16 spread over the heads), ``dt_bias``,
    ``d_skip``; ``norm_w``; ``w_out`` (d_in, d)."""

    def __init__(self, cfg, device=None,
                 generator: torch.Generator | None = None):
        super().__init__()
        d = cfg.d_model
        d_in, nh, ns = _dims(cfg)
        conv_dim = d_in + 2 * ns
        self.w_in = new_param((d, 2 * d_in + 2 * ns + nh), device, generator)
        self.conv_w = new_param((CONV_W, conv_dim), device, generator, 0.5)
        self.conv_b = new_param((conv_dim,), device, generator, "zeros")
        self.a_log = new_param((nh,), device, generator, torch.log(
            torch.linspace(1.0, 16.0, nh, dtype=torch.float32)))
        self.dt_bias = new_param((nh,), device, generator, "zeros")
        self.d_skip = new_param((nh,), device, generator, "ones")
        self.norm_w = new_param((d_in,), device, generator, "ones")
        self.w_out = new_param((d_in, d), device, generator,
                               1.0 / math.sqrt(d_in))


def init_mamba2(generator: torch.Generator | None, cfg,
                device=None) -> Mamba2:
    return Mamba2(cfg, resolve_device(device), generator)


def _split_in(cfg, xz):
    d_in, nh, ns = _dims(cfg)
    return torch.split(xz, [d_in, d_in + 2 * ns, nh], dim=-1)


def _causal_conv(xbc, w, b, state=None):
    """Depthwise causal conv of width CONV_W over (B, S, C), as the
    reference's sum of shifted products in the input's dtype (``conv1d``
    would accumulate otherwise).  Returns ``(out, new_state)``, the state
    being the last CONV_W - 1 inputs."""
    B, S, C = xbc.shape
    if state is None:
        state = torch.zeros((B, CONV_W - 1, C), dtype=xbc.dtype,
                            device=xbc.device)
    xp = torch.cat([state, xbc], dim=1)
    out = sum(xp[:, i:i + S] * w[i].to(xbc.dtype) for i in range(CONV_W))
    out = F.silu(out + b.to(xbc.dtype))
    return out, xp[:, -(CONV_W - 1):]


def _ssd_chunked(xh, dt, a, Bm, Cm, chunk: int, h0=None):
    """Chunked SSD scan.

    xh: (B, S, H, P) inputs; dt: (B, S, H) softplus'd step; a: (H,)
    negative decay rate; Bm/Cm: (B, S, N).  Returns (y (B, S, H, P)
    float32, final state (B, H, P, N))."""
    Bb, S, H, P = xh.shape
    N = Bm.shape[-1]
    Q = min(chunk, S)
    S0 = S
    if S % Q:
        # padded steps carry dt = 0 (decay 1, zero input): they neither
        # emit nor move the state
        pad = Q - S % Q
        xh, dt, Bm, Cm = (pad_seq(t, pad) for t in (xh, dt, Bm, Cm))
        S = S + pad
    nc = S // Q

    la = (dt * a[None, None, :]).float().reshape(Bb, nc, Q, H)
    xw = (xh * dt[..., None]).float().reshape(Bb, nc, Q, H, P)
    Bc = Bm.reshape(Bb, nc, Q, N).float()
    Cc = Cm.reshape(Bb, nc, Q, N).float()

    cum = prefix_sum(la, 2)                               # (B,nc,Q,H)
    seg = cum[:, :, :, None, :] - cum[:, :, None, :, :]   # (B,nc,Q,Qs,H)
    tri = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=xh.device))
    # mask BEFORE exp: exp of the (positive) upper-triangle entries would
    # overflow and poison a backward pass with 0 * inf = NaN
    seg = torch.where(tri[None, None, :, :, None], seg, -1e30)
    L = torch.exp(seg)

    # intra-chunk: y[q] = sum_{s<=q} (C_q . B_s) exp(cum_q - cum_s) xw_s
    xw_h = xw.permute(0, 1, 3, 2, 4)                      # (B,nc,H,Qs,P)
    scores = Cc @ Bc.transpose(-1, -2)                    # (B,nc,Q,Qs)
    W = (scores[..., None] * L).permute(0, 1, 4, 2, 3)    # (B,nc,H,Q,Qs)
    y_intra = W @ xw_h                                    # (B,nc,H,Q,P)

    # chunk summary state: Z_c = sum_s exp(cum_end - cum_s) xw_s B_s^T
    decay_to_end = torch.exp(cum[:, :, -1:, :] - cum)     # (B,nc,Q,H)
    xd = (xw * decay_to_end[..., None]).permute(0, 1, 3, 4, 2)
    Z = xd @ Bc[:, :, None]                               # (B,nc,H,P,N)
    chunk_decay = torch.exp(cum[:, :, -1])                # (B,nc,H)

    h = (torch.zeros((Bb, H, P, N), dtype=torch.float32, device=xh.device)
         if h0 is None else h0)
    h_prevs = []
    for c in range(nc):                                   # state BEFORE chunk
        h_prevs.append(h)
        h = h * chunk_decay[:, c, :, None, None] + Z[:, c]
    h_prevs = torch.stack(h_prevs, dim=1)                 # (B,nc,H,P,N)

    # inter-chunk: y[q] += exp(cum_q) * (h_prev C_q)
    y_inter = (Cc[:, :, None] @ h_prevs.transpose(-1, -2)
               ) * torch.exp(cum).permute(0, 1, 3, 2)[..., None]
    y = (y_intra + y_inter).permute(0, 1, 3, 2, 4)        # (B,nc,Q,H,P)
    return y.reshape(Bb, S, H, P)[:, :S0], h


def mamba2_ref_scan(xh, dt, a, Bm, Cm, h0=None):
    """Token-by-token oracle for the chunked SSD (tests)."""
    Bb, S, H, P = xh.shape
    N = Bm.shape[-1]
    h = (torch.zeros((Bb, H, P, N), dtype=torch.float32, device=xh.device)
         if h0 is None else h0)
    ys = []
    for t in range(S):
        at = torch.exp(dt[:, t] * a[None, :])             # (B,H)
        upd = (xh[:, t] * dt[:, t, :, None])[..., None] * \
            Bm[:, t, None, None, :]
        h = h * at[..., None, None] + upd
        ys.append((h @ Cm[:, t, None, :, None])[..., 0])
    return torch.stack(ys, dim=1), h


def mamba2_prefill(p: Mamba2, cfg, x, chunk: int | None = None):
    """x: (B, S, d) -> ``(y (B, S, d), {"h": final SSD state (B, H, P, N)
    float32, "conv": the last CONV_W - 1 conv inputs in x's dtype})``."""
    d_in, nh, ns = _dims(cfg)
    B, S, _ = x.shape
    dt_model = x.dtype
    z, xbc, dt_raw = _split_in(cfg, x @ p.w_in.to(dt_model))
    xbc, conv_state = _causal_conv(xbc, p.conv_w, p.conv_b)
    xm, Bm, Cm = torch.split(xbc, [d_in, ns, ns], dim=-1)
    dt = F.softplus(dt_raw.float() + p.dt_bias)
    a = -torch.exp(p.a_log)
    xh = xm.reshape(B, S, nh, HEADDIM)
    y, h = _ssd_chunked(xh, dt, a, Bm, Cm, chunk or cfg.ssm_chunk or S)
    y = y + xh.float() * p.d_skip[None, None, :, None]
    y = y.reshape(B, S, d_in).to(dt_model) * F.silu(z)
    y = rms_norm(y, p.norm_w, cfg.norm_eps)
    return y @ p.w_out.to(dt_model), {"h": h, "conv": conv_state}


def mamba2_train(p: Mamba2, cfg, x, chunk: int | None = None):
    """x: (B, S, d) -> (B, S, d)."""
    return mamba2_prefill(p, cfg, x, chunk)[0]


def init_mamba2_state(cfg, batch: int, device=None) -> dict:
    """``h`` (B, H, P, N) float32 and ``conv`` (B, CONV_W - 1, d_in + 2·N)
    bfloat16, whatever the compute dtype, as in the reference."""
    d_in, nh, ns = _dims(cfg)
    device = resolve_device(device)
    return {
        "h": torch.zeros((batch, nh, HEADDIM, ns), dtype=torch.float32,
                         device=device),
        "conv": torch.zeros((batch, CONV_W - 1, d_in + 2 * ns),
                            dtype=torch.bfloat16, device=device),
    }


def mamba2_decode(p: Mamba2, cfg, x, state: dict):
    """One-token step.  x: (B, 1, d).  Writes ``state`` in place and
    returns ``(y, state)``."""
    d_in, nh, ns = _dims(cfg)
    B = x.shape[0]
    dt_model = x.dtype
    z, xbc, dt_raw = _split_in(cfg, x @ p.w_in.to(dt_model))
    xbc, conv_state = _causal_conv(xbc, p.conv_w, p.conv_b,
                                   state["conv"].to(xbc.dtype))
    xm, Bm, Cm = torch.split(xbc, [d_in, ns, ns], dim=-1)
    dt = F.softplus(dt_raw.float() + p.dt_bias)[:, 0]
    a = -torch.exp(p.a_log)
    at = torch.exp(dt * a[None, :])                       # (B,H)
    xh = xm.reshape(B, nh, HEADDIM).float()
    upd = (xh * dt[..., None])[..., None] * Bm[:, 0, None, None, :].float()
    h = state["h"] * at[..., None, None] + upd
    y = (h @ Cm[:, 0, None, :, None].float())[..., 0]     # (B,H,P)
    y = y + xh * p.d_skip[None, :, None]
    y = y.reshape(B, 1, d_in).to(dt_model) * F.silu(z)
    y = rms_norm(y, p.norm_w, cfg.norm_eps)
    state["h"].copy_(h)
    state["conv"].copy_(conv_state)
    return y @ p.w_out.to(dt_model), state
