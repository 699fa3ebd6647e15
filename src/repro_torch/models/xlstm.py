"""xLSTM blocks: the chunkwise-parallel mLSTM (matrix memory) and the
sequential sLSTM (scalar memory), after Beck et al. 2024
(arXiv:2405.04517).

The port of ``src/repro/models/xlstm.py``.  The mLSTM recurrence per head
(cell C in R^{dh x dh}, normaliser n in R^dh, log-stabiliser m):

    C_t = f_t C_{t-1} + i_t k_t v_t^T
    n_t = f_t n_{t-1} + i_t k_t
    h_t = C_t^T q_t / max(|n_t^T q_t|, exp(-m_t))

runs chunked: the intra-chunk pairwise decays as dense products, the
inter-chunk state through a Python loop over the chunks where the
reference scans.  All gate math is log-space stabilised, with the
reference's running max ``m`` and its floor ``exp(min(-m, 30))``.

The reference's einsums of three operands are written here as products of
two in a fixed order: the sum runs in the same order whether or not
``opt_einsum`` is installed, and no intermediate outgrows (B, chunks, Q,
H, dh) (contracted left to right, the inter-chunk term would build a
(B, chunks, Q, H, dh, dh) product).  The decode steps write their state
in place and return it.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.models.common import (new_param, pad_seq, prefix_sum,
                                       rms_norm)
from repro_torch.util import resolve_device

__all__ = ["MLSTM", "SLSTM", "init_mlstm", "mlstm_train", "mlstm_prefill",
           "mlstm_decode", "init_mlstm_state", "mlstm_ref_scan",
           "init_slstm", "slstm_apply", "slstm_prefill", "init_slstm_state",
           "slstm_decode", "PROJ"]

PROJ = 2  # block up-projection factor


def _dims(cfg):
    d_in = PROJ * cfg.d_model
    dh = d_in // cfg.n_heads
    return d_in, cfg.n_heads, dh


def _const(n: int, value: float) -> torch.Tensor:
    return torch.full((n,), value, dtype=torch.float32)


# --------------------------------------------------------------------- #
# mLSTM
# --------------------------------------------------------------------- #
class MLSTM(nn.Module):
    """``w_up``, ``w_og`` (d, d_in); ``wq``/``wk``/``wv`` (d_in, d_in);
    ``w_if`` (d_in, 2·H) and the gate biases ``b_i`` (-2) and ``b_f``
    (+3); ``norm_w``; ``w_down`` (d_in, d)."""

    def __init__(self, cfg, device=None,
                 generator: torch.Generator | None = None):
        super().__init__()
        d = cfg.d_model
        d_in, nh, _ = _dims(cfg)
        self.w_up = new_param((d, d_in), device, generator)
        self.w_og = new_param((d, d_in), device, generator)
        self.wq = new_param((d_in, d_in), device, generator)
        self.wk = new_param((d_in, d_in), device, generator)
        self.wv = new_param((d_in, d_in), device, generator)
        self.w_if = new_param((d_in, 2 * nh), device, generator, 0.02)
        self.b_i = new_param((nh,), device, generator, _const(nh, -2.0))
        self.b_f = new_param((nh,), device, generator, _const(nh, 3.0))
        self.norm_w = new_param((d_in,), device, generator, "ones")
        self.w_down = new_param((d_in, d), device, generator,
                                1.0 / math.sqrt(d_in))


def init_mlstm(generator: torch.Generator | None, cfg, device=None) -> MLSTM:
    return MLSTM(cfg, resolve_device(device), generator)


def _qkv_gates(p: MLSTM, cfg, x):
    d_in, nh, dh = _dims(cfg)
    B, S, _ = x.shape
    dt = x.dtype
    xm = x @ p.w_up.to(dt)
    og = F.silu(x @ p.w_og.to(dt))
    q = (xm @ p.wq.to(dt)).reshape(B, S, nh, dh)
    # the scale is rounded to the activation's dtype, as the reference's
    # weakly typed scalar is
    k = (xm @ p.wk.to(dt)).reshape(B, S, nh, dh) * torch.tensor(
        dh ** -0.5, dtype=dt, device=x.device)
    v = (xm @ p.wv.to(dt)).reshape(B, S, nh, dh)
    gates = (xm @ p.w_if.to(dt)).float()
    log_i = gates[..., :nh] + p.b_i                         # pre-act i gate
    log_f = -F.softplus(-(gates[..., nh:] + p.b_f))        # log sigmoid(f)
    return q, k, v, log_i, log_f, og


def mlstm_ref_scan(q, k, v, log_i, log_f):
    """Token-by-token stabilised oracle (tests)."""
    B, S, H, dh = q.shape
    dev = q.device
    C = torch.zeros((B, H, dh, dh), dtype=torch.float32, device=dev)
    n = torch.zeros((B, H, dh), dtype=torch.float32, device=dev)
    m = torch.zeros((B, H), dtype=torch.float32, device=dev)
    hs = []
    for t in range(S):
        C, n, m, h = _mlstm_step(C, n, m, q[:, t].float(), k[:, t].float(),
                                 v[:, t].float(), log_i[:, t], log_f[:, t])
        hs.append(h)
    return torch.stack(hs, dim=1)                           # (B,S,H,dh)


#: the constants of the reference's ``jnp.minimum(-m, 30)`` and
#: ``jnp.maximum(n, 1e-6)`` as 0-d host tensors: ``torch.minimum`` /
#: ``maximum`` halve the gradient at a tie as jax does (``clamp`` would
#: pass it whole), and a host scalar reaches a kernel as an argument, with
#: no copy to the card
_CAP_EXP, _FLOOR_N = torch.tensor(30.0), torch.tensor(1e-6)


def _min30(x: torch.Tensor) -> torch.Tensor:
    return torch.minimum(x, _CAP_EXP)


def _mlstm_step(C, n, m, qt, kt, vt, li, lf):
    """One stabilised mLSTM step on float32 (B, H, ·) tensors: the new
    ``(C, n, m)`` and the output h (B, H, dh)."""
    m_new = torch.maximum(lf + m, li)                       # (B,H)
    f_ = torch.exp(lf + m - m_new)
    i_ = torch.exp(li - m_new)
    C = C * f_[..., None, None] + i_[..., None, None] * \
        (kt[..., :, None] * vt[..., None, :])
    n = n * f_[..., None] + i_[..., None] * kt
    num = (qt[..., None, :] @ C)[..., 0, :]                 # (B,H,dh)
    den = torch.abs((n[..., None, :] @ qt[..., :, None])[..., 0, 0])
    den = torch.maximum(den, torch.exp(_min30(-m_new)))
    return C, n, m_new, num / den[..., None]


def _mlstm_chunked(q, k, v, log_i, log_f, chunk: int, state=None):
    """Chunkwise-parallel stabilised mLSTM.

    Returns (h (B, S, H, dh) float32, final (C, n, m))."""
    B, S, H, dh = q.shape
    Q = min(chunk, S)
    S0 = S
    if S % Q:
        # padded steps have i-gate -1e30 (no contribution) and f-gate 1
        # (log 0: the state kept)
        pad = Q - S % Q
        q, k, v, log_f = (pad_seq(t, pad) for t in (q, k, v, log_f))
        log_i = pad_seq(log_i, pad, -1e30)
        S = S + pad
    nc = S // Q
    # (B, nc, H, Q, ·): heads ahead of the chunk's steps for the products
    qf, kf, vf = (t.reshape(B, nc, Q, H, dh).float().permute(0, 1, 3, 2, 4)
                  for t in (q, k, v))
    li = log_i.reshape(B, nc, Q, H)
    lf = log_f.reshape(B, nc, Q, H)

    Fc = prefix_sum(lf, 2)                                  # (B,nc,Q,H)
    Ftot = Fc[:, :, -1]                                     # (B,nc,H)
    # log weight of source s surviving to the chunk's end: Ftot - F_s + li_s
    lw_end = Ftot[:, :, None] - Fc + li                     # (B,nc,Q,H)
    m_loc = lw_end.amax(dim=2)                              # (B,nc,H)

    if state is None:
        C = torch.zeros((B, H, dh, dh), dtype=torch.float32, device=q.device)
        n = torch.zeros((B, H, dh), dtype=torch.float32, device=q.device)
        m = torch.zeros((B, H), dtype=torch.float32, device=q.device)
    else:
        C, n, m = state
    Cp, np_, mp = [], [], []
    for c in range(nc):                                     # emit pre-chunk
        Cp.append(C)
        np_.append(n)
        mp.append(m)
        m_new = torch.maximum(m + Ftot[:, c], m_loc[:, c])  # (B,H)
        w = torch.exp(lw_end[:, c] - m_new[:, None])        # (B,Q,H)
        wk = kf[:, c] * w.transpose(1, 2)[..., None]        # (B,H,Q,dh)
        decay = torch.exp(m + Ftot[:, c] - m_new)
        C = C * decay[..., None, None] + wk.transpose(-1, -2) @ vf[:, c]
        n = n * decay[..., None] + wk.sum(dim=2)
        m = m_new
    Cp = torch.stack(Cp, dim=1)                             # (B,nc,H,dh,dh)
    np_ = torch.stack(np_, dim=1)                           # (B,nc,H,dh)
    mp = torch.stack(mp, dim=1)                             # (B,nc,H)

    # intra-chunk pairwise: log decay s->q = F_q - F_s + li_s  (s <= q)
    seg = Fc[:, :, :, None, :] - Fc[:, :, None, :, :] + li[:, :, None, :, :]
    tri = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=q.device))
    seg = torch.where(tri[None, None, :, :, None], seg, -torch.inf)
    # inter-chunk: log decay prev->q = F_q + m_prev
    l_inter = Fc + mp[:, :, None]                           # (B,nc,Q,H)
    m_tot = torch.maximum(seg.amax(dim=3), l_inter)         # (B,nc,Q,H)
    D = torch.exp(seg - m_tot[:, :, :, None, :])            # (B,nc,Q,Qs,H)
    w_inter = torch.exp(l_inter - m_tot).permute(0, 1, 3, 2)[..., None]

    scores = qf @ kf.transpose(-1, -2)                      # (B,nc,H,Q,Qs)
    SD = scores * D.permute(0, 1, 4, 2, 3)
    num = SD @ vf + w_inter * (qf @ Cp)                     # (B,nc,H,Q,dh)
    # den: sum_s D[q,s] (k_s . q_q) + w_inter (n_prev . q_q)
    den = SD.sum(dim=-1, keepdim=True) + w_inter * (qf @ np_[..., None])
    # cap the stabiliser exponent: for very negative m the true
    # normaliser max(|n.q|, 1) is 1 and the output is ~0 anyway
    floor = torch.exp(_min30(-m_tot))
    den = torch.maximum(torch.abs(den),
                        floor.permute(0, 1, 3, 2)[..., None])
    h = (num / den).permute(0, 1, 3, 2, 4)                  # (B,nc,Q,H,dh)
    return h.reshape(B, S, H, dh)[:, :S0], (C, n, m)


def mlstm_prefill(p: MLSTM, cfg, x, chunk: int | None = None):
    """x: (B, S, d) -> ``(y (B, S, d), {"C", "n", "m"})``, the final
    state in float32."""
    d_in, _, _ = _dims(cfg)
    B, S, _ = x.shape
    q, k, v, log_i, log_f, og = _qkv_gates(p, cfg, x)
    h, (C, n, m) = _mlstm_chunked(q, k, v, log_i, log_f,
                                  chunk or cfg.ssm_chunk or S)
    h = h.reshape(B, S, d_in).to(x.dtype) * og
    h = rms_norm(h, p.norm_w, cfg.norm_eps)
    return h @ p.w_down.to(x.dtype), {"C": C, "n": n, "m": m}


def mlstm_train(p: MLSTM, cfg, x, chunk: int | None = None):
    return mlstm_prefill(p, cfg, x, chunk)[0]


def init_mlstm_state(cfg, batch: int, device=None) -> dict:
    d_in, nh, dh = _dims(cfg)
    device = resolve_device(device)
    return {
        "C": torch.zeros((batch, nh, dh, dh), dtype=torch.float32,
                         device=device),
        "n": torch.zeros((batch, nh, dh), dtype=torch.float32, device=device),
        "m": torch.zeros((batch, nh), dtype=torch.float32, device=device),
    }


def mlstm_decode(p: MLSTM, cfg, x, state: dict):
    """One-token step.  x: (B, 1, d).  Writes ``state`` in place and
    returns ``(y, state)``."""
    d_in, _, _ = _dims(cfg)
    B = x.shape[0]
    q, k, v, log_i, log_f, og = _qkv_gates(p, cfg, x)
    C, n, m, h = _mlstm_step(state["C"], state["n"], state["m"],
                             q[:, 0].float(), k[:, 0].float(),
                             v[:, 0].float(), log_i[:, 0], log_f[:, 0])
    h = h.reshape(B, 1, d_in).to(x.dtype) * og
    h = rms_norm(h, p.norm_w, cfg.norm_eps)
    for key, t in (("C", C), ("n", n), ("m", m)):
        state[key].copy_(t)
    return h @ p.w_down.to(x.dtype), state


# --------------------------------------------------------------------- #
# sLSTM: scalar memory, sequential (no parallel form exists)
# --------------------------------------------------------------------- #
class SLSTM(nn.Module):
    """``w_up`` (d, d_in); ``w_gates`` and the recurrent ``r_gates``
    (d_in, 4·d_in), blocks [i, f, z, o]; ``b_gates`` (-2, +3, 0, 0 by
    block); ``norm_w``; ``w_down`` (d_in, d)."""

    def __init__(self, cfg, device=None,
                 generator: torch.Generator | None = None):
        super().__init__()
        d = cfg.d_model
        d_in, _, _ = _dims(cfg)
        self.w_up = new_param((d, d_in), device, generator)
        self.w_gates = new_param((d_in, 4 * d_in), device, generator, 0.02)
        self.r_gates = new_param((d_in, 4 * d_in), device, generator, 0.02)
        self.b_gates = new_param((4 * d_in,), device, generator, torch.cat(
            [_const(d_in, -2.0), _const(d_in, 3.0), _const(d_in, 0.0),
             _const(d_in, 0.0)]))
        self.norm_w = new_param((d_in,), device, generator, "ones")
        self.w_down = new_param((d_in, d), device, generator,
                                1.0 / math.sqrt(d_in))


def init_slstm(generator: torch.Generator | None, cfg, device=None) -> SLSTM:
    return SLSTM(cfg, resolve_device(device), generator)


def init_slstm_state(cfg, batch: int, device=None) -> dict:
    """``c``, ``n``, ``m``, ``h`` (B, d_in) float32: four tensors (the
    decode step writes each in place)."""
    d_in, _, _ = _dims(cfg)
    device = resolve_device(device)
    return {k: torch.zeros((batch, d_in), dtype=torch.float32, device=device)
            for k in ("c", "n", "m", "h")}


def _slstm_cell(p: SLSTM, xg, st: dict) -> dict:
    """xg: (B, 4·d_in) pre-activation input contribution, float32.  The
    recurrent product is float32 × float32 (TF32 must be off; bf16
    serving weights are widened, as the reference's type promotion
    does)."""
    c, n, m, h_prev = st["c"], st["n"], st["m"], st["h"]
    g = xg + h_prev @ p.r_gates.to(h_prev.dtype) + p.b_gates
    gi, gf, gz, go = torch.chunk(g, 4, dim=-1)
    log_f = -F.softplus(-gf)                                # log sigmoid
    m_new = torch.maximum(log_f + m, gi)
    i_ = torch.exp(gi - m_new)
    f_ = torch.exp(log_f + m - m_new)
    z_ = torch.tanh(gz)
    o_ = torch.sigmoid(go)
    c_new = f_ * c + i_ * z_
    n_new = f_ * n + i_
    h = o_ * c_new / torch.maximum(n_new, _FLOOR_N)
    return {"c": c_new, "n": n_new, "m": m_new, "h": h}


def slstm_prefill(p: SLSTM, cfg, x):
    """Sequential over S.  x: (B, S, d) -> ``(y (B, S, d), {"c", "n",
    "m", "h"})``, the final state."""
    B, S, _ = x.shape
    xm = x @ p.w_up.to(x.dtype)
    xg = (xm @ p.w_gates.to(x.dtype)).float()
    st = init_slstm_state(cfg, B, x.device)
    hs = []
    for t in range(S):
        st = _slstm_cell(p, xg[:, t], st)
        hs.append(st["h"])
    h = torch.stack(hs, dim=1).to(x.dtype)
    h = rms_norm(h, p.norm_w, cfg.norm_eps)
    return h @ p.w_down.to(x.dtype), st


def slstm_apply(p: SLSTM, cfg, x):
    """Training / prefill: sequential over S.  x: (B, S, d)."""
    return slstm_prefill(p, cfg, x)[0]


def slstm_decode(p: SLSTM, cfg, x, state: dict):
    """One-token step.  x: (B, 1, d).  Writes ``state`` in place and
    returns ``(y, state)``."""
    xm = x[:, 0] @ p.w_up.to(x.dtype)
    xg = (xm @ p.w_gates.to(x.dtype)).float()
    st = _slstm_cell(p, xg, state)
    h = rms_norm(st["h"][:, None].to(x.dtype), p.norm_w, cfg.norm_eps)
    for key, t in st.items():
        state[key].copy_(t)
    return h @ p.w_down.to(x.dtype), state
