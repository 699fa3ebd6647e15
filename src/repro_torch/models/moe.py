"""Mixture-of-Experts layer: top-k token-choice routing with static capacity
(GShard-style dispatch and combine einsums).

The port of ``src/repro/models/moe.py``.  The routing keeps the
reference's arithmetic where a straightforward port would differ:

* ``jax.lax.top_k`` returns the values in descending order with the lower
  index first on ties; a stable descending sort gives that order, and the
  order sets each (token, k)'s place in its expert's queue, hence which
  tokens are dropped;
* the queue positions are floats, and ``jax.nn.one_hot`` of a position at
  or past the capacity is a zero row, so an overflowing (token, k) adds
  exactly zero (``F.one_hot`` would raise instead);
* regrouping happens only when ``(B·S) % group_size == 0`` and
  ``S != group_size``, and the capacity is ``max(1, int(S·K/E·cf))`` in
  Python floats (1 at decode).
"""
from __future__ import annotations

import contextlib
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.models.common import new_param
from repro_torch.util import resolve_device

__all__ = ["MoE", "Routing", "init_moe", "route", "moe_apply",
           "record_routing", "first_divergence", "top_k_gap", "NEAR_TIE"]

#: the open ``record_routing`` logs, innermost last
_LOGS: list[list] = []


class MoE(nn.Module):
    """``router`` (d, E) and the experts' ``w_gate``/``w_up`` (E, d, f) and
    ``w_down`` (E, f, d).  As in the reference, ``w_gate``/``w_up`` draw
    with ``dense_init``'s default scale, whose fan-in is the leading
    dimension: E."""

    def __init__(self, cfg, device=None,
                 generator: torch.Generator | None = None):
        super().__init__()
        m = cfg.moe
        d, e, f = cfg.d_model, m.n_experts, m.d_expert
        self.router = new_param((d, e), device, generator, 0.02)
        self.w_gate = new_param((e, d, f), device, generator)
        self.w_up = new_param((e, d, f), device, generator)
        self.w_down = new_param((e, f, d), device, generator, 1.0 / f ** 0.5)


def init_moe(generator: torch.Generator | None, cfg, device=None) -> MoE:
    return MoE(cfg, resolve_device(device), generator)


class Routing(NamedTuple):
    """One ``route`` call: ``x`` regrouped to (B, S, d), the capacity
    ``C``, the router's float32 ``logits`` and ``probs`` (B, S, E), the
    chosen experts ``gate_idx`` (B, S, K), their renormalised gates
    ``gate_vals`` (zero where dropped), their ``onehot`` (B, S, K, E),
    each (token, k)'s float queue position ``pos`` and ``keep``."""
    x: torch.Tensor
    C: int
    logits: torch.Tensor
    probs: torch.Tensor
    gate_idx: torch.Tensor
    gate_vals: torch.Tensor
    onehot: torch.Tensor
    pos: torch.Tensor
    keep: torch.Tensor


def route(p: MoE, cfg, x: torch.Tensor) -> Routing:
    """Top-k routing with static capacity of ``x`` (B0, S0, d)."""
    m = cfg.moe
    B0, S0, d = x.shape
    g = m.group_size or S0
    if (B0 * S0) % g == 0 and S0 != g:
        x = x.reshape(B0 * S0 // g, g, d)
    B, S, _ = x.shape
    E, K = m.n_experts, m.top_k
    C = max(1, int(S * K / E * m.capacity_factor))
    dt = x.dtype

    logits = (x @ p.router.to(dt)).float()                     # (B,S,E)
    probs = torch.softmax(logits, dim=-1)
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate_vals, gate_idx = vals[..., :K], idx[..., :K]           # (B,S,K)
    # a 0-d host tensor: jnp.maximum's gradient at a tie, no host copy
    gate_vals = gate_vals / torch.maximum(gate_vals.sum(-1, keepdim=True),
                                          torch.tensor(1e-9))

    # position of each (token, k) within its expert queue, per group
    # a comparison, as jax.nn.one_hot computes it: no host sync (F.one_hot
    # checks its indices' range on the host) and deterministic on the card
    onehot = (gate_idx[..., None] == torch.arange(
        E, device=x.device)).float()                           # (B,S,K,E)
    flat = onehot.reshape(B, S * K, E)
    # counted in integers: the same exact sums as a float cumsum, and
    # deterministic on the card (a float cumsum there is not)
    pos_in_expert = (torch.cumsum(flat.to(torch.int32), dim=1).float()
                     - flat).reshape(B, S, K, E)
    pos = (pos_in_expert * onehot).sum(-1)                     # (B,S,K)
    keep = (pos < C) & (gate_vals > 0)
    gate_vals = torch.where(keep, gate_vals, 0.0)
    r = Routing(x, C, logits, probs, gate_idx, gate_vals, onehot, pos, keep)
    for log in _LOGS:
        log.append(r)
    return r


@contextlib.contextmanager
def record_routing():
    """``with record_routing() as log:`` appends the ``Routing`` of every
    ``route`` call in the block, in call order (one per MoE layer of a
    forward), so that two runs' routing can be compared."""
    log: list[Routing] = []
    _LOGS.append(log)
    try:
        yield log
    finally:
        _LOGS.remove(log)


def moe_apply(p: MoE, cfg, x: torch.Tensor):
    """x: (B, S, d) -> (y, aux) with aux = {load_balance_loss,
    router_z_loss}.  Overflowing (token, k) pairs are dropped (contribute
    zero), as in capacity-based MoE."""
    B0, S0, d = x.shape
    r = route(p, cfg, x)
    x, dt, E = r.x, x.dtype, cfg.moe.n_experts

    # dispatch/combine tensors: (B, S, E, C); a position >= C one-hots to 0
    pos_oh = (r.pos[..., None] == torch.arange(
        r.C, dtype=torch.float32, device=x.device)).float()   # (B,S,K,C)
    disp = torch.einsum("bske,bskc->bsec", r.onehot,
                        pos_oh * r.keep[..., None].float())
    comb = torch.einsum("bske,bskc->bsec", r.onehot * r.gate_vals[..., None],
                        pos_oh)

    xin = torch.einsum("bsec,bsd->ebcd", disp.to(dt), x)      # (E,B,C,d)
    g = F.silu(torch.einsum("ebcd,edf->ebcf", xin, p.w_gate.to(dt)))
    u = torch.einsum("ebcd,edf->ebcf", xin, p.w_up.to(dt))
    out = torch.einsum("ebcf,efd->ebcd", g * u, p.w_down.to(dt))
    y = torch.einsum("bsec,ebcd->bsd", comb.to(dt), out)

    # auxiliary losses (Switch-style)
    density = r.onehot.sum(2).mean(dim=1)                      # (B,E)
    router_prob = r.probs.mean(dim=1)                          # (B,E)
    lb_loss = E * torch.mean(torch.sum(density * router_prob, dim=-1))
    z_loss = torch.mean(torch.logsumexp(r.logits, dim=-1) ** 2)
    if y.shape[:2] != (B0, S0):
        y = y.reshape(B0, S0, d)
    return y, {"load_balance_loss": lb_loss, "router_z_loss": z_loss}


def first_divergence(want: list, got: list) -> list:
    """Where two runs' routings part: ``want`` and ``got`` hold one
    (B, S, K) array of chosen experts per MoE layer, in call order.  For
    each row ``b``, ``None`` if the two choose the same expert set for
    every token in every layer, else ``(token, layer)``: the row's first
    token chosen differently in any layer, and the first layer at which it
    is.  Every token of the row before it was routed alike in every layer.
    """
    if len(want) != len(got):
        raise ValueError(f"{len(want)} routed layers against {len(got)}")
    differs = [(np.sort(np.asarray(w), -1) != np.sort(np.asarray(g), -1))
               .any(-1) for w, g in zip(want, got)]           # (B, S) each
    out = []
    for b in range(differs[0].shape[0]) if differs else ():
        hits = [(int(np.argmax(d[b])), layer)
                for layer, d in enumerate(differs) if d[b].any()]
        out.append(min(hits) if hits else None)
    return out


#: the largest ``top_k_gap`` at which two bf16 runs may route a token
#: differently: bf16 keeps 8 significant bits, so two computations of one
#: router logit may differ by a few of its rounding steps, and the k-th
#: and (k+1)-th experts swap only when that close (measured swaps 0.001–
#: 0.005; the median gap of the reduced configs' routing is about 0.06)
NEAR_TIE = 2.0 ** -7


def top_k_gap(probs, k: int) -> np.ndarray:
    """``log p_k - log p_(k+1)`` of each token's sorted router
    probabilities (..., E): how far its k-th expert is from being
    displaced.  Zero on a tie."""
    p = -np.sort(-np.asarray(probs, np.float64), axis=-1)
    return np.log(p[..., k - 1]) - np.log(p[..., k])
