"""Halo-exchange transports — the ``HaloTransport`` layer, on a virtual mesh.

One card holds the whole ``(n_node, n_core)`` grid as the leading axes of
every vector, so the collectives of the JAX package's shard bodies become
on-device index operations with the same semantics:

  * ``all_to_all`` over ``node``: ``recv[dst, c, src] = sent[src, c, dst]``
    — a transpose of the send table;
  * the core-axis gather + add of partial ghost buffers (``_gather_add``):
    a sum over the core axis.  Every real ghost slot has exactly one
    writer, so the sum adds one value to zeros and is exact.

A transport owns its static plan state (index tensors derived from the
plan's own ``send_own``/``recv_own``), the exchange itself
(``exchange(x, F, ...) -> x_ghost``), a numpy reference of the same
dataflow (``host_exchange``) and its predicted wire cost
(``predicted_cost``, per exchange, as if the nodes were separate devices).

Only ``a2a`` (one fused ``all_to_all`` — the PETSc VecScatter analogue) and
the exact ``f32`` wire codec are ported so far.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

__all__ = ["HaloTransport", "A2ATransport", "WireCodec", "get_codec",
           "available_wire_dtypes", "register_transport",
           "get_transport", "available_transports", "transport_stamp",
           "resolve_transport", "transport_census"]


class HaloTransport:
    """Interface of a halo-exchange transport.

    Subclasses set ``name`` (registry key) and implement ``exchange`` /
    ``host_exchange`` / ``predicted_cost``.  All static state is derived
    from the plan's own arrays, so a transport can be selected for any plan
    after the fact.
    """

    name: str = ""

    # -- static plan state --------------------------------------------- #
    def plan_state(self, plan) -> dict:
        """Static state for this plan (host data or index tensors)."""
        return {}

    # -- the exchange --------------------------------------------------- #
    def exchange(self, x: torch.Tensor, F: dict, *, state: dict,
                 n_node: int, g_pad: int) -> torch.Tensor:
        """``x`` ``(n_node, n_core, rc_pad)`` -> the assembled ghost buffer
        of every node, ``(n_node, g_pad + 1)``.  Real slots ``< g_pad``
        hold exactly the owners' bits; slot ``g_pad`` is write-only."""
        raise NotImplementedError

    # -- numpy reference of the same dataflow -------------------------- #
    def host_exchange(self, xd: np.ndarray, send_own: np.ndarray,
                      recv_own: np.ndarray, g_pad: int,
                      state: dict) -> np.ndarray:
        """Per-shard ghost buffers ``(n_node, n_core, g_pad + 1)``."""
        raise NotImplementedError

    # -- census --------------------------------------------------------- #
    def predicted_cost(self, plan, state: dict, itemsize: int = 4) -> dict:
        """Padded inter-node wire bytes + per-kind collective counts for one
        exchange, as if each node were its own device."""
        raise NotImplementedError


# --------------------------------------------------------------------- #
# wire codec — only the exact f32 codec is ported
# --------------------------------------------------------------------- #
class WireCodec:
    """Encode/decode of halo payload chunks on the inter-node wire.

    A chunk is one (sender core -> destination node) send slice of ``hs``
    entries, the last axis of the send table.  The f32 codec is exact: the
    round trip is the identity and inserts no operation.
    """

    name: str = "f32"
    exact: bool = True

    def encode(self, x: torch.Tensor) -> torch.Tensor:
        return x

    def decode(self, w: torch.Tensor, out_dtype=torch.float32) -> torch.Tensor:
        return w

    def payload_bytes(self, hs: int, itemsize: int = 4) -> int:
        return hs * itemsize

    def host_roundtrip(self, x: np.ndarray) -> np.ndarray:
        return x


_WIRE_CODECS: dict[str, WireCodec] = {c.name: c for c in (WireCodec(),)}


def get_codec(wire_dtype: str) -> WireCodec:
    """Resolve a wire-dtype name."""
    try:
        return _WIRE_CODECS[wire_dtype]
    except KeyError:
        raise ValueError(
            f"unknown wire_dtype {wire_dtype!r}; available: "
            f"{available_wire_dtypes()}") from None


def available_wire_dtypes() -> tuple[str, ...]:
    return tuple(sorted(_WIRE_CODECS))


# --------------------------------------------------------------------- #
# shared pieces
# --------------------------------------------------------------------- #
def _gather_add(part: torch.Tensor) -> torch.Tensor:
    """Combine the per-core partial ghost buffers ``(n_node, n_core,
    g_pad + 1)`` of each node: the core-axis gather + local add, a sum
    over the core axis.  Each real slot has exactly one writer, so the sum
    adds one value to zeros — exact, as an all-reduce would be."""
    return part.sum(dim=1)


def _host_send_table(xd, send_own, codec: WireCodec):
    """Gather the full send-chunk table ``(src, core, dst, hs)`` and route
    it through the wire codec."""
    n_node, n_core = send_own.shape[:2]
    sent = xd[np.arange(n_node)[:, None, None, None],
              np.arange(n_core)[None, :, None, None], send_own]
    if not codec.exact:
        sent = codec.host_roundtrip(sent)
    return sent


def _host_pair_scatter(xd, send_own, recv_own, g_pad, codec: WireCodec):
    """Numpy ghost assembly: every core scatters its own recv slice per
    source node, then the per-core partial buffers are summed node-wide
    (duplicate dump-slot writes land in the write-only slot ``g_pad``)."""
    n_node, n_core = send_own.shape[:2]
    sent = _host_send_table(xd, send_own, codec)
    ghost = np.zeros((n_node, n_core, g_pad + 1), dtype=xd.dtype)
    for dst in range(n_node):
        for c in range(n_core):
            part = np.zeros(g_pad + 1, dtype=xd.dtype)
            for src in range(n_node):
                part[recv_own[dst, c, src]] = sent[src, c, dst]
            ghost[dst, :, :] += part[None, :]
    return ghost


# --------------------------------------------------------------------- #
# a2a — one fused all_to_all (the PETSc VecScatter analogue)
# --------------------------------------------------------------------- #
@dataclasses.dataclass(frozen=True)
class A2ATransport(HaloTransport):
    name = "a2a"

    def plan_state(self, plan):
        # int64 copies of the tables, made once: torch's gather/scatter
        # take int64 indices
        n_node, n_core = plan.n_node, plan.n_core
        return {"send_idx": plan.send_own.reshape(n_node, n_core, -1).long(),
                "recv_idx": plan.recv_own.reshape(n_node, n_core, -1).long()}

    def exchange(self, x, F, *, state, n_node, g_pad):
        codec = state["wire_codec"]
        send_own = F["send_own"]                     # (src, c, dst, hs)
        # each core gathers its send chunks from its own shard
        sent = torch.gather(x, 2, state["send_idx"]).view(send_own.shape)
        # all_to_all over node: recv[dst, c, src] = sent[src, c, dst]
        recv = codec.decode(codec.encode(sent).transpose(0, 2), x.dtype)
        # each core scatters its own slice; duplicates only hit slot g_pad
        part = x.new_zeros((n_node, x.shape[1], g_pad + 1))
        part.scatter_(2, state["recv_idx"], recv.reshape(part.shape[:2] + (-1,)))
        return _gather_add(part)

    def host_exchange(self, xd, send_own, recv_own, g_pad, state):
        return _host_pair_scatter(xd, send_own, recv_own, g_pad,
                                  codec=state["wire_codec"])

    def predicted_cost(self, plan, state, itemsize=4):
        n_node, n_core, hs = plan.n_node, plan.n_core, plan.hs
        pb = state["wire_codec"].payload_bytes(hs, itemsize)
        return {"wire_bytes": n_node * (n_node - 1) * n_core * pb,
                "all-to-all": 1 if hs else 0,
                "all-gather": 1 if hs else 0,
                "collective-permute": 0}


# --------------------------------------------------------------------- #
# registry
# --------------------------------------------------------------------- #
_TRANSPORTS: dict[str, HaloTransport] = {}


def register_transport(transport: HaloTransport,
                       overwrite: bool = False) -> HaloTransport:
    """Register ``transport`` under ``transport.name`` for lookup by name."""
    if not transport.name:
        raise ValueError("a HaloTransport needs a non-empty name")
    if transport.name in _TRANSPORTS and not overwrite:
        raise ValueError(f"transport {transport.name!r} is already "
                         "registered (pass overwrite=True to replace it)")
    _TRANSPORTS[transport.name] = transport
    return transport


def get_transport(transport: str | HaloTransport) -> HaloTransport:
    """Resolve a transport name (or pass through an instance)."""
    if isinstance(transport, HaloTransport):
        return transport
    try:
        return _TRANSPORTS[transport]
    except KeyError:
        raise ValueError(f"unknown transport {transport!r}; available: "
                         f"{available_transports()}") from None


def available_transports() -> tuple[str, ...]:
    return tuple(sorted(_TRANSPORTS))


def transport_stamp(transport: str | HaloTransport) -> str:
    """Resolve ``transport`` to a *registered* name fit for stamping into
    a plan (an unregistered instance fails here, at plan build)."""
    tr = get_transport(transport)
    if _TRANSPORTS.get(tr.name) is not tr:
        raise ValueError(
            f"transport instance {tr.name!r} is not registered; the plan "
            "stamps transports by name, so register_transport() it first")
    return tr.name


def resolve_transport(plan) -> tuple[HaloTransport, dict]:
    """The plan's stamped transport and its plan state, resolved up front
    by ``make_shard_body``; the stamped codec rides the state under
    ``wire_codec``."""
    tr = get_transport(plan.transport)
    state = tr.plan_state(plan)
    state["wire_codec"] = get_codec(plan.wire_dtype)
    return tr, state


def transport_census(plan, itemsize: int = 4) -> dict:
    """{name: predicted_cost} over every registered transport, at the
    plan's wire codec."""
    codec = get_codec(plan.wire_dtype)
    out = {}
    for name in available_transports():
        tr = _TRANSPORTS[name]
        out[name] = tr.predicted_cost(plan, {"wire_codec": codec},
                                      itemsize=itemsize)
    return out


register_transport(A2ATransport())
