"""Halo-exchange transports — the ``HaloTransport`` layer, on a virtual mesh.

One card holds the whole ``(n_node, n_core)`` grid as the leading axes of
every vector, so the collectives of the JAX package's shard bodies become
on-device index operations with the same semantics:

  * ``all_to_all`` over ``node``: ``recv[dst, c, src] = sent[src, c, dst]``
    — a transpose of the send table;
  * ``ppermute`` over ``node`` at offset ``d``: node ``dst`` receives node
    ``(dst - d) mod n_node``'s chunk for it — a gather from the sender's
    shard with the sender's send indices, for every receiving pair;
  * the core-axis gather + add of partial ghost buffers (``_gather_add``):
    a sum over the core axis.  Every real ghost slot has exactly one
    writer, so the sum adds one value to zeros and is exact.

A value that the reference replicates over the core axis (each core's copy
of its node's assembled ghost buffer, ``hier``'s receive table) is held
once per node: ``exchange`` returns one ``(g_pad + 1,)`` buffer per node,
which every core of the node reads.

Every transport is a named plugin owning its static host state
(``plan_state``, derived from the plan's own ``send_own``/``recv_own``),
the device index tensors its exchange needs (``extra_arrays``, folded
into the shard body's ``F``), the exchange itself (``exchange(x, F, ...)
-> x_ghost``), a numpy reference of the same dataflow (``host_exchange``)
and its predicted wire cost (``predicted_cost``, per exchange, as if each
node were its own device).  Four ship:

``a2a``       one ``all_to_all`` of the whole send table + the core-axis
              gather/add of the per-core partial ghost buffers;
``ring``      one full-cycle ``ppermute`` per populated neighbour offset;
``pairwise``  ``ring`` restricted to the pairs that communicate at each
              offset;
``hier``      the node-leader exchange (the paper's "one MPI rank per
              node"): the core-axis gather of the send table, one
              ``all_to_all`` over nodes, a scatter through the node's whole
              receive table — no core-axis sum.

``FaultyTransport`` corrupts every ghost word; it is not registered at
import, and exists for the conformance harness
(``repro_torch.testing.transport_check``) to fail.

Orthogonal to the transport is the **wire dtype** (``f32`` | ``bf16`` |
``int8``): every transport encodes each ``hs``-entry send chunk through a
shared ``WireCodec`` before its collective and decodes right after, so
transports agree bit for bit at one wire dtype.  ``autotune_transport``
times each candidate's SpMV on the plan's device and stamps the winner
(``transport="auto"``); ``make_exchange`` is the ghost-buffer probe.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable

import numpy as np
import torch

from repro_torch.core.halo import (ghost_writer_counts, pair_traffic,
                                   populated_offsets)
from repro_torch.runtime.compression import compress_int8, decompress_int8

__all__ = ["HaloTransport", "A2ATransport", "RingTransport",
           "PairwiseTransport", "HierTransport", "FaultyTransport",
           "register_transport", "unregister_transport", "get_transport",
           "available_transports", "transport_stamp", "resolve_transport",
           "transport_census", "AutotuneResult", "autotune_transport",
           "make_exchange", "WireCodec", "BF16WireCodec", "Int8WireCodec",
           "get_codec", "available_wire_dtypes", "plan_wire_dtype"]


class HaloTransport:
    """Interface of a halo-exchange transport.

    Subclasses set ``name`` (registry key) and implement ``exchange`` /
    ``host_exchange`` / ``predicted_cost``; ``plan_state`` and
    ``extra_arrays`` default to "needs nothing".  All static state is
    derived from the plan's own arrays (``send_own``/``recv_own``/
    ``g_pad``), so a transport can be selected for any plan after the fact.
    """

    name: str = ""

    # -- static plan state (host) -------------------------------------- #
    def plan_state(self, plan) -> dict:
        """Static host-side state for this plan (python/numpy)."""
        return {}

    def extra_arrays(self, plan, state: dict) -> dict[str, torch.Tensor]:
        """Device index tensors the exchange needs beyond ``send_own`` /
        ``recv_own``; they reach ``exchange`` in ``F`` by name."""
        return {}

    def finalize_state(self, plan, state: dict) -> dict:
        """Recompute derived state after a caller override (an explicit
        ``neighbor_offsets`` list) — called by ``resolve_transport`` before
        ``validate``.  Default: passthrough."""
        return state

    def validate(self, plan, state: dict) -> None:
        """Raise ``ValueError`` on unusable state — called up front by
        ``resolve_transport``, before any exchange runs."""

    # -- the exchange --------------------------------------------------- #
    def exchange(self, x: torch.Tensor, F: dict, *, state: dict,
                 n_node: int, g_pad: int) -> torch.Tensor:
        """``x`` ``(n_node, n_core, cc_pad)`` (the plan's input layout) ->
        the assembled ghost buffer of every node, ``(n_node, g_pad + 1)``.
        Real slots ``< g_pad`` hold exactly the owners' bits, up to the
        wire codec; slot ``g_pad`` is write-only.  A batched ``x`` ``(nrhs,
        n_node, n_core, cc_pad)`` gives ``(nrhs, n_node, g_pad + 1)``, each
        column exchanged as alone (the codec's chunks stay per column): the
        JAX package's exchange under ``vmap``."""
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
# wire codecs — the wire-dtype axis shared by every transport
# --------------------------------------------------------------------- #
class WireCodec:
    """Encode/decode of halo payload *chunks* on the inter-node wire.

    A chunk is one (sender core -> destination node) send slice of ``hs``
    entries, the last axis of every transport's send table, so the same
    codec applied by any transport gives bit-identical decoded ghosts.

    Contract:
      * ``encode``/``decode`` round-trip each last-axis chunk with
        elementwise error ``|dec - x| <= rel_bound * max|chunk|``
        (``rel_bound == 0.0`` iff ``exact``, in which case the round trip
        is the identity and inserts no operation);
      * the ghost-buffer accumulate stays f32: transports decode to
        ``x.dtype`` right after the collective;
      * ``payload_bytes(hs, itemsize)`` is the on-wire bytes per chunk
        (int8 carries its per-chunk f32 scale in 4 trailing payload
        bytes, so one collective still carries everything);
      * ``declared_downcasts`` lists the ``"src->dst"`` float conversions
        the codec performs;
      * ``host_roundtrip`` runs this codec's ``encode``/``decode`` on a
        numpy chunk table (on the CPU), so the ``host_exchange``
        references stay the bit-level truth under lossy wire.
    """

    name: str = "f32"
    exact: bool = True
    rel_bound: float = 0.0
    declared_downcasts: tuple[str, ...] = ()

    def encode(self, x: torch.Tensor) -> torch.Tensor:
        return x

    def decode(self, w: torch.Tensor, out_dtype=torch.float32) -> torch.Tensor:
        return w

    def payload_bytes(self, hs: int, itemsize: int = 4) -> int:
        return hs * itemsize

    def host_roundtrip(self, x: np.ndarray) -> np.ndarray:
        if self.exact:
            return x
        t = torch.from_numpy(np.ascontiguousarray(x, dtype=np.float32))
        return self.decode(self.encode(t), torch.float32).numpy().astype(
            x.dtype)


class BF16WireCodec(WireCodec):
    """Round chunks to bfloat16 on the wire: half the bytes, 8 significant
    bits — round-to-nearest-even error ``<= 2^-8`` relative, elementwise."""

    name = "bf16"
    exact = False
    rel_bound = 2.0 ** -8
    declared_downcasts = ("float32->bfloat16",)

    def encode(self, x):
        return x.to(torch.bfloat16)

    def decode(self, w, out_dtype=torch.float32):
        return w.to(out_dtype)

    def payload_bytes(self, hs, itemsize=4):
        return hs * 2


class Int8WireCodec(WireCodec):
    """Per-chunk absmax-scaled int8 quantisation (``compress_int8``): ~4x
    fewer wire bytes + 4 bytes per chunk for the f32 scale, which rides
    inside the int8 payload (its bytes as the last 4 entries of the chunk)
    so one collective still carries everything.  Error ``<= scale / 2 ~=
    max|chunk| / 254``."""

    name = "int8"
    exact = False
    rel_bound = 0.5 / 127.0 + 1e-6
    declared_downcasts = ()

    def encode(self, x):
        q, scale = compress_int8(x, axis=-1, keepdims=True)
        sb = scale.to(torch.float32).contiguous().view(torch.int8)
        return torch.cat([q, sb], dim=-1)                   # (..., hs + 4)

    def decode(self, w, out_dtype=torch.float32):
        scale = w[..., -4:].contiguous().view(torch.float32)     # (..., 1)
        return decompress_int8(w[..., :-4], scale, dtype=out_dtype)

    def payload_bytes(self, hs, itemsize=4):
        return hs + 4 if hs else 0


_WIRE_CODECS: dict[str, WireCodec] = {
    c.name: c for c in (WireCodec(), BF16WireCodec(), Int8WireCodec())}


def get_codec(wire_dtype) -> WireCodec:
    """Resolve a wire-dtype name (or pass through a codec instance)."""
    if isinstance(wire_dtype, WireCodec):
        return wire_dtype
    try:
        return _WIRE_CODECS[wire_dtype]
    except KeyError:
        raise ValueError(
            f"unknown wire_dtype {wire_dtype!r}; available: "
            f"{available_wire_dtypes()}") from None


def available_wire_dtypes() -> tuple[str, ...]:
    return tuple(sorted(_WIRE_CODECS))


def plan_wire_dtype(plan) -> str:
    """The wire dtype a plan stamps (a plan without one reads f32)."""
    return getattr(plan, "wire_dtype", "f32") or "f32"


def _wire_codec(state: dict) -> WireCodec:
    """Codec carried in resolved transport state (f32 when a caller built
    the state with bare ``plan_state`` rather than ``resolve_transport``)."""
    return state.get("wire_codec") or _WIRE_CODECS["f32"]


# --------------------------------------------------------------------- #
# shared pieces
# --------------------------------------------------------------------- #
def _neighbour_state(plan) -> dict:
    """Communicating-pair table + populated offsets from the plan arrays.

    Cached on the plan instance: ``transport_census`` (run at every plan
    build) and each ring/pairwise resolution would otherwise repeat the
    same device-to-host copy and scan."""
    cached = getattr(plan, "_neighbour_cache", None)
    if cached is None:
        traffic = pair_traffic(plan.recv_own.cpu().numpy(), plan.g_pad)
        cached = (traffic, populated_offsets(traffic))
        plan._neighbour_cache = cached
    traffic, offsets = cached
    return {"traffic": traffic, "neighbor_offsets": list(offsets)}


def _norm_offsets(offsets, n_node: int) -> list[int]:
    """Offsets reduced mod n_node, deduped, self-offset dropped — an
    override listing an alias (e.g. 5 on 4 nodes) must not schedule the
    same hop twice."""
    return sorted({d % n_node for d in offsets} - {0})


def _validate_offsets(name: str, plan, state: dict) -> None:
    """Shared ring/pairwise check: the (possibly overridden) offset list
    must cover every populated (dst - src) offset — a partial list would
    silently drop halo traffic."""
    if plan.hs == 0:
        return
    offsets = state["neighbor_offsets"]
    if not offsets:
        raise ValueError(f"{name} transport needs neighbor_offsets "
                         "covering every populated (dst-src) offset")
    missing = set(populated_offsets(state["traffic"])) - set(offsets)
    if missing:
        raise ValueError(
            f"{name} transport neighbor_offsets {sorted(offsets)} miss "
            f"populated (dst-src) offsets {sorted(missing)}; the "
            "exchange would silently drop that halo traffic")


def _batch(x: torch.Tensor) -> torch.Tensor:
    """The exchanges run on a leading batch axis: ``(nrhs, n_node, n_core,
    cc_pad)``, a single column as a batch of one."""
    return x if x.dim() == 4 else x[None]


def _unbatch(out: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    return out if x.dim() == 4 else out[0]


def _expand(idx: torch.Tensor, k: int) -> torch.Tensor:
    """An index tensor repeated over ``k`` columns, as a view."""
    return idx.expand(k, *idx.shape)


def _gather_add(part: torch.Tensor) -> torch.Tensor:
    """Combine the per-core partial ghost buffers ``(..., n_node, n_core,
    g_pad + 1)`` of each node: the core-axis gather + local add, a sum
    over the core axis.  Each real slot has exactly one writer, so the sum
    adds one value to zeros — exact, as an all-reduce would be."""
    return part.sum(dim=-2)


def _owner_tables(plan) -> dict[str, torch.Tensor]:
    """int64 copies of the send and receive tables, one row per shard:
    torch's gather/scatter take int64 indices."""
    n_node, n_core = plan.n_node, plan.n_core
    return {"send_idx": plan.send_own.reshape(n_node, n_core, -1).long(),
            "recv_idx": plan.recv_own.reshape(n_node, n_core, -1).long()}


def _send_table(xb: torch.Tensor, F: dict, codec: WireCodec) -> torch.Tensor:
    """Every core gathers its send chunks from its own shard and encodes
    them: the wire payload ``(nrhs, src, core, dst, hs')`` of a batched
    ``xb``."""
    k = xb.shape[0]
    sent = torch.gather(xb, 3, _expand(F["send_idx"], k))
    return codec.encode(sent.view((k,) + tuple(F["send_own"].shape)))


def _permute_tables(plan, pairs_by_offset: dict) -> dict[str, torch.Tensor]:
    """Flat gather/scatter indices of each offset's ``ppermute``: for a
    pair ``src -> dst`` and every core ``c``, ``take_<d>`` reads
    ``x[src, c, send_own[src, c, dst]]`` and ``put_<d>`` writes slot
    ``recv_own[dst, c, src]`` of ``dst``'s core-``c`` partial buffer.
    Receivers no pair names are left out, so they get zeros (their receive
    rows are all dump slot)."""
    send = plan.send_own.cpu().numpy().astype(np.int64)
    recv = plan.recv_own.cpu().numpy().astype(np.int64)
    c = np.arange(plan.n_core)[None, :, None]
    out = {}
    for d, pairs in pairs_by_offset.items():
        src = np.array([s for s, _ in pairs])[:, None, None]
        dst = np.array([t for _, t in pairs])[:, None, None]
        take = ((src * plan.n_core + c) * plan.cc_pad
                + send[src[..., 0], c[..., 0], dst[..., 0]])
        put = ((dst * plan.n_core + c) * (plan.g_pad + 1)
               + recv[dst[..., 0], c[..., 0], src[..., 0]])
        out[f"take_{d}"] = torch.from_numpy(take).to(plan.device)
        out[f"put_{d}"] = torch.from_numpy(put).to(plan.device)
    return out


def _ppermute_exchange(x, F, offsets, n_node: int, g_pad: int,
                       codec: WireCodec) -> torch.Tensor:
    """Shared ring/pairwise dataflow: one independent ``ppermute`` per
    neighbour offset (each chunk encoded to the wire dtype, decoded back
    on arrival), scattered into the per-core partial ghost buffers,
    assembled with the core-axis gather + add."""
    xb = _batch(x)
    k = xb.shape[0]
    flat = xb.reshape(k, -1)
    part = x.new_zeros((k, n_node, xb.shape[2], g_pad + 1))
    for d in offsets:
        take, put = F[f"take_{d}"], F[f"put_{d}"]
        got = torch.gather(flat, 1, _expand(take.reshape(-1), k))
        got = codec.decode(codec.encode(got.view((k,) + tuple(take.shape))),
                           x.dtype)
        # duplicate indices only ever hit the dump slot g_pad
        part.view(k, -1).scatter_(1, _expand(put.reshape(-1), k),
                                  got.reshape(k, -1))
    return _unbatch(_gather_add(part), x)


def _host_send_table(xd, send_own, codec: WireCodec | None):
    """Gather the full send-chunk table ``(src, core, dst, hs)`` and route
    it through the wire codec — the chunks are exactly the last axis, so
    one ``host_roundtrip`` reproduces the device encode/decode."""
    n_node, n_core = send_own.shape[:2]
    sent = xd[np.arange(n_node)[:, None, None, None],
              np.arange(n_core)[None, :, None, None], send_own]
    if codec is not None and not codec.exact:
        sent = codec.host_roundtrip(sent)
    return sent


def _host_pair_scatter(xd, send_own, recv_own, g_pad, traffic=None,
                       codec: WireCodec | None = None):
    """Numpy ghost assembly shared by a2a/ring/pairwise: every core
    scatters its own recv slice per source node, then the per-core partial
    buffers are summed node-wide (duplicate dump-slot writes land in the
    write-only slot ``g_pad``).  Sent chunks pass through the wire codec's
    round trip first."""
    n_node, n_core = send_own.shape[:2]
    sent = _host_send_table(xd, send_own, codec)
    ghost = np.zeros((n_node, n_core, g_pad + 1), dtype=xd.dtype)
    for dst in range(n_node):
        for c in range(n_core):
            part = np.zeros(g_pad + 1, dtype=xd.dtype)
            for src in range(n_node):
                if traffic is not None and not traffic[dst, src]:
                    continue
                part[recv_own[dst, c, src]] = sent[src, c, dst]
            ghost[dst, :, :] += part[None, :]
    return ghost


# --------------------------------------------------------------------- #
# a2a — one fused all_to_all (the PETSc VecScatter analogue)
# --------------------------------------------------------------------- #
@dataclasses.dataclass(frozen=True)
class A2ATransport(HaloTransport):
    name = "a2a"

    def extra_arrays(self, plan, state):
        return _owner_tables(plan)

    def exchange(self, x, F, *, state, n_node, g_pad):
        codec = _wire_codec(state)
        xb = _batch(x)
        k = xb.shape[0]
        # all_to_all over node: recv[dst, c, src] = sent[src, c, dst]
        recv = codec.decode(_send_table(xb, F, codec).transpose(1, 3),
                            x.dtype)
        # each core scatters its own slice; duplicates only hit slot g_pad
        part = x.new_zeros((k, n_node, xb.shape[2], g_pad + 1))
        part.scatter_(3, _expand(F["recv_idx"], k),
                      recv.reshape(part.shape[:3] + (-1,)))
        return _unbatch(_gather_add(part), x)

    def host_exchange(self, xd, send_own, recv_own, g_pad, state):
        return _host_pair_scatter(xd, send_own, recv_own, g_pad,
                                  codec=_wire_codec(state))

    def predicted_cost(self, plan, state, itemsize=4):
        n_node, n_core, hs = plan.n_node, plan.n_core, plan.hs
        pb = _wire_codec(state).payload_bytes(hs, itemsize)
        return {"wire_bytes": n_node * (n_node - 1) * n_core * pb,
                "all-to-all": 1 if hs else 0,
                "all-gather": 1 if hs else 0,
                "collective-permute": 0}


# --------------------------------------------------------------------- #
# ring — one full-cycle ppermute per populated neighbour offset
# --------------------------------------------------------------------- #
@dataclasses.dataclass(frozen=True)
class RingTransport(HaloTransport):
    name = "ring"

    def plan_state(self, plan):
        return _neighbour_state(plan)

    def finalize_state(self, plan, state):
        return dict(state, neighbor_offsets=_norm_offsets(
            state["neighbor_offsets"], plan.n_node))

    def validate(self, plan, state):
        _validate_offsets("ring", plan, state)

    def extra_arrays(self, plan, state):
        n = plan.n_node
        return _permute_tables(plan, {
            d: [(i, (i + d) % n) for i in range(n)]
            for d in state["neighbor_offsets"]})

    def exchange(self, x, F, *, state, n_node, g_pad):
        return _ppermute_exchange(x, F, state["neighbor_offsets"], n_node,
                                  g_pad, _wire_codec(state))

    def host_exchange(self, xd, send_own, recv_own, g_pad, state):
        n_node = send_own.shape[0]
        reach = np.zeros_like(state["traffic"])
        for d in state["neighbor_offsets"]:
            for src in range(n_node):
                reach[(src + d) % n_node, src] = True
        return _host_pair_scatter(xd, send_own, recv_own, g_pad,
                                  traffic=reach, codec=_wire_codec(state))

    def predicted_cost(self, plan, state, itemsize=4):
        k = len(state["neighbor_offsets"])
        n_node, n_core, hs = plan.n_node, plan.n_core, plan.hs
        pb = _wire_codec(state).payload_bytes(hs, itemsize)
        return {"wire_bytes": k * n_node * n_core * pb,
                "all-to-all": 0,
                "all-gather": 1 if hs else 0,
                "collective-permute": k}


# --------------------------------------------------------------------- #
# pairwise — ring minus the dead steps: per-offset ppermutes list only
# the actually-communicating pairs
# --------------------------------------------------------------------- #
@dataclasses.dataclass(frozen=True)
class PairwiseTransport(HaloTransport):
    name = "pairwise"

    def plan_state(self, plan):
        return self.finalize_state(plan, _neighbour_state(plan))

    def finalize_state(self, plan, state):
        # pairs follow the (possibly overridden) offset list, restricted
        # to pairs that actually communicate — extra offsets contribute
        # no pairs, and completeness is enforced by validate below
        traffic, n_node = state["traffic"], plan.n_node
        offsets = _norm_offsets(state["neighbor_offsets"], n_node)
        pairs = {
            d: [(src, (src + d) % n_node) for src in range(n_node)
                if traffic[(src + d) % n_node, src]]
            for d in offsets}
        return dict(state, neighbor_offsets=offsets,
                    pairs_by_offset={d: p for d, p in pairs.items() if p})

    def validate(self, plan, state):
        _validate_offsets("pairwise", plan, state)

    def extra_arrays(self, plan, state):
        return _permute_tables(plan, state["pairs_by_offset"])

    def exchange(self, x, F, *, state, n_node, g_pad):
        return _ppermute_exchange(x, F, state["pairs_by_offset"], n_node,
                                  g_pad, _wire_codec(state))

    def host_exchange(self, xd, send_own, recv_own, g_pad, state):
        return _host_pair_scatter(xd, send_own, recv_own, g_pad,
                                  traffic=state["traffic"],
                                  codec=_wire_codec(state))

    def predicted_cost(self, plan, state, itemsize=4):
        n_pairs = int(np.count_nonzero(state["traffic"]))
        pb = _wire_codec(state).payload_bytes(plan.hs, itemsize)
        return {"wire_bytes": n_pairs * plan.n_core * pb,
                "all-to-all": 0,
                "all-gather": 1 if plan.hs else 0,
                "collective-permute": len(state["pairs_by_offset"])}


# --------------------------------------------------------------------- #
# hier — two-level node-leader exchange ("one MPI rank per node")
# --------------------------------------------------------------------- #
@dataclasses.dataclass(frozen=True)
class HierTransport(HaloTransport):
    name = "hier"

    def validate(self, plan, state):
        # the whole node's table is scattered at once, so a real slot
        # with two writers would be a race (scatter order on the card is
        # unspecified); only the dump slot g_pad may repeat
        if plan.hs and (ghost_writer_counts(plan.recv_own.cpu().numpy(),
                                            plan.g_pad) > 1).any():
            raise ValueError("hier transport: a real ghost slot has more "
                             "than one writer in recv_own")

    def extra_arrays(self, plan, state):
        # every core of node dst scatters the node's *whole* receive table
        # (the reference replicates it over the core axis,
        # (n_node, n_core, n_core, n_node, hs)); one copy per node here
        return {"send_idx": _owner_tables(plan)["send_idx"],
                "recv_all": plan.recv_own.reshape(plan.n_node, -1).long()}

    def exchange(self, x, F, *, state, n_node, g_pad):
        codec = _wire_codec(state)
        xb = _batch(x)
        k = xb.shape[0]
        # the core-axis gather of the encoded send chunks to the node's
        # leader (the table already holds every core's), then one
        # all_to_all of the combined per-node payload over nodes
        recv = codec.decode(_send_table(xb, F, codec).transpose(1, 3),
                            x.dtype)              # (k, dst, c, src, hs)
        # the intra-node scatter through the node's whole receive table
        # assembles the full ghost buffer — no core-axis sum
        ghost = x.new_zeros((k, n_node, g_pad + 1))
        ghost.scatter_(2, _expand(F["recv_all"], k),
                       recv.reshape(k, n_node, -1))
        return _unbatch(ghost, x)

    def host_exchange(self, xd, send_own, recv_own, g_pad, state):
        n_node, n_core = send_own.shape[:2]
        sent = _host_send_table(xd, send_own, _wire_codec(state))
        ghost = np.zeros((n_node, n_core, g_pad + 1), dtype=xd.dtype)
        for dst in range(n_node):
            buf = np.zeros(g_pad + 1, dtype=xd.dtype)
            for c in range(n_core):
                for src in range(n_node):
                    buf[recv_own[dst, c, src]] = sent[src, c, dst]
            ghost[dst, :, :] = buf[None, :]
        return ghost

    def predicted_cost(self, plan, state, itemsize=4):
        n_node, n_core, hs = plan.n_node, plan.n_core, plan.hs
        pb = _wire_codec(state).payload_bytes(hs, itemsize)
        # the combined payload rides the node axis once per core row
        # (SPMD replication), so the padded wire is n_core x the a2a bytes;
        # the win is the removed receive-side core gather
        return {"wire_bytes": n_node * (n_node - 1) * n_core * n_core * pb,
                "all-to-all": 1 if hs else 0,
                "all-gather": 1 if hs else 0,   # send-side, core axis
                "collective-permute": 0}


# --------------------------------------------------------------------- #
# faulty — a corrupting wrapper for the conformance harness
# --------------------------------------------------------------------- #
@dataclasses.dataclass(frozen=True)
class FaultyTransport(HaloTransport):
    """Delegating wrapper that XORs an exponent bit into every word of the
    exchanged ghost buffer — deterministic transport-level corruption.

    The whole payload is hit, so detection never depends on which halo
    rows carry signal: every nonzero halo entry is blown up by ~2^128.
    ``host_exchange`` delegates *uncorrupted*: the numpy reference stays
    the truth, so ``repro_torch.testing.transport_check --include-faulty``
    must fail this transport on both the ghost and the SpMV comparison.

    Not registered at import: every registered transport is swept by the
    conformance checks, and this one exists to fail them.  Register it
    temporarily (``register_transport`` / ``unregister_transport``) or
    pass the instance directly.
    """

    name = "faulty"
    base: HaloTransport = dataclasses.field(default_factory=A2ATransport)
    #: f32 bit to XOR — bit 30 is the top exponent bit
    bit: int = 30

    def plan_state(self, plan):
        return self.base.plan_state(plan)

    def extra_arrays(self, plan, state):
        return self.base.extra_arrays(plan, state)

    def finalize_state(self, plan, state):
        return self.base.finalize_state(plan, state)

    def validate(self, plan, state):
        self.base.validate(plan, state)

    def exchange(self, x, F, *, state, n_node, g_pad):
        ghost = self.base.exchange(x, F, state=state, n_node=n_node,
                                   g_pad=g_pad)
        if g_pad == 0:          # halo-free: nothing real to corrupt
            return ghost
        return (ghost.view(torch.int32) ^ (1 << self.bit)).view(ghost.dtype)

    def host_exchange(self, xd, send_own, recv_own, g_pad, state):
        # uncorrupted on purpose — see the class docstring
        return self.base.host_exchange(xd, send_own, recv_own, g_pad, state)

    def predicted_cost(self, plan, state, itemsize=4):
        return self.base.predicted_cost(plan, state, itemsize=itemsize)


# --------------------------------------------------------------------- #
# registry
# --------------------------------------------------------------------- #
_TRANSPORTS: dict[str, HaloTransport] = {}


def register_transport(transport: HaloTransport,
                       overwrite: bool = False) -> HaloTransport:
    """Register ``transport`` under ``transport.name`` for lookup by name
    (and for the conformance harness's sweep)."""
    if not transport.name:
        raise ValueError("a HaloTransport needs a non-empty name")
    if transport.name in _TRANSPORTS and not overwrite:
        raise ValueError(f"transport {transport.name!r} is already "
                         "registered (pass overwrite=True to replace it)")
    _TRANSPORTS[transport.name] = transport
    return transport


def unregister_transport(name: str) -> HaloTransport:
    """Remove and return a registered transport — the cleanup half of a
    temporary registration."""
    try:
        return _TRANSPORTS.pop(name)
    except KeyError:
        raise ValueError(f"unknown transport {name!r}; registered: "
                         f"{available_transports()}") from None


def get_transport(transport: str | HaloTransport) -> HaloTransport:
    """Resolve a transport name (or pass through an instance)."""
    if isinstance(transport, HaloTransport):
        return transport
    try:
        return _TRANSPORTS[transport]
    except KeyError:
        raise ValueError(f"unknown transport {transport!r}; available: "
                         f"{available_transports()} (or 'auto')") from None


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


def resolve_transport(transport, plan, neighbor_offsets=None,
                      wire_dtype=None) -> tuple[HaloTransport, dict]:
    """(transport, validated plan state) — the up-front resolution used by
    ``make_shard_body`` and ``make_exchange``.

    ``neighbor_offsets``, when given, replaces the offsets ring/pairwise
    derive from the plan and is validated for completeness.
    ``wire_dtype`` overrides the plan's stamped wire codec (default:
    follow the stamp); the resolved codec rides the state under
    ``"wire_codec"``.
    """
    tr = get_transport(transport)
    state = tr.plan_state(plan)
    if neighbor_offsets is not None and "neighbor_offsets" in state:
        state = tr.finalize_state(
            plan, dict(state, neighbor_offsets=list(neighbor_offsets)))
    tr.validate(plan, state)
    state["wire_codec"] = get_codec(
        wire_dtype if wire_dtype is not None else plan_wire_dtype(plan))
    return tr, state


def transport_census(plan, itemsize: int = 4, wire_dtype=None) -> dict:
    """{name: predicted_cost} over every registered transport, each from
    its own plan state; wire bytes follow ``wire_dtype`` (default: the
    plan's stamp)."""
    codec = get_codec(
        wire_dtype if wire_dtype is not None else plan_wire_dtype(plan))
    out = {}
    for name in available_transports():
        tr = _TRANSPORTS[name]
        state = tr.plan_state(plan)
        state["wire_codec"] = codec
        out[name] = tr.predicted_cost(plan, state, itemsize=itemsize)
    return out


# --------------------------------------------------------------------- #
# ghost-buffer probe (the conformance harness's microscope)
# --------------------------------------------------------------------- #
def make_exchange(plan, transport: str | HaloTransport = "a2a",
                  neighbor_offsets=None, wire_dtype=None) -> Callable:
    """Ghost-buffer probe: input-layout ``x`` (``plan.x_shape``) ->
    ``(n_node, n_core, g_pad + 1)``, the reference's per-shard shape, each
    node's assembled buffer repeated over the core axis — exactly what the
    shard body feeds the off-diagonal matvec.  Raises on halo-free plans (there is no exchange
    to probe)."""
    if plan.hs == 0:
        raise ValueError("plan has no halo traffic (hs == 0): "
                         "there is no exchange to probe")
    tr, state = resolve_transport(transport, plan, neighbor_offsets,
                                  wire_dtype=wire_dtype)
    F = {"send_own": plan.send_own, "recv_own": plan.recv_own,
         **tr.extra_arrays(plan, state)}
    n_node, n_core, g_pad = plan.n_node, plan.n_core, plan.g_pad

    def probe(xd: torch.Tensor) -> torch.Tensor:
        ghost = tr.exchange(xd, F, state=state, n_node=n_node, g_pad=g_pad)
        return ghost[:, None].expand(n_node, n_core, g_pad + 1)

    probe.transport = tr.name
    probe.wire_dtype = state["wire_codec"].name
    return probe


# --------------------------------------------------------------------- #
# the per-plan autotuner
# --------------------------------------------------------------------- #
@dataclasses.dataclass
class AutotuneResult:
    winner: str
    timings_us: dict[str, float]        # per-candidate median, full table
    spmv: Callable                      # the winner's SpMV
    #: raw per-repetition table behind each median
    reps_us: dict[str, list[float]] = dataclasses.field(default_factory=dict)
    #: per-candidate min-of-reps — the estimator the winner is selected by
    timings_min_us: dict[str, float] = dataclasses.field(
        default_factory=dict)


def autotune_transport(plan, candidates: tuple[str, ...] | None = None,
                       iters: int = 20, warmup: int = 2, reps: int = 3,
                       neighbor_offsets=None,
                       wire_dtype=None) -> AutotuneResult:
    """Time every candidate transport's SpMV on the plan's device and
    stamp the winner into ``plan.transport``.

    Each candidate is built once, warmed ``warmup`` calls, then timed over
    ``reps`` repetitions of ``iters`` back-to-back calls, with the card
    synchronised before and after each repetition.  The per-candidate
    median and min are reported; the winner is selected by the **min**,
    which estimates the uncontended cost.  ``transport="auto"`` in
    ``make_spmv`` / ``make_solver`` resolves through this function, so a
    plan autotuned once keeps its winner for every later build.  Halo-free
    plans skip timing — every transport builds the same exchange-free
    body — and stamp ``a2a``.
    """
    from repro_torch.core.spmv import make_spmv

    names = tuple(candidates) if candidates else available_transports()
    if plan.hs == 0:
        plan.transport = "a2a"
        return AutotuneResult("a2a", {n: 0.0 for n in names},
                              make_spmv(plan, transport="a2a",
                                        wire_dtype=wire_dtype),
                              timings_min_us={n: 0.0 for n in names})
    on_card = plan.device.type == "cuda"

    def sync():
        if on_card:
            torch.cuda.synchronize(plan.device)

    x = plan.mask_col                   # any full input-layout vector
    timings: dict[str, float] = {}
    timings_min: dict[str, float] = {}
    reps_us: dict[str, list[float]] = {}
    fns: dict[str, Callable] = {}
    for name in names:
        spmv = make_spmv(plan, transport=name,
                         neighbor_offsets=neighbor_offsets,
                         wire_dtype=wire_dtype)
        for _ in range(max(warmup, 1)):
            spmv(x)
        rep_times = []
        for _ in range(max(reps, 1)):
            sync()
            t0 = time.perf_counter()
            for _ in range(iters):
                spmv(x)
            sync()
            rep_times.append((time.perf_counter() - t0) / iters * 1e6)
        reps_us[name] = rep_times
        timings[name] = float(np.median(rep_times))
        timings_min[name] = float(np.min(rep_times))
        fns[name] = spmv
    winner = min(timings_min, key=lambda n: timings_min[n])
    plan.transport = winner
    return AutotuneResult(winner, timings, fns[winner], reps_us,
                          timings_min)


register_transport(A2ATransport())
register_transport(RingTransport())
register_transport(PairwiseTransport())
register_transport(HierTransport())
