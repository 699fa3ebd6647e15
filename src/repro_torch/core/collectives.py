"""The virtual mesh's collectives, as named functions.

One card holds the whole ``(n_node, n_core)`` grid as the leading axes of
every sharded tensor, so each collective of the JAX package's shard bodies
(``jax.lax.all_to_all`` / ``ppermute`` / ``all_gather`` / ``psum``) is an
index operation, a view or a sum on the card.  Every place the port moves
data between shards calls one of the four functions below; each notes what
it moved when a :func:`record_collectives` block is open, and otherwise
costs one list check:

``all_to_all``  over ``node``: ``recv[dst, c, src] = sent[src, c, dst]``
                — a transpose of the send table (a view);
``ppermute``    over ``node`` at one offset: each pair's chunk, gathered by
                its sender (the flat ``take`` gather of the pair tables),
                is already laid out by pair, so the delivery moves nothing
                here; the receiver's ``put`` scatter follows;
``all_gather``  over ``core`` (or ``node``): every shard's operand stacked
                along the axis — on one card the sharded tensor itself,
                which each node's cores read (a view);
``psum``        over both axes: the sum over the shards.

A sharded tensor is laid out ``(*batch, n_node, n_core, *operand)``: ``lead``
leading batch axes (right-hand sides), the two mesh axes, then each
shard's operand.  A tensor already gathered over the core axis
(``core_gathered=True``) holds each node's stack once per node: each
shard's operand is then ``(n_core, *operand)``.

A record (:class:`Collective`) speaks the JAX package's vocabulary
(:data:`COLLECTIVE_OPS`, the compiled-HLO names), so a census of records is
directly comparable with a transport's ``predicted_cost`` and with the
reference's jaxpr census.  Its ``shape`` and ``dtype`` are those of the
tensor handed to the collective — after a wire codec's encode — for one
shard and one column; ``nrhs`` counts the columns.

On a **process mesh** (``repro_torch.launch.mesh``, passed as ``mesh=``)
each rank holds one shard, so the leading mesh axes of every tensor have
extent 1, and each function is a ``torch.distributed`` call with the same
meaning: ``all_to_all`` an ``all_to_all_single`` over the node group,
``ppermute`` point-to-point sends and receives over the node group (its
``perm`` names the pairs), ``all_gather`` over the core or node group
(the stacked shards, concatenated along that axis), and ``psum`` an
all-gather of the per-shard partials over the world, summed as the
virtual mesh sums them (in shard order), so the two meshes agree bit for
bit wherever the partials do.  Every payload moves as raw bytes (any
dtype, bit for bit).  gloo moves host tensors, so on a card each payload is
staged through host memory after a stream sync (``_Staged``); NCCL moves
them card to card (``_OnCard``): no host copy and no sync, the calls
queued on the card's stream like its kernels.  :data:`WIRE` times both.
The records are the same on every mesh.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
import time
from collections import deque
from collections.abc import Mapping

import torch

__all__ = ["COLLECTIVE_OPS", "SOLVER_REDUCTION_OPS", "TRANSPORT_OPS",
           "census_split", "Collective", "record_collectives", "census",
           "all_to_all", "ppermute", "all_gather", "psum", "WIRE",
           "reset_wire", "CONTROL", "host_control"]

COLLECTIVE_OPS = ("all-reduce", "reduce-scatter", "all-gather",
                  "all-to-all", "collective-permute",
                  "collective-broadcast")

#: the two sides of the census.  The SpMV shard body emits no reduction
#: (ghost assembly is gather + local add), so in a solver's loop body every
#: op in SOLVER_REDUCTION_OPS is the solver's own and every op in
#: TRANSPORT_OPS belongs to the halo transport and the vector assembly.
SOLVER_REDUCTION_OPS = ("all-reduce", "reduce-scatter")
TRANSPORT_OPS = ("all-gather", "all-to-all", "collective-permute",
                 "collective-broadcast")

AXES = ("node", "core")


def census_split(counts: dict) -> dict:
    """Split a per-kind census into solver reductions vs transport traffic
    (the per-collective-kind attribution the bench harness reports)."""
    return {"solver_reductions": sum(counts.get(k, 0)
                                     for k in SOLVER_REDUCTION_OPS),
            "transport_ops": sum(counts.get(k, 0) for k in TRANSPORT_OPS)}


@dataclasses.dataclass(frozen=True)
class Collective:
    """One collective as issued: its kind (:data:`COLLECTIVE_OPS`), mesh
    axes, the operand of one shard for one column (shape, dtype), the
    columns it carried and, for ``collective-permute``, its src != dst
    pairs."""

    kind: str
    axis: tuple[str, ...]
    shape: tuple[int, ...]
    dtype: torch.dtype
    nrhs: int = 1
    pairs: int | None = None

    @property
    def nbytes(self) -> int:
        """Bytes of one shard's operand, all columns."""
        return self.nrhs * math.prod(self.shape) * self.dtype.itemsize


#: open recorders (see :func:`record_collectives`)
_RECORDERS: list[list[Collective]] = []


@contextlib.contextmanager
def record_collectives():
    """Record every collective issued inside the block: ``with
    record_collectives() as log: ...`` leaves the :class:`Collective`
    records in ``log``, in issue order.  Nested blocks each record what
    they enclose."""
    log: list[Collective] = []
    _RECORDERS.append(log)
    try:
        yield log
    finally:
        _RECORDERS.pop()


def census(records) -> dict[str, int]:
    """Per-kind counts of ``records``, every kind of
    :data:`COLLECTIVE_OPS` present."""
    counts = {kind: 0 for kind in COLLECTIVE_OPS}
    for c in records:
        counts[c.kind] += 1
    return counts


def _note(kind: str, axis, x: torch.Tensor, lead: int,
          core_gathered: bool = False, pairs: int | None = None) -> None:
    if not _RECORDERS:
        return
    shape = tuple(x.shape[lead + 2:])
    if core_gathered:
        shape = (x.shape[lead + 1],) + shape
    rec = Collective(kind, (axis,) if isinstance(axis, str) else tuple(axis),
                     shape, x.dtype, math.prod(x.shape[:lead]), pairs)
    for log in _RECORDERS:
        log.append(rec)


def _check_axis(axis: str) -> None:
    if axis not in AXES:
        raise ValueError(f"mesh axis must be one of {AXES}, got {axis!r}")


# ---------------------------------------------------------------------- #
# the process mesh's wire: torch.distributed calls, host-staged on gloo
# ---------------------------------------------------------------------- #
class _Wire(Mapping):
    """The process mesh's collectives since the last :func:`reset_wire`:
    ``calls``, ``seconds`` spent in them, payload ``bytes`` sent by this
    rank, and ``by_kind``, the seconds by :data:`COLLECTIVE_OPS` kind
    (host control under :data:`CONTROL`).  gloo's seconds are the host
    clock around each call (staging to the host and back included, after
    the card has finished the work before it).  NCCL's are CUDA-event
    times on the card's stream, from the work before the call to the
    result's arrival: the events are read when this is read (which waits
    for them), so timing never serialises the loop."""

    def __init__(self):
        self.reset()

    def _add(self, kind: str, seconds: float) -> None:
        self._d["seconds"] += seconds
        by = self._d["by_kind"]
        by[kind] = by.get(kind, 0.0) + seconds

    def _settle(self, done_only: bool = False) -> None:
        while self._events:
            kind, start, end = self._events[0]
            if done_only and not end.query():
                return
            end.synchronize()
            self._add(kind, start.elapsed_time(end) / 1e3)
            self._events.popleft()

    def __getitem__(self, key):
        self._settle()
        return self._d[key]

    def __iter__(self):
        return iter(self._d)

    def __len__(self) -> int:
        return len(self._d)

    def reset(self) -> None:
        self._d = {"calls": 0, "seconds": 0.0, "bytes": 0, "by_kind": {}}
        self._events = deque()          # (kind, start, end) not yet read


#: the process mesh's wire since the last :func:`reset_wire` (a read-only
#: mapping; ``dict(WIRE)`` is a snapshot)
WIRE = _Wire()

#: events held before the ones the card has passed are read (a long run
#: whose WIRE is never read keeps no more than about this many)
_MAX_EVENTS = 4096


def reset_wire() -> None:
    WIRE.reset()


def _account(kind: str, seconds: float, nbytes: int = 0) -> None:
    WIRE._d["calls"] += 1
    WIRE._d["bytes"] += nbytes
    WIRE._add(kind, seconds)


#: the :data:`WIRE` kind of a process mesh's host control (an agreed
#: decision, a vector gathered whole, a barrier: ``CGMesh.agree`` and its
#: kin).  Not a collective of the shard bodies: never recorded, so no
#: census or ``predicted_cost`` sees it
CONTROL = "control"


@contextlib.contextmanager
def host_control(nbytes: int = 0):
    """Time one host-control exchange of a process mesh into :data:`WIRE`
    under :data:`CONTROL` (``nbytes``: the payload this rank sent)."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        _account(CONTROL, time.perf_counter() - t0, nbytes)


def _on_ranks(mesh) -> bool:
    return mesh is not None and mesh.is_process


class _Staged:
    """One gloo collective: payloads go to the host as raw bytes and come
    back to ``device`` bit for bit; the block's host time goes to
    :data:`WIRE`."""

    def __init__(self, device: torch.device, kind: str):
        self.device, self.kind = device, kind
        self.on_card = device.type == "cuda"

    def __enter__(self):
        if self.on_card:                 # the work the payload waits for
            torch.cuda.current_stream(self.device).synchronize()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        _account(self.kind, time.perf_counter() - self.t0)
        return False

    def out(self, t: torch.Tensor) -> torch.Tensor:
        """A contiguous host copy of ``t`` as bytes (gloo moves host
        tensors; bytes carry every wire dtype unaltered)."""
        h = t.detach().contiguous()
        if self.on_card:
            h = h.to("cpu")
        WIRE._d["bytes"] += h.numel() * h.element_size()
        return h.reshape(-1).view(torch.uint8)

    def empty(self, nbytes: int) -> torch.Tensor:
        """A receive buffer of ``nbytes`` where the wire delivers."""
        return torch.empty(nbytes, dtype=torch.uint8)

    def gather(self, mine: torch.Tensor, size: int, group) -> list:
        """Every group member's ``mine``, in group-rank order."""
        import torch.distributed as dist

        parts = [torch.empty_like(mine) for _ in range(size)]
        dist.all_gather(parts, mine, group=group)
        return parts

    def back(self, b: torch.Tensor, like: torch.Tensor, shape) -> torch.Tensor:
        """Bytes received on the host -> a tensor of ``like``'s dtype,
        ``shape``, on the device."""
        t = b.view(like.dtype).reshape(shape)
        return t.to(self.device, non_blocking=True) if self.on_card else t


def _mark(device: torch.device):
    """A timing event recorded now on ``device``'s current stream."""
    ev = torch.cuda.Event(enable_timing=True)
    ev.record(torch.cuda.current_stream(device))
    return ev


class _OnCard(_Staged):
    """One NCCL collective: payloads stay on the card as raw bytes, and
    the call is queued on its stream with no host sync; its time is two
    CUDA events on that stream, read when :data:`WIRE` is."""

    def __enter__(self):
        self.start = _mark(self.device)
        return self

    def __exit__(self, *exc):
        WIRE._d["calls"] += 1
        WIRE._events.append((self.kind, self.start, _mark(self.device)))
        if len(WIRE._events) > _MAX_EVENTS:
            WIRE._settle(done_only=True)
        return False

    def out(self, t: torch.Tensor) -> torch.Tensor:
        b = t.detach().contiguous().reshape(-1).view(torch.uint8)
        WIRE._d["bytes"] += b.numel()
        return b

    def empty(self, nbytes: int) -> torch.Tensor:
        return torch.empty(nbytes, dtype=torch.uint8, device=self.device)

    def gather(self, mine: torch.Tensor, size: int, group) -> list:
        import torch.distributed as dist

        out = mine.new_empty(size * mine.numel())
        dist.all_gather_into_tensor(out, mine, group=group)
        return list(out.chunk(size))

    def back(self, b: torch.Tensor, like: torch.Tensor, shape) -> torch.Tensor:
        return b.view(like.dtype).reshape(shape)


def _wire(mesh, device: torch.device, kind: str) -> _Staged:
    """The wire of one collective on a process mesh: NCCL's on the card,
    gloo's through the host."""
    return (_OnCard if mesh.backend == "nccl" else _Staged)(device, kind)


def _gather_over(x: torch.Tensor, mesh, group, size: int, dim: int,
                 kind: str = "all-gather") -> torch.Tensor:
    """Every group member's ``x``, concatenated along ``dim`` in group-rank
    order (which is node or core order: groups list ranks ascending)."""
    if size == 1:
        return x
    with _wire(mesh, x.device, kind) as st:
        parts = st.gather(st.out(x), size, group)
        return torch.cat([st.back(p, x, x.shape) for p in parts], dim=dim)


def all_to_all(sent: torch.Tensor, axis: str = "node", *, lead: int = 1,
               core_gathered: bool = False, mesh=None) -> torch.Tensor:
    """Node-axis ``all_to_all`` of a send table ``(*batch, src, core, dst,
    chunk)``: returns ``recv`` ``(*batch, dst, core, src, chunk)`` with
    ``recv[dst, c, src] = sent[src, c, dst]``, a view.  With
    ``core_gathered`` each node's table was first gathered over its cores
    (``hier``), so each shard sends ``(n_core, dst, chunk)``.  On a
    process mesh (``src`` and ``dst`` of extent 1 on either side) an
    ``all_to_all_single`` over the node group: chunk ``dst`` of this rank's
    table goes to node ``dst``, and the chunks arrive stacked by ``src``."""
    if axis != "node":
        raise ValueError(f"all_to_all runs over the node axis, got {axis!r}")
    _note("all-to-all", axis, sent, lead, core_gathered)
    if not _on_ranks(mesh):
        return sent.transpose(lead, lead + 2)
    import torch.distributed as dist

    if mesh.n_node == 1:
        return sent
    table = sent.movedim(lead + 2, 0)           # (dst, *batch, 1, c, chunk)
    with _wire(mesh, sent.device, "all-to-all") as st:
        mine = st.out(table)
        got = torch.empty_like(mine)
        dist.all_to_all_single(got, mine, group=mesh.node_group)
        return st.back(got, sent, table.shape).movedim(0, lead + 2)


def ppermute(chunks: torch.Tensor, axis: str = "node", *, pairs: int,
             lead: int = 1, perm=None, mesh=None) -> torch.Tensor:
    """Node-axis ``ppermute`` at one offset of ``chunks`` ``(*batch, pair,
    core, chunk)``: each pair's chunk as its sender gathered it.  The
    ``take`` gather already laid the chunks out by pair, so the delivery
    returns them as they are; ``pairs`` is the permutation's src != dst
    pair count (the wire the census charges).  On a process mesh
    ``perm`` lists the ``(src, dst)`` node pairs: ``chunks`` holds this
    rank's chunk for its ``dst`` (a pair axis of extent 1, or 0 if it
    sends nothing), it goes to ``(dst, core)`` point to point over the
    node group, and the chunk from this rank's ``src`` is returned (pair
    axis 1, or 0 if nothing arrives)."""
    if axis != "node":
        raise ValueError(f"ppermute runs over the node axis, got {axis!r}")
    _note("collective-permute", axis, chunks, lead, pairs=pairs)
    if not _on_ranks(mesh):
        return chunks
    import torch.distributed as dist

    if perm is None:
        raise ValueError("ppermute on a process mesh needs perm, the "
                         "(src, dst) node pairs")
    to = [t for s, t in perm if s == mesh.node]
    frm = [s for s, t in perm if t == mesh.node]
    if chunks.shape[lead] != len(to):
        raise ValueError(f"ppermute: node {mesh.node} sends to {to} but "
                         f"holds {chunks.shape[lead]} chunk(s)")
    shape = list(chunks.shape)
    shape[lead] = len(frm)
    if not to and not frm:
        return chunks.new_empty(shape)
    with _wire(mesh, chunks.device, "collective-permute") as st:
        ops = []
        if to:
            ops.append(dist.P2POp(dist.isend, st.out(chunks),
                                  mesh.rank_of(to[0], mesh.core),
                                  group=mesh.node_group))
        got = st.empty(math.prod(shape) * chunks.element_size())
        if frm:
            ops.append(dist.P2POp(dist.irecv, got,
                                  mesh.rank_of(frm[0], mesh.core),
                                  group=mesh.node_group))
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        return st.back(got, chunks, shape)


def all_gather(x: torch.Tensor, axis: str = "core", *, lead: int = 0,
               core_gathered: bool = False, mesh=None) -> torch.Tensor:
    """``all_gather`` of every shard's operand along ``axis``: ``x``
    ``(*batch, n_node, n_core, *operand)`` itself, which holds each
    shard's stack (its node's row for ``core``, all of it for ``node``).
    ``core_gathered``: ``x`` was already gathered over the cores, so each
    shard's operand is ``(n_core, *operand)`` (the reference's core- then
    node-axis gather).  On a process mesh the group's shards concatenated
    along the axis: ``(*batch, 1, n_core, ...)`` over ``core``, ``(*batch,
    n_node, ...)`` over ``node``."""
    _check_axis(axis)
    _note("all-gather", axis, x, lead, core_gathered)
    if not _on_ranks(mesh):
        return x
    if axis == "core":
        return _gather_over(x, mesh, mesh.core_group, mesh.n_core, lead + 1)
    return _gather_over(x, mesh, mesh.node_group, mesh.n_node, lead)


def psum(partials: torch.Tensor, axis=AXES, *, mesh=None) -> torch.Tensor:
    """``psum`` over both mesh axes (the only reduction the port issues):
    ``partials`` ``(*batch, n_node, n_core)``, one per shard, summed to
    ``(*batch,)``.  On a process mesh every rank's ``(*batch, 1, 1)``
    partials are gathered over the world into ``(*batch, n_node,
    n_core)`` and summed there as on the virtual mesh."""
    if tuple(axis) != AXES:
        raise ValueError(f"psum reduces over {AXES}, got {axis!r}")
    _note("all-reduce", AXES, partials, partials.dim() - 2)
    if _on_ranks(mesh):
        flat = _gather_over(partials.flatten(-2), mesh, mesh.world,
                            mesh.world_size, -1, "all-reduce")
        partials = flat.unflatten(-1, (mesh.n_node, mesh.n_core))
    return partials.sum(dim=(-2, -1))
