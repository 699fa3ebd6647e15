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

**Issue now, wait later.**  ``all_to_all``, ``ppermute`` and
``all_gather`` each have a form that issues the call and returns a
:class:`Pending` handle (``all_to_all_start``, ``ppermute_start``,
``all_gather_start``); ``handle.wait()`` returns what the synchronous call
returns, and the synchronous call is ``start(...).wait()``.  On NCCL the
call is issued with ``async_op`` (P2P as one ``batch_isend_irecv``) and
the wait makes the card's stream wait on the process group's, with no
host sync; on gloo the payload is staged to the host and the call issued
async at ``start``, and the wait blocks the host, then copies the result
back to the card.  The handle keeps its send and receive buffers until
the wait.  On the virtual mesh there is nothing to wait for: the handle
holds the view the call returns.  The census records at issue.  Every
handle is waited exactly once; :func:`open_handles` and
:func:`check_waited` let a shard body raise on one it left behind.
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
           "reset_wire", "CONTROL", "host_control", "Pending",
           "all_to_all_start", "ppermute_start", "all_gather_start",
           "open_handles", "check_waited", "wire_seconds", "note_group"]

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
    pairs.  An LM mesh's collective (:func:`note_group`) also carries
    its ``group``'s size."""

    kind: str
    axis: tuple[str, ...]
    shape: tuple[int, ...]
    dtype: torch.dtype
    nrhs: int = 1
    pairs: int | None = None
    group: int | None = None

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


def note_group(kind: str, axes, x: torch.Tensor, size: int) -> None:
    """Record one collective of an LM mesh (``launch.mesh.LMMesh``) for
    the open :func:`record_collectives` blocks: ``kind``, the mesh
    ``axes`` of its group, ``x`` the operand this rank hands it (its
    block for an all-gather, the whole input for a reduce-scatter) and
    the group's ``size``."""
    if not _RECORDERS:
        return
    rec = Collective(kind, tuple(axes), tuple(x.shape), x.dtype,
                     group=int(size))
    for log in _RECORDERS:
        log.append(rec)


def _check_axis(axis: str) -> None:
    if axis not in AXES:
        raise ValueError(f"mesh axis must be one of {AXES}, got {axis!r}")


#: handles issued and not yet waited, in issue order
_OPEN: list["Pending"] = []


class Pending:
    """A collective issued and not yet waited for: ``wait()`` returns the
    synchronous call's result, once (``kind``: its
    :data:`COLLECTIVE_OPS` kind).  ``keep`` (the send buffers) stays
    referenced until the wait: the wire may still be reading it."""

    __slots__ = ("kind", "_done", "_keep")

    def __init__(self, kind: str, done, keep=()):
        self.kind, self._done, self._keep = kind, done, keep
        _OPEN.append(self)

    def wait(self) -> torch.Tensor:
        done, self._done = self._done, None
        if done is None:
            raise RuntimeError(f"{self.kind}: a pending collective waited "
                               "twice")
        _OPEN.remove(self)
        out = done()
        self._keep = ()
        return out


def _ready(kind: str, value: torch.Tensor) -> Pending:
    """A handle with nothing to wait for (the virtual mesh, an empty
    group)."""
    return Pending(kind, lambda: value)


def open_handles() -> int:
    """How many handles are issued and not yet waited."""
    return len(_OPEN)


def check_waited(since: int, what: str) -> None:
    """Raise if handles issued after ``open_handles()`` read ``since`` are
    still open (each is dropped: the raise ends the run)."""
    left = _OPEN[since:]
    if left:
        del _OPEN[since:]
        raise RuntimeError(f"{what}: {len(left)} collective(s) issued and "
                           f"never waited ({', '.join(p.kind for p in left)})")


# ---------------------------------------------------------------------- #
# the process mesh's wire: torch.distributed calls, host-staged on gloo
# ---------------------------------------------------------------------- #
class _Wire(Mapping):
    """The process mesh's collectives since the last :func:`reset_wire`:
    ``calls``, ``seconds`` spent in them, payload ``bytes`` sent by this
    rank, ``by_kind``, the seconds by :data:`COLLECTIVE_OPS` kind (host
    control under :data:`CONTROL`), and ``exposed`` / ``exposed_by_kind``:
    the part of those seconds nothing else hid.

    A call's seconds run from its issue to its result's arrival; its
    exposed seconds from the end of the local work issued between its
    issue and its wait to the arrival — all of it for a synchronous call
    (``start(...).wait()``: nothing in between), 0 when the work in
    between outlasted the wire.  gloo's are the host clock: from issue
    (staging to the host included, after the card has finished the work
    before it) to the result back on the card, and around the wait.
    NCCL's are CUDA events on the card's stream: at issue, at the wait
    (after the work in between) and after it; they are read when this is
    read (which waits for them), so timing never serialises the loop.
    ``exposed <= seconds`` call by call."""

    def __init__(self):
        self.reset()

    def _add(self, kind: str, seconds: float, exposed: float) -> None:
        self._d["seconds"] += seconds
        self._d["exposed"] += exposed
        for key, v in (("by_kind", seconds), ("exposed_by_kind", exposed)):
            by = self._d[key]
            by[kind] = by.get(kind, 0.0) + v

    def _settle(self, done_only: bool = False) -> None:
        while self._events:
            kind, start, mid, end = self._events[0]
            if done_only and not end.query():
                return
            end.synchronize()
            self._add(kind, start.elapsed_time(end) / 1e3,
                      mid.elapsed_time(end) / 1e3)
            self._events.popleft()

    def __getitem__(self, key):
        self._settle()
        return self._d[key]

    def __iter__(self):
        return iter(self._d)

    def __len__(self) -> int:
        return len(self._d)

    def reset(self) -> None:
        self._d = {"calls": 0, "seconds": 0.0, "bytes": 0, "by_kind": {},
                   "exposed": 0.0, "exposed_by_kind": {}}
        self._events = deque()      # (kind, start, mid, end) not yet read


#: the process mesh's wire since the last :func:`reset_wire` (a read-only
#: mapping; ``dict(WIRE)`` is a snapshot)
WIRE = _Wire()

#: events held before the ones the card has passed are read (a long run
#: whose WIRE is never read keeps no more than about this many)
_MAX_EVENTS = 4096


def reset_wire() -> None:
    WIRE.reset()


def wire_seconds(snapshot=None) -> tuple[float, float]:
    """``(seconds, exposed seconds)`` of the collectives in a :data:`WIRE`
    snapshot (default: :data:`WIRE` now), host control left out."""
    w = WIRE if snapshot is None else snapshot
    return (sum(v for k, v in w["by_kind"].items() if k != CONTROL),
            sum(v for k, v in w["exposed_by_kind"].items() if k != CONTROL))


def _account(kind: str, seconds: float, nbytes: int = 0,
             exposed: float | None = None) -> None:
    WIRE._d["calls"] += 1
    WIRE._d["bytes"] += nbytes
    WIRE._add(kind, seconds, seconds if exposed is None else exposed)


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
    """One gloo collective, from its issue (made when this is built) to
    :meth:`pending`'s wait: payloads go to the host as raw bytes and come
    back to ``device`` bit for bit; the host's time goes to :data:`WIRE`."""

    def __init__(self, device: torch.device, kind: str):
        self.device, self.kind = device, kind
        self.on_card = device.type == "cuda"
        if self.on_card:                 # the work the payload waits for
            torch.cuda.current_stream(self.device).synchronize()
        self.t0 = time.perf_counter()

    def pending(self, works: list, finish, keep=()) -> Pending:
        """The handle of the call ``works`` issued (``keep``: its send
        buffers): its wait blocks the host on them, then ``finish()`` (the
        copy back) gives the result."""
        def done():
            t_wait = time.perf_counter()
            for w in works:
                w.wait()
            out = finish()
            t1 = time.perf_counter()
            _account(self.kind, t1 - self.t0, exposed=t1 - t_wait)
            return out
        return Pending(self.kind, done, keep)

    def put(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` contiguous where the wire reads it, its dtype kept: a host
        copy (gloo moves host tensors), counted as sent."""
        h = t.detach().contiguous()
        if self.on_card:
            h = h.to("cpu")
        WIRE._d["bytes"] += h.numel() * h.element_size()
        return h

    def out(self, t: torch.Tensor) -> torch.Tensor:
        """:meth:`put` as bytes (bytes carry every wire dtype
        unaltered)."""
        return self.put(t).reshape(-1).view(torch.uint8)

    def empty(self, nbytes: int) -> torch.Tensor:
        """A receive buffer of ``nbytes`` where the wire delivers."""
        return torch.empty(nbytes, dtype=torch.uint8)

    def gather(self, mine: torch.Tensor, size: int, group):
        """Issue the gather of every group member's ``mine``: ``(works,
        parts)``, the parts in group-rank order once the works are done."""
        import torch.distributed as dist

        parts = [torch.empty_like(mine) for _ in range(size)]
        return [dist.all_gather(parts, mine, group=group,
                                async_op=True)], parts

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
    the call is queued on its process group's stream with no host sync;
    the wait makes the card's stream wait on it.  Its times are CUDA
    events on the card's stream (at issue, at the wait, after it), read
    when :data:`WIRE` is."""

    def __init__(self, device: torch.device, kind: str):
        self.device, self.kind = device, kind
        self.on_card = True
        self.start = _mark(device)

    def pending(self, works: list, finish, keep=()) -> Pending:
        def done():
            mid = _mark(self.device)
            for w in works:
                w.wait()
            out = finish()
            WIRE._d["calls"] += 1
            WIRE._events.append((self.kind, self.start, mid,
                                 _mark(self.device)))
            if len(WIRE._events) > _MAX_EVENTS:
                WIRE._settle(done_only=True)
            return out
        return Pending(self.kind, done, keep)

    def put(self, t: torch.Tensor) -> torch.Tensor:
        h = t.detach().contiguous()
        WIRE._d["bytes"] += h.numel() * h.element_size()
        return h

    def empty(self, nbytes: int) -> torch.Tensor:
        return torch.empty(nbytes, dtype=torch.uint8, device=self.device)

    def gather(self, mine: torch.Tensor, size: int, group):
        import torch.distributed as dist

        out = mine.new_empty(size * mine.numel())
        work = dist.all_gather_into_tensor(out, mine, group=group,
                                           async_op=True)
        return [work], list(out.chunk(size))

    def back(self, b: torch.Tensor, like: torch.Tensor, shape) -> torch.Tensor:
        return b.view(like.dtype).reshape(shape)


class _Fake(_OnCard):
    """One collective of a fake process group (``backend="fake"``: the
    dry-run's ranks, ``launch.dryrun``): the payloads are fake tensors
    that stay where they are, nothing moves and nothing is timed; the
    call and its bytes are counted."""

    def __init__(self, device: torch.device, kind: str):
        self.device, self.kind = device, kind
        self.on_card = True

    def pending(self, works: list, finish, keep=()) -> Pending:
        def done():
            for w in works:
                w.wait()
            WIRE._d["calls"] += 1
            return finish()
        return Pending(self.kind, done, keep)


def _wire(mesh, device: torch.device, kind: str) -> _Staged:
    """The wire of one collective on a process mesh: NCCL's on the card,
    gloo's through the host, a fake group's nowhere."""
    return {"nccl": _OnCard, "fake": _Fake}.get(mesh.backend,
                                                _Staged)(device, kind)


def _gather_start(x: torch.Tensor, mesh, group, size: int, dim: int,
                  kind: str = "all-gather") -> Pending:
    """Issue the gather of every group member's ``x``, concatenated along
    ``dim`` in group-rank order (which is node or core order: groups list
    ranks ascending)."""
    if size == 1:
        return _ready(kind, x)
    st = _wire(mesh, x.device, kind)
    mine = st.out(x)
    works, parts = st.gather(mine, size, group)
    return st.pending(works, lambda: torch.cat(
        [st.back(p, x, x.shape) for p in parts], dim=dim), (mine,))


def all_to_all(sent: torch.Tensor, axis: str = "node", *, lead: int = 1,
               core_gathered: bool = False, mesh=None) -> torch.Tensor:
    """:func:`all_to_all_start`, waited."""
    return all_to_all_start(sent, axis, lead=lead,
                            core_gathered=core_gathered, mesh=mesh).wait()


def all_to_all_start(sent: torch.Tensor, axis: str = "node", *,
                     lead: int = 1, core_gathered: bool = False,
                     mesh=None) -> Pending:
    """Issue the node-axis ``all_to_all`` of a send table (the handle's
    ``wait()`` returns the result) ``(*batch, src, core, dst,
    chunk)``: returns ``recv`` ``(*batch, dst, core, src, chunk)`` with
    ``recv[dst, c, src] = sent[src, c, dst]``, a view.  With
    ``core_gathered`` each node's table was first gathered over its cores
    (``hier``), so each shard sends ``(n_core, dst, chunk)``.  On a
    process mesh (``src`` and ``dst`` of extent 1 on either side) an
    ``all_to_all_single`` over the node group: chunk ``dst`` of this rank's
    table goes to node ``dst``, and the chunks arrive stacked by ``src``."""
    kind = "all-to-all"
    if axis != "node":
        raise ValueError(f"all_to_all runs over the node axis, got {axis!r}")
    _note(kind, axis, sent, lead, core_gathered)
    if not _on_ranks(mesh):
        return _ready(kind, sent.transpose(lead, lead + 2))
    import torch.distributed as dist

    if mesh.n_node == 1:
        return _ready(kind, sent)
    table = sent.movedim(lead + 2, 0)           # (dst, *batch, 1, c, chunk)
    st = _wire(mesh, sent.device, kind)
    mine = st.out(table)
    got = torch.empty_like(mine)
    work = dist.all_to_all_single(got, mine, group=mesh.node_group,
                                  async_op=True)
    return st.pending([work], lambda: st.back(got, sent, table.shape)
                      .movedim(0, lead + 2), (mine,))


def ppermute(chunks: torch.Tensor, axis: str = "node", *, pairs: int,
             lead: int = 1, perm=None, mesh=None) -> torch.Tensor:
    """:func:`ppermute_start`, waited."""
    return ppermute_start(chunks, axis, pairs=pairs, lead=lead, perm=perm,
                          mesh=mesh).wait()


def ppermute_start(chunks: torch.Tensor, axis: str = "node", *, pairs: int,
                   lead: int = 1, perm=None, mesh=None) -> Pending:
    """Issue the node-axis ``ppermute`` (the handle's ``wait()`` returns
    the result) at one offset of ``chunks`` ``(*batch, pair,
    core, chunk)``: each pair's chunk as its sender gathered it.  The
    ``take`` gather already laid the chunks out by pair, so the delivery
    returns them as they are; ``pairs`` is the permutation's src != dst
    pair count (the wire the census charges).  On a process mesh
    ``perm`` lists the ``(src, dst)`` node pairs: ``chunks`` holds this
    rank's chunk for its ``dst`` (a pair axis of extent 1, or 0 if it
    sends nothing), it goes to ``(dst, core)`` point to point over the
    node group, and the chunk from this rank's ``src`` is returned (pair
    axis 1, or 0 if nothing arrives)."""
    kind = "collective-permute"
    if axis != "node":
        raise ValueError(f"ppermute runs over the node axis, got {axis!r}")
    _note(kind, axis, chunks, lead, pairs=pairs)
    if not _on_ranks(mesh):
        return _ready(kind, chunks)
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
        return _ready(kind, chunks.new_empty(shape))
    st = _wire(mesh, chunks.device, kind)
    ops, mine = [], st.out(chunks) if to else None
    if to:
        ops.append(dist.P2POp(dist.isend, mine,
                              mesh.rank_of(to[0], mesh.core),
                              group=mesh.node_group))
    got = st.empty(math.prod(shape) * chunks.element_size())
    if frm:
        ops.append(dist.P2POp(dist.irecv, got,
                              mesh.rank_of(frm[0], mesh.core),
                              group=mesh.node_group))
    return st.pending(dist.batch_isend_irecv(ops),
                      lambda: st.back(got, chunks, shape), (mine,))


def all_gather(x: torch.Tensor, axis: str = "core", *, lead: int = 0,
               core_gathered: bool = False, mesh=None) -> torch.Tensor:
    """:func:`all_gather_start`, waited."""
    return all_gather_start(x, axis, lead=lead, core_gathered=core_gathered,
                            mesh=mesh).wait()


def all_gather_start(x: torch.Tensor, axis: str = "core", *, lead: int = 0,
                     core_gathered: bool = False, mesh=None) -> Pending:
    """Issue the ``all_gather`` (the handle's ``wait()`` returns the
    result) of every shard's operand along ``axis``: ``x``
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
        return _ready("all-gather", x)
    if axis == "core":
        return _gather_start(x, mesh, mesh.core_group, mesh.n_core,
                             lead + 1)
    return _gather_start(x, mesh, mesh.node_group, mesh.n_node, lead)


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
        flat = _gather_start(partials.flatten(-2), mesh, mesh.world,
                             mesh.world_size, -1, "all-reduce").wait()
        partials = flat.unflatten(-1, (mesh.n_node, mesh.n_core))
    return partials.sum(dim=(-2, -1))
