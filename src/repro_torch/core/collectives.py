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

These are the seam where real process groups (``torch.distributed``) will
replace the virtual mesh's index operations.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math

import torch

__all__ = ["COLLECTIVE_OPS", "SOLVER_REDUCTION_OPS", "TRANSPORT_OPS",
           "census_split", "Collective", "record_collectives", "census",
           "all_to_all", "ppermute", "all_gather", "psum"]

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


def all_to_all(sent: torch.Tensor, axis: str = "node", *, lead: int = 1,
               core_gathered: bool = False) -> torch.Tensor:
    """Node-axis ``all_to_all`` of a send table ``(*batch, src, core, dst,
    chunk)``: returns ``recv`` ``(*batch, dst, core, src, chunk)`` with
    ``recv[dst, c, src] = sent[src, c, dst]``, a view.  With
    ``core_gathered`` each node's table was first gathered over its cores
    (``hier``), so each shard sends ``(n_core, dst, chunk)``."""
    if axis != "node":
        raise ValueError(f"all_to_all runs over the node axis, got {axis!r}")
    _note("all-to-all", axis, sent, lead, core_gathered)
    return sent.transpose(lead, lead + 2)


def ppermute(chunks: torch.Tensor, axis: str = "node", *, pairs: int,
             lead: int = 1) -> torch.Tensor:
    """Node-axis ``ppermute`` at one offset of ``chunks`` ``(*batch, pair,
    core, chunk)``: each pair's chunk as its sender gathered it.  The
    ``take`` gather already laid the chunks out by pair, so the delivery
    returns them as they are; ``pairs`` is the permutation's src != dst
    pair count (the wire the census charges)."""
    if axis != "node":
        raise ValueError(f"ppermute runs over the node axis, got {axis!r}")
    _note("collective-permute", axis, chunks, lead, pairs=pairs)
    return chunks


def all_gather(x: torch.Tensor, axis: str = "core", *, lead: int = 0,
               core_gathered: bool = False) -> torch.Tensor:
    """``all_gather`` of every shard's operand along ``axis``: ``x``
    ``(*batch, n_node, n_core, *operand)`` itself, which holds each
    shard's stack (its node's row for ``core``, all of it for ``node``).
    ``core_gathered``: ``x`` was already gathered over the cores, so each
    shard's operand is ``(n_core, *operand)`` (the reference's core- then
    node-axis gather)."""
    _check_axis(axis)
    _note("all-gather", axis, x, lead, core_gathered)
    return x


def psum(partials: torch.Tensor, axis=AXES) -> torch.Tensor:
    """``psum`` over both mesh axes (the only reduction the port issues):
    ``partials`` ``(*batch, n_node, n_core)``, one per shard, summed to
    ``(*batch,)``."""
    if tuple(axis) != AXES:
        raise ValueError(f"psum reduces over {AXES}, got {axis!r}")
    _note("all-reduce", AXES, partials, partials.dim() - 2)
    return partials.sum(dim=(-2, -1))
