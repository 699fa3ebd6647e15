"""Explicit compute/communication overlap: ring collective-matmul.

The port of ``src/repro/runtime/overlap.py``.  The paper's task-based SpMV
dedicates a thread to drive the halo gather while workers multiply the
diagonal block.  The dense-TP mirror of that idea is the *collective
matmul*: computing ``y = x @ W`` where the contraction dim is sharded over
the ``model`` axis normally requires an all-gather of ``x`` (the "halo")
before the matmul.  The ring form instead multiplies the locally-resident
chunk while the next chunk moves — n-1 hops, each hidden behind a chunk
matmul; no serialised all-gather ("diagonal-block compute while the halo
is in flight").

On the port's process mesh (``launch.mesh.LMMesh``) a hop is one
``batch_isend_irecv`` over the ``model`` group: the ``x`` chunk and its
``W`` rows go to the next rank of the ring and the previous rank's arrive.
The hop is issued before the chunk's product and waited on after it, so
the product hides it; its time goes to ``core.collectives.WIRE`` under
``collective-permute`` (issue to arrival, and the exposed part after the
product).  Each rank accumulates in its own ring order (its chunk first,
then its predecessors'), as each shard does in the reference, so the
ranks' ``y`` may differ in the last bits.  The chunk products and the sum
run in float32 whatever the storage dtype (the same arithmetic as the
reference's for float32 chunks).

``ring_linear_rs`` is the reverse (reduce-scatter) form for row-parallel
layers: the shard's partial product is already its own output columns.
"""
from __future__ import annotations

import torch

from repro_torch.core.collectives import _wire
from repro_torch.runtime.sharding import NamedSharding, P

__all__ = ["ring_linear_ag", "ring_linear_rs", "make_ring_linear"]


def _product(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    return torch.matmul(x.to(torch.float32), w.to(torch.float32))


def _peer(mesh, axis: str, step: int) -> int:
    """The global rank ``step`` places along ``axis`` from this one."""
    c = dict(mesh.coords)
    c[axis] = (c[axis] + step) % mesh.shape[axis]
    r = 0
    for a in mesh.axis_names:
        r = r * mesh.shape[a] + c[a]
    return r


def _hop(mesh, axis: str, x: torch.Tensor, w: torch.Tensor):
    """Issue one ring hop: ``(x, w)`` to the next rank, the previous
    rank's pair received.  Returns the handle (``wait()`` -> the pair)."""
    import torch.distributed as dist

    group = mesh.group((axis,))
    st = _wire(mesh, x.device, "collective-permute")
    send = [st.put(t) for t in (x, w)]
    got = [torch.empty_like(t) for t in send]
    nxt, prv = _peer(mesh, axis, 1), _peer(mesh, axis, -1)
    ops = [dist.P2POp(dist.isend, t, nxt, group=group) for t in send] + \
        [dist.P2POp(dist.irecv, t, prv, group=group) for t in got]
    return st.pending(dist.batch_isend_irecv(ops), lambda: [
        st.back(t, t, t.shape) for t in got], send)


def ring_linear_ag(x_shard: torch.Tensor, w_shard: torch.Tensor, mesh,
                   axis: str = "model") -> torch.Tensor:
    """y = x @ W with x feature-sharded and W row-sharded over ``axis``.

    x_shard: (..., K/n);  w_shard: (K/n, N)  ->  y: (..., N) float32 (the
    whole product on every shard; each shard accumulates all K chunks).
    At ring step s, the shard multiplies the chunk that arrived at step
    s-1 while forwarding it — compute hides the hop."""
    n = mesh.shape[axis]
    x_c, w_c = x_shard.contiguous(), w_shard.contiguous()
    acc = None
    for s in range(n):
        hop = _hop(mesh, axis, x_c, w_c) if s < n - 1 else None
        part = _product(x_c, w_c)
        acc = part if acc is None else acc + part
        if hop is not None:
            x_c, w_c = hop.wait()
    return acc


def ring_linear_rs(x_full: torch.Tensor, w_shard: torch.Tensor
                   ) -> torch.Tensor:
    """Row-parallel y = x @ W with W column-sharded: the shard's own
    output columns (the reduce-scatter overlap form).

    x_full: (..., K) replicated; w_shard: (K, N/n) -> y_shard: (..., N/n).
    """
    return _product(x_full, w_shard)


def make_ring_linear(mesh, axis: str = "model"):
    """``fn(x, w)`` -> ``x @ w`` by the ring over ``axis``, ``x`` and ``w``
    whole on every rank: each rank takes its feature chunk of ``x`` and
    the matching rows of ``w`` (the reference's ``shard_map`` in_specs)."""
    def fn(x, w):
        xs = NamedSharding(mesh, P(*(None,) * (x.ndim - 1), axis)).shard(x)
        ws = NamedSharding(mesh, P(axis, None)).shard(w)
        return ring_linear_ag(xs, ws, mesh, axis)

    return fn
