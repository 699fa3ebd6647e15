"""Parameters and optimizer state stored sharded over an LM mesh.

``runtime.sharding``'s rules say how every leaf is split over the
``data x model (x pod)`` mesh (``launch.mesh.LMMesh``); this module holds
a model that way on the mesh's ranks, with the simplest placement of the
collectives that GSPMD inserts for the reference:

* **Storage.**  :func:`init_sharded` keeps, on each rank, only its block
  of every parameter (``NamedSharding.shard``).  ``init_params`` draws the
  leaves from the shared seed one after another, and each is cut to the
  rank's block and freed before the next is drawn, so the numbers are the
  one-device model's and a rank never holds the whole model; AdamW's
  moments are made beside the blocks, so they are sharded the same way.
  A checkpoint is read the same way, leaf by leaf (:func:`cutters`).
* **Use.**  A split parameter is gathered whole where the model reads it:
  a ``torch.nn.utils.parametrize`` parametrization all-gathers it, dim by
  dim, over the groups of its spec's axes, each time the model code reads
  the attribute.  Under ``_remat`` that read is inside the recomputed
  block, so a block's whole weights live only while the block runs.  The
  all-gather is an autograd function whose backward is the
  reduce-scatter of the whole gradient onto the block (the ZeRO-3 plan the
  reference's ``dp`` docstring describes).  Activations stay on the rank's
  rows of the batch; every rank computes the whole model on them (no
  tensor-parallel compute along ``model``).
* **Gradient.**  Each rank's loss is the mean over its rows; the mesh's
  loss is the mean of the ranks' (equal rows).  After the backward,
  :func:`sync_grads` sums each block's gradient over the axes its leaf is
  replicated on (the reduce-scatter summed over the spec's axes) and
  divides by the rank count: every rank then holds its block of the
  one-device gradient, and replicas of a block hold it bit for bit alike
  (one all-reduce gives them one result).
* **Norm.**  :func:`global_norm` sums the squares of the blocks over the
  mesh, each element once (a block replicated over an axis counts on the
  replica at index 0 of that axis only).

A mesh of one rank leaves every parameter whole and every collective out:
the one-device trainer's arithmetic, bit for bit.  The collectives go over
the process mesh's wire (``core.collectives``: NCCL on the card, gloo
through the host) and are timed into its ``WIRE`` by kind
(``all-gather``, ``reduce-scatter``, ``all-reduce``).
"""
from __future__ import annotations

import dataclasses
import math
import warnings

import numpy as np
import torch
from torch import nn
from torch.nn.utils import parametrize

from repro_torch.core.collectives import _gather_start, _wire, note_group
from repro_torch.runtime.sharding import (NamedSharding, named,
                                          param_pspecs)

__all__ = ["ShardState", "init_sharded", "model_params", "gather",
           "group_axes",
           "all_gather_dim", "all_reduce", "sync_grads", "global_norm",
           "full_tensor", "mean_over_mesh", "cutters", "CacheBlocks",
           "init_cache_sharded"]

#: gradients smaller than this (elements) are all-reduced flattened
#: together, one call per replica group
_BUCKET = 1 << 22


def group_axes(mesh, group) -> tuple:
    """The mesh axes whose process group ``group`` is (``()`` for
    none)."""
    for axes, g in mesh.groups.items():
        if g is group:
            return axes
    return ()


def all_gather_dim(x: torch.Tensor, mesh, group, n: int,
                   dim: int) -> torch.Tensor:
    """The group's blocks of ``x`` concatenated along ``dim`` in
    group-rank order."""
    note_group("all-gather", group_axes(mesh, group), x, n)
    return _gather_start(x.detach(), mesh, group, n, dim).wait()


def _reduce_scatter_dim(g: torch.Tensor, mesh, group, n: int,
                        dim: int) -> torch.Tensor:
    """The sum over the group of ``g``'s ``n`` blocks along ``dim``: this
    rank's block."""
    import torch.distributed as dist

    note_group("reduce-scatter", group_axes(mesh, group), g, n)
    st = _wire(mesh, g.device, "reduce-scatter")
    parts = st.put(torch.stack(g.chunk(n, dim)))
    out = parts.new_empty(parts.shape[1:])
    with warnings.catch_warnings():     # newer PyTorch renames it
        warnings.simplefilter("ignore", FutureWarning)
        work = dist.reduce_scatter_tensor(out.view(-1), parts.view(-1),
                                          group=group, async_op=True)
    return st.pending([work], lambda: st.back(out, g, out.shape),
                      (parts,)).wait()


class _GatherDim(torch.autograd.Function):
    """All-gather along one dim; its backward reduce-scatters."""

    @staticmethod
    def forward(ctx, x, mesh, group, n, dim):
        ctx.args = (mesh, group, n, dim)
        return all_gather_dim(x, mesh, group, n, dim)

    @staticmethod
    def backward(ctx, g):
        return (_reduce_scatter_dim(g, *ctx.args), None, None, None, None)


def gather(block: torch.Tensor, placement: NamedSharding) -> torch.Tensor:
    """The whole tensor from every rank's ``block`` (differentiable)."""
    mesh, out = placement.mesh, block
    for dim, axes in reversed(placement.splits):
        group = mesh.group(axes)
        if group is not None:
            out = _GatherDim.apply(out, mesh, group, placement.parts(axes),
                                   dim)
    return out


def full_tensor(block: torch.Tensor, placement: NamedSharding):
    """:func:`gather` without a graph (a checkpoint's leaf)."""
    with torch.no_grad():
        return gather(block.detach(), placement)


class _Gathered(nn.Module):
    """The parametrization: the parameter's block -> the whole leaf."""

    def __init__(self, placement: NamedSharding):
        super().__init__()
        self.placement = placement

    def forward(self, block):
        return gather(block, self.placement)


@dataclasses.dataclass(eq=False)
class ShardState:
    """What :func:`init_sharded` leaves on the model (``model.sharding``):
    the mesh, each parameter's placement and whole shape, and the blocks
    under the port's parameter names, in ``named_parameters``' order of
    the whole model."""

    mesh: object
    placements: dict
    shapes: dict
    params: dict


def init_sharded(cfg, generator: torch.Generator | None, mesh, device=None,
                 trainable: bool = True, serving: bool = False) -> nn.Module:
    """``init_params(cfg, generator, ...)`` holding only this rank's block
    of every parameter, as ``param_pspecs(cfg, mesh, ..., serving=)``
    says: each leaf is cut to its block as soon as it is drawn (with
    ``serving``, and cast to bf16, the reference's serving weights), and
    each split one is gathered where it is read.  Without a ``generator`` the blocks are
    left empty (the dry-run's fake ranks).  ``model.sharding`` is its
    :class:`ShardState`."""
    from repro_torch.models.common import on_new_param
    from repro_torch.models.model import init_params

    made: list = []                     # the leaves in the order drawn
    with on_new_param(lambda p: made.append(p) or p):
        skeleton = init_params(cfg, None, device="meta")
    whole = dict(skeleton.named_parameters())
    name_of = {id(p): k for k, p in whole.items()}
    order = iter([name_of[id(p)] for p in made])
    placements = named(mesh, param_pspecs(cfg, mesh, whole,
                                          serving=serving))
    dtype = torch.bfloat16 if serving else None
    shapes = {k: tuple(p.shape) for k, p in whole.items()}
    del skeleton, whole, made

    def keep_block(p):
        pl = placements[next(order)]
        if not pl.splits or mesh.size == 1:
            return p if dtype in (None, p.dtype) else nn.Parameter(
                p.detach().to(dtype), requires_grad=False)
        return nn.Parameter(pl.shard(p.detach()).to(dtype or p.dtype)
                            .clone(), requires_grad=False)
    with on_new_param(keep_block):
        model = init_params(cfg, generator, device=device,
                            trainable=trainable)
    params = dict(model.named_parameters())
    for name, block in params.items():
        pl = placements[name]
        if pl.splits and mesh.size > 1:
            prefix, _, attr = name.rpartition(".")
            parametrize.register_parametrization(
                model.get_submodule(prefix), attr, _Gathered(pl),
                unsafe=True)
    model.sharding = ShardState(mesh, placements, shapes, params)
    return model


class CacheBlocks(dict):
    """A serving cache held as blocks on a mesh: ``init_cache``'s tree of
    this rank's blocks, with ``placements`` (the same tree of
    ``NamedSharding``, ``cache_pspecs``).  ``models.model.prefill`` /
    ``decode_step`` read the placements: an attention KV leaf is the
    rank's slice of the sequence, a recurrent state is gathered where it
    is read."""

    placements: dict


def init_cache_sharded(cfg, batch: int, max_len: int, mesh,
                       kv_dtype=torch.bfloat16, device=None) -> CacheBlocks:
    """``init_cache(cfg, batch, max_len, kv_dtype)`` held as this rank's
    blocks (zeros), placed by ``cache_pspecs``; no whole leaf is
    allocated."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.models.model import init_cache
    from repro_torch.runtime.sharding import cache_pspecs

    whole = init_cache(cfg, batch, max_len, kv_dtype, device="meta")
    shape = ShapeConfig("serve", max_len, batch, "decode")
    placements = named(mesh, cache_pspecs(cfg, shape, mesh, whole))

    def blocks(tree, pl):
        return {k: blocks(v, pl[k]) if isinstance(v, dict) else
                torch.zeros(pl[k].shard_shape(v.shape), dtype=v.dtype,
                            device=device) for k, v in tree.items()}

    out = CacheBlocks(blocks(whole, placements))
    out.placements = placements
    return out


def model_params(model: nn.Module) -> dict:
    """The model's parameters by the port's names: its blocks on a mesh,
    ``named_parameters()`` otherwise."""
    st = getattr(model, "sharding", None)
    return dict(st.params) if st is not None else dict(
        model.named_parameters())


def all_reduce(t: torch.Tensor, mesh, group) -> torch.Tensor:
    """``t`` summed over ``group`` in place (``None``: as it is)."""
    import torch.distributed as dist

    if group is None:
        return t
    axes = group_axes(mesh, group)
    note_group("all-reduce", axes, t,
               math.prod(mesh.shape[a] for a in axes))
    st = _wire(mesh, t.device, "all-reduce")
    buf = st.put(t)
    work = dist.all_reduce(buf, group=group, async_op=True)
    got = st.pending([work], lambda: st.back(buf, t, t.shape),
                     (buf,)).wait()
    # the result is ``t``'s own memory unless the wire staged a copy
    if (got.untyped_storage()._cdata, got.storage_offset()) != \
            (t.untyped_storage()._cdata, t.storage_offset()):
        t.copy_(got)
    return t


def mean_over_mesh(x: torch.Tensor, mesh) -> torch.Tensor:
    """The mean of a 0-d tensor over every rank (each rank's value once)."""
    if mesh.size == 1:
        return x
    t = x.detach().clone()
    return all_reduce(t, mesh, mesh.world) / mesh.size


@torch.no_grad()
def sync_grads(st: ShardState, grads: dict) -> None:
    """Every block's gradient summed over the axes its leaf is replicated
    on, then divided by the rank count (in place): the one-device
    gradient's block on every rank."""
    mesh = st.mesh
    if mesh.size == 1:
        return
    buckets: dict = {}
    for name, g in grads.items():
        group = mesh.group(st.placements[name].replicated)
        if group is None:
            continue
        if g.numel() >= _BUCKET:
            all_reduce(g, mesh, group)
        else:
            buckets.setdefault(st.placements[name].replicated, []).append(g)
    for axes, gs in buckets.items():
        flat = torch.cat([g.reshape(-1) for g in gs])
        all_reduce(flat, mesh, mesh.group(axes))
        i = 0
        for g in gs:
            g.copy_(flat[i:i + g.numel()].view_as(g))
            i += g.numel()
    for g in grads.values():
        g.div_(mesh.size)


def global_norm(st: ShardState, tree: dict) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf whose blocks ``tree``
    holds, each element counted once over the mesh; on one rank
    ``optim.global_norm``'s arithmetic."""
    mesh = st.mesh
    coords = mesh.coords
    total = None
    for name, x in tree.items():
        if any(coords[a] for a in st.placements[name].replicated):
            continue            # another replica counts this block
        sq = torch.sum(torch.square(x.to(torch.float32)))
        total = sq if total is None else total + sq
    if total is None:
        total = torch.zeros((), dtype=torch.float32,
                            device=next(iter(tree.values())).device)
    if mesh.size > 1:
        all_reduce(total, mesh, mesh.world)
    return torch.sqrt(total)


def cutters(st: ShardState) -> dict:
    """In the reference's layout (``models.model.to_reference``'s tree),
    each leaf's function from the whole array to this rank's block (a
    stacked leaf: its layers' blocks, restacked): a checkpoint is read
    one leaf at a time through them."""
    from repro_torch.models.model import _nest

    def block(pl):
        return lambda a: np.ascontiguousarray(pl.shard(np.asarray(a)))

    def stack(fns):
        return lambda a: np.stack([f(a[i]) for i, f in enumerate(fns)])
    return _nest(st.placements, block, stack)
