"""Sharding rules: map every parameter / batch / cache leaf to a
PartitionSpec for the production mesh.

The port of ``src/repro/runtime/sharding.py``.  Strategy (the hybrid
hierarchy from the paper, transposed to LM training):

* ``model`` axis — tensor parallelism: column-parallel in-projections,
  row-parallel out-projections, vocab-parallel embedding/head, expert
  parallelism for MoE (when the expert count divides the axis).
* ``data`` axis — batch data-parallelism + FSDP-style parameter sharding
  (the second dim of every weight is sharded over ``data`` so optimizer
  state for 34B-param configs fits per card).
* ``pod`` axis — pure data parallelism; parameters are replicated across
  pods so cross-pod (slow) traffic is only the gradient reduction.

Every rule degrades gracefully: an axis that does not divide a dim is
dropped (replicated) rather than failing — head counts like Yi's 56 stay
correct because projections are stored with heads fused into 2-D dims.

A mesh here is anything with ``shape`` (axis name -> size) and
``axis_names``: a :class:`MeshShape` (a plain description, no process
behind it: the production meshes of ``launch.mesh.make_production_mesh``)
or a process mesh of ``launch.mesh``.  A :class:`PartitionSpec` is a tuple
with one entry per dim: ``None`` (replicated), an axis name, or a tuple of
axis names (the dim split over their product, the first axis major).
:class:`NamedSharding` turns a spec into placements on a mesh: which dim
each axis splits, and the slice of a whole tensor one rank holds.

Parameters come in two layouts.  The reference's nested tree (``dict`` of
``dict``; a leaf under one of ``_STACKED`` carries a leading layer dim,
whose spec entry is ``None``), as ``launch.specs.param_specs`` gives it;
or the port's parameter names (``<stack>.<i>.<rest>``, one tensor per
layer, ``models.model.named_from_reference`` maps the one onto the
other), whose spec is the stacked leaf's without that lead.

Where they are applied: ``param_pspecs`` by ``runtime.sharded.
init_sharded`` (training; with ``serving=True`` sharded serving's bf16
weights), ``batch_pspecs`` by the trainer's and the server's rows
(``launch.train.batch_rows``, which the server's rows use too) and
``cache_pspecs`` by ``runtime.sharded.init_cache_sharded``: a serving
cache held as blocks, its KV caches as the rank's slice of the sequence
(``models.attention.SeqSplit``).  ``launch.dryrun`` traces all three on
a fake process group.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

__all__ = ["PartitionSpec", "P", "MeshShape", "NamedSharding",
           "batch_axes", "param_pspecs", "batch_pspecs", "cache_pspecs",
           "named", "fits"]

# leaf names -> role
_COL = {"wq", "wk", "wv", "w_gate", "w_up", "w_og", "w_in", "router",
        "w_gates", "r_gates", "w_if", "lm_head"}
_ROW = {"wo", "w_down", "w_out"}
_STACKED = {"blocks", "enc_blocks", "dec_blocks", "mlstm_blocks",
            "slstm_blocks", "mamba_blocks"}


class PartitionSpec(tuple):
    """One entry per dim: ``None``, an axis name or a tuple of names (a
    tuple of one name is that name, as JAX's ``PartitionSpec`` keeps
    it)."""

    def __new__(cls, *parts):
        return super().__new__(cls, (
            p[0] if isinstance(p, tuple) and len(p) == 1 else p
            for p in parts))

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


P = PartitionSpec


@dataclasses.dataclass(frozen=True)
class MeshShape:
    """A mesh's axis names and sizes, with no process group behind it."""

    axis_names: tuple
    sizes: tuple

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.sizes))


def _axes(part) -> tuple:
    """A spec entry's axes: ``()`` for ``None``."""
    if part is None:
        return ()
    return tuple(part) if isinstance(part, tuple) else (part,)


def batch_axes(mesh, cfg=None):
    names = ("pod", "data", "model") if (
        cfg is not None and cfg.shard_strategy == "dp") else ("pod", "data")
    return tuple(a for a in names if a in mesh.axis_names)


def fits(mesh, dim: int, *axes) -> bool:
    n = math.prod(mesh.shape[a] for a in axes)
    return dim % n == 0


def _maybe(mesh, dim, axis):
    """axis if it divides dim else None (replicated)."""
    if axis is None:
        return None
    return axis if fits(mesh, dim, *_axes(axis)) else None


def _leaf_rule(cfg, mesh, name: str, body: tuple[int, ...]) -> tuple:
    """The spec entries of one leaf's body (a stacked leaf's shape without
    its leading ``L``)."""
    def spec(*parts):
        return tuple(_maybe(mesh, d, a) for d, a in zip(body, parts))

    if cfg.shard_strategy == "dp":
        # ZeRO-3: weights sharded across both axes for storage only, and
        # gathered per layer where they are used.  Vocab-parallel layouts
        # would clash with the model-axis batch sharding, so embed/head
        # shard non-vocab dims.
        if name == "embed":
            return spec(None, ("data", "model"))
        if name == "lm_head":
            return spec(("data", "model"), None)
        if len(body) == 2:
            return spec("data", "model")
        if len(body) == 3:
            return spec(None, "data", "model")
        if len(body) == 1:
            return spec(("data", "model")) \
                if fits(mesh, body[0], "data", "model") else spec(None)
        return (None,) * len(body)

    if name == "embed":
        return spec("model", "data")
    if name == "enc_pos":
        return spec(None, "model")
    if len(body) == 3 and name in ("w_gate", "w_up", "w_down"):
        # MoE expert weights
        ep = cfg.moe is not None and cfg.moe.expert_parallel and \
            fits(mesh, body[0], "model")
        if name == "w_down":
            return spec("model", None, "data") if ep else \
                spec(None, "model", "data")
        return spec("model", "data", None) if ep else \
            spec(None, "data", "model")
    if name in _COL and len(body) == 2:
        return spec("data", "model")
    if name in _ROW and len(body) == 2:
        return spec("model", "data")
    if name == "conv_w":
        return spec(None, "model")
    if len(body) == 1:
        return spec("model") if body[0] >= 4096 else spec(None)
    return (None,) * len(body)


def _serving(parts: tuple) -> tuple:
    """The FSDP (``data``) factor dropped from every entry."""
    return tuple(None if p == "data" else
                 (tuple(a for a in p if a != "data") or None)
                 if isinstance(p, tuple) else p for p in parts)


def param_pspecs(cfg, mesh, params, serving: bool = False):
    """Specs for ``params``: the reference's nested tree (specs of its
    structure, a stacked leaf's with a leading ``None``) or a dict under
    the port's parameter names (a layer's spec: its stacked leaf's without
    that lead).  Leaves need only ``shape``.

    ``serving``: inference holds no optimizer state, so the FSDP (`data`)
    factor is dropped — weights replicate across the batch axes instead of
    being re-gathered every decode step."""
    def rule(name: str, shape, lead: bool):
        body = tuple(shape)[1:] if lead else tuple(shape)
        parts = _leaf_rule(cfg, mesh, name, body)
        if serving:
            parts = _serving(parts)
        return P(*((None,) if lead else ()), *parts)

    if any(isinstance(v, dict) for v in params.values()):
        def walk(tree, stacked):
            return {k: walk(v, stacked or k in _STACKED)
                    if isinstance(v, dict) else
                    rule(k, v.shape, stacked or k in _STACKED)
                    for k, v in tree.items()}
        return walk(params, False)
    return {name: rule(name.rsplit(".", 1)[-1], t.shape, False)
            for name, t in params.items()}


def batch_pspecs(cfg, shape_cfg, mesh):
    """Input specs for {tokens[, frames][, pos]}."""
    bax = batch_axes(mesh, cfg)
    b = shape_cfg.global_batch
    while bax and not fits(mesh, b, *bax):
        bax = bax[:-1]
    bspec = bax if bax else None
    out = {"tokens": P(bspec, None)}
    if cfg.is_encdec:
        out["frames"] = P(bspec, None, None)
    if shape_cfg.kind == "decode":
        out["pos"] = P()   # scalar (synchronized wave)
    return out


def cache_pspecs(cfg, shape_cfg, mesh, cache_tree):
    """Specs for the serving cache (``models.model.init_cache``'s tree).

    Attention KV caches are *sequence-sharded over the model axis*
    (distributed flash-decode: each shard computes a partial attention and
    the softmax statistics are combined) — the two-phase local-compute +
    small-combine structure of the paper's SpMV.  When global_batch == 1
    (long_500k) the sequence is sharded over data x model instead.
    SSM states shard their largest divisible state dim over ``model``.
    """
    bax = batch_axes(mesh)
    b = shape_cfg.global_batch
    b_ok = fits(mesh, b, *bax)
    bspec = bax if b_ok else None

    def rule(name, sh):
        if name in ("k", "v", "cross_k", "cross_v"):
            # (L, B, S, KV, dh)
            seq = _maybe(mesh, sh[2], "model") if b_ok else \
                _maybe(mesh, sh[2], ("data", "model"))
            return P(None, bspec, seq, None, None)
        if name == "h" and len(sh) == 5:   # mamba state (L, B, H, dh, N)
            return P(None, bspec, _maybe(mesh, sh[2], "model"), None, None)
        if name == "conv" and len(sh) == 4:  # (L, B, W-1, C)
            return P(None, bspec, None, _maybe(mesh, sh[3], "model"))
        if name == "C" and len(sh) == 5:   # mlstm cell (L, B, H, dh, dh)
            return P(None, bspec, None, _maybe(mesh, sh[3], "model"), None)
        if name == "n" and len(sh) == 4:   # mlstm normaliser (L, B, H, dh)
            return P(None, bspec, None, _maybe(mesh, sh[3], "model"))
        if len(sh) == 3:                   # mlstm m / slstm c,n,m,h (L, B, d)
            return P(None, bspec, _maybe(mesh, sh[2], "model"))
        return P(*(None,) * len(sh))

    def walk(tree):
        return {k: walk(v) if isinstance(v, dict) else rule(k, tuple(v.shape))
                for k, v in tree.items()}
    return walk(cache_tree)


@dataclasses.dataclass(frozen=True, eq=False)
class NamedSharding:
    """A spec placed on a mesh: ``splits`` lists ``(dim, axes)`` for every
    split dim, ``replicated`` the mesh axes no dim is split over.  On a
    process mesh (which has ``coords``, this rank's index on every axis)
    :meth:`shard` cuts this rank's block out of a whole tensor."""

    mesh: Any
    spec: PartitionSpec

    @property
    def splits(self) -> tuple:
        return tuple((d, _axes(p)) for d, p in enumerate(self.spec)
                     if _axes(p))

    @property
    def replicated(self) -> tuple:
        used = {a for _, axes in self.splits for a in axes}
        return tuple(a for a in self.mesh.axis_names if a not in used)

    def parts(self, axes) -> int:
        return math.prod(self.mesh.shape[a] for a in axes)

    def shard_shape(self, shape) -> tuple:
        out = list(shape)
        for d, axes in self.splits:
            n = self.parts(axes)
            if out[d] % n:
                raise ValueError(f"dim {d} of {tuple(shape)} does not split "
                                 f"over {axes} ({n} parts)")
            out[d] //= n
        return tuple(out)

    def part_index(self, axes, coords=None) -> int:
        """This rank's block along a dim split over ``axes`` (the first
        axis major)."""
        coords = self.mesh.coords if coords is None else coords
        i = 0
        for a in axes:
            i = i * self.mesh.shape[a] + coords[a]
        return i

    def shard(self, full, coords=None):
        """The block of ``full`` (a tensor or array) that the rank at
        ``coords`` (default: this rank) holds."""
        out = full
        for d, axes in self.splits:
            n = self.parts(axes)
            size = full.shape[d] // n
            i = self.part_index(axes, coords)
            idx = [slice(None)] * full.ndim
            idx[d] = slice(i * size, (i + 1) * size)
            out = out[tuple(idx)]
        return out


def named(mesh, tree_of_pspecs):
    """Every spec of a (nested) dict placed on ``mesh``."""
    return {k: named(mesh, v) if isinstance(v, dict)
            else NamedSharding(mesh, v) for k, v in tree_of_pspecs.items()}
