"""The port's sharding rules (``runtime/sharding.py``) against the JAX
package's, leaf for leaf, with no process group.

The reference's rules read only ``mesh.shape`` and ``mesh.axis_names``, so
a plain namespace with those two is a mesh for them here; the port gets
its own ``MeshShape`` of the same axes.  Held on the CPU:

* ``param_pspecs`` for every registered arch x ``shard_strategy``
  ``tp``/``dp`` x ``serving`` False/True x meshes 1x1, 16x16 and
  2x16x16: on the reference's nested tree (``launch.specs.param_specs``)
  the same spec for every leaf, and under the port's parameter names each
  layer's spec is its stacked leaf's without the leading ``None``;
* ``batch_pspecs`` for every arch x ``SHAPES`` entry x strategy x mesh;
* ``cache_pspecs`` on every arch's cache at ``decode_32k`` and
  ``long_500k`` (meta-device stand-ins on the port's side);
* the four cases of ``tests/test_runtime.py`` (yi-34b's rules, serving
  drops the FSDP factor, ``dp`` shards the batch over ``model``, MoE
  group sizes) against the port;
* ``NamedSharding``: a spec's blocks tile the whole tensor, and
  ``constrain_batch`` is the identity with no ambient mesh and records
  the reference's fall-back of axes under one.
"""
import dataclasses
import functools
import types

import jax
import numpy as np
import pytest
import torch

from repro.configs import SHAPES as REF_SHAPES
from repro.configs import get_config as ref_config
from repro.configs import list_archs
from repro.launch import specs as rspecs
from repro.runtime import sharding as rs
from repro_torch.configs import SHAPES, get_config
from repro_torch.launch import specs as pspecs
from repro_torch.models.model import Model
from repro_torch.runtime import sharding as ps

ARCHS = sorted(list_archs())
MESHES = {"1x1": (("data", "model"), (1, 1)),
          "16x16": (("data", "model"), (16, 16)),
          "2x16x16": (("pod", "data", "model"), (2, 16, 16))}


def _meshes():
    for axes, sizes in MESHES.values():
        yield (types.SimpleNamespace(axis_names=axes,
                                     shape=dict(zip(axes, sizes))),
               ps.MeshShape(axes, sizes))


def _cfgs(arch: str, strategy: str = "tp"):
    return (dataclasses.replace(get_config(arch), shard_strategy=strategy),
            dataclasses.replace(ref_config(arch), shard_strategy=strategy))


@functools.lru_cache(maxsize=None)
def _ref_params(arch: str):
    return rspecs.param_specs(ref_config(arch))


def _flat(tree, prefix=()):
    """(path, leaf) of a nested dict (a reference PartitionSpec is a
    leaf)."""
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _spec(p) -> tuple:
    return tuple(p)


@pytest.mark.parametrize("serving", [False, True])
@pytest.mark.parametrize("strategy", ["tp", "dp"])
@pytest.mark.parametrize("arch", ARCHS)
def test_param_pspecs_match_the_reference(arch, strategy, serving):
    cfg, cfg_r = _cfgs(arch, strategy)
    ref_tree = _ref_params(arch)
    port_tree = pspecs.param_specs(cfg)
    named = dict(Model(cfg, "meta").named_parameters())
    for ref_mesh, mesh in _meshes():
        want = dict(_flat(rs.param_pspecs(cfg_r, ref_mesh, ref_tree,
                                          serving=serving)))
        got = dict(_flat(ps.param_pspecs(cfg, mesh, port_tree,
                                         serving=serving)))
        assert set(got) == set(want)
        for path, spec in want.items():
            assert _spec(got[path]) == _spec(spec), (mesh, path)
        # the port's names: a layer's spec is its stack's without the lead
        by_name = ps.param_pspecs(cfg, mesh, named, serving=serving)
        assert set(by_name) == set(named)
        for name, spec in by_name.items():
            head, _, rest = name.partition(".")
            if head in ps._STACKED:
                _, _, rest = rest.partition(".")
                ref = want[(head, *rest.split("."))]
                assert _spec(ref)[0] is None
                assert _spec(spec) == _spec(ref)[1:], (mesh, name)
            else:
                assert _spec(spec) == _spec(want[tuple(name.split("."))])


@pytest.mark.parametrize("shape", sorted(SHAPES))
@pytest.mark.parametrize("arch", ARCHS)
def test_batch_pspecs_match_the_reference(arch, shape):
    for strategy in ("tp", "dp"):
        cfg, cfg_r = _cfgs(arch, strategy)
        for ref_mesh, mesh in _meshes():
            want = rs.batch_pspecs(cfg_r, REF_SHAPES[shape], ref_mesh)
            got = ps.batch_pspecs(cfg, SHAPES[shape], mesh)
            assert set(got) == set(want)
            for k in want:
                assert _spec(got[k]) == _spec(want[k]), (strategy, mesh, k)


@pytest.mark.parametrize("shape", ["decode_32k", "long_500k"])
@pytest.mark.parametrize("arch", ARCHS)
def test_cache_pspecs_match_the_reference(arch, shape):
    from repro.models.model import init_cache as ref_init_cache

    cfg, cfg_r = _cfgs(arch)
    s = SHAPES[shape]
    ref_cache = jax.eval_shape(lambda: ref_init_cache(
        cfg_r, s.global_batch, s.seq_len))
    cache = pspecs.cache_specs(cfg, s)
    for ref_mesh, mesh in _meshes():
        want = dict(_flat(rs.cache_pspecs(cfg_r, REF_SHAPES[shape],
                                          ref_mesh, ref_cache)))
        got = dict(_flat(ps.cache_pspecs(cfg, s, mesh, cache)))
        assert set(got) == set(want)
        for path, spec in want.items():
            assert _spec(got[path]) == _spec(spec), (mesh, path)


# --------------------------------------------------------------------- #
# tests/test_runtime.py's cases, against the port
# --------------------------------------------------------------------- #
def _one_by_one():
    return ps.MeshShape(("data", "model"), (1, 1))


def test_param_pspecs_rules():
    cfg = get_config("yi-34b")
    spec = ps.param_pspecs(cfg, _one_by_one(), pspecs.param_specs(cfg))
    # embed: vocab over model, d over data
    assert spec["embed"] == ps.P("model", "data")
    # stacked col-parallel weight
    assert spec["blocks"]["attn"]["wq"] == ps.P(None, "data", "model")
    assert spec["blocks"]["attn"]["wo"] == ps.P(None, "model", "data")
    # large 1-D vectors sharded over model; small ones replicated
    assert spec["final_norm"] == ps.P("model")
    assert spec["blocks"]["ln1"] == ps.P(None, "model")


def test_param_pspecs_serving_drops_fsdp():
    cfg = get_config("yi-34b")
    spec = ps.param_pspecs(cfg, _one_by_one(), pspecs.param_specs(cfg),
                           serving=True)
    for _, s in _flat(spec):
        for part in s:
            assert part != "data" and (not isinstance(part, tuple)
                                       or "data" not in part), s


def test_dp_strategy_shards_batch_over_model():
    cfg = dataclasses.replace(get_config("stablelm-1.6b"),
                              shard_strategy="dp")
    bs = ps.batch_pspecs(cfg, SHAPES["train_4k"], _one_by_one())
    assert bs["tokens"][0] == ("data", "model")


def test_moe_group_size_preserves_shapes_and_finiteness():
    from repro_torch.models.moe import init_moe, moe_apply

    cfg = get_config("qwen3-moe-30b-a3b").reduced()
    p = init_moe(torch.Generator().manual_seed(0), cfg, "cpu")
    x = torch.randn((2, 128, cfg.d_model),
                    generator=torch.Generator().manual_seed(1))
    for g in (32, 64, 128):
        cfg_g = dataclasses.replace(
            cfg, moe=dataclasses.replace(cfg.moe, group_size=g))
        y, aux = moe_apply(p, cfg_g, x)
        assert y.shape == x.shape
        assert torch.isfinite(y.float()).all()


# --------------------------------------------------------------------- #
# placements and the layout hint
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("spec", [(None, "model"), ("data", "model"),
                                  (("data", "model"), None),
                                  ("model", "data"), (None, None)])
def test_named_sharding_blocks_tile_the_tensor(spec):
    mesh = ps.MeshShape(("data", "model"), (2, 3))
    full = np.arange(12 * 18).reshape(12, 18)
    pl = ps.NamedSharding(mesh, ps.P(*spec))
    seen = np.zeros_like(full)
    for d in range(2):
        for m in range(3):
            block = pl.shard(full, {"data": d, "model": m})
            assert block.shape == pl.shard_shape(full.shape)
            seen[np.isin(full, block)] += 1
    copies = int(np.prod([mesh.shape[a] for a in pl.replicated]))
    assert (seen == copies).all()


def test_constrain_batch_is_the_identity_and_keeps_the_fallback():
    """No mesh: nothing recorded.  Under pod=2 x data=4 x model=2 the axes
    drop from the front until the global batch divides them, as the
    reference's ``constrain_batch`` drops them."""
    from repro_torch.models.common import (constrain_batch,
                                           record_constraints, use_mesh)

    x = torch.randn(16, 4, 8)
    mesh = ps.MeshShape(("pod", "data", "model"), (2, 4, 2))
    with record_constraints() as log:
        assert constrain_batch(x) is x              # no ambient mesh
        with use_mesh(mesh):
            for rows, dp in ((16, False), (6, False), (4, True), (1, False)):
                assert constrain_batch(x[:rows], dp=dp).data_ptr() \
                    == x.data_ptr()
        with use_mesh(mesh, batch_shards=8):
            constrain_batch(x[:2])                  # 16 global rows
    assert log == [((16, 4, 8), ("pod", "data")), ((6, 4, 8), ()),
                   ((4, 4, 8), ("model",)), ((1, 4, 8), ()),
                   ((2, 4, 8), ("pod", "data"))]
