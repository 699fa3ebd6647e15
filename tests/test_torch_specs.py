"""The port's stand-ins (``launch/specs.py``) against the JAX package's
``jax.eval_shape`` trees: for every registered arch x ``SHAPES`` entry,
``input_specs`` and ``cache_specs`` give the same structure, shapes and
dtypes; for every arch ``param_specs`` and ``opt_specs`` do too.  The
port's leaves are meta-device tensors: nothing is allocated, so the full
configs (yi-34b, chameleon-34b) cost nothing here.
"""
import jax
import pytest
import torch

from repro.configs import SHAPES as REF_SHAPES
from repro.configs import get_config as ref_config
from repro.configs import list_archs
from repro.launch import specs as rspecs
from repro_torch.configs import SHAPES, get_config
from repro_torch.launch import specs as pspecs

ARCHS = sorted(list_archs())


def _leaves(tree, prefix=()):
    """(path, shape, dtype name) of every leaf of a nested dict, a
    NamedTuple (``OptState``) or a leaf."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], prefix + (k,))
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        for k in tree._fields:
            yield from _leaves(getattr(tree, k), prefix + (k,))
    else:
        dt = str(tree.dtype).removeprefix("torch.")
        yield prefix, tuple(tree.shape), dt


def _same(got, want):
    g, w = list(_leaves(got)), list(_leaves(want))
    assert [p for p, *_ in g] == [p for p, *_ in w]
    assert g == w
    return len(g)


def _on_meta(tree):
    return all(t.device.type == "meta" for t in jax.tree_util.tree_leaves(
        tree, is_leaf=lambda x: isinstance(x, torch.Tensor)))


@pytest.mark.parametrize("shape", sorted(SHAPES))
@pytest.mark.parametrize("arch", ARCHS)
def test_input_and_cache_specs_match_the_reference(arch, shape):
    cfg, cfg_r = get_config(arch), ref_config(arch)
    got = pspecs.input_specs(cfg, SHAPES[shape])
    _same(got, rspecs.input_specs(cfg_r, REF_SHAPES[shape]))
    assert _on_meta(got)
    cache = pspecs.cache_specs(cfg, SHAPES[shape])
    assert _same(cache, rspecs.cache_specs(cfg_r, REF_SHAPES[shape])) > 0
    assert _on_meta(cache)


@pytest.mark.parametrize("arch", ARCHS)
def test_param_and_opt_specs_match_the_reference(arch):
    cfg, cfg_r = get_config(arch), ref_config(arch)
    params = pspecs.param_specs(cfg)
    ref = rspecs.param_specs(cfg_r)
    assert _same(params, ref) > 0
    assert _on_meta(params)
    _same(pspecs.opt_specs(params), rspecs.opt_specs(ref))
    n = sum(t.numel() for t in jax.tree_util.tree_leaves(
        params, is_leaf=lambda x: isinstance(x, torch.Tensor)))
    assert n == sum(int(x.size) for x in jax.tree_util.tree_leaves(ref))
