"""The port's AdamW (``optim/adamw.py``) and token pipeline
(``data/pipeline.py``) against the JAX package's, on the CPU.

* AdamW: one parameter tree (zamba2-1.2b at ``reduced()``: stacked mamba
  blocks and the unstacked shared attention block), three steps given
  the same gradients on both sides, the first and last with the clip
  active (global norm 10x ``clip_norm``), the second without (0.1x);
  every parameter within ``1e-6·(1 + |p|)`` of the reference's after each
  step (largest reading 5.9e-8), the moments likewise, and the step's
  ``grad_norm`` and ``lr`` within 1e-6 relative.
* ``warmup_cosine`` at step 0, at the warmup edge and at
  ``total_steps``, within 1e-6 relative.
* The weight-decay rule, read off the reference: with zero gradients a
  step moves exactly the decayed leaves.  The reference decays leaves of
  rank >= 2, and a layer stack's leaves carry the layer dim: every
  parameter inside a stack (the mamba blocks' ``ln``, ``a_log``,
  ``dt_bias``, ``d_skip``) decays, ``final_norm`` and the shared
  attention block's norms do not.
* ``TokenPipeline.batch_at`` / ``frames_at`` byte for byte the
  reference's for several ``(seed, step)`` pairs, a large step included.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data import TokenPipeline as RefPipeline
from repro.optim import adamw as ra
from repro_torch.data import TokenPipeline
from repro_torch.models import model as pm
from repro_torch.optim import adamw as pa
from test_torch_lm import _cfgs, _ref_shapes, _tree

ADAMW = pa.AdamWConfig(lr=1e-2, warmup_steps=2, total_steps=5)
RULES = dataclasses.asdict(ADAMW)
#: the reference's step, compiled once (its config is static)
REF_UPDATE = jax.jit(ra.apply_updates, static_argnums=0)


def _params():
    cfg_r = _cfgs("zamba2-1.2b", "float32")[1]
    return _tree(_ref_shapes(cfg_r), np.random.default_rng(0))


def _scaled_grads(tree, rng, norm: float):
    g = jax.tree.map(lambda a: rng.standard_normal(a.shape).astype(
        np.float32), tree)
    total = np.sqrt(sum(float(np.sum(a.astype(np.float64) ** 2))
                        for a in jax.tree.leaves(g)))
    return jax.tree.map(lambda a: (a * (norm / total)).astype(np.float32),
                        g)


def _port_state(tree):
    named = pm.named_from_reference(tree)
    params = {k: torch.from_numpy(np.array(a)) for k, a in named.items()}
    ndim = {k: pm.reference_ndim(k, p) for k, p in params.items()}
    return params, pa.init_opt(params), ndim


def _torch_named(tree) -> dict:
    return {k: torch.from_numpy(np.array(a))
            for k, a in pm.named_from_reference(tree).items()}


def _close_tree(got: dict, want) -> float:
    """Every leaf within ``1e-6·(1 + |want|)``; returns the largest
    ``|got - want| / (1 + |want|)``."""
    got = jax.tree_util.tree_flatten_with_path(got)[0]
    want = jax.tree_util.tree_flatten_with_path(want)[0]
    assert [p for p, _ in got] == [p for p, _ in want]
    worst = 0.0
    for (path, g), (_, w) in zip(got, want):
        w = np.asarray(w)
        r = float(np.max(np.abs(g - w) / (1 + np.abs(w))))
        assert r <= 1e-6, (jax.tree_util.keystr(path), r)
        worst = max(worst, r)
    return worst


def test_apply_updates_matches_reference():
    tree = _params()
    rng = np.random.default_rng(1)
    ref_cfg = ra.AdamWConfig(**RULES)
    ref_p = jax.tree.map(jnp.asarray, tree)
    ref_opt = ra.init_opt(ref_p)
    params, opt, ndim = _port_state(tree)
    for norm in (10 * ADAMW.clip_norm, 0.1 * ADAMW.clip_norm,
                 10 * ADAMW.clip_norm):
        grads = _scaled_grads(tree, rng, norm)
        ref_p, ref_opt, rmet = REF_UPDATE(
            ref_cfg, ref_p, jax.tree.map(jnp.asarray, grads), ref_opt)
        params, opt, met = pa.apply_updates(ADAMW, params,
                                            _torch_named(grads), opt, ndim)
        _close_tree(pm.to_reference(params), ref_p)
        _close_tree(pm.to_reference(opt.m), ref_opt.m)
        _close_tree(pm.to_reference(opt.v), ref_opt.v)
        assert int(opt.step) == int(ref_opt.step)
        for k in ("grad_norm", "lr"):
            assert abs(float(met[k]) - float(rmet[k])) <= 1e-6 * abs(
                float(rmet[k])), k
    assert opt.step.dtype == torch.int32


@pytest.mark.parametrize("step", [0, ADAMW.warmup_steps, ADAMW.total_steps])
def test_warmup_cosine_matches_reference(step):
    want = float(ra.warmup_cosine(ra.AdamWConfig(**RULES), jnp.int32(step)))
    got = pa.warmup_cosine(ADAMW, torch.tensor(step, dtype=torch.int32))
    assert got.dtype == torch.float32
    assert abs(float(got) - want) <= 1e-6 * abs(want), (float(got), want)


def test_weight_decay_follows_the_reference_leaf_rank():
    tree = _params()
    zeros = jax.tree.map(np.zeros_like, tree)
    ref_p, _, _ = REF_UPDATE(ra.AdamWConfig(**RULES),
                                   jax.tree.map(jnp.asarray, tree),
                                   jax.tree.map(jnp.asarray, zeros),
                                   ra.init_opt(tree))
    ref_moved = {k for k, a in pm.named_from_reference(
        jax.tree.map(np.asarray, ref_p)).items()
        if not np.array_equal(a, pm.named_from_reference(tree)[k])}
    params, opt, ndim = _port_state(tree)
    before = {k: p.clone() for k, p in params.items()}
    pa.apply_updates(ADAMW, params, _torch_named(zeros), opt, ndim)
    moved = {k for k, p in params.items() if not torch.equal(p, before[k])}
    assert moved == ref_moved
    assert {"mamba_blocks.0.ln", "mamba_blocks.0.mix.a_log",
            "mamba_blocks.0.mix.dt_bias", "mamba_blocks.0.mix.d_skip",
            "mamba_blocks.0.mix.w_in", "shared_attn.attn.wq"} <= moved
    assert not moved & {"final_norm", "shared_attn.ln1", "shared_attn.ln2"}
    # the tensors' own rank would decay none of the stacked vectors
    assert params["mamba_blocks.0.ln"].ndim == 1


@pytest.mark.parametrize("seed,step", [(0, 0), (0, 7), (3, 1), (11, 123456),
                                       (5, 10 ** 12)])
def test_pipeline_bytes_match_reference(seed, step):
    kw = dict(vocab=151936, global_batch=3, seq_len=40, seed=seed)
    ref, port = RefPipeline(**kw), TokenPipeline(**kw)
    a, b = ref.batch_at(step), port.batch_at(step)
    assert a.dtype == b.dtype and a.shape == b.shape
    assert a.tobytes() == b.tobytes()
    fa, fb = ref.frames_at(step, 6, 16), port.frames_at(step, 6, 16)
    assert fa.dtype == fb.dtype and fa.tobytes() == fb.tobytes()
