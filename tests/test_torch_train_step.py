"""The port's train step (``launch/train.py:make_train_step``) against
the JAX package's, and ``_remat``'s policies against each other, on the
CPU.

* Three steps of qwen2.5-3b at ``reduced()`` and float32 compute, from
  one numpy weight tree (``test_torch_lm._tree``) on both sides, batches
  of 4 × 32 from the token pipeline, AdamW with a 1-step warmup: every
  step's loss within 1e-4 relative of the reference's (largest reading
  3.8e-7), with ``accum`` 1 and 2 (two microbatches of 2 rows).
* ``remat_policy`` ``full``, ``dots`` and ``none`` (and ``remat``
  off) give the same gradient bits, for an attention arch (qwen2.5-3b)
  and a recurrent one (zamba2-1.2b: mamba blocks and the shared
  attention block), and the wrap really recomputes: under ``full`` and
  ``dots`` the backward runs each attention's forward tiles again.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.launch import train as rt
from repro.optim import AdamWConfig as RefAdamW
from repro.optim import init_opt as ref_init_opt
from repro_torch.data import TokenPipeline
from repro_torch.launch import train as pt
from repro_torch.models import common as pc
from repro_torch.models import model as pm
from repro_torch.optim import AdamWConfig, init_opt
from test_torch_lm import _cfgs, _ref_shapes, _tree

ADAMW = dict(lr=1e-3, warmup_steps=1, total_steps=3)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for the module: the tensors here are small, and
    a pool per test worker oversubscribes the host under ``pytest -n``."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("accum", [1, 2])
def test_train_step_matches_reference(accum):
    cfg, cfg_r = _cfgs("qwen2.5-3b", "float32")
    tree = _tree(_ref_shapes(cfg_r), np.random.default_rng(0))
    pipe = TokenPipeline(vocab=cfg.vocab, global_batch=4, seq_len=32, seed=1)

    ref_step = jax.jit(rt.make_train_step(cfg_r, RefAdamW(**ADAMW), accum))
    params, opt = tree, ref_init_opt(tree)
    model = pm.params_from_reference(cfg, tree, device="cpu",
                                     trainable=True)
    popt = init_opt(dict(model.named_parameters()))
    step = pt.make_train_step(cfg, AdamWConfig(**ADAMW), accum)
    for i in range(3):
        toks = pipe.batch_at(i)
        params, opt, lr, _ = ref_step(params, opt, {"tokens": toks})
        model, popt, lp, met = step(model, popt,
                                    {"tokens": torch.from_numpy(toks)})
        assert abs(float(lp) - float(lr)) <= 1e-4 * abs(float(lr)), (
            i, float(lp), float(lr))
        assert ("nll" in met) == (accum == 1)
    assert int(popt.step) == 3
    assert all(p.grad is None for p in model.parameters())


def _grads(name: str, policy: str, remat: bool = True) -> dict:
    cfg, cfg_r = _cfgs(name, "float32", remat=remat, remat_policy=policy)
    rng = np.random.default_rng(2)
    tree = _tree(_ref_shapes(cfg_r), rng)
    model = pm.params_from_reference(cfg, tree, device="cpu",
                                     trainable=True)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, (2, 32)))
    loss, _ = pm.loss_fn(model, cfg, {"tokens": toks})
    loss.backward()
    return {k: p.grad for k, p in model.named_parameters()}


@pytest.mark.parametrize("name", ["qwen2.5-3b", "zamba2-1.2b"])
def test_remat_policies_give_the_same_bits(name):
    want = _grads(name, "none")
    for policy, remat in (("full", True), ("dots", True), ("full", False)):
        got = _grads(name, policy, remat)
        assert got.keys() == want.keys()
        for k in want:
            assert torch.equal(got[k], want[k]), (policy, remat, k)


@pytest.mark.parametrize("policy,recomputed", [("none", False),
                                               ("full", True),
                                               ("dots", True)])
def test_remat_recomputes_in_the_backward(monkeypatch, policy, recomputed):
    calls = []
    fwd = pc._flash_fwd_impl

    def counted(*a):
        calls.append(torch.is_grad_enabled())
        return fwd(*a)
    monkeypatch.setattr(pc, "_flash_fwd_impl", counted)
    cfg = dataclasses.replace(_cfgs("qwen2.5-3b", "float32")[0],
                              remat_policy=policy)
    model = pm.init_params(cfg, torch.Generator().manual_seed(0),
                           device="cpu", trainable=True)
    toks = torch.randint(0, cfg.vocab, (2, 16),
                         generator=torch.Generator().manual_seed(1))
    loss, _ = pm.loss_fn(model, cfg, {"tokens": toks})
    n_fwd = len(calls)
    assert n_fwd == cfg.n_layers
    loss.backward()
    assert len(calls) - n_fwd == (cfg.n_layers if recomputed else 0)
    # serving records no graph and never recomputes
    calls.clear()
    cache = pm.init_cache(cfg, 2, 20, device="cpu")
    _, last = pm.prefill(model, cfg, toks, cache)
    assert not last.requires_grad and len(calls) == cfg.n_layers
