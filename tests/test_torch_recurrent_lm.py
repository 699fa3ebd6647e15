"""The port's recurrent LM serving path against the JAX package's, on the
CPU.

xlstm-350m (7 mLSTM + 1 sLSTM blocks) and zamba2-1.2b (5 mamba blocks,
the shared attention block, a tail of 2) at ``reduced()`` (B = 2, S =
32), one weight tree in the shapes of the reference's ``init_params``
handed to both: ``forward_train`` logits, ``loss_fn``, ``prefill``'s last
logits and every cache tensor, and ``decode_step``'s logits and caches
with a scalar ``pos`` and a ragged ``(B,)`` one (which xlstm ignores).
Both decodes start from the reference's prefill cache, so a step is held
on the same inputs.  ``ssm_chunk`` 12 runs the scans in three chunks with
padding.

Weights: at float32, numpy draws (matrices at their fan-in scale) with
every vector at the reference's init value plus 0.1·N(0, 1): norms near
one, the gate biases near -2 / +3, the decay logs near log 1..16, so a
misplaced vector shows and the gates stay in their working range; at
bfloat16 the reference's own ``init_params`` draw, as for the attention
archs.

Tolerances, with the largest error measured on this CPU beside each:
  * float32 compute: ``1e-4·max(1, max|ref|)`` (largest 1.5e-5, zamba's
    forward at ``ssm_chunk`` 12);
  * bfloat16 compute: ``max(2e-2, 2δ)·max(1, max|ref|)``, where δ is the
    reference's own bf16 error on that tensor, against its float32 run
    on the same weights and inputs.  The recurrent stacks carry more
    bf16 error than the attention archs (δ 5.3e-2 on xlstm's logits,
    2.7e-2 on zamba's) and two bf16 runs, each δ from the float32
    answer, may be 2δ apart: the port measured 4.2e-2 on xlstm's
    forward (bound 0.105) and 3.0e-2 on a zamba cache tensor (bound
    0.054); the loss stays within 2e-2 (largest 6.2e-4);
  * the bfloat16 caches at float32 compute (zamba's conv state and KV
    layer): within one bf16 step at the tensor's largest magnitude
    (``bf16_step``, the rule ``chip_smoke.py`` holds the card to: 2^-6
    in [2, 4)), and at most 1e-3 of the elements past the bound above
    (rounding flips);
  * the float32 states (mLSTM C, n, m; sLSTM c, n, m, h; the SSD h) at
    the bound of their compute dtype.
The port's own properties: prefill's last logits equal ``forward_train``'s
last position within ``atol 1e-5`` (float32; the same code runs both), at
float32 with float32 caches one decode step equals ``forward_train`` on
the S + 1 tokens within the float32 bound, a scalar ``pos`` (int or 0-d
tensor) and the same ``(B,)`` ``pos`` give the same bits, and the caches
have the reference's layout.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import model as rm
from repro_torch.models import model as pm
from repro_torch.testing.tolerance import bf16_step
from test_torch_lm import B, EXTRA, RAGGED, S, _cfgs, _clone, _close, _np

ARCHS = ["xlstm-350m", "zamba2-1.2b"]
BOUND = {"float32": 1e-4, "bfloat16": 2e-2}
PREFILL_ATOL = 1e-5


@functools.lru_cache(maxsize=None)
def _ref_init(name: str, key: int) -> dict:
    """The reference's ``init_params`` draw of ``name`` at ``reduced()``
    (numpy leaves), jitted once for every case that draws it."""
    cfg_r = _cfgs(name, "float32")[1]
    return jax.tree.map(np.asarray, jax.jit(
        lambda k: rm.init_params(k, cfg_r))(jax.random.PRNGKey(key)))


def _weights(name: str, compute: str, rng) -> dict:
    """The reference's ``init_params`` draw; at float32 its matrices
    redrawn with numpy at their fan-in scale and its vectors moved by
    0.1·N(0, 1)."""
    tree = _ref_init(name, int(rng.integers(1 << 30)))
    if compute != "float32":
        return tree

    def leaf(path, a):
        stacked = "_blocks'" in jax.tree_util.keystr(path)
        shape = a.shape[1:] if stacked else a.shape
        if len(shape) == 1:
            return (a + 0.1 * rng.standard_normal(a.shape)).astype(np.float32)
        return (rng.standard_normal(a.shape) / np.sqrt(shape[0])).astype(
            np.float32)
    return jax.tree_util.tree_map_with_path(leaf, tree)


def _torch(a) -> torch.Tensor:
    """A reference array as a tensor of its dtype, bf16 bits kept."""
    a = np.asarray(a)
    if a.dtype == jnp.bfloat16:
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


class Case:
    """One recurrent arch at one compute dtype (and config changes): the
    reference's results and the port's on the same weights and inputs;
    at bf16 also the reference's float32 run, which sets δ."""

    def __init__(self, name: str, compute: str, seed: int = 0, **changes):
        cfg, cfg_r = _cfgs(name, compute, **changes)
        self.cfg, self.compute = cfg, compute
        rng = np.random.default_rng(seed)
        tree = _weights(name, compute, rng)
        toks = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
        nxt = rng.integers(0, cfg.vocab, (B, 1)).astype(np.int32)
        cache_r = None
        self.ref, self.ref32 = {}, {}
        runs = [(self.ref, cfg_r)]
        if compute != "float32":
            runs.append((self.ref32, _cfgs(name, "float32", **changes)[1]))
        for out, c in runs:
            # one program for the forward and the loss (XLA shares the
            # forward), and one decode for the scalar and the ragged pos
            fwd = jax.jit(lambda p, t, c=c: (
                rm.forward_train(p, c, t)[0],
                rm.loss_fn(p, c, {"tokens": t})[0]))
            pre = jax.jit(lambda p, t, k, c=c: rm.prefill(p, c, t, k))
            dec = jax.jit(lambda p, t, k, q, c=c: rm.decode_step(p, c, t, k,
                                                                 q))
            cr, last = pre(tree, toks, rm.init_cache(c, B, S + EXTRA))
            # every decode starts from the (compute-dtype) reference's cache
            cache_r = cr if cache_r is None else cache_r
            logits, loss = fwd(tree, toks)
            out.update(
                forward=_np(logits), loss=_np(loss),
                prefill=(jax.tree.map(_np, cr), _np(last)),
                decode=jax.tree.map(_np, dec(tree, nxt, cache_r,
                                             jnp.full((B,), S, jnp.int32))),
                ragged=jax.tree.map(_np, dec(tree, nxt, cache_r,
                                             jnp.asarray(RAGGED))))

        model = pm.params_from_reference(cfg, tree, device="cpu")
        t, n = torch.from_numpy(toks), torch.from_numpy(nxt)
        start = jax.tree.map(_torch, cache_r)
        self.start = start
        cache, last = pm.prefill(model, cfg, t,
                                 pm.init_cache(cfg, B, S + EXTRA,
                                               device="cpu"))
        self.port = {
            "forward": pm.forward_train(model, cfg, t),
            "loss": pm.loss_fn(model, cfg, {"tokens": t}),
            "prefill": (cache, last),
        }
        for which, pos in (("decode", S), ("ragged", torch.from_numpy(RAGGED)),
                           ("decode_0d", torch.tensor(S)),
                           ("decode_vec", torch.full((B,), S))):
            self.port[which] = pm.decode_step(model, cfg, n, _clone(start),
                                              pos)

    def bound(self, key: tuple, want) -> float:
        """The bound for the reference tensor ``want`` at ``key`` (a path
        into ``ref``): the compute dtype's, or at bf16 ``max(2e-2, 2δ)``."""
        rel = BOUND[self.compute]
        if self.compute == "float32":
            return rel
        w32 = self.ref32
        for k in key:
            w32 = w32[k]
        scale = max(1.0, float(np.abs(want).max()))
        return max(rel, 2 * float(np.abs(want - w32).max()) / scale)


@pytest.fixture(scope="module", params=ARCHS)
def f32(request):
    return Case(request.param, "float32")


@pytest.fixture(scope="module", params=ARCHS)
def chunked(request):
    return Case(request.param, "float32", ssm_chunk=12)


@pytest.fixture(scope="module", params=ARCHS)
def bf16(request):
    return Case(request.param, "bfloat16")


def _close_cache(c: Case, got: dict, want: dict, key: tuple) -> None:
    """Every cache tensor: a float32 state at ``c.bound``; a bf16 one
    (conv state, KV) within one bf16 step at its largest magnitude and at
    most 1e-3 of its elements past ``c.bound``."""
    assert set(got) == set(want), (set(got), set(want))
    for k, w in want.items():
        if isinstance(w, dict):
            _close_cache(c, got[k], w, key + (k,))
            continue
        g, rel = got[k], c.bound(key + (k,), w)
        if g.dtype == torch.float32:
            _close(g, w, rel)
            continue
        assert g.dtype == torch.bfloat16, (k, g.dtype)
        g = _np(g)
        assert g.shape == w.shape, (g.shape, w.shape)
        top = float(np.abs(w).max())
        bound = rel * max(1.0, top)
        diff = np.abs(g - w)
        assert diff.max() <= max(bound, bf16_step(top)), (k, diff.max(), top)
        assert (diff > bound).sum() <= 1e-3 * w.size, (k, (diff > bound).sum())


def _check_forward(c: Case):
    lg, _ = c.port["forward"]
    assert lg.shape == (B, S, c.cfg.vocab_padded) and lg.dtype == getattr(
        torch, c.compute)
    _close(lg, c.ref["forward"], c.bound(("forward",), c.ref["forward"]))


def _check_loss(c: Case):
    loss, metrics = c.port["loss"]
    assert set(metrics) == {"nll", "z_loss"}
    _close(loss, c.ref["loss"], c.bound(("loss",), c.ref["loss"]))


def _check_prefill(c: Case):
    (cache, last), (cw, lw) = c.port["prefill"], c.ref["prefill"]
    assert last.shape == (B, 1, c.cfg.vocab_padded)
    _close(last, lw, c.bound(("prefill", 1), lw))
    _close_cache(c, cache, cw, ("prefill", 0))


def _check_decode(c: Case, which: str):
    (lg, cache), (lw, cw) = c.port[which], c.ref[which]
    assert lg.shape == (B, c.cfg.vocab_padded)
    _close(lg, lw, c.bound((which, 0), lw))
    _close_cache(c, cache, cw, (which, 1))


def test_forward_train(f32):
    _check_forward(f32)


def test_loss_fn(f32):
    _check_loss(f32)


def test_prefill(f32):
    _check_prefill(f32)


@pytest.mark.parametrize("which", ["decode", "ragged"])
def test_decode_step(f32, which):
    _check_decode(f32, which)


def test_chunks_with_padding(chunked):
    """``ssm_chunk`` 12: S = 32 runs as three chunks, the last padded by
    four steps that must neither emit nor move a state."""
    _check_forward(chunked)
    _check_prefill(chunked)
    _check_decode(chunked, "decode")


def test_bf16_forward_and_loss(bf16):
    _check_forward(bf16)
    _check_loss(bf16)


def test_bf16_prefill_and_decode(bf16):
    _check_prefill(bf16)
    _check_decode(bf16, "decode")
    _check_decode(bf16, "ragged")


def test_prefill_matches_forward_train(f32):
    last = f32.port["prefill"][1][:, 0]
    full = f32.port["forward"][0][:, -1]
    np.testing.assert_allclose(_np(last), _np(full), atol=PREFILL_ATOL)


@pytest.mark.parametrize("name", ARCHS)
def test_f32_step_matches_forward_train(name):
    """At float32 compute with every cache tensor in float32 (the conv
    state and KV caches too, which serve in bf16), prefill and one decode
    step equal ``forward_train``'s last position on the S + 1 tokens
    within ``1e-4·max(1, max|ref|)`` (largest 1.2e-6, xlstm): the
    recurrent step against the chunked scans, ``chip_smoke.py``'s f32
    first-step gate at full width."""
    cfg = _cfgs(name, "float32")[0]
    model = pm.init_params(cfg, torch.Generator().manual_seed(0),
                           device="cpu")
    toks = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab, (B, S)))
    cache = jax.tree.map(lambda t: t.float(),
                         pm.init_cache(cfg, B, S + EXTRA, device="cpu"))
    cache, last = pm.prefill(model, cfg, toks, cache)
    nt = last[:, 0, :cfg.vocab].argmax(-1, keepdim=True)
    step, _ = pm.decode_step(model, cfg, nt, cache, S)
    full, _ = pm.forward_train(model, cfg, torch.cat([toks, nt], 1))
    _close(step, _np(full[:, -1]), BOUND["float32"])


def test_scalar_and_vector_pos_same_bits(f32):
    lg, cache = f32.port["decode"]
    for which in ("decode_0d", "decode_vec"):
        lg2, cache2 = f32.port[which]
        assert torch.equal(lg, lg2)
        for a, b in zip(jax.tree.leaves(cache), jax.tree.leaves(cache2)):
            assert torch.equal(a, b)


def test_decode_writes_the_cache_in_place(f32):
    """``decode_step`` returns the cache it was given, every tensor the
    same buffer, the recurrent states moved and (zamba) the KV slot at
    ``pos`` written."""
    cfg, start = f32.cfg, f32.start
    cache = _clone(start)
    buffers = jax.tree.leaves(cache)
    model = pm.init_params(cfg, torch.Generator().manual_seed(0),
                           device="cpu")
    _, out = pm.decode_step(model, cfg, torch.zeros((B, 1), dtype=torch.long),
                            cache, S)
    assert out is cache
    assert all(a is b for a, b in zip(jax.tree.leaves(out), buffers))
    for group, state in cache.items():
        for k, t in state.items():
            if group == "attn_kv":
                assert not torch.equal(t[:, :, S], start[group][k][:, :, S])
                assert torch.equal(t[:, :, :S], start[group][k][:, :, :S])
            elif k != "conv":
                assert not torch.equal(t, start[group][k]), (group, k)


@pytest.mark.parametrize("name", ARCHS)
def test_cache_layout(name):
    """``init_cache`` lays the states out as the reference's: the same
    groups, keys, shapes (leading layer dim) and dtypes, all zero."""
    cfg, cfg_r = _cfgs(name, "float32")
    want = rm.init_cache(cfg_r, B, S + EXTRA)
    got = pm.init_cache(cfg, B, S + EXTRA, device="cpu")
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        assert tuple(g.shape) == w.shape
        assert str(g.dtype).removeprefix("torch.") == str(w.dtype)
        assert not g.any()
