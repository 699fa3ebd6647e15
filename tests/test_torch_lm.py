"""The port's whole LM serving path against the JAX package's, on the CPU.

Every attention-family architecture at ``reduced()`` (B = 2, S = 32): one
weight tree made with numpy from a seed in the shapes of the reference's
``init_params`` (norm weights and biases drawn too, so none is trivially
one or zero), run through the reference's functions (jitted once per
arch) and, through ``params_from_reference``, through the port's:
``forward_train`` logits and MoE aux losses, ``loss_fn`` with ``nll`` and
``z_loss``, ``prefill``'s caches and last logits, and ``decode_step``'s
logits and caches with a scalar ``pos`` and with a ragged ``(B,)`` one.

Tolerances, with the largest error measured on this CPU beside each:
  * float32 compute: ``1e-4·max(1, max|ref|)`` (largest 4.1e-5, yi-34b's
    ragged decode step);
  * bfloat16 compute (qwen2.5-3b, whisper-large-v3, and qwen3-moe-30b-a3b
    at capacity factor 64 as ``test_moe_decode_matches_with_large_capacity``
    runs it): ``2e-2·max(1, max|ref|)``, the reference's own bf16 bound
    (largest 1.8e-2, qwen3-moe's ragged decode; 1.2e-2 without MoE).  At
    bf16 the weights are the reference's own ``init_params`` draw, the
    init that bound was set for: with the float32 cases' perturbed norms
    and 4.5x larger router logits, four layers of bf16 rounding reach
    2.8% in qwen3-moe at a position routed alike;
  * qwen3-moe at bf16: top-k routing is discontinuous, so the routing is
    read from both runs and must agree except at near-ties (a swapped
    k-th and (k+1)-th expert within a log-ratio of 2^-7 in the
    reference: measured swaps at 0.0012 and 0.0049, against a median gap
    of 0.058 over its 256 routing decisions); the logits and caches are
    held at every position before its row's first swap, and the decode
    step from one shared cache on each row whose token was routed alike;
  * the bfloat16 KV caches at float32 compute: within one bf16 step at
    the tensor's largest magnitude (2^-8·max|ref|, the storage's own
    resolution), and at most 1e-3 of the elements past the bound above.
    The two packages' float32 keys and values differ in their last bits,
    so a value on a rounding boundary lands on the neighbouring bf16
    number (2 to 22 of 40,960 to 147,456 elements per arch here), and a
    flip in an early layer's written slot moves later layers' values by
    about 1e-4 of their size (on the card against the CPU: 4.9e-4 of a
    key whose tensor peaks at 2.8, on an H100).
The port's own properties: prefill's last logits equal ``forward_train``'s
last position within the reference test's ``atol 1e-5`` (float32), and a
scalar ``pos`` (int or 0-d tensor) and the same ``(B,)`` ``pos`` give the
same bits, logits and caches.  ``init_params`` gives the reference's tree,
leaf for leaf, and draws its distribution, for the recurrent archs too
(whose serving path ``tests/test_torch_recurrent_lm.py`` holds).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _jax_spy import Spy
from repro.configs import get_config as ref_config
from repro.models import model as rm
from repro.models import moe as rmoe
from repro_torch.configs import get_config
from repro_torch.models import model as pm
from repro_torch.models import moe as pmoe

ATTN_ARCHS = ["yi-34b", "stablelm-1.6b", "qwen2.5-3b", "granite-3-8b",
              "chameleon-34b", "granite-moe-3b-a800m", "qwen3-moe-30b-a3b",
              "whisper-large-v3"]
BF16_ARCHS = ["qwen2.5-3b", "whisper-large-v3"]
BF16_MOE = "qwen3-moe-30b-a3b"
RECURRENT = ["xlstm-350m", "zamba2-1.2b"]
#: the reference's layer-stacked subtrees
STACKS = ("blocks", "enc_blocks", "dec_blocks", "mlstm_blocks",
          "slstm_blocks", "mamba_blocks")
B, S, EXTRA = 2, 32, 8
RAGGED = np.array([S, S - 5], np.int32)
BOUND = {"float32": 1e-4, "bfloat16": 2e-2}


def _cfgs(name: str, compute: str, **changes):
    """(port, reference) reduced configs at ``compute`` with ``changes``;
    MoE at bf16 with capacity factor 64."""
    cfgs = []
    for get in (get_config, ref_config):
        cfg = dataclasses.replace(get(name).reduced(), compute_dtype=compute,
                                  **changes)
        if cfg.moe is not None and compute == "bfloat16":
            cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
                cfg.moe, capacity_factor=64.0))
        cfgs.append(cfg)
    return cfgs


def _ref_shapes(cfg_r) -> dict:
    return jax.eval_shape(lambda k: rm.init_params(k, cfg_r),
                          jax.random.PRNGKey(0))


def _tree(shapes, rng) -> dict:
    """numpy leaves in ``shapes``' structure: weights at their fan-in
    scale, vectors (norms, biases) around one or zero."""
    def leaf(path, s):
        name = jax.tree_util.keystr(path)
        stacked = any(k in name for k in ("'blocks'", "_blocks'"))
        shape = s.shape[1:] if stacked else s.shape
        if len(shape) == 1:
            base = 1.0 if "norm" in name or "ln" in name else 0.0
            return (base + 0.1 * rng.standard_normal(s.shape)).astype(
                np.float32)
        return (rng.standard_normal(s.shape) / np.sqrt(shape[0])).astype(
            np.float32)
    return jax.tree_util.tree_map_with_path(leaf, shapes)


def _weights(cfg_r, compute: str, rng) -> dict:
    """The float32 cases' perturbed tree (``_tree``); at bfloat16 the
    reference's own ``init_params`` draw, the init its 2e-2 bound was
    set for."""
    if compute == "float32":
        return _tree(_ref_shapes(cfg_r), rng)
    key = jax.random.PRNGKey(int(rng.integers(1 << 30)))
    return _tree_np(jax.jit(lambda k: rm.init_params(k, cfg_r))(key))


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _tree_np(tree):
    return jax.tree.map(_np, tree)


def _clone(cache: dict) -> dict:
    return jax.tree.map(torch.clone, cache)


class Case:
    """One arch at one compute dtype: the reference's results and the
    port's, on the same weights and inputs."""

    def __init__(self, name: str, compute: str, seed: int = 0, **changes):
        self.name, self.compute = name, compute
        cfg, cfg_r = _cfgs(name, compute, **changes)
        self.cfg = cfg
        rng = np.random.default_rng(seed)
        tree = _weights(cfg_r, compute, rng)
        toks = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
        nxt = rng.integers(0, cfg.vocab, (B, 1)).astype(np.int32)
        frames = (rng.standard_normal((B, cfg.n_audio_frames, cfg.d_model))
                  .astype(np.float32) if cfg.is_encdec else None)

        fwd = jax.jit(lambda p, t, f: rm.forward_train(p, cfg_r, t, frames=f))
        loss = jax.jit(lambda p, b: rm.loss_fn(p, cfg_r, b))
        pre = jax.jit(lambda p, t, c, f: rm.prefill(p, cfg_r, t, c, frames=f))
        dec = jax.jit(lambda p, t, c, q: rm.decode_step(p, cfg_r, t, c, q))
        batch = {"tokens": toks} if frames is None else {"tokens": toks,
                                                         "frames": frames}
        cache0 = rm.init_cache(cfg_r, B, S + EXTRA)
        cache_r, last_r = pre(tree, toks, cache0, frames)
        self.ref = {
            "forward": _tree_np(fwd(tree, toks, frames)),
            "loss": _tree_np(loss(tree, batch)),
            "prefill": _tree_np((cache_r, last_r)),
            "decode": _tree_np(dec(tree, nxt, cache_r, jnp.int32(S))),
            "ragged": _tree_np(dec(tree, nxt, cache_r, jnp.asarray(RAGGED))),
        }

        model = pm.params_from_reference(cfg, tree, device="cpu")
        t, n = torch.from_numpy(toks), torch.from_numpy(nxt)
        f = None if frames is None else torch.from_numpy(frames)
        tb = {"tokens": t} if f is None else {"tokens": t, "frames": f}
        cache, last = pm.prefill(model, cfg, t,
                                 pm.init_cache(cfg, B, S + EXTRA,
                                               device="cpu"), frames=f)
        self.port = {
            "forward": pm.forward_train(model, cfg, t, frames=f),
            "loss": pm.loss_fn(model, cfg, tb),
            "prefill": (_clone(cache), last),
            "decode": pm.decode_step(model, cfg, n, _clone(cache), S),
            "ragged": pm.decode_step(model, cfg, n, _clone(cache),
                                     torch.from_numpy(RAGGED)),
            "decode_0d": pm.decode_step(model, cfg, n, _clone(cache),
                                        torch.tensor(S)),
            "decode_vec": pm.decode_step(model, cfg, n, _clone(cache),
                                         torch.full((B,), S)),
        }


@pytest.fixture(scope="module", params=ATTN_ARCHS)
def f32(request):
    return Case(request.param, "float32")


@pytest.fixture(scope="module", params=BF16_ARCHS)
def bf16(request):
    return Case(request.param, "bfloat16")


def _close(got, want, rel: float) -> None:
    got, want = _np(got), np.asarray(want, np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = rel * max(1.0, float(np.abs(want).max()))
    err = float(np.abs(got - want).max())
    assert err <= scale, (err, scale)


def _close_cache(got: dict, want: dict, rel: float) -> None:
    """Every bf16 cache tensor within one bf16 step at its largest
    magnitude (2^-8·max|ref|, the storage's resolution), and at most 1e-3
    of its elements past the bound (rounding flips)."""
    gl, wl = jax.tree.leaves(_tree_np(got)), jax.tree.leaves(want)
    assert len(gl) == len(wl)
    for g, w in zip(gl, wl):
        assert g.shape == w.shape, (g.shape, w.shape)
        if not w.size:
            continue
        top = float(np.abs(w).max())
        bound = rel * max(1.0, top)
        diff = np.abs(g - w)
        assert diff.max() <= max(bound, top / 256), (diff.max(), top)
        assert (diff > bound).sum() <= 1e-3 * w.size


def _check_forward(c: Case, rel):
    (lg, aux), (lw, auxw) = c.port["forward"], c.ref["forward"]
    assert lg.shape == (B, S, c.cfg.vocab_padded)
    _close(lg, lw, rel)
    for k in auxw:
        _close(aux[k], auxw[k], rel)


def _check_loss(c: Case, rel):
    (loss, m), (lw, mw) = c.port["loss"], c.ref["loss"]
    assert set(m) == set(mw)
    _close(loss, lw, rel)
    for k in mw:
        _close(m[k], mw[k], rel)


def _check_prefill(c: Case, rel):
    (cache, last), (cw, lw) = c.port["prefill"], c.ref["prefill"]
    assert last.shape == (B, 1, c.cfg.vocab_padded)
    _close(last, lw, rel)
    _close_cache(cache, cw, rel)


def _check_decode(c: Case, rel, which: str):
    (lg, cache), (lw, cw) = c.port[which], c.ref[which]
    assert lg.shape == (B, c.cfg.vocab_padded)
    _close(lg, lw, rel)
    _close_cache(cache, cw, rel)


def test_forward_train(f32):
    _check_forward(f32, BOUND["float32"])


def test_loss_fn(f32):
    _check_loss(f32, BOUND["float32"])


def test_prefill(f32):
    _check_prefill(f32, BOUND["float32"])


@pytest.mark.parametrize("which", ["decode", "ragged"])
def test_decode_step(f32, which):
    _check_decode(f32, BOUND["float32"], which)


def test_bf16_forward_and_loss(bf16):
    _check_forward(bf16, BOUND["bfloat16"])
    _check_loss(bf16, BOUND["bfloat16"])


def test_bf16_prefill_and_decode(bf16):
    _check_prefill(bf16, BOUND["bfloat16"])
    _check_decode(bf16, BOUND["bfloat16"], "decode")
    _check_decode(bf16, BOUND["bfloat16"], "ragged")


# --------------------------------------------------------------------- #
# MoE at bfloat16: top-k routing is discontinuous, and where a token's
# k-th and (k+1)-th experts are within bf16 rounding of each other the two
# packages may choose differently; every later token of that row then
# differs through attention.  So the routing is read from both runs and
# the logits are held where the routing agreed.
# --------------------------------------------------------------------- #
def _traced(fn, calls: list):
    """``fn`` jitted, returning also the ``(probs, experts)`` of every
    ``lax.top_k`` the reference's MoE made while it was traced."""
    def run(*args):
        calls.clear()
        out = fn(*args)
        return out, [(a[0], o[1]) for n, a, o in calls if n == "lax.top_k"]
    return jax.jit(run)


def _bf16_np(t: torch.Tensor) -> np.ndarray:
    """A bf16 tensor as numpy bfloat16 (the same bits)."""
    return t.view(torch.int16).numpy().view(jnp.bfloat16)


class MoECase:
    """qwen3-moe-30b-a3b reduced at bfloat16 (capacity factor 64): the
    reference run layer by layer through its own block functions
    (``_attn_block_train`` / ``_prefill`` / ``_decode``, the bodies of its
    layer scans), each jitted with its routing returned; the port under
    ``record_routing``.  Both decodes start from the port's prefill cache,
    so a decode step is compared on the same inputs."""

    def __init__(self, seed: int = 0):
        cfg, cfg_r = _cfgs(BF16_MOE, "bfloat16")
        self.cfg = cfg
        rng = np.random.default_rng(seed)
        tree = _weights(cfg_r, "bfloat16", rng)
        toks = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
        nxt = rng.integers(0, cfg.vocab, (B, 1)).astype(np.int32)
        L = cfg.n_layers

        # the port
        model = pm.params_from_reference(cfg, tree, device="cpu")
        t, n = torch.from_numpy(toks), torch.from_numpy(nxt)
        self.port, self.port_routes = {}, {}
        with pmoe.record_routing() as log:
            self.port["forward"] = pm.forward_train(model, cfg, t)
        self.port_routes["forward"] = log
        with pmoe.record_routing() as log:
            cache, last = pm.prefill(model, cfg, t, pm.init_cache(
                cfg, B, S + EXTRA, device="cpu"))
        self.port["prefill"] = (_clone(cache), last)
        self.port_routes["prefill"] = log
        for which, pos in (("decode", S), ("ragged", torch.from_numpy(RAGGED))):
            with pmoe.record_routing() as log:
                self.port[which] = pm.decode_step(model, cfg, n,
                                                  _clone(cache), pos)
            self.port_routes[which] = log

        # the reference, block by block
        calls = []
        saved, rmoe.jax = rmoe.jax, Spy(jax, calls)
        try:
            train = _traced(lambda bp, x: rm._attn_block_train(bp, cfg_r, x),
                            calls)
            pre = _traced(lambda bp, x, kv: rm._attn_block_prefill(
                bp, cfg_r, x, kv), calls)
            dec = _traced(lambda bp, x, kv, q: rm._attn_block_decode(
                bp, cfg_r, x, kv, q), calls)
            layer = [jax.tree.map(lambda a, i=i: a[i], tree["blocks"])
                     for i in range(L)]
            self.ref, self.ref_routes = {}, {}

            x, lb, rz, routes = rm._embed(tree, cfg_r, toks), 0.0, 0.0, []
            for i in range(L):
                (x, aux), tk = train(layer[i], x)
                lb, rz = lb + aux["load_balance_loss"], rz + aux["router_z_loss"]
                routes += tk
            self.ref["forward"] = _tree_np((rm._unembed(tree, cfg_r, x),
                                            {"load_balance_loss": lb / L,
                                             "router_z_loss": rz / L}))
            self.ref_routes["forward"] = _tree_np(routes)

            c0 = rm.init_cache(cfg_r, B, S + EXTRA)["kv"]
            x, kvs, routes = rm._embed(tree, cfg_r, toks), [], []
            for i in range(L):
                (x, kv), tk = pre(layer[i], x, {"k": c0["k"][i],
                                                "v": c0["v"][i]})
                kvs.append(kv)
                routes += tk
            stacked = {k: jnp.stack([kv[k] for kv in kvs]) for k in "kv"}
            self.ref["prefill"] = _tree_np((
                {"kv": stacked}, rm._unembed(tree, cfg_r, x[:, -1:])))
            self.ref_routes["prefill"] = _tree_np(routes)

            port_kv = {k: _bf16_np(v) for k, v in cache["kv"].items()}
            for which, pos in (("decode", jnp.int32(S)),
                               ("ragged", jnp.asarray(RAGGED))):
                x, kvs, routes = rm._embed(tree, cfg_r, nxt), [], []
                for i in range(L):
                    (x, kv), tk = dec(layer[i], x, {k: port_kv[k][i]
                                                    for k in "kv"}, pos)
                    kvs.append(kv)
                    routes += tk
                stacked = {k: jnp.stack([kv[k] for kv in kvs]) for k in "kv"}
                self.ref[which] = _tree_np((
                    rm._unembed(tree, cfg_r, x)[:, 0], {"kv": stacked}))
                self.ref_routes[which] = _tree_np(routes)
        finally:
            rmoe.jax = saved

    def divergence(self, which: str) -> list:
        """Per row: ``None`` or the first ``(token, layer)`` routed
        differently; each such swap asserted to be a near-tie."""
        K = self.cfg.moe.top_k
        ref = self.ref_routes[which]
        got = [r.gate_idx.numpy() for r in self.port_routes[which]]
        out = pmoe.first_divergence([idx for _, idx in ref], got)
        for b, hit in enumerate(out):
            if hit is not None:
                tok, layer = hit
                gap = pmoe.top_k_gap(ref[layer][0][b, tok], K)
                assert gap <= pmoe.NEAR_TIE, (which, b, tok, layer, gap)
        return out


@pytest.fixture(scope="module")
def moe_bf16():
    return MoECase()


def test_bf16_moe_forward(moe_bf16):
    """Logits within the bf16 bound at every position before its row's
    first routing swap (each row keeps its first token), and the aux
    losses."""
    c, rel = moe_bf16, BOUND["bfloat16"]
    first = c.divergence("forward")
    (lg, aux), (lw, auxw) = c.port["forward"], c.ref["forward"]
    keep = np.ones((B, S), bool)
    for b, hit in enumerate(first):
        if hit is not None:
            keep[b, hit[0]:] = False
    assert keep[:, 0].all(), first
    _close(_np(lg)[keep], lw[keep], rel)
    for k in auxw:
        _close(aux[k], auxw[k], rel)


def test_bf16_moe_prefill(moe_bf16):
    """The caches at every position before the row's first swap (all
    layers), and the last logits of a row with none."""
    c, rel = moe_bf16, BOUND["bfloat16"]
    first = c.divergence("prefill")
    (cache, last), (cw, lw) = c.port["prefill"], c.ref["prefill"]
    for b, hit in enumerate(first):
        end = S if hit is None else hit[0]
        _close_cache({k: v[:, b, :end] for k, v in cache["kv"].items()},
                     {k: v[:, b, :end] for k, v in cw["kv"].items()}, rel)
        if hit is None:
            _close(last[b], lw[b], rel)


@pytest.mark.parametrize("which", ["decode", "ragged"])
def test_bf16_moe_decode(moe_bf16, which):
    """From the same cache: the logits and the cache of every row whose
    one token was routed alike in every layer (at least one row)."""
    c, rel = moe_bf16, BOUND["bfloat16"]
    first = c.divergence(which)
    (lg, cache), (lw, cw) = c.port[which], c.ref[which]
    rows = [b for b, hit in enumerate(first) if hit is None]
    assert rows, first
    for b in rows:
        _close(lg[b], lw[b], rel)
    _close_cache({k: v[:, rows] for k, v in cache["kv"].items()},
                 {k: v[:, rows] for k, v in cw["kv"].items()}, rel)


def test_prefill_matches_forward_train(f32):
    """The reference's property, on the port: prefill's last logits are
    the training forward's last position (``atol 1e-5``)."""
    last = f32.port["prefill"][1][:, 0]
    full = f32.port["forward"][0][:, -1]
    np.testing.assert_allclose(_np(last), _np(full), atol=1e-5)


def test_scalar_and_vector_pos_same_bits(f32):
    lg, cache = f32.port["decode"]
    for which in ("decode_0d", "decode_vec"):
        lg2, cache2 = f32.port[which]
        assert torch.equal(lg, lg2)
        for a, b in zip(jax.tree.leaves(cache), jax.tree.leaves(cache2)):
            assert torch.equal(a, b)


@pytest.mark.parametrize("name", ATTN_ARCHS + RECURRENT)
def test_init_params_tree(name):
    """``init_params`` on the CPU has the reference's tree: each leaf
    (a stacked leaf per layer) is one port parameter of its shape, none
    left over; ``params_from_reference`` refuses a tree with a leaf
    missing or one too many."""
    cfg, cfg_r = _cfgs(name, "float32")
    shapes = _ref_shapes(cfg_r)
    want = {}
    for path, s in jax.tree_util.tree_flatten_with_path(shapes)[0]:
        head, *rest = [str(p.key) for p in path]
        if head in STACKS:
            for i in range(s.shape[0]):
                want[".".join([head, str(i), *rest])] = tuple(s.shape[1:])
        else:
            want[".".join([head, *rest])] = tuple(s.shape)
    model = pm.init_params(cfg, torch.Generator().manual_seed(0),
                           device="cpu")
    got = {k: tuple(v.shape) for k, v in model.named_parameters()}
    assert got == want
    assert all(v.dtype == torch.float32 for v in model.parameters())

    tree = _tree(shapes, np.random.default_rng(1))
    missing = jax.tree.map(lambda a: a, tree)
    missing.pop("final_norm")
    with pytest.raises(KeyError):
        pm.params_from_reference(cfg, missing, device="cpu")
    extra = dict(tree, stray=np.zeros(3, np.float32))
    with pytest.raises(KeyError):
        pm.params_from_reference(cfg, extra, device="cpu")


@pytest.mark.parametrize("name", ["qwen3-moe-30b-a3b", "whisper-large-v3",
                                  *RECURRENT])
def test_init_params_distribution(name):
    """The port draws each leaf as the reference does: ones and zeros
    exactly, every other fixed vector (the recurrent blocks' gate biases
    -2 / +3 and ``b_gates`` blocks, the decay logs ``log(linspace(1,
    16))``) within one float32 step (the two linspaces round apart on
    some heads), and each weight with the reference's spread (std) within
    5% and its bound (max |w|, two scales: the normal is cut at ±2) within
    2% (leaves of at least 4,096 entries)."""
    cfg, cfg_r = _cfgs(name, "float32")
    ref = _tree_np(jax.jit(lambda k: rm.init_params(k, cfg_r))(
        jax.random.PRNGKey(0)))
    model = pm.init_params(cfg, torch.Generator().manual_seed(0),
                           device="cpu")
    params = dict(model.named_parameters())
    for path, w in jax.tree_util.tree_flatten_with_path(ref)[0]:
        head, *rest = [str(p.key) for p in path]
        stacked = head in STACKS
        if stacked:
            g = torch.stack([params[".".join([head, str(i), *rest])]
                             for i in range(w.shape[0])]).numpy()
        else:
            g = params[".".join([head, *rest])].numpy()
        if np.all(w == w.flat[0]):
            np.testing.assert_array_equal(g, w)
        elif w.ndim - stacked == 1:
            np.testing.assert_allclose(g, w, rtol=2 ** -23, atol=0)
        elif w.size >= 4096:
            assert abs(g.std() / w.std() - 1) < 0.05, path
            assert abs(np.abs(g).max() / np.abs(w).max() - 1) < 0.02, path


def test_entry_points_default_to_the_card():
    """Without ``device`` the entry points place tensors on ``cuda``: on
    this CPU-only machine they fail rather than fall back (an attention
    arch and both recurrent ones, whose caches are their states)."""
    for name in ("qwen2.5-3b", *RECURRENT):
        cfg = get_config(name).reduced()
        for call in (lambda: pm.init_cache(cfg, 1, 4),
                     lambda: pm.init_params(cfg, torch.Generator())):
            with pytest.raises((AssertionError, RuntimeError)):
                call()
