"""The port's model layers against the JAX package's, on the CPU.

``repro_torch.models.{common,mlp,moe}`` against ``repro.models.*`` on the
same inputs, made with numpy from a seed and handed to both.  Weights are
numpy draws too, biases and norm weights included (non-trivial, so a
dropped bias or a misplaced norm shows).

Tolerances, with the largest error measured on this CPU beside each:
  * float32: ``1e-5·max(1, max|ref|)`` (the two packages sum in another
    order; largest 3.8e-7, in ``flash_attention``);
  * bfloat16: ``2e-2·max(1, max|ref|)``, the reference's own bf16 bound
    (outputs a rounding step apart where the float32 values straddle a
    bf16 boundary; largest 6.5e-3, in ``swiglu``);
  * ``gelu_mlp`` is held tightly enough that PyTorch's default, exact GELU
    fails it (exact against the reference: 1.2e-4, 12x the bound; the
    tanh form 1.5e-7);
  * MoE routing exactly: the chosen experts, each (token, k)'s queue
    position and the kept / dropped pattern at capacity factor 1.25, read
    from the reference's own ``top_k`` / ``one_hot`` calls.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from _jax_spy import Spy
from repro.configs import get_config as ref_config
from repro.models import common as rc
from repro.models import mlp as rmlp
from repro.models import moe as rmoe
from repro_torch.configs import get_config
from repro_torch.models import common as pc
from repro_torch.models import mlp as pmlp
from repro_torch.models import moe as pmoe

DTYPES = {"f32": (torch.float32, jnp.float32, 1e-5),
          "bf16": (torch.bfloat16, jnp.bfloat16, 2e-2)}


def _t(a, dtype=torch.float32) -> torch.Tensor:
    return torch.from_numpy(np.array(a)).to(dtype)


def _j(a, dtype=jnp.float32):
    return jnp.asarray(np.asarray(a), dtype)


def _f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _close(got, want, rel: float) -> float:
    """Assert ``max|got - want| <= rel·max(1, max|want|)``; return the
    error relative to that scale."""
    got, want = _f32(got), _f32(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = max(1.0, float(np.abs(want).max()))
    err = float(np.abs(got - want).max()) / scale
    assert err <= rel, (err, rel)
    return err


def _fill(module: torch.nn.Module, tree: dict) -> None:
    """Copy the numpy leaves of a flat reference dict into the module's
    parameters of the same names (all of them, no more)."""
    params = dict(module.named_parameters())
    assert set(params) == set(tree)
    for k, a in tree.items():
        params[k].copy_(_t(a))


# --------------------------------------------------------------------- #
# norms and RoPE
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("dt", DTYPES)
def test_rms_norm(dt):
    tdt, jdt, rel = DTYPES[dt]
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 16, 128)) * 3
    w = 1 + 0.1 * rng.standard_normal(128)
    _close(pc.rms_norm(_t(x, tdt), _t(w), 1e-5),
           rc.rms_norm(_j(x, jdt), _j(w), 1e-5), rel)


@pytest.mark.parametrize("dt", DTYPES)
def test_layer_norm(dt):
    tdt, jdt, rel = DTYPES[dt]
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 16, 128)) * 3 + 1
    w = 1 + 0.1 * rng.standard_normal(128)
    b = 0.1 * rng.standard_normal(128)
    _close(pc.layer_norm(_t(x, tdt), _t(w), _t(b), 1e-5),
           rc.layer_norm(_j(x, jdt), _j(w), _j(b), 1e-5), rel)


@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("theta", [1e4, 1e6])
@pytest.mark.parametrize("positions", ["prefill", "decode"])
def test_rope(dt, theta, positions):
    """``positions`` (1, S) as prefill passes them, or (B, 1) per row as
    decode does."""
    tdt, jdt, rel = DTYPES[dt]
    rng = np.random.default_rng(2)
    S = 16 if positions == "prefill" else 1
    x = rng.standard_normal((2, S, 4, 32))
    pos = (np.arange(S)[None] if positions == "prefill"
           else np.array([[37], [500]])).astype(np.int32)
    _close(pc.rope(_t(x, tdt), torch.from_numpy(pos), theta),
           rc.rope(_j(x, jdt), jnp.asarray(pos), theta), rel)


# --------------------------------------------------------------------- #
# feed-forward blocks
# --------------------------------------------------------------------- #
def _weights(rng, shapes: dict) -> dict:
    return {k: rng.standard_normal(s) / np.sqrt(s[0]) if len(s) > 1
            else 0.1 * rng.standard_normal(s) for k, s in shapes.items()}


@pytest.mark.parametrize("dt", DTYPES)
def test_swiglu(dt):
    tdt, jdt, rel = DTYPES[dt]
    rng = np.random.default_rng(3)
    d, f = 128, 256
    w = _weights(rng, {"w_gate": (d, f), "w_up": (d, f), "w_down": (f, d)})
    x = rng.standard_normal((2, 16, d))
    p = pmlp.SwiGLU(d, f, device="cpu")
    _fill(p, w)
    _close(pmlp.swiglu(p, _t(x, tdt)),
           rmlp.swiglu({k: _j(v) for k, v in w.items()}, _j(x, jdt)), rel)


@pytest.mark.parametrize("dt", DTYPES)
def test_gelu_mlp(dt):
    """The tanh GELU, as ``jax.nn.gelu``'s default: in float32 the exact
    form (PyTorch's default) must fail the bound."""
    tdt, jdt, rel = DTYPES[dt]
    rng = np.random.default_rng(4)
    d, f = 128, 256
    w = _weights(rng, {"w_up": (d, f), "b_up": (f,), "w_down": (f, d),
                       "b_down": (d,)})
    x = rng.standard_normal((2, 16, d)) * 2
    p = pmlp.GeluMLP(d, f, device="cpu")
    _fill(p, w)
    want = rmlp.gelu_mlp({k: _j(v) for k, v in w.items()}, _j(x, jdt))
    _close(pmlp.gelu_mlp(p, _t(x, tdt)), want, rel)
    if dt == "f32":
        xt = _t(x)
        h = F.gelu(xt @ p.w_up + p.b_up)
        exact = h @ p.w_down + p.b_down
        with pytest.raises(AssertionError):
            _close(exact, want, rel)


# --------------------------------------------------------------------- #
# attention
# --------------------------------------------------------------------- #
FLASH_CASES = {
    # the reference's three (tests/test_models.py)
    "64-mha": (64, 64, 4, 4, 16, 16, 0),
    "128-gqa": (128, 128, 8, 2, 32, 64, 0),
    "64-one-tile": (64, 64, 6, 3, 64, 64, 0),
    # queries at the end of a longer key range
    "q-offset": (32, 64, 4, 2, 16, 16, 32),
    # 45 has no divisor 16: the picker takes 15 (3 x 3 tiles)
    "non-dividing": (45, 45, 4, 2, 16, 16, 0),
}


@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("case", FLASH_CASES)
def test_flash_attention(case, dt):
    tdt, jdt, rel = DTYPES[dt]
    Sq, Sk, H, KV, cq, ck, off = FLASH_CASES[case]
    rng = np.random.default_rng(5)
    dh = 16
    q = rng.standard_normal((2, Sq, H, dh)) * 2
    k = rng.standard_normal((2, Sk, KV, dh))
    v = rng.standard_normal((2, Sk, KV, dh))
    got = pc.flash_attention(_t(q, tdt), _t(k, tdt), _t(v, tdt), causal=True,
                             q_offset=off, chunk_q=cq, chunk_k=ck)
    want = rc.flash_attention(_j(q, jdt), _j(k, jdt), _j(v, jdt),
                              causal=True, q_offset=off, chunk_q=cq,
                              chunk_k=ck)
    assert got.dtype == tdt
    _close(got, want, rel)


@pytest.mark.parametrize("S,want,chunk", [(513, 512, 171), (1500, 512, 500),
                                          (45, 16, 15), (64, 16, 16),
                                          (4096, 512, 512), (7, 1024, 7)])
def test_chunk_picker(S, want, chunk):
    assert pc._pick_chunk(S, want) == chunk


def test_tile_state_matches_reference():
    for causal in (True, False):
        for off in (0, 16, 40):
            for i in range(4):
                for j in range(6):
                    assert (pc._tile_state(i, j, 16, 12, off, causal)
                            == rc._tile_state(i, j, 16, 12, off, causal))


@pytest.mark.parametrize("dt", DTYPES)
def test_decode_attention_ragged(dt):
    tdt, jdt, rel = DTYPES[dt]
    rng = np.random.default_rng(6)
    B, S, H, KV, dh = 3, 32, 8, 4, 16
    q = rng.standard_normal((B, 1, H, dh))
    kc = rng.standard_normal((B, S, KV, dh))
    vc = rng.standard_normal((B, S, KV, dh))
    pos = np.array([5, 17, 32], np.int32)
    got = pc.decode_attention(_t(q, tdt), _t(kc, tdt), _t(vc, tdt),
                              torch.from_numpy(pos))
    want = rc.decode_attention(_j(q, jdt), _j(kc, jdt), _j(vc, jdt),
                               jnp.asarray(pos))
    assert got.dtype == tdt
    _close(got, want, rel)


# --------------------------------------------------------------------- #
# mixture of experts
# --------------------------------------------------------------------- #
def _moe_case(name, group_size, capacity_factor, seed):
    cfg = get_config(name).reduced()
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, group_size=group_size, capacity_factor=capacity_factor))
    rcfg = dataclasses.replace(ref_config(name).reduced(), moe=cfg.moe)
    m, d = cfg.moe, cfg.d_model
    rng = np.random.default_rng(seed)
    w = _weights(rng, {"router": (d, m.n_experts),
                       "w_gate": (m.n_experts, d, m.d_expert),
                       "w_up": (m.n_experts, d, m.d_expert),
                       "w_down": (m.n_experts, m.d_expert, d)})
    for k in ("w_gate", "w_up"):
        w[k] *= np.sqrt(m.n_experts / d)       # fan-in d, not E
    w["w_down"] *= np.sqrt(m.n_experts / m.d_expert)
    x = rng.standard_normal((2, 32, d))
    p = pmoe.MoE(cfg, device="cpu")
    _fill(p, w)
    return cfg, rcfg, p, {k: _j(v) for k, v in w.items()}, x


@pytest.mark.parametrize("name", ["qwen3-moe-30b-a3b",
                                  "granite-moe-3b-a800m"])
@pytest.mark.parametrize("group_size", [512, 16])
def test_moe_apply(name, group_size, monkeypatch):
    """``y`` and both auxiliary losses in float32, and the routing exactly,
    at capacity factor 1.25 (some (token, k) pairs dropped).  Group size
    16 regroups the 2 x 32 tokens into four groups of 16."""
    cfg, rcfg, p, rp, x = _moe_case(name, group_size, 1.25, seed=7)
    calls = []
    monkeypatch.setattr(rmoe, "jax", Spy(jax, calls))
    want_y, want_aux = rmoe.moe_apply(rp, rcfg, _j(x))
    (_, _, (vals, idx)), (_, (idx2, E), _), (_, (pos, C), _) = calls
    got_y, got_aux = pmoe.moe_apply(p, cfg, _t(x))
    _close(got_y, want_y, 1e-5)
    for k in ("load_balance_loss", "router_z_loss"):
        _close(got_aux[k], want_aux[k], 1e-5)

    r = pmoe.route(p, cfg, _t(x))
    keep = (np.asarray(pos) < C) & (np.asarray(vals) > 0)
    assert r.C == C and E == cfg.moe.n_experts
    np.testing.assert_array_equal(r.gate_idx.numpy(), np.asarray(idx))
    np.testing.assert_array_equal(r.pos.numpy(), np.asarray(pos))
    np.testing.assert_array_equal(r.keep.numpy(), keep)
    assert 0 < (~keep).sum() < keep.size / 2      # drops, not a collapse


@pytest.mark.parametrize("dt", DTYPES)
def test_moe_apply_dtypes(dt):
    """At capacity factor 64 nothing drops; both dtypes within their
    bounds."""
    tdt, jdt, rel = DTYPES[dt]
    cfg, rcfg, p, rp, x = _moe_case("qwen3-moe-30b-a3b", 512, 64.0, seed=8)
    want_y, _ = rmoe.moe_apply(rp, rcfg, _j(x, jdt))
    got_y, _ = pmoe.moe_apply(p, cfg, _t(x, tdt))
    assert got_y.dtype == tdt
    _close(got_y, want_y, rel)
    assert bool(pmoe.route(p, cfg, _t(x, tdt)).keep.all())


def test_moe_decode_capacity_is_one():
    """One token a row: no regrouping, capacity ``max(1, int(1·K/E·cf))``
    = 1, so each expert keeps the first (token, k) of its queue."""
    cfg, _, p, _, x = _moe_case("qwen3-moe-30b-a3b", 512, 1.25, seed=9)
    r = pmoe.route(p, cfg, _t(x[:, :1]))
    assert r.C == 1 and r.x.shape == (2, 1, cfg.d_model)
    assert bool(r.keep.all())                   # top-k experts are distinct
