"""The port's recurrent mixers against the JAX package's, on the CPU.

``repro_torch.models.{mamba2,xlstm}`` against ``repro.models.{mamba2,
xlstm}`` on the same inputs, made with numpy from a seed and handed to
both.  Block weights are numpy draws in the shapes of the reference's
``init_*`` (gate biases, decay rates and norm weights drawn too), at the
``reduced()`` widths of xlstm-350m (d 128, 4 heads of 64) and zamba2-1.2b
(d 128, 4 SSD heads of 64, state 16).

Tolerances, with the largest error measured on this CPU beside each:
  * the chunked scans against the reference's token-by-token oracles at
    the reference test's chunks (SSD 16, 32, 96, 25; mLSTM 16, 40, 80,
    23: padding included) and its ``atol 5e-4`` (largest 3.0e-5, the
    mLSTM at chunk 80);
  * float32 otherwise: ``1e-4·max(1, max|ref|)`` (largest 3.9e-6, the
    mLSTM chunked at 80 against the reference's);
  * bfloat16: ``2e-2·max(1, max|ref|)``, the reference's own bf16 bound,
    or for a whole mixer ``2δ`` where that is larger, δ being the
    reference's own bf16 error on that output against its float32 run on
    the same inputs: two bf16 evaluations of one function, each δ from
    the float32 answer, may be 2δ apart.  The mamba mixer's RMS norm over
    rows of the gated SSD output carries δ = 5.9e-2 at these weights
    (bound 0.118; measured 1.6e-2, where 2e-2 alone would hold this seed
    and fail others); every other bf16 output is under 2e-2 (largest
    6.8e-3, the mamba mixer's final states).  Part of the spread is the
    reference's: its bf16 sigmoid is not the rounded float32 one but a
    bf16 step off it on many inputs, and a bf16 SiLU with it;
  * the mamba conv state, bfloat16 storage at float32 compute, within
    one bf16 step at its largest magnitude (2^-8·max|ref|).
The scans run in the same order with and without ``opt_einsum``: same
bits.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_config
from repro.models import mamba2 as rm2
from repro.models import xlstm as rxl
from repro_torch.configs import get_config
from repro_torch.models import mamba2 as pm2
from repro_torch.models import model as pmodel
from repro_torch.models import xlstm as pxl

DTYPES = {"f32": (torch.float32, jnp.float32, 1e-4),
          "bf16": (torch.bfloat16, jnp.bfloat16, 2e-2)}
COMPUTE = {"f32": "float32", "bf16": "bfloat16"}
ORACLE_ATOL = 5e-4
B, S = 2, 32


def _t(a, dtype=torch.float32) -> torch.Tensor:
    return torch.from_numpy(np.array(a, np.float32)).to(dtype)


def _j(a, dtype=jnp.float32):
    return jnp.asarray(np.asarray(a, np.float32), dtype)


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _close(got, want, rel: float) -> float:
    """Assert ``max|got - want| <= rel·max(1, max|want|)``; return the
    error relative to that scale."""
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = max(1.0, float(np.abs(want).max()))
    err = float(np.abs(got - want).max()) / scale
    assert err <= rel, (err, rel)
    return err


def _cfg(name: str, compute: str = "float32"):
    """(port, reference) reduced configs."""
    import dataclasses
    return tuple(dataclasses.replace(get(name).reduced(),
                                     compute_dtype=compute)
                 for get in (get_config, ref_config))


def _weights(init, cfg_r, rng) -> dict:
    """numpy leaves in the shapes of the reference's ``init(key, cfg)``:
    matrices at their fan-in scale, vectors around one (norms) or zero
    (biases, gates, decay logs)."""
    shapes = jax.eval_shape(lambda k: init(k, cfg_r), jax.random.PRNGKey(0))
    out = {}
    for name, s in shapes.items():
        if len(s.shape) == 1:
            base = 1.0 if "norm" in name else 0.0
            out[name] = (base + 0.1 * rng.standard_normal(s.shape)).astype(
                np.float32)
        else:
            out[name] = (rng.standard_normal(s.shape)
                         / np.sqrt(s.shape[0])).astype(np.float32)
    return out


def _module(init, cfg, tree: dict) -> torch.nn.Module:
    """The port's block (``init`` with no generator: empty) filled with
    ``tree``'s leaves, each of its parameters exactly once."""
    mod = init(None, cfg, device="cpu")
    params = dict(mod.named_parameters())
    assert set(params) == set(tree)
    for k, a in tree.items():
        params[k].copy_(_t(a))
    return mod


# --------------------------------------------------------------------- #
# the chunked scans
# --------------------------------------------------------------------- #
def _ssd_inputs(seed: int):
    """The reference test's SSD shapes and draws, from numpy."""
    rng = np.random.default_rng(seed)
    Bb, Sq, H, P, N = 2, 96, 3, 8, 5
    xh = rng.standard_normal((Bb, Sq, H, P))
    dt = np.logaddexp(rng.standard_normal((Bb, Sq, H)), 0.0)
    a = -np.exp(rng.standard_normal(H) * 0.5)
    Bm = rng.standard_normal((Bb, Sq, N))
    Cm = rng.standard_normal((Bb, Sq, N))
    h0 = rng.standard_normal((Bb, H, P, N))
    return [np.asarray(v, np.float32) for v in (xh, dt, a, Bm, Cm, h0)]


def _mlstm_inputs(seed: int):
    """The reference test's mLSTM shapes and draws, from numpy."""
    rng = np.random.default_rng(seed)
    Bb, Sq, H, dh = 2, 80, 3, 8
    q = rng.standard_normal((Bb, Sq, H, dh))
    k = rng.standard_normal((Bb, Sq, H, dh)) * dh ** -0.5
    v = rng.standard_normal((Bb, Sq, H, dh))
    li = rng.standard_normal((Bb, Sq, H)) * 2 - 1
    lf = -np.logaddexp(-(rng.standard_normal((Bb, Sq, H)) + 2), 0.0)
    state = (rng.standard_normal((Bb, H, dh, dh)),
             rng.standard_normal((Bb, H, dh)),
             rng.standard_normal((Bb, H)))
    return ([np.asarray(x, np.float32) for x in (q, k, v, li, lf)],
            [np.asarray(x, np.float32) for x in state])


#: the reference's functions, jitted (eager JAX compiles op by op)
REF_SSD = jax.jit(rm2._ssd_chunked, static_argnums=5)
REF_MLSTM = jax.jit(rxl._mlstm_chunked, static_argnums=5)
REF_SSD_SCAN = jax.jit(rm2.mamba2_ref_scan)
REF_MLSTM_SCAN = jax.jit(rxl.mlstm_ref_scan)


@pytest.fixture(scope="module")
def ssd_oracle():
    xh, dt, a, Bm, Cm, _ = _ssd_inputs(0)
    return REF_SSD_SCAN(*map(_j, (xh, dt, a, Bm, Cm)))


@pytest.fixture(scope="module")
def mlstm_oracle():
    return REF_MLSTM_SCAN(*map(_j, _mlstm_inputs(1)[0]))


@pytest.mark.parametrize("chunk", [16, 32, 96, 25])
def test_ssd_chunked_matches_oracle(chunk, ssd_oracle):
    """Against the reference's ``mamba2_ref_scan`` (atol 5e-4: largest
    2.6e-5, chunk 96), and against the reference's ``_ssd_chunked`` at
    the same chunk from zero and from a drawn ``h0`` (largest 2.2e-6)."""
    xh, dt, a, Bm, Cm, h0 = _ssd_inputs(0)
    yr, hr = ssd_oracle
    y, hf = pm2._ssd_chunked(*map(_t, (xh, dt, a, Bm, Cm)), chunk)
    np.testing.assert_allclose(_np(y), _np(yr), atol=ORACLE_ATOL)
    np.testing.assert_allclose(_np(hf), _np(hr), atol=ORACLE_ATOL)
    for h in (None, h0):
        want = REF_SSD(*map(_j, (xh, dt, a, Bm, Cm)), chunk,
                       None if h is None else _j(h))
        got = pm2._ssd_chunked(*map(_t, (xh, dt, a, Bm, Cm)), chunk,
                               h0=None if h is None else _t(h))
        for g, w in zip(got, want):
            _close(g, w, DTYPES["f32"][2])


@pytest.mark.parametrize("chunk", [16, 40, 80, 23])
def test_mlstm_chunked_matches_oracle(chunk, mlstm_oracle):
    """Against the reference's ``mlstm_ref_scan`` (atol 5e-4: largest
    3.0e-5, chunk 80), and against the reference's ``_mlstm_chunked`` at
    the same chunk, from zero and from a drawn ``(C, n, m)`` (largest
    3.9e-6)."""
    xs, state = _mlstm_inputs(1)
    h, _ = pxl._mlstm_chunked(*map(_t, xs), chunk)
    np.testing.assert_allclose(_np(h), _np(mlstm_oracle), atol=ORACLE_ATOL)
    for st in (None, state):
        hw, sw = REF_MLSTM(*map(_j, xs), chunk,
                           None if st is None else tuple(map(_j, st)))
        hg, sg = pxl._mlstm_chunked(*map(_t, xs), chunk,
                                    None if st is None else
                                    tuple(map(_t, st)))
        _close(hg, hw, DTYPES["f32"][2])
        for g, w in zip(sg, sw):
            _close(g, w, DTYPES["f32"][2])


def test_ref_scans_match_reference():
    """The port's token-by-token oracles against the reference's
    (float32: largest 1.1e-7)."""
    xh, dt, a, Bm, Cm, h0 = _ssd_inputs(2)
    yr, hr = REF_SSD_SCAN(*map(_j, (xh, dt, a, Bm, Cm)), _j(h0))
    y, h = pm2.mamba2_ref_scan(*map(_t, (xh, dt, a, Bm, Cm)), h0=_t(h0))
    _close(y, yr, DTYPES["f32"][2])
    _close(h, hr, DTYPES["f32"][2])
    xs, _ = _mlstm_inputs(3)
    _close(pxl.mlstm_ref_scan(*map(_t, xs)),
           REF_MLSTM_SCAN(*map(_j, xs)), DTYPES["f32"][2])


def _scan_runs(which: str):
    """A callable giving the tensors of one run of ``which``."""
    if which == "ssd":
        xh, dt, a, Bm, Cm, h0 = _ssd_inputs(4)
        return lambda: pm2._ssd_chunked(*map(_t, (xh, dt, a, Bm, Cm)), 25,
                                        h0=_t(h0))
    if which == "mlstm":
        xs, st = _mlstm_inputs(5)
        return lambda: (lambda h, s: (h, *s))(*pxl._mlstm_chunked(
            *map(_t, xs), 23, tuple(map(_t, st))))
    cfg = get_config("xlstm-350m").reduced()
    model = pmodel.init_params(cfg, torch.Generator().manual_seed(0),
                               device="cpu")
    toks = torch.from_numpy(np.random.default_rng(6).integers(
        0, cfg.vocab, (B, S)))

    def prefill():
        cache, last = pmodel.prefill(model, cfg, toks, pmodel.init_cache(
            cfg, B, S, device="cpu"))
        return [last] + [t for g in cache.values() for t in g.values()]
    return prefill


@pytest.mark.parametrize("which", ["ssd", "mlstm", "xlstm_prefill"])
def test_scans_do_not_depend_on_opt_einsum(which):
    """The card's machine has no ``opt_einsum``: with it disabled the
    scans (and a reduced xlstm prefill) give the same bits as with it."""
    run = _scan_runs(which)
    saved = torch.backends.opt_einsum.enabled
    try:
        torch.backends.opt_einsum.enabled = True
        with_opt = run()
        torch.backends.opt_einsum.enabled = False
        without = run()
    finally:
        torch.backends.opt_einsum.enabled = saved
    assert len(with_opt) == len(without)
    for a, b in zip(with_opt, without):
        assert torch.equal(a, b)


# --------------------------------------------------------------------- #
# the mamba2 mixer
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("with_state", [False, True])
def test_causal_conv(dt, with_state):
    """The shifted-product conv, from zero and from a drawn state (f32:
    largest 5.6e-8; bf16: 3.7e-3); the state is the inputs' tail, exact."""
    tdt, jdt, rel = DTYPES[dt]
    rng = np.random.default_rng(7)
    C = 48
    x = rng.standard_normal((B, S, C))
    w = rng.standard_normal((pm2.CONV_W, C)) * 0.5
    b = 0.1 * rng.standard_normal(C)
    st = rng.standard_normal((B, pm2.CONV_W - 1, C)) if with_state else None
    out_r, st_r = rm2._causal_conv(
        _j(x, jdt), _j(w), _j(b), None if st is None else _j(st, jdt))
    out_p, st_p = pm2._causal_conv(
        _t(x, tdt), _t(w), _t(b), None if st is None else _t(st, tdt))
    assert out_p.dtype == tdt
    _close(out_p, out_r, rel)
    _close(st_p, st_r, 0.0)


def _reference(fn, name: str, dt: str, *args):
    """``fn(cfg_r, *args)`` (the reference, jitted) at the test's compute
    dtype, and the bound of each of its output leaves: the dtype's, or at
    bf16 ``max(2e-2, 2δ)``, δ that leaf's distance from ``fn`` at float32
    compute on the same (bf16-rounded) inputs, relative to ``max(1,
    max|ref|)``: two bf16 evaluations of one function, each δ from the
    float32 answer, may be 2δ apart."""
    rel = DTYPES[dt][2]
    want = jax.jit(lambda *a: fn(_cfg(name, COMPUTE[dt])[1], *a))(*args)
    if dt == "f32":
        return want, jax.tree.map(lambda _: rel, want)
    wide = jax.tree.map(lambda a: a.astype(jnp.float32), args)
    want32 = jax.jit(lambda *a: fn(_cfg(name)[1], *a))(*wide)
    return want, jax.tree.map(
        lambda w, w32: max(rel, 2 * float(np.abs(_np(w) - _np(w32)).max())
                           / max(1.0, float(np.abs(_np(w)).max()))),
        want, want32)


def _close_state(got: dict, want: dict, bounds: dict) -> None:
    """Each float32 state within its bound; a bfloat16 one (the conv
    state) within its bound or one bf16 step at its magnitude."""
    assert set(got) == set(want)
    for k in want:
        rel = bounds[k]
        if got[k].dtype == torch.bfloat16:
            rel = max(rel, 2.0 ** -8)
        else:
            assert got[k].dtype == torch.float32, (k, got[k].dtype)
        _close(got[k], want[k], rel)


def _mixer(init_ref, init_port, name: str, seed: int):
    """The port's block (float32 parameters) holding a numpy draw in the
    shapes of the reference's ``init_ref``: (cfg, tree, module)."""
    cfg, cfg_r = _cfg(name)
    tree = _weights(init_ref, cfg_r, np.random.default_rng(seed))
    return cfg, jax.tree.map(_j, tree), _module(init_port, cfg, tree)


def _drawn_state(init_state, cfg, rng) -> dict:
    """A state of ``init_state``'s layout drawn from ``rng`` (normalisers
    positive), as numpy."""
    st = {k: rng.standard_normal(tuple(t.shape))
          for k, t in init_state(cfg, B, device="cpu").items()}
    if "n" in st and st["n"].ndim == 2:
        st["n"] = np.abs(st["n"])
    return st


@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("chunk", [None, 12])
def test_mamba2_train(dt, chunk):
    """The whole mixer over S = 32 in one chunk (``ssm_chunk`` 64) and in
    three with padding (12) (f32: largest 3.6e-6; bf16: 1.6e-2 of a
    0.118 bound, the states 6.8e-3), and its prefill form's final states
    (f32 SSD state, conv state in the compute dtype) against the
    reference's pieces."""
    tdt, jdt, _ = DTYPES[dt]
    name = "zamba2-1.2b"
    cfg, pj, mod = _mixer(rm2.init_mamba2, pm2.init_mamba2, name, 8)
    x = np.random.default_rng(9).standard_normal((B, S, cfg.d_model))

    def ref(c, p, x):
        d_in, nh, ns = rm2._dims(c)
        y = rm2.mamba2_train(p, c, x, chunk)
        _, xbc, dt_raw = rm2._split_in(p, c, x @ p["w_in"].astype(x.dtype))
        xbc, conv = rm2._causal_conv(xbc, p["conv_w"], p["conv_b"])
        xm, Bm, Cm = jnp.split(xbc, [d_in, d_in + ns], axis=-1)
        dtv = jax.nn.softplus(dt_raw.astype(jnp.float32) + p["dt_bias"])
        _, h = rm2._ssd_chunked(xm.reshape(B, S, nh, rm2.HEADDIM), dtv,
                                -jnp.exp(p["a_log"]), Bm, Cm,
                                chunk or c.ssm_chunk)
        return y, {"h": h, "conv": conv}
    (want, st_r), (rel, st_rel) = _reference(ref, name, dt, pj, _j(x, jdt))
    pcfg = _cfg(name, COMPUTE[dt])[0]
    y, st = pm2.mamba2_prefill(mod, pcfg, _t(x, tdt), chunk)
    assert y.dtype == tdt
    _close(y, want, rel)
    _close(pm2.mamba2_train(mod, pcfg, _t(x, tdt), chunk), y, 0.0)
    _close_state(st, st_r, st_rel)


@pytest.mark.parametrize("dt", DTYPES)
def test_mamba2_decode(dt):
    """One step from a drawn state (f32 SSD state, bf16 conv state, as
    ``init_mamba2_state`` lays them out), written in place and returned
    (f32: largest 3.8e-7; bf16: 6.2e-3)."""
    tdt, jdt, _ = DTYPES[dt]
    name = "zamba2-1.2b"
    cfg, pj, mod = _mixer(rm2.init_mamba2, pm2.init_mamba2, name, 10)
    rng = np.random.default_rng(11)
    x = rng.standard_normal((B, 1, cfg.d_model))
    drawn = _drawn_state(pm2.init_mamba2_state, cfg, rng)
    (y_r, st_r), (rel, st_rel) = _reference(
        lambda c, p, x, h, conv: rm2.mamba2_decode(
            p, c, x, {"h": h, "conv": conv.astype(jnp.bfloat16)}),
        name, dt, pj, _j(x, jdt), _j(drawn["h"]),
        _j(drawn["conv"], jnp.bfloat16))
    state = {"h": _t(drawn["h"]), "conv": _t(drawn["conv"], torch.bfloat16)}
    buffers = dict(state)
    y, out = pm2.mamba2_decode(mod, _cfg(name, COMPUTE[dt])[0],
                               _t(x, tdt), state)
    assert out is state and all(out[k] is buffers[k] for k in buffers)
    assert state["conv"].dtype == torch.bfloat16
    _close(y, y_r, rel)
    _close_state(state, st_r, st_rel)


# --------------------------------------------------------------------- #
# the xLSTM mixers
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("chunk", [None, 12])
def test_mlstm_train(dt, chunk):
    """The mLSTM block over S = 32 in one chunk and in three with padding
    (f32: largest 1.5e-6; bf16: 5.3e-3), and its prefill form's final
    ``(C, n, m)`` against the reference's chunked scan."""
    tdt, jdt, _ = DTYPES[dt]
    name = "xlstm-350m"
    cfg, pj, mod = _mixer(rxl.init_mlstm, pxl.init_mlstm, name, 12)
    x = np.random.default_rng(13).standard_normal((B, S, cfg.d_model))

    def ref(c, p, x):
        q, k, v, li, lf, _ = rxl._qkv_gates(p, c, x)
        _, (C, n, m) = rxl._mlstm_chunked(q, k, v, li, lf,
                                          chunk or c.ssm_chunk)
        return rxl.mlstm_train(p, c, x, chunk), {"C": C, "n": n, "m": m}
    (want, st_r), (rel, st_rel) = _reference(ref, name, dt, pj, _j(x, jdt))
    pcfg = _cfg(name, COMPUTE[dt])[0]
    y, st = pxl.mlstm_prefill(mod, pcfg, _t(x, tdt), chunk)
    assert y.dtype == tdt
    _close(y, want, rel)
    _close(pxl.mlstm_train(mod, pcfg, _t(x, tdt), chunk), y, 0.0)
    _close_state(st, st_r, st_rel)


@pytest.mark.parametrize("dt", DTYPES)
def test_mlstm_decode(dt):
    """One step from a drawn ``(C, n, m)``, written in place (f32:
    largest 6.0e-7; bf16: 5.6e-3)."""
    tdt, jdt, _ = DTYPES[dt]
    name = "xlstm-350m"
    cfg, pj, mod = _mixer(rxl.init_mlstm, pxl.init_mlstm, name, 14)
    rng = np.random.default_rng(15)
    x = rng.standard_normal((B, 1, cfg.d_model))
    drawn = _drawn_state(pxl.init_mlstm_state, cfg, rng)
    (y_r, st_r), (rel, st_rel) = _reference(
        lambda c, p, x, st: rxl.mlstm_decode(p, c, x, st), name, dt, pj,
        _j(x, jdt), {k: _j(a) for k, a in drawn.items()})
    state = {k: _t(a) for k, a in drawn.items()}
    buffers = dict(state)
    y, out = pxl.mlstm_decode(mod, _cfg(name, COMPUTE[dt])[0], _t(x, tdt),
                              state)
    assert out is state and all(out[k] is buffers[k] for k in buffers)
    _close(y, y_r, rel)
    _close_state(state, st_r, st_rel)


def test_slstm_cell():
    """One float32 cell from a drawn state (largest 5.0e-7)."""
    name = "xlstm-350m"
    cfg, pj, mod = _mixer(rxl.init_slstm, pxl.init_slstm, name, 16)
    rng = np.random.default_rng(17)
    d_in = pxl._dims(cfg)[0]
    xg = rng.standard_normal((B, 4 * d_in))
    st = _drawn_state(pxl.init_slstm_state, cfg, rng)
    want, bounds = _reference(lambda c, p, xg, st: rxl._slstm_cell(p, xg, st),
                              name, "f32", pj, _j(xg),
                              {k: _j(a) for k, a in st.items()})
    got = pxl._slstm_cell(mod, _t(xg), {k: _t(a) for k, a in st.items()})
    _close_state(got, want, bounds)


@pytest.mark.parametrize("dt", DTYPES)
def test_slstm_apply(dt):
    """The sLSTM block over S = 32, cell by cell (f32: largest 3.5e-7;
    bf16: 3.9e-3), and its prefill form's final state against the
    reference's cells run over the same gates."""
    tdt, jdt, _ = DTYPES[dt]
    name = "xlstm-350m"
    cfg, pj, mod = _mixer(rxl.init_slstm, pxl.init_slstm, name, 18)
    x = np.random.default_rng(19).standard_normal((B, S, cfg.d_model))

    def ref(c, p, x):
        xg = ((x @ p["w_up"].astype(x.dtype)) @ p["w_gates"].astype(x.dtype)
              ).astype(jnp.float32)
        st = jax.lax.scan(lambda s, g: (rxl._slstm_cell(p, g, s), None),
                          rxl.init_slstm_state(c, B), xg.transpose(1, 0, 2))[0]
        return rxl.slstm_apply(p, c, x), st
    (want, st_r), (rel, st_rel) = _reference(ref, name, dt, pj, _j(x, jdt))
    pcfg = _cfg(name, COMPUTE[dt])[0]
    y, st = pxl.slstm_prefill(mod, pcfg, _t(x, tdt))
    assert y.dtype == tdt
    _close(y, want, rel)
    _close(pxl.slstm_apply(mod, pcfg, _t(x, tdt)), y, 0.0)
    _close_state(st, st_r, st_rel)


@pytest.mark.parametrize("dt", DTYPES)
def test_slstm_decode(dt):
    """One step from a drawn state, written in place (f32: largest
    3.4e-7; bf16: 4.4e-3)."""
    tdt, jdt, _ = DTYPES[dt]
    name = "xlstm-350m"
    cfg, pj, mod = _mixer(rxl.init_slstm, pxl.init_slstm, name, 20)
    rng = np.random.default_rng(21)
    x = rng.standard_normal((B, 1, cfg.d_model))
    drawn = _drawn_state(pxl.init_slstm_state, cfg, rng)
    (y_r, st_r), (rel, st_rel) = _reference(
        lambda c, p, x, st: rxl.slstm_decode(p, c, x, st), name, dt, pj,
        _j(x, jdt), {k: _j(a) for k, a in drawn.items()})
    state = {k: _t(a) for k, a in drawn.items()}
    buffers = dict(state)
    y, out = pxl.slstm_decode(mod, _cfg(name, COMPUTE[dt])[0], _t(x, tdt),
                              state)
    assert out is state and all(out[k] is buffers[k] for k in buffers)
    _close(y, y_r, rel)
    _close_state(state, st_r, st_rel)


def test_init_states_are_separate_buffers():
    """The decode steps write their states in place, so no two state
    tensors (the sLSTM's four zeros above all) share memory."""
    cfg = get_config("xlstm-350m").reduced()
    for st in (pxl.init_slstm_state(cfg, B, device="cpu"),
               pxl.init_mlstm_state(cfg, B, device="cpu"),
               pm2.init_mamba2_state(get_config("zamba2-1.2b").reduced(), B,
                                     device="cpu")):
        ptrs = [t.data_ptr() for t in st.values()]
        assert len(set(ptrs)) == len(ptrs)
    cache = pmodel.init_cache(cfg, B, S, device="cpu")
    ptrs = [t.data_ptr() for g in cache.values() for t in g.values()]
    assert len(set(ptrs)) == len(ptrs)
