"""The port's flash-attention backward (``models/common.py``: ``_Flash``,
``_flash_bwd``) against the JAX package's ``_flash_bwd``, on the CPU.

Shapes chosen to reach every branch of the tile loops: causal with
``skip``, ``edge`` and ``full`` tiles, ``cq != ck``, ``q_offset > 0``
with ``Sq != Sk`` (a later chunk of queries against the whole key
range), non-causal with ``Sq != Sk`` (whisper's encoder and
cross-attention), and G = H / KV of 1, 2 and 4.  Inputs and the
cotangent are numpy draws from a seed, rounded to the storage dtype
alike on both sides.

Bounds, each against max|ref| of the output it holds (dq, dk, dv and
the forward's out), with the largest reading on this CPU:
  * float32: 1e-5 against ``jax.vjp`` of the reference's
    ``flash_attention`` (5.7e-7) and against torch autograd through the
    port's own forward (``_flash_fwd_impl``, the plain version; 7.4e-7);
  * bfloat16: 2e-2, the reference's own bf16 bound (0 against the
    reference: the same bits; 7.5e-3 against the plain version, whose
    autograd rounds elsewhere);
  * float64 ``torch.autograd.gradcheck`` of the Function on a tiny shape.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.common import flash_attention as ref_flash
from repro_torch.models import common as pc

#: (B, Sq, Sk, H, KV, dh, causal, q_offset, chunk_q, chunk_k)
CASES = {
    "causal_g2": (2, 16, 16, 4, 2, 8, True, 0, 4, 4),
    "causal_g1_cq_ne_ck": (1, 16, 16, 4, 4, 8, True, 0, 4, 8),
    "offset_g4_sq_ne_sk": (2, 8, 24, 8, 2, 8, True, 16, 4, 8),
    "noncausal_sq_ne_sk": (2, 12, 20, 4, 2, 8, False, 0, 4, 5),
}
BOUND = {"float32": 1e-5, "bfloat16": 2e-2}


def _draw(case, seed=0):
    B, Sq, Sk, H, KV, dh, *_ = CASES[case]
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32)
            for s in ((B, Sq, H, dh), (B, Sk, KV, dh), (B, Sk, KV, dh),
                      (B, Sq, H, dh))]


def _opts(case):
    *_, causal, off, cq, ck = CASES[case]
    return dict(causal=causal, q_offset=off, chunk_q=cq, chunk_k=ck)


def _reference(case, dtype):
    q, k, v, do = (jnp.asarray(a, dtype) for a in _draw(case))
    out, vjp = jax.vjp(lambda q, k, v: ref_flash(q, k, v, **_opts(case)),
                       q, k, v)
    return [np.asarray(t, np.float32) for t in (out, *vjp(do))]


def _port(case, dtype, plain=False):
    q, k, v, do = (torch.from_numpy(a).to(dtype) for a in _draw(case))
    for t in (q, k, v):
        t.requires_grad_(True)
    if plain:
        o = _opts(case)
        cq = pc._pick_chunk(q.shape[1], o["chunk_q"])
        ck = pc._pick_chunk(k.shape[1], o["chunk_k"])
        out = pc._flash_fwd_impl(q, k, v, o["causal"], o["q_offset"], cq,
                                 ck)[0]
    else:
        out = pc.flash_attention(q, k, v, **_opts(case))
    grads = torch.autograd.grad(out, (q, k, v), do)
    return [t.detach().float().numpy() for t in (out, *grads)]


def _close(got, want, rel):
    for name, g, w in zip(("out", "dq", "dk", "dv"), got, want):
        assert g.shape == w.shape, (name, g.shape, w.shape)
        assert np.isfinite(g).all(), name
        err = float(np.abs(g - w).max())
        assert err <= rel * float(np.abs(w).max()), (name, err)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", list(CASES))
def test_backward_matches_reference(case, dtype):
    _close(_port(case, getattr(torch, dtype)),
           _reference(case, getattr(jnp, dtype)), BOUND[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", list(CASES))
def test_backward_matches_autograd_of_the_forward(case, dtype):
    dt = getattr(torch, dtype)
    _close(_port(case, dt), _port(case, dt, plain=True), BOUND[dtype])


def test_tiles_cover_every_state():
    """The cases reach every tile state and G of 1, 2 and 4."""
    states, groups = set(), set()
    for B, Sq, Sk, H, KV, dh, causal, off, cq, ck in CASES.values():
        cq, ck = pc._pick_chunk(Sq, cq), pc._pick_chunk(Sk, ck)
        groups.add(H // KV)
        states |= {pc._tile_state(i, j, cq, ck, off, causal)
                   for i in range(Sq // cq) for j in range(Sk // ck)}
    assert states == {"skip", "edge", "full"}
    assert groups == {1, 2, 4}


def test_gradcheck_float64():
    rng = np.random.default_rng(1)
    q, k, v = (torch.from_numpy(rng.standard_normal(s)).requires_grad_(True)
               for s in ((1, 8, 2, 4), (1, 8, 1, 4), (1, 8, 1, 4)))
    assert torch.autograd.gradcheck(
        lambda q, k, v: pc._Flash.apply(q, k, v, True, 0, 4, 4), (q, k, v))
    # a query chunk at an offset into a longer key range, causal and not
    k2, v2 = (torch.from_numpy(rng.standard_normal((1, 12, 1, 4)))
              .requires_grad_(True) for _ in range(2))
    assert torch.autograd.gradcheck(
        lambda q, k, v: pc._Flash.apply(q, k, v, True, 4, 4, 4), (q, k2, v2))
    assert torch.autograd.gradcheck(
        lambda q, k, v: pc._Flash.apply(q, k, v, False, 0, 4, 6),
        (q, k2, v2))
