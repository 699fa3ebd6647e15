"""The port's ``loss_fn`` gradient against ``jax.grad`` of the JAX
package's, on the CPU.

One arch per family at ``reduced()`` (B = 2, S = 32): qwen2.5-3b (dense
GQA with QKV bias), granite-moe-3b-a800m (MoE, with its aux losses in the
loss), whisper-large-v3 (encoder-decoder, with ``frames``), xlstm-350m
(mLSTM + sLSTM) and zamba2-1.2b (Mamba2 + the shared attention block).
One weight tree in the shapes of the reference's ``init_params``, made
with numpy from a seed (``test_torch_lm._tree`` for the attention archs;
``test_torch_recurrent_lm._weights``, the reference's draw with its
matrices redrawn and its vectors moved, for the recurrent two), goes to
both through ``params_from_reference``; the port's gradients are
restacked into the reference's layout (``to_reference``) and compared
leaf by leaf.  Every block runs under the config's ``remat`` (``full``)
on both sides.

Tolerances, with the largest reading on this CPU beside each:
  * float32 compute: per leaf ``1e-4·max|ref leaf| + 1e-6·max|ref|``
    over the whole tree (largest reading 0.54 of that bound, xlstm-350m;
    qwen2.5-3b 0.014, granite-moe 0.033, whisper 0.047, zamba 0.34), and
    the loss within 1e-4 relative;
  * bfloat16 compute (qwen2.5-3b, xlstm-350m): per leaf
    ``max(2e-2, 2δ)·max|ref leaf|``, δ the *reference's* own distance
    between its bf16 and its float32 gradient of that leaf on the same
    weights and inputs, over max|ref leaf| (two bf16 evaluations, each δ
    from the float32 answer, may be 2δ apart).  Read off the reference,
    never the port, so no fault of the port widens its own bound
    (largest reading 0.88 of that bound, qwen2.5-3b's stacked ``bk``:
    2.6e-2 of max|ref leaf| against δ 1.5e-2; the port's own bf16 run is
    1.7e-2 from its float32 one there; xlstm-350m 0.48).
Every gradient is finite, the recurrent scans' masked entries included
(the -1e30 and ``-inf`` masks before ``exp`` stay masks in the backward).
"""
import jax
import numpy as np
import pytest
import torch

from repro.models import model as rm
from repro_torch.models import model as pm
from test_torch_lm import B, S, _cfgs, _ref_shapes, _tree
from test_torch_recurrent_lm import _weights as _recurrent_weights

ARCHS = ["qwen2.5-3b", "granite-moe-3b-a800m", "whisper-large-v3",
         "xlstm-350m", "zamba2-1.2b"]
BF16 = ["qwen2.5-3b", "xlstm-350m"]
F32_LEAF, F32_TREE, BF16_FLOOR = 1e-4, 1e-6, 2e-2


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for the module: the tensors here are small, and
    a pool per test worker oversubscribes the host under ``pytest -n``."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(name: str, seed: int = 0):
    """(float32 reference config, weights, batch) of one arch."""
    cfg_r = _cfgs(name, "float32")[1]
    rng = np.random.default_rng(seed)
    if cfg_r.block_pattern in ("xlstm", "zamba"):
        tree = _recurrent_weights(name, "float32", rng)
    else:
        tree = _tree(_ref_shapes(cfg_r), rng)
    batch = {"tokens": rng.integers(0, cfg_r.vocab, (B, S)).astype(
        np.int32)}
    if cfg_r.is_encdec:
        batch["frames"] = rng.standard_normal(
            (B, cfg_r.n_audio_frames, cfg_r.d_model)).astype(np.float32)
    return tree, batch


def _ref_grad(name: str, compute: str, tree, batch) -> tuple:
    cfg_r = _cfgs(name, compute)[1]
    loss, g = jax.jit(jax.value_and_grad(
        lambda p, b: rm.loss_fn(p, cfg_r, b)[0]))(tree, batch)
    return float(loss), jax.tree.map(lambda a: np.asarray(a, np.float32), g)


def _port_grad(name: str, compute: str, tree, batch) -> tuple:
    cfg = _cfgs(name, compute)[0]
    model = pm.params_from_reference(cfg, tree, device="cpu",
                                     trainable=True)
    loss, _ = pm.loss_fn(model, cfg, {k: torch.from_numpy(v)
                                      for k, v in batch.items()})
    loss.backward()
    grads = {k: p.grad for k, p in model.named_parameters()}
    return loss.item(), pm.to_reference(grads)


def _leaves(tree) -> dict:
    return {jax.tree_util.keystr(p): a for p, a in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.fixture(scope="module", params=ARCHS)
def f32(request):
    name = request.param
    tree, batch = _inputs(name)
    return (name, tree, batch, _ref_grad(name, "float32", tree, batch),
            _port_grad(name, "float32", tree, batch))


def _ratio(got: dict, want: dict, bound) -> float:
    """The largest ``max|got - want| / bound(leaf)`` over the leaves."""
    assert got.keys() == want.keys()
    worst = 0.0
    for k, w in want.items():
        g = got[k]
        assert g.shape == w.shape, (k, g.shape, w.shape)
        assert np.isfinite(g).all(), k
        worst = max(worst, float(np.abs(g - w).max()) / bound(k, w))
    return worst


def test_f32_grad_matches_reference(f32):
    name, _, _, (lr, gr), (lp, gp) = f32
    want, got = _leaves(gr), _leaves(gp)
    top = max(float(np.abs(w).max()) for w in want.values())
    ratio = _ratio(got, want, lambda k, w: F32_LEAF * float(
        np.abs(w).max()) + F32_TREE * top)
    assert ratio <= 1.0, (name, ratio)
    assert abs(lp - lr) <= F32_LEAF * abs(lr), (lp, lr)


@pytest.mark.parametrize("name", BF16)
def test_bf16_grad_within_reference_spread(name):
    tree, batch = _inputs(name)
    _, g32 = _ref_grad(name, "float32", tree, batch)
    _, g16 = _ref_grad(name, "bfloat16", tree, batch)
    _, gp = _port_grad(name, "bfloat16", tree, batch)
    want, ref32, got = _leaves(g16), _leaves(g32), _leaves(gp)

    def bound(k, w):
        top = max(float(np.abs(w).max()), 1e-30)
        delta = float(np.abs(w - ref32[k]).max()) / top
        return max(BF16_FLOOR, 2 * delta) * top
    ratio = _ratio(got, want, bound)
    assert ratio <= 1.0, (name, ratio)
