"""Sharded serving (``models.model.prefill`` / ``decode_step`` on a mesh:
``runtime.sharded.init_sharded(..., serving=True)``,
``init_cache_sharded``, the sequence-split KV caches of
``models.attention``) against one device, on the CPU.

One spawn of 4 gloo ranks as a 2x2 ``data x model`` mesh serves
qwen2.5-3b, granite-moe-3b-a800m, xlstm-350m, zamba2-1.2b and
whisper-large-v3 at ``reduced()``, float32 compute and float32 caches
(bf16 weights): a prompt of 6 tokens in 4 rows, prefill, 4 greedy steps
into a 16-slot cache, so the second slice of every KV cache holds no
valid slot for the first two steps (``testing.serve_mesh_check``).
Every rank's tokens equal the one-device run's on its rows, its logits
are within 1e-5·max|ref|, and each of its cache blocks within the same
bound of its slice of the one-device cache; the first arch decoded with
``pos`` as an int, a 0-d tensor and one per row gives the same bits.

On a 1x1 mesh (no process group) every arch's tokens, logits and cache
equal the non-mesh path's bit for bit on the same weights, the
placements split nothing, and the mesh's bf16 serving weights are the
one-device draw cast to bf16.
"""
import numpy as np
import pytest

from repro_torch.launch.mesh import make_host_mesh
from repro_torch.testing import serve_mesh_check as sm

ARCHS = sm.ARCHS


@pytest.fixture(scope="module")
def ranks():
    _, out = sm.run(ARCHS, "cpu")
    return out


@pytest.mark.parametrize("arch", ARCHS)
def test_mesh_tokens_equal_one_device(ranks, arch):
    assert [r[arch]["tokens_equal"] for r in ranks] == [True] * sm.RANKS


@pytest.mark.parametrize("arch", ARCHS)
def test_mesh_logits_within_bound(ranks, arch):
    worst = max(r[arch]["logit_rel"] for r in ranks)
    assert worst <= sm.GATE, worst


@pytest.mark.parametrize("arch", ARCHS)
def test_mesh_cache_blocks_are_their_slices(ranks, arch):
    worst = {k: max(r[arch]["cache_by_leaf"][k] for r in ranks)
             for k in ranks[0][arch]["cache_by_leaf"]}
    assert max(worst.values()) <= sm.GATE, worst


def test_pos_forms_give_the_same_bits(ranks):
    assert all(r["pos_forms_equal"] for r in ranks)


def test_mesh_is_two_by_two(ranks):
    assert [r["mesh"] for r in ranks] == [{"data": 2, "model": 2}] * 4


@pytest.mark.parametrize("arch", ARCHS)
def test_one_by_one_mesh_is_the_one_device_path_bit_for_bit(arch):
    cfg = sm._cfg(arch)
    kw = dict(batch=2, seq=5, steps=2, slots=8)
    one = sm.serve_steps(cfg, "cpu", **kw)
    # the same weights (the test below holds the 1x1 draw to the
    # one-device one): the mesh's caches, placements and state paths
    mesh = sm.serve_steps(cfg, "cpu", mesh=make_host_mesh(device="cpu"),
                          model=one["model"], **kw)
    assert sm._same_bits(one, mesh)
    # a 1x1 mesh's placements split every leaf into one part
    for _, pl in sm._leaves(mesh["placements"]):
        assert all(pl.parts(axes) == 1 for _, axes in pl.splits)
    assert np.isfinite(mesh["logits"]).all()


def test_one_by_one_serving_weights_are_the_one_device_weights():
    import torch

    from repro_torch.models.model import init_params
    from repro_torch.runtime.sharded import init_sharded

    cfg = sm._cfg("qwen2.5-3b")
    one = init_params(cfg, torch.Generator().manual_seed(0), "cpu").to(
        torch.bfloat16)
    mesh = init_sharded(cfg, torch.Generator().manual_seed(0),
                        make_host_mesh(device="cpu"), "cpu",
                        trainable=False, serving=True)
    got = dict(mesh.named_parameters())
    for name, p in one.named_parameters():
        assert got[name].dtype == torch.bfloat16
        assert torch.equal(got[name], p), name
