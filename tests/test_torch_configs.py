"""The port's config registry against the JAX package's, on the CPU.

``repro_torch.configs`` is a copy of ``repro.configs`` (pure data): every
registered architecture, its ``reduced()`` form and each derived figure
(``d_head``, ``vocab_padded``, ``n_q_per_kv``, ``block_kind`` of every
layer, ``n_params``, ``n_active_params``), ``SHAPES`` and the paper's four
``CGConfig`` sizes must be equal field for field, the nested ``MoEConfig``
included.  No tolerance: these are integers, strings and exact floats.
"""
import dataclasses

import pytest

from repro import configs as ref
from repro.configs import fluidity_cg as ref_cg
from repro_torch import configs as port
from repro_torch.configs import fluidity_cg as port_cg

ARCHS = ["chameleon-34b", "granite-3-8b", "granite-moe-3b-a800m",
         "qwen2.5-3b", "qwen3-moe-30b-a3b", "stablelm-1.6b",
         "whisper-large-v3", "xlstm-350m", "yi-34b", "zamba2-1.2b"]
CG_SIZES = ("PAPER_SMALL", "PAPER_LARGE", "BENCH_SMALL", "BENCH_LARGE")


def _derived(cfg) -> dict:
    return {"d_head": cfg.d_head, "vocab_padded": cfg.vocab_padded,
            "n_q_per_kv": cfg.n_q_per_kv,
            "block_kind": [cfg.block_kind(i) for i in range(cfg.n_layers)],
            "n_params": cfg.n_params(),
            "n_active_params": cfg.n_active_params()}


def test_same_archs_registered():
    assert port.list_archs() == ref.list_archs() == ARCHS


@pytest.mark.parametrize("name", ARCHS)
def test_config_equal(name):
    got, want = port.get_config(name), ref.get_config(name)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert (got.moe is None) == (want.moe is None)
    if got.moe is not None:
        assert dataclasses.asdict(got.moe) == dataclasses.asdict(want.moe)
    assert _derived(got) == _derived(want)


@pytest.mark.parametrize("name", ARCHS)
def test_reduced_config_equal(name):
    got, want = port.get_config(name).reduced(), ref.get_config(name).reduced()
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert _derived(got) == _derived(want)


def test_shapes_equal():
    assert list(port.SHAPES) == list(ref.SHAPES)
    for k in ref.SHAPES:
        assert dataclasses.asdict(port.SHAPES[k]) == \
            dataclasses.asdict(ref.SHAPES[k])


@pytest.mark.parametrize("size", CG_SIZES)
def test_cg_config_equal(size):
    got, want = getattr(port_cg, size), getattr(ref_cg, size)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.approx_dof == want.approx_dof
    assert [f.name for f in dataclasses.fields(port_cg.CGConfig)] == \
        [f.name for f in dataclasses.fields(ref_cg.CGConfig)]


def test_unknown_arch_raises_as_the_reference():
    for pkg in (port, ref):
        with pytest.raises(ModuleNotFoundError):
            pkg.get_config("no-such-arch")


@pytest.fixture
def registered():
    """A name registered in both registries for one test, then removed."""
    name = "test-tiny-arch"
    yield name
    for mod in (port.base, ref.base):
        mod._REGISTRY.pop(name, None)


def test_register_adds_an_arch(registered):
    def make(base):
        return base.ArchConfig(name=registered, family="dense", n_layers=2,
                               d_model=64, n_heads=2, n_kv_heads=1, d_ff=128,
                               vocab=100)
    port.register(registered)(lambda: make(port.base))
    ref.register(registered)(lambda: make(ref.base))
    assert port.get_config(registered) == make(port.base)
    assert registered in port.list_archs()
    assert port.list_archs() == ref.list_archs()
    assert dataclasses.asdict(port.get_config(registered)) == \
        dataclasses.asdict(ref.get_config(registered))
