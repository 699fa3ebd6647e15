"""Granite-3.0 MoE 3B (800M active) — 40 experts top-8, d_expert=512.
40 experts don't divide the 16-way model axis, so expert weights use
tensor-parallelism *inside* each expert (expert_parallel=False).
[hf:ibm-granite/granite-3.0-1b-a400m-base family]"""
from repro_torch.configs.base import ArchConfig, MoEConfig, register


@register("granite-moe-3b-a800m")
def granite_moe() -> ArchConfig:
    return ArchConfig(
        name="granite-moe-3b-a800m", family="moe",
        n_layers=32, d_model=1536, n_heads=24, n_kv_heads=8,
        d_ff=512, vocab=49155, tie_embeddings=True,
        moe=MoEConfig(n_experts=40, top_k=8, d_expert=512,
                      expert_parallel=False))
