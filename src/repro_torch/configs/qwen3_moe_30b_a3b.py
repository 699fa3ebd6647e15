"""Qwen3-30B-A3B — 128 experts top-8, d_expert=768; expert-parallel over the
model axis (128 % 16 == 0). [hf:Qwen/Qwen3-30B-A3B]"""
from repro_torch.configs.base import ArchConfig, MoEConfig, register


@register("qwen3-moe-30b-a3b")
def qwen3_moe() -> ArchConfig:
    return ArchConfig(
        name="qwen3-moe-30b-a3b", family="moe",
        n_layers=48, d_model=2048, n_heads=32, n_kv_heads=4,
        d_ff=768, vocab=151936, qk_norm=True, rope_theta=1_000_000.0,
        moe=MoEConfig(n_experts=128, top_k=8, d_expert=768,
                      expert_parallel=True))
