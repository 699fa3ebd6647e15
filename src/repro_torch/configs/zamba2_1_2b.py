"""Zamba2-1.2B — Mamba2 backbone + shared attention block every 6 layers.
Sub-quadratic (SSM blocks are O(S); the shared-attn block at decode is
O(S) per token) so it runs long_500k. [arXiv:2411.15242]"""
from repro_torch.configs.base import ArchConfig, register


@register("zamba2-1.2b")
def zamba2() -> ArchConfig:
    return ArchConfig(
        name="zamba2-1.2b", family="hybrid",
        n_layers=38, d_model=2048, n_heads=32, n_kv_heads=32,
        d_ff=8192, vocab=32000, ssm_state=64, block_pattern="zamba",
        sub_quadratic=True)
