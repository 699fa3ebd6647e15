"""Granite-3.0 8B — dense GQA [hf:ibm-granite/granite-3.0]."""
from repro_torch.configs.base import ArchConfig, register


@register("granite-3-8b")
def granite_3_8b() -> ArchConfig:
    return ArchConfig(
        name="granite-3-8b", family="dense",
        n_layers=40, d_model=4096, n_heads=32, n_kv_heads=8,
        d_ff=12800, vocab=49155, tie_embeddings=True)
