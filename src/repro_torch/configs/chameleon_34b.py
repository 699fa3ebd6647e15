"""Chameleon-34B — early-fusion VLM backbone; VQ image tokens live in the
text vocabulary so the backbone is a dense GQA transformer with QK-norm
(Chameleon's stabilisation trick).  The image tokenizer is a frontend STUB:
``input_specs`` feeds token ids that may include image codes.
[arXiv:2405.09818]"""
from repro_torch.configs.base import ArchConfig, register


@register("chameleon-34b")
def chameleon_34b() -> ArchConfig:
    return ArchConfig(
        name="chameleon-34b", family="vlm",
        n_layers=48, d_model=8192, n_heads=64, n_kv_heads=8,
        d_ff=22016, vocab=65536, qk_norm=True, frontend="image")
