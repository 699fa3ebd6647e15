"""Whisper-large-v3 — encoder-decoder; the conv audio frontend is a STUB
(``input_specs`` provides precomputed (B, 1500, d) frame embeddings).
[arXiv:2212.04356]"""
from repro_torch.configs.base import ArchConfig, register


@register("whisper-large-v3")
def whisper_large_v3() -> ArchConfig:
    return ArchConfig(
        name="whisper-large-v3", family="audio",
        n_layers=32, d_model=1280, n_heads=20, n_kv_heads=20,
        d_ff=5120, vocab=51866, is_encdec=True, frontend="audio",
        n_audio_frames=1500)
