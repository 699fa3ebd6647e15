"""xLSTM-350M — mLSTM + sLSTM blocks (7:1 pattern), no FFN (d_ff=0).
Sub-quadratic: runs the long_500k shape. [arXiv:2405.04517]"""
from repro_torch.configs.base import ArchConfig, register


@register("xlstm-350m")
def xlstm_350m() -> ArchConfig:
    return ArchConfig(
        name="xlstm-350m", family="ssm",
        n_layers=24, d_model=1024, n_heads=4, n_kv_heads=4,
        d_ff=0, vocab=50304, block_pattern="xlstm", sub_quadratic=True)
