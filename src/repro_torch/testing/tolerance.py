"""Tolerance rules shared by the LM checks of ``chip_smoke.py`` and the
port's CPU tests."""
from __future__ import annotations

import math


def bf16_step(top: float) -> float:
    """The spacing of bfloat16 numbers at magnitude ``top`` (8 significant
    bits: 2^-6 in [2, 4)).  A bf16 cache tensor whose float32 source sits
    on a rounding boundary may be one such step off in two correct runs."""
    return 2.0 ** (math.floor(math.log2(top)) - 7) if top > 0 else 0.0
