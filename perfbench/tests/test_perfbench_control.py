"""The control: the plain reference's Jacobi CG put in the program's place
in bfloat16, the precision below the configurations' float32, fails the
comparison that decides ``correct``; the program passes it.  At a size a
test run holds; ``perfbench/control.py`` reads both at a cell's size on
the card."""
import json
from pathlib import Path

import pytest
import torch

from perfbench import control, traffic

HERE = Path(__file__).resolve().parent


@pytest.mark.parametrize("config,mix", [("tiny", "ksp"),
                                        ("tiny-hpcg", "cgsets")])
def test_control_fails_and_the_program_passes(config, mix):
    cfg = json.loads((HERE / "configs" / f"{config}.json").read_text())
    got = []
    s = control.readings(cfg, traffic.load(mix), 11, 8, 3,
                         torch.device("cpu"), emit=got.append)
    limit = cfg["check"][s["judged"]]
    assert s["lower"] <= limit < s["upper"]
    assert len(s["program"]) == 8
    assert all(r > limit for r in s["control"]) and len(s["control"]) == 3
    f32 = [g for g in got if g["side"] == "reference_float32"]
    assert f32 and f32[0][s["judged"]] <= limit
