"""Traffic mixes and their generators.

A mix is a data file, ``perfbench/traffic/<mix>.json``, of parameters
with its ``source``.  Its ``generator`` names the module of this package
that drives it: ``perfbench/traffic/<generator>.py``, which has

``Traffic(mix, A, seed)``  the mix's inputs for run ``seed``, made on the
                           device from the plain reference's float64
                           operator ``A`` (``perfbench.reference``)
``drive(plan, g, load, cfg, job, device) -> record``
                           the warm-up, the measured window and, traced,
                           the profile (``perfbench/harness.py`` lists
                           the record's keys)
``check(load, A, answers, rec, cfg) -> checks``
                           the comparison that decides ``correct``

So a mix of a new shape (more callers, arrivals, another stopping rule)
comes as a new generator module and a data file, and edits neither.
"""
from __future__ import annotations

import importlib
import json
from pathlib import Path

__all__ = ["DIR", "load", "generator"]

DIR = Path(__file__).resolve().parent


def load(name: str, directory: Path = DIR) -> dict:
    """Mix ``name``'s parameters."""
    return json.loads((Path(directory) / f"{name}.json").read_text())


def generator(mix: dict):
    """The module that drives ``mix``."""
    return importlib.import_module(f"perfbench.traffic.{mix['generator']}")
