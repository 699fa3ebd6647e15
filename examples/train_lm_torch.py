"""Train a ~100M-parameter transformer for a few hundred steps with the
PyTorch port: the counterpart of ``examples/train_lm.py``.

Registers ``granite-100m`` in the port's registry (the granite-3-8b
family config scaled to ~100M params: the same GQA block structure, 12
layers x d768) and runs the port's training driver on it: the
deterministic token pipeline, AdamW with warmup-cosine, remat,
checkpointing and the straggler watchdog, as ``repro_torch.launch.train``
runs them.

    PYTHONPATH=src python examples/train_lm_torch.py [--steps 300] \\
        [--device cuda|cpu]
"""
import argparse
import dataclasses
import os
import sys
import tempfile

import torch

from repro_torch.configs import get_config
from repro_torch.configs.base import register
from repro_torch.launch.train import main as train_main
from repro_torch.models.model import Model


@register("granite-100m")
def granite_100m():
    base = get_config("granite-3-8b")
    return dataclasses.replace(
        base, name="granite-100m",
        n_layers=12, d_model=768, n_heads=12, n_kv_heads=4,
        d_ff=2048, vocab=16384, vocab_align=256)


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--device", default="cuda",
                    help="where the model trains: cuda (default) or cpu")
    args = ap.parse_args()
    cfg = get_config("granite-100m")
    n = sum(p.numel() for p in Model(cfg, torch.device("meta")).parameters())
    print(f"granite-100m: {n/1e6:.1f}M params")
    out = os.path.join(tempfile.gettempdir(), "repro_torch_train_lm")
    sys.exit(train_main([
        "--arch", "granite-100m",
        "--steps", str(args.steps),
        "--batch", str(args.batch),
        "--seq", str(args.seq),
        "--ckpt-dir", os.path.join(out, "ckpt"),
        "--ckpt-every", "100",
        "--log-every", "20",
        "--metrics-out", os.path.join(out, "metrics.json"),
        "--device", args.device,
    ]))
