"""End-to-end training driver, on one device.

The port of ``src/repro/launch/train.py``:
  * config system (``--arch``, ``--reduced``), deterministic seekable data
    (``data.TokenPipeline``)
  * a train step of ``loss_fn``'s gradient (``loss.backward()``, every
    block under ``_remat`` as its config says) and AdamW
  * optional gradient accumulation (``--accum``: microbatches in order,
    gradients summed in float32)
  * checkpoint/restart (``--resume``), async saves, keep-N retention; a
    checkpoint holds ``(params_to_reference(model), opt)`` in the
    reference's layout, so either package resumes the other's
  * straggler watchdog + non-finite-loss rollback (``runtime/fault.py``)

Runs on ``--device`` (default ``cuda``; never a silent fallback), with
``torch.use_deterministic_algorithms(True)`` for its duration, so that a
resumed run is bit for bit an uninterrupted one on the card as on the
CPU.  The reference's mesh and parameter shardings have no counterpart
here (one device).

Example (CPU smoke):
  PYTHONPATH=src python -m repro_torch.launch.train --arch xlstm-350m \\
      --reduced --device cpu --steps 8 --batch 2 --seq 64 \\
      --ckpt-dir /tmp/ckpt --ckpt-every 4
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import time

import numpy as np
import torch

from repro_torch.checkpoint import AsyncSaver, latest_step, load
from repro_torch.configs import get_config
from repro_torch.data import TokenPipeline
from repro_torch.models.model import (init_params, load_named, loss_fn,
                                      named_from_reference,
                                      params_to_reference, reference_like,
                                      reference_ndim, to_reference)
from repro_torch.optim import AdamWConfig, OptState, apply_updates, init_opt
from repro_torch.runtime.fault import StepGuard, Watchdog

__all__ = ["make_train_step", "deterministic", "checkpoint_tree",
           "checkpoint_like", "restore", "main"]

#: cuBLAS's workspace setting under which its products are reproducible
#: (PyTorch refuses cuBLAS in deterministic mode without it)
CUBLAS_WORKSPACE = ":4096:8"


def make_train_step(cfg, adamw: AdamWConfig, accum: int = 1):
    """``train_step(model, opt, batch) -> (model, opt, loss, metrics)``:
    the gradient of ``loss_fn`` by ``loss.backward()`` and one AdamW step
    applied to the model's parameters in place.  With ``accum > 1`` the
    batch runs as ``accum`` microbatches of ``B // accum`` rows in order,
    their gradients summed in float32 and divided by ``accum``, the loss
    averaged, and ``metrics`` holding only the optimizer's (as in the
    reference).  The gradients are freed after the update."""
    def train_step(model, opt, batch):
        params = dict(model.named_parameters())
        for p in params.values():
            p.grad = None
        if accum == 1:
            loss, metrics = loss_fn(model, cfg, batch)
            loss.backward()
            loss = loss.detach()
            metrics = {k: v.detach() for k, v in metrics.items()}
        else:
            mb = batch["tokens"].shape[0] // accum
            loss = None
            for i in range(accum):
                part = {k: v[i * mb:(i + 1) * mb] for k, v in batch.items()}
                l, _ = loss_fn(model, cfg, part)
                l.backward()
                loss = l.detach() if loss is None else loss + l.detach()
            with torch.no_grad():
                for p in params.values():
                    p.grad.div_(accum)
            loss = loss / accum
            metrics = {}
        grads = {k: p.grad for k, p in params.items()}
        ndim = {k: reference_ndim(k, p) for k, p in params.items()}
        _, opt, om = apply_updates(adamw, params, grads, opt, ndim)
        for p in params.values():
            p.grad = None
        return model, opt, loss, {**metrics, **om}

    return train_step


@contextlib.contextmanager
def deterministic():
    """``torch.use_deterministic_algorithms(True)`` inside the block, the
    previous setting restored after it."""
    prev = (torch.are_deterministic_algorithms_enabled(),
            torch.is_deterministic_algorithms_warn_only_enabled())
    torch.use_deterministic_algorithms(True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(prev[0], warn_only=prev[1])


def checkpoint_tree(model, opt: OptState):
    """What a checkpoint holds: ``(params, opt)`` in the reference's
    layout, numpy leaves (the moments restacked as the parameters)."""
    return (params_to_reference(model),
            OptState(to_reference(opt.m), to_reference(opt.v),
                     opt.step.cpu().numpy()))


def checkpoint_like(model, opt: OptState):
    """The structure of ``checkpoint_tree(model, opt)``, with meta-device
    leaves of its shapes and dtypes (no copy to the host)."""
    return (reference_like(dict(model.named_parameters())),
            OptState(reference_like(opt.m), reference_like(opt.v),
                     opt.step.to("meta")))


def restore(ckpt_dir: str, step: int, model, opt: OptState):
    """Load checkpoint ``step`` into ``model``'s parameters (in place) and
    a new ``OptState`` on the model's device.  Returns ``(opt, extra)``."""
    (tree, ropt), extra = load(ckpt_dir, step, checkpoint_like(model, opt))
    load_named(model, named_from_reference(tree))
    dev = opt.step.device

    def moments(t):
        return {k: torch.from_numpy(np.array(a)).to(dev)
                for k, a in named_from_reference(t).items()}
    opt = OptState(moments(ropt.m), moments(ropt.v),
                   torch.from_numpy(np.array(ropt.step)).to(dev))
    return opt, extra


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true",
                    help="tiny same-family config (CPU)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--accum", type=int, default=1)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--metrics-out", default=None)
    ap.add_argument("--device", default="cuda",
                    help="where the model trains: cuda (default) or cpu")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            ap.error("--device cuda: torch.cuda.is_available() is False "
                     "(pass --device cpu to train on the CPU)")
        # read by cuBLAS's first handle and by the deterministic check
        os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", CUBLAS_WORKSPACE)
    with deterministic():
        return _train(args, device)


def _train(args, device: torch.device) -> int:
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    adamw = AdamWConfig(lr=args.lr, total_steps=args.steps,
                        warmup_steps=max(1, args.steps // 10))

    gen = torch.Generator(device=device).manual_seed(args.seed)
    model = init_params(cfg, gen, device=device, trainable=True)
    opt = init_opt(dict(model.named_parameters()))
    start = 0

    pipe = TokenPipeline(vocab=cfg.vocab, global_batch=args.batch,
                         seq_len=args.seq, seed=args.seed)

    saver = AsyncSaver(args.ckpt_dir) if args.ckpt_dir else None
    if args.resume and args.ckpt_dir:
        s = latest_step(args.ckpt_dir)
        if s is not None:
            opt, extra = restore(args.ckpt_dir, s, model, opt)
            start = int(extra["step"])
            print(f"resumed from step {start}")

    step_fn = make_train_step(cfg, adamw, args.accum)
    watchdog = Watchdog()
    losses = []
    t_start = time.time()
    step = start
    while step < args.steps:
        batch = {"tokens": torch.from_numpy(pipe.batch_at(step)).to(device)}
        if cfg.is_encdec:
            batch["frames"] = torch.from_numpy(pipe.frames_at(
                step, cfg.n_audio_frames, cfg.d_model)).to(device)

        def emergency():
            if saver:
                saver.submit(step, checkpoint_tree(model, opt),
                             {"step": step})

        with StepGuard(watchdog, on_emergency=emergency):
            model, opt, loss, metrics = step_fn(model, opt, batch)
            loss = float(loss)

        if not np.isfinite(loss):
            if saver and latest_step(args.ckpt_dir) is not None:
                s = latest_step(args.ckpt_dir)
                opt, extra = restore(args.ckpt_dir, s, model, opt)
                step = int(extra["step"])
                print(f"non-finite loss; rolled back to step {step}")
                continue
            raise FloatingPointError(f"non-finite loss at step {step}")

        losses.append(loss)
        step += 1
        if step % args.log_every == 0 or step == args.steps:
            print(f"step {step:5d} loss {loss:8.4f} "
                  f"gnorm {float(metrics.get('grad_norm', 0)):7.3f} "
                  f"dt {watchdog.ema:6.3f}s stragglers {watchdog.stragglers}",
                  flush=True)
        if saver and step % args.ckpt_every == 0:
            saver.submit(step, checkpoint_tree(model, opt), {"step": step})

    if saver:
        saver.submit(step, checkpoint_tree(model, opt), {"step": step})
        saver.wait()
    wall = time.time() - t_start
    summary = {
        "arch": cfg.name, "steps": args.steps,
        "final_loss": losses[-1] if losses else None,
        "first_loss": losses[0] if losses else None,
        "wall_s": round(wall, 1),
        "stragglers": watchdog.stragglers,
        "loss_decreased": bool(losses and losses[-1] < losses[0]),
        "resumed_past_target": not losses and start >= args.steps,
    }
    print(json.dumps(summary))
    if args.metrics_out:
        with open(args.metrics_out, "w") as f:
            json.dump({**summary, "losses": losses}, f)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
