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
CPU.

``--mesh process --ranks N [--dist-backend gloo|nccl]`` trains on the
reference's ``make_host_mesh``: ``N`` spawned ranks as a ``data x model``
mesh (``model`` 2 when ``N`` is even; NCCL one rank per card, refused
before any process starts without a card per rank).  Every parameter and
both AdamW moments are stored sharded as ``runtime.sharding.param_pspecs``
says (``runtime.sharded``: each leaf cut to the rank's block as it is
drawn or read from a checkpoint, each weight gathered where it is used,
its gradient reduce-scattered back), each
rank takes its rows of the batch as ``batch_pspecs`` says, and the loss,
gradient and norm are the one-device trainer's up to summation order.
Rank 0 logs, writes the metrics and the checkpoints (gathered whole, in
the reference's layout, so the one-device trainer and the reference read
them) and takes the rollback decision, which every rank then holds.
Without ``--mesh`` it is the one-device trainer.

Example (CPU smoke):
  PYTHONPATH=src python -m repro_torch.launch.train --arch xlstm-350m \\
      --reduced --device cpu --steps 8 --batch 2 --seq 64 \\
      --ckpt-dir /tmp/ckpt --ckpt-every 4
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2.5-3b \\
      --reduced --device cpu --steps 4 --batch 4 --seq 32 \\
      --mesh process --ranks 4
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import time

import numpy as np
import torch

from repro_torch.checkpoint import AsyncSaver, latest_step, load
from repro_torch.configs import ShapeConfig, get_config
from repro_torch.data import TokenPipeline
from repro_torch.launch.mesh import (add_dist_backend, require_cards,
                                     spawn_mesh)
from repro_torch.models.common import use_mesh
from repro_torch.models.model import (init_params, load_named, loss_fn,
                                      named_from_reference, reference_like,
                                      reference_ndim, to_reference)
from repro_torch.optim import AdamWConfig, OptState, apply_updates, init_opt
from repro_torch.runtime import sharded
from repro_torch.runtime.fault import StepGuard, Watchdog
from repro_torch.runtime.sharding import NamedSharding, batch_pspecs

__all__ = ["make_train_step", "deterministic", "checkpoint_tree",
           "checkpoint_like", "restore", "batch_rows", "run_on_mesh",
           "main"]

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
    reference).  The gradients are freed after the update.

    On a sharded model (``runtime.sharded.init_sharded``) ``batch`` is the
    rank's rows: the gradient's blocks are summed over the mesh
    (``sync_grads``), the clip reads the mesh's norm, and the loss and
    metrics are the means over the ranks."""
    def train_step(model, opt, batch):
        st = getattr(model, "sharding", None)
        params = sharded.model_params(model)
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
        gnorm = None
        if st is not None:
            sharded.sync_grads(st, grads)
            gnorm = sharded.global_norm(st, grads)
            loss = sharded.mean_over_mesh(loss, st.mesh)
            metrics = {k: sharded.mean_over_mesh(v, st.mesh)
                       for k, v in metrics.items()}
        _, opt, om = apply_updates(adamw, params, grads, opt, ndim, gnorm)
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
    layout, numpy leaves (the moments restacked as the parameters).  On a
    sharded model every rank calls this (each leaf is gathered whole from
    its blocks) and rank 0 gets the tree; the others get ``None``."""
    st = getattr(model, "sharding", None)
    params = sharded.model_params(model)
    if st is None:
        return (to_reference(params),
                OptState(to_reference(opt.m), to_reference(opt.v),
                         opt.step.cpu().numpy()))

    lead = st.mesh.rank in (None, 0)

    def whole(tree):
        out = {}
        for k, t in tree.items():      # one whole leaf on the card at a time
            full = sharded.full_tensor(t, st.placements[k])
            if lead:
                out[k] = full.cpu()
        return out
    p, m, v = whole(params), whole(opt.m), whole(opt.v)
    if not lead:
        return None
    return (to_reference(p), OptState(to_reference(m), to_reference(v),
                                      opt.step.cpu().numpy()))


def checkpoint_like(model, opt: OptState):
    """The structure of ``checkpoint_tree(model, opt)``, with meta-device
    leaves of its shapes and dtypes (no copy to the host)."""
    st = getattr(model, "sharding", None)
    params = sharded.model_params(model)

    def like(tree):
        if st is None:
            return reference_like(tree)
        return reference_like({k: torch.empty(st.shapes[k], dtype=t.dtype,
                                               device="meta")
                               for k, t in tree.items()})
    return (like(params), OptState(like(opt.m), like(opt.v),
                                   opt.step.to("meta")))


def restore(ckpt_dir: str, step: int, model, opt: OptState):
    """Load checkpoint ``step`` into ``model``'s parameters (in place) and
    a new ``OptState`` on the model's device (on a sharded model: this
    rank's blocks, each leaf cut as it is read).  Returns ``(opt,
    extra)``."""
    st = getattr(model, "sharding", None)
    cut = None
    if st is not None:
        blocks = sharded.cutters(st)
        cut = (blocks, OptState(blocks, blocks, lambda a: a))
    (tree, ropt), extra = load(ckpt_dir, step, checkpoint_like(model, opt),
                               cut=cut)
    dev = opt.step.device
    if st is None:
        load_named(model, named_from_reference(tree))
    else:
        with torch.no_grad():
            for k, a in named_from_reference(tree).items():
                st.params[k].copy_(torch.from_numpy(a))

    def moments(t):
        return {k: torch.from_numpy(np.array(a)).to(dev)
                for k, a in named_from_reference(t).items()}
    opt = OptState(moments(ropt.m), moments(ropt.v),
                   torch.from_numpy(np.array(ropt.step)).to(dev))
    return opt, extra


def batch_rows(cfg, mesh, batch: int, seq: int) -> NamedSharding:
    """The placement of a ``(batch, seq)`` token batch on ``mesh``
    (``batch_pspecs``): ``.shard(tokens)`` is a rank's rows."""
    spec = batch_pspecs(cfg, ShapeConfig("train", seq, batch, "train"),
                        mesh)["tokens"]
    return NamedSharding(mesh, spec)


def _parser() -> argparse.ArgumentParser:
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
    ap.add_argument("--mesh", default=None, choices=["process"],
                    help="process: train on --ranks spawned ranks, a "
                         "data x model mesh with sharded parameters")
    ap.add_argument("--ranks", type=int, default=None,
                    help="with --mesh process: the rank count (default: "
                         "every card with --dist-backend nccl)")
    add_dist_backend(ap)
    return ap


def main(argv=None) -> int:
    ap = _parser()
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            ap.error("--device cuda: torch.cuda.is_available() is False "
                     "(pass --device cpu to train on the CPU)")
        # read by cuBLAS's first handle and by the deterministic check
        os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", CUBLAS_WORKSPACE)
    if args.mesh is None:
        if args.ranks is not None or args.dist_backend != "gloo":
            ap.error("--ranks and --dist-backend train on a process mesh: "
                     "add --mesh process")
        with deterministic():
            return _train(args, device)
    ranks = args.ranks
    if ranks is None:
        if args.dist_backend != "nccl":
            ap.error("--mesh process with gloo: give --ranks")
        ranks = torch.cuda.device_count()
    if args.dist_backend == "nccl":
        require_cards(ranks, device)
    rcs = spawn_mesh(run_on_mesh, ranks, device, backend=args.dist_backend,
                     args=(list(argv if argv is not None
                                else sys.argv[1:]),),
                     timeout=float("inf"))
    return max(rcs)


def run_on_mesh(mesh, argv) -> int:
    """A rank of ``main``'s process mesh: the trainer's ``argv`` on
    ``mesh`` (what ``--mesh process`` runs on every rank)."""
    args = _parser().parse_args(argv)
    if mesh.device.type == "cuda":
        os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", CUBLAS_WORKSPACE)
    with deterministic():
        return _train(args, mesh.device, mesh)


def _train(args, device: torch.device, mesh=None) -> int:
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    adamw = AdamWConfig(lr=args.lr, total_steps=args.steps,
                        warmup_steps=max(1, args.steps // 10))
    lead = mesh is None or mesh.rank in (None, 0)

    def say(*a, **kw):
        if lead:
            print(*a, **kw)

    gen = torch.Generator(device=device).manual_seed(args.seed)
    rows = None
    if mesh is None:
        model = init_params(cfg, gen, device=device, trainable=True)
    else:
        model = sharded.init_sharded(cfg, gen, mesh, device)
        rows = batch_rows(cfg, mesh, args.batch, args.seq)
    opt = init_opt(sharded.model_params(model))
    start = 0

    pipe = TokenPipeline(vocab=cfg.vocab, global_batch=args.batch,
                         seq_len=args.seq, seed=args.seed)

    saver = AsyncSaver(args.ckpt_dir) if args.ckpt_dir and lead else None
    if args.resume and args.ckpt_dir:
        s = latest_step(args.ckpt_dir)
        if s is not None:
            opt, extra = restore(args.ckpt_dir, s, model, opt)
            start = int(extra["step"])
            say(f"resumed from step {start}")

    def save(step):
        tree = checkpoint_tree(model, opt)
        if saver:
            saver.submit(step, tree, {"step": step})

    def rollback():
        """Rank 0's verdict, held by every rank: the step to roll back
        to, or None."""
        s = None
        if saver:
            saver.wait()
            s = latest_step(args.ckpt_dir)
        return s if mesh is None else mesh.agree(s)

    def shard_rows(a):
        return a if rows is None else rows.shard(a)

    step_fn = make_train_step(cfg, adamw, args.accum)
    watchdog = Watchdog()
    losses = []
    t_start = time.time()
    step = start
    ambient = (contextlib.nullcontext() if mesh is None else use_mesh(
        mesh, args.batch // rows.shard_shape((args.batch, args.seq))[0]))
    with ambient:
        while step < args.steps:
            batch = {"tokens": torch.from_numpy(
                shard_rows(pipe.batch_at(step))).to(device)}
            if cfg.is_encdec:
                batch["frames"] = torch.from_numpy(shard_rows(pipe.frames_at(
                    step, cfg.n_audio_frames, cfg.d_model))).to(device)

            def emergency():
                # a failure on one rank of a mesh leaves the others in a
                # collective: no rank can gather a checkpoint then
                if saver and (mesh is None or mesh.size == 1):
                    save(step)

            with StepGuard(watchdog, on_emergency=emergency):
                model, opt, loss, metrics = step_fn(model, opt, batch)
                loss = float(loss)

            bad = not np.isfinite(loss)
            if mesh is not None and mesh.size > 1:
                bad = mesh.agree(bad)       # rank 0's verdict
            if bad:
                s = rollback()
                if s is not None:
                    opt, extra = restore(args.ckpt_dir, s, model, opt)
                    step = int(extra["step"])
                    say(f"non-finite loss; rolled back to step {step}")
                    continue
                raise FloatingPointError(f"non-finite loss at step {step}")

            losses.append(loss)
            step += 1
            if step % args.log_every == 0 or step == args.steps:
                say(f"step {step:5d} loss {loss:8.4f} "
                    f"gnorm {float(metrics.get('grad_norm', 0)):7.3f} "
                    f"dt {watchdog.ema:6.3f}s stragglers "
                    f"{watchdog.stragglers}", flush=True)
            if args.ckpt_dir and step % args.ckpt_every == 0:
                save(step)

    if args.ckpt_dir:
        save(step)
    if saver:
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
    if mesh is not None and mesh.size > 1:
        summary["mesh"] = mesh.shape
    say(json.dumps(summary))
    if args.metrics_out and lead:
        with open(args.metrics_out, "w") as f:
            json.dump({**summary, "losses": losses}, f)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
