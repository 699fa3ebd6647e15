"""The mesh trainer against the one-device trainer.

    python -m repro_torch.testing.train_mesh_check [--device cuda|cpu]
        [--dist-backend gloo|nccl] [--arch qwen2.5-3b]

trains ``<arch>`` at ``reduced()`` and float32 compute for 3 AdamW steps
(lr 3e-5, warmup 1, 4 x 32 from the ``TokenPipeline``, seed 0) once on
one device (this process) and once on a spawned 2x2 ``data x model``
process mesh (``launch.mesh.spawn_mesh``; parameters and moments sharded
by ``param_pspecs``, the batch by ``batch_pspecs``), and prints
``LOSSES``, ``GRAD_NORMS`` (both runs), ``GRAD_REL`` (the worst leaf's
gradient after step 1 against the one-device gradient's block, over every
rank), ``PARAM_DIFF_LR`` (the largest ``|p_mesh - p_one|`` after the last
step, in units of lr), ``SHAPES ok`` when every rank's blocks have its
specs' shapes, then ``OK`` or ``FAIL`` against :data:`LOSS_REL`,
:data:`NORM_REL`, :data:`GRAD_REL` and :data:`PARAM_LR`.

:func:`run_steps`, :func:`grad_diff` and :func:`param_diff` are the pieces
``chip_smoke.py``'s phase ``shard`` and the tests drive.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import sys

import numpy as np
import torch

from repro_torch.launch.mesh import add_dist_backend, spawn_mesh

#: the gates of a float32 run on a mesh against one device.  Only the
#: summation order differs (each data shard's mean, then the mean of the
#: shards; the gradient's blocks summed over the ranks), so the loss, the
#: norm and each leaf's gradient agree to a few float32 roundings of their
#: sums; a sync missed or doubled on one leaf, or a block not divided by
#: the rank count, moves that leaf's gradient by 50% or more.
#: ``GRAD_REL``: ``|g_mesh - g_one| / |g_one|`` (2-norms) of each leaf's
#: block after step 1, read as AdamW's first moment, ``(1 - b1)`` times
#: the clipped gradient.  ``PARAM_LR``: the largest ``|p_mesh - p_one|``
#: after :data:`STEPS` steps, in units of lr.  Readings at ``reduced()``
#: (PERF.md §6): grad norm 9e-8, parameters 0.011 lr on the CPU, 0.031
#: lr on the card
LOSS_REL = 1e-5
NORM_REL = 1e-4
GRAD_REL = 1e-4
PARAM_LR = 0.1
#: the check's run: ranks, steps, batch, sequence and learning rate
RANKS, STEPS, BATCH, SEQ, LR = 4, 3, 4, 32, 3e-5


def run_steps(cfg, device, *, steps: int, batch: int, seq: int,
              lr: float = 3e-5, seed: int = 0, mesh=None, first: int = 0,
              model=None, opt=None, after=None):
    """Steps ``first .. first+steps-1`` of ``make_train_step`` (AdamW, lr
    ``lr``, warmup 1) on the ``TokenPipeline``'s batches, in the
    deterministic mode; on ``mesh`` with the model sharded and each rank
    on its rows.  A new model from ``seed`` unless ``model``/``opt`` are
    given; ``after(step, model, opt)`` is called after each step, outside
    its timing.  Returns ``(model, opt, row)``: ``row`` holds the losses,
    grad norms and each step's ms (CUDA events on a card, the host clock
    otherwise)."""
    import time

    from repro_torch.data import TokenPipeline
    from repro_torch.launch.train import (batch_rows, deterministic,
                                          make_train_step)
    from repro_torch.models.common import use_mesh
    from repro_torch.models.model import init_params
    from repro_torch.optim import AdamWConfig, init_opt
    from repro_torch.runtime.sharded import init_sharded, model_params

    device = torch.device(device)
    if model is None:
        gen = torch.Generator(device=device).manual_seed(seed)
        model = (init_params(cfg, gen, device=device, trainable=True)
                 if mesh is None else init_sharded(cfg, gen, mesh, device))
        opt = init_opt(model_params(model))
    step_fn = make_train_step(cfg, AdamWConfig(
        lr=lr, warmup_steps=1, total_steps=first + steps))
    pipe = TokenPipeline(vocab=cfg.vocab, global_batch=batch, seq_len=seq,
                         seed=seed)
    rows = None if mesh is None else batch_rows(cfg, mesh, batch, seq)
    ambient = contextlib.nullcontext() if mesh is None else use_mesh(
        mesh, batch // rows.shard_shape((batch, seq))[0])
    cuda = device.type == "cuda"
    losses, norms, ms = [], [], []
    with ambient, deterministic():
        for i in range(first, first + steps):
            parts = {"tokens": pipe.batch_at(i)}
            if cfg.is_encdec:
                parts["frames"] = pipe.frames_at(i, cfg.n_audio_frames,
                                                 cfg.d_model)
            data = {k: torch.from_numpy(a if rows is None
                                        else rows.shard(a)).to(device)
                    for k, a in parts.items()}
            if cuda:
                ev = [torch.cuda.Event(enable_timing=True) for _ in "ab"]
                ev[0].record()
            else:
                t0 = time.perf_counter()
            model, opt, loss, met = step_fn(model, opt, data)
            if cuda:
                ev[1].record()
                ev[1].synchronize()
                ms.append(ev[0].elapsed_time(ev[1]))
            else:
                ms.append((time.perf_counter() - t0) * 1e3)
            losses.append(float(loss))
            norms.append(float(met["grad_norm"]))
            if after is not None:
                after(i, model, opt)
    return model, opt, {"losses": losses, "grad_norms": norms,
                        "step_ms": ms}


def whole_params(model) -> dict:
    """Every parameter whole, on the host (float32 numpy): on a sharded
    model every rank calls this and rank 0 gets the dict (the others
    ``None``)."""
    from repro_torch.runtime.sharded import full_tensor, model_params

    st = getattr(model, "sharding", None)
    out = {}
    for k, t in model_params(model).items():
        full = t.detach() if st is None else full_tensor(t,
                                                         st.placements[k])
        out[k] = full.cpu().numpy()
    return out if st is None or st.mesh.rank in (None, 0) else None


def param_diff(model, ref: dict | None) -> float | None:
    """The largest ``|p - ref[name]|`` over every parameter (``ref``:
    whole tensors or arrays by name, needed on rank 0 only).  On a sharded
    model every rank calls this (each leaf is gathered to compare) and
    rank 0 gets the value; the others ``None``."""
    from repro_torch.runtime.sharded import full_tensor, model_params

    st = getattr(model, "sharding", None)
    lead = st is None or st.mesh.rank in (None, 0)
    worst = 0.0
    for k, t in model_params(model).items():
        full = t.detach() if st is None else full_tensor(t,
                                                         st.placements[k])
        if lead:
            r = torch.as_tensor(ref[k]).to(full.device)
            worst = max(worst, float((full - r).abs().max()))
        del full
    return worst if lead else None


def first_moments(model, opt) -> dict:
    """AdamW's first moment of every parameter, whole, on the host
    (float32 numpy); on a sharded model every rank calls this and rank 0
    gets the dict (the others ``None``)."""
    from repro_torch.runtime.sharded import full_tensor

    st = getattr(model, "sharding", None)
    out = {k: np.array((m if st is None else full_tensor(
        m, st.placements[k])).cpu()) for k, m in opt.m.items()}
    return out if st is None or st.mesh.rank in (None, 0) else None


def grad_diff(model, opt, ref: dict) -> tuple[float, str]:
    """``(worst, leaf)``: the largest ``|m - m_one| / |m_one|`` (2-norms,
    float64) over this rank's blocks of AdamW's first moment, ``ref``
    holding the one-device trainer's whole moments (:func:`first_moments`)
    after the same step; ``ref`` may be any mapping, read once per leaf in
    ``opt.m``'s order.  After step 1 the moment is ``(1 - b1)`` times the
    synced, clipped gradient, so this holds each leaf's gradient block on
    every rank (replicas included)."""
    st = getattr(model, "sharding", None)
    worst, leaf = 0.0, ""
    for k, m in opt.m.items():
        want = torch.as_tensor(ref[k])
        if st is not None:
            want = st.placements[k].shard(want)
        want = want.to(m.device, torch.float64)
        err = float(torch.linalg.vector_norm(m.detach().double() - want))
        top = float(torch.linalg.vector_norm(want))
        rel = err / top if top else err
        if rel >= worst:
            worst, leaf = rel, k
    return worst, leaf


def block_shapes(model) -> tuple[bool, dict]:
    """``(every block has its spec's shard shape, the blocks' shapes)``."""
    st = model.sharding
    shapes = {k: tuple(t.shape) for k, t in st.params.items()}
    ok = all(shapes[k] == st.placements[k].shard_shape(st.shapes[k])
             for k in shapes)
    return ok, shapes


def checksums(model) -> list:
    """Each parameter block's int64 sum of its float32 bits."""
    from repro_torch.runtime.sharded import model_params

    return [int(t.detach().view(torch.int32).to(torch.int64).sum())
            for t in model_params(model).values()]


def _f32(arch: str):
    from repro_torch.configs import get_config

    return dataclasses.replace(get_config(arch).reduced(),
                               compute_dtype="float32")


def _rank(mesh, arch: str, ref: dict) -> dict:
    seen = {}

    def after(i, model, opt):
        if i == 0:
            seen["grad"] = grad_diff(model, opt, ref["m1"])
    model, _, row = run_steps(_f32(arch), mesh.device, steps=STEPS,
                              batch=BATCH, seq=SEQ, lr=LR, mesh=mesh,
                              after=after)
    ok, _ = block_shapes(model)
    return {**row, "shapes_ok": ok, "grad": seen["grad"],
            "param_diff": param_diff(model, ref["params"])}


def one_device(arch: str, device) -> tuple[dict, dict]:
    """The one-device run's row and what the ranks are held to: its
    whole parameters after the last step (``params``) and AdamW's first
    moments after step 1 (``m1``)."""
    ref = {}

    def after(i, model, opt):
        if i == 0:
            ref["m1"] = first_moments(model, opt)
    model, _, row = run_steps(_f32(arch), device, steps=STEPS, batch=BATCH,
                              seq=SEQ, lr=LR, after=after)
    ref["params"] = whole_params(model)
    return row, ref


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--arch", default="qwen2.5-3b")
    add_dist_backend(ap)
    args = ap.parse_args(argv)
    one, ref = one_device(args.arch, args.device)
    ranks = spawn_mesh(_rank, RANKS, args.device, backend=args.dist_backend,
                       args=(args.arch, ref), timeout=600)
    got = ranks[0]
    ok = all(r["losses"] == got["losses"] and
             r["grad_norms"] == got["grad_norms"] for r in ranks)
    print(f"RANKS {'ok' if ok else 'BAD'}")
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(got["losses"],
                                                        one["losses"]))
    norm_rel = max(abs(a - b) / abs(b) for a, b in zip(got["grad_norms"],
                                                        one["grad_norms"]))
    grad_rel, leaf = max(r["grad"] for r in ranks)
    diff_lr = got["param_diff"] / LR
    shapes = all(r["shapes_ok"] for r in ranks)
    print(f"LOSSES mesh {got['losses']} one {one['losses']} "
          f"rel {loss_rel:.3e}")
    print(f"GRAD_NORMS mesh {got['grad_norms']} one {one['grad_norms']} "
          f"rel {norm_rel:.3e}")
    print(f"GRAD_REL {grad_rel:.3e} {leaf}")
    print(f"PARAM_DIFF_LR {diff_lr:.3e}")
    print(f"SHAPES {'ok' if shapes else 'BAD'}")
    ok &= (loss_rel <= LOSS_REL and norm_rel <= NORM_REL and shapes
           and grad_rel <= GRAD_REL and diff_lr <= PARAM_LR)
    print("OK" if ok else "FAIL")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
