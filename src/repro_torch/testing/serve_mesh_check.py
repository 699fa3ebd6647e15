"""Sharded serving against one device.

    python -m repro_torch.testing.serve_mesh_check [--device cuda|cpu]
        [--dist-backend gloo|nccl] [--arch qwen2.5-3b ...]

serves each ``<arch>`` at ``reduced()``, float32 compute and float32
caches, every leaf (zamba's conv state too; bf16 weights, the serving
dtype): a prompt of :data:`PROMPT`
tokens in :data:`BATCH` rows (``default_rng(seed)``; whisper with random
frames), prefill, then :data:`STEPS` greedy steps, once on one device
(this process) and once on a spawned 2x2 ``data x model`` process mesh
(``launch.mesh.spawn_mesh``): weights split over ``model``
(``param_pspecs(..., serving=True)``), the rows over ``data``
(``batch_pspecs``), the caches by ``cache_pspecs``, the KV caches as each
rank's slice of the slots (``models.attention.SeqSplit``).  The cache
holds :data:`SLOTS` slots, so the second slice holds no valid slot until
the decode reaches it.  Prints ``TOKENS`` (equal on every rank's rows),
``LOGIT_REL`` (the largest ``|logit - ref| / max|ref|``), ``CACHE_REL``
(every rank's block against its slice of the one-device cache, each leaf
over its own max), ``POS_FORMS`` (the first arch decoded with ``pos`` as
an int, a 0-d tensor and one per row: bit for bit) and ``OK`` or
``FAIL`` against :data:`GATE`.

:func:`serve_steps` is the piece ``chip_smoke.py`` and the tests drive.
"""
from __future__ import annotations

import argparse
import contextlib
import sys

import numpy as np
import torch

from repro_torch.launch.mesh import add_dist_backend, spawn_mesh

#: a float32 mesh run against one device: only the attention combine's
#: summation order (and the products' row blocking) differs
GATE = 1e-5
#: the check's run: ranks, rows, prompt, greedy steps, cache slots
RANKS, BATCH, PROMPT, STEPS, SLOTS = 4, 4, 6, 4, 16
ARCHS = ("qwen2.5-3b", "granite-moe-3b-a800m", "xlstm-350m", "zamba2-1.2b",
         "whisper-large-v3")


def prompt(cfg, batch: int, seq: int, seed: int = 0) -> dict:
    """The prompt (and whisper's frames) as numpy arrays."""
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab, (batch, seq)).astype(
        np.int64)}
    if cfg.is_encdec:
        out["frames"] = rng.standard_normal(
            (batch, cfg.n_audio_frames, cfg.d_model)).astype(np.float32)
    return out


def serve_steps(cfg, device, *, batch: int, seq: int, steps: int,
                slots: int, seed: int = 0, mesh=None,
                kv_dtype=torch.float32,
                model=None, keep_cache: bool = True,
                pos_form: str = "int") -> dict:
    """Prefill ``seq`` tokens of ``batch`` rows into a ``slots``-slot
    cache, then ``steps`` greedy steps (argmax over the real vocab;
    ``pos`` an int, or with ``pos_form`` a 0-d tensor, ``"scalar"``, or
    one per row, ``"rows"``), on one device or on ``mesh`` (this rank's
    rows and blocks;
    ``model``: a model already built for it).  Returns the tokens
    (``(rows, steps + 1)``), the logits of each step (``(steps + 1, rows,
    vocab_padded)`` float32, numpy), the cache (numpy blocks, with
    ``keep_cache``), the model, and the host ms of the prefill and of
    each step (on a card after a synchronise)."""
    import time
    from repro_torch.launch.train import batch_rows
    from repro_torch.models.common import use_mesh
    from repro_torch.models.model import (decode_step, init_cache,
                                          init_params, prefill)
    from repro_torch.runtime import sharded

    device = torch.device(device)
    data = prompt(cfg, batch, seq, seed)
    rows = None if mesh is None else batch_rows(cfg, mesh, batch, seq)
    if model is None:
        gen = torch.Generator(device=device).manual_seed(seed)
        if mesh is None:
            model = init_params(cfg, gen, device=device).to(torch.bfloat16)
        else:
            model = sharded.init_sharded(cfg, gen, mesh, device,
                                         trainable=False, serving=True)
    if mesh is None:
        cache = init_cache(cfg, batch, slots, kv_dtype, device=device)
        ambient = contextlib.nullcontext()
    else:
        cache = sharded.init_cache_sharded(cfg, batch, slots, mesh,
                                           kv_dtype, device)
        ambient = use_mesh(mesh, batch // rows.shard_shape((batch, seq))[0])
    if kv_dtype == torch.float32:
        _widen(cache)

    def mine(a):
        a = a if rows is None else rows.shard(a)
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    tok = mine(data["tokens"])
    frames = mine(data["frames"]) if cfg.is_encdec else None
    logits = []

    def now():
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        return time.perf_counter()

    step_ms = []
    with ambient:
        t0 = now()
        cache, last = prefill(model, cfg, tok, cache, frames=frames)
        prefill_ms = (now() - t0) * 1e3
        step = last[:, 0]
        out = []
        for i in range(steps + 1):
            logits.append(step.float().cpu().numpy())
            nxt = step[:, :cfg.vocab].argmax(dim=-1)
            out.append(nxt.cpu().numpy())
            if i == steps:
                break
            pos = seq + i
            if pos_form != "int":
                pos = torch.full(() if pos_form == "scalar" else
                                 (nxt.shape[0],), pos, dtype=torch.int32,
                                 device=device)
            t0 = now()
            step, cache = decode_step(model, cfg, nxt[:, None], cache, pos)
            step_ms.append((now() - t0) * 1e3)

    def host(tree):
        return {k: host(v) if isinstance(v, dict)
                else v.float().cpu().numpy() for k, v in tree.items()}
    return {"tokens": np.stack(out, axis=1), "logits": np.stack(logits),
            "cache": host(cache) if keep_cache else None, "model": model,
            "placements": getattr(cache, "placements", None),
            "prefill_ms": prefill_ms, "step_ms": step_ms}


def _widen(cache: dict) -> None:
    """Every leaf of ``cache`` float32, in place of the tree's tensors
    (zamba's conv state is bf16 whatever the KV dtype: a last-bit
    difference upstream flips it by a bf16 step, which the decode then
    carries into every later logit)."""
    for k, v in cache.items():
        if isinstance(v, dict):
            _widen(v)
        else:
            cache[k] = v.to(torch.float32)


def _leaves(tree, path=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, path + (k,))
        else:
            yield path + (k,), v


def compare(one: dict, got: dict, rows, placements) -> dict:
    """A mesh rank's run ``got`` against the one-device run ``one``: its
    tokens equal to its rows', the logits' and every cache block's
    largest difference over the reference's max (a leaf whose max is 0
    counts its largest difference)."""
    def rel(a, b):
        top = float(np.abs(b).max())
        return float(np.abs(a - b).max()) / (top if top > 0 else 1.0)

    want_tok = rows.shard(one["tokens"])
    want_log = np.stack([rows.shard(a) for a in one["logits"]])
    cache = {}
    whole = dict(_leaves(one["cache"]))
    pl = dict(_leaves(placements))
    for path, block in _leaves(got["cache"]):
        cache["/".join(path)] = rel(block, pl[path].shard(whole[path]))
    return {"tokens_equal": bool(np.array_equal(got["tokens"], want_tok)),
            "logit_rel": rel(got["logits"], want_log),
            "cache_rel": max(cache.values()), "cache_by_leaf": cache}


def _rank(mesh, archs: list, one: dict) -> dict:
    from repro_torch.launch.train import batch_rows

    out = {"rank": mesh.rank, "mesh": mesh.shape}
    for arch in archs:
        cfg = _cfg(arch)
        got = serve_steps(cfg, mesh.device, batch=BATCH, seq=PROMPT,
                          steps=STEPS, slots=SLOTS, mesh=mesh)
        rows = batch_rows(cfg, mesh, BATCH, PROMPT)
        out[arch] = compare(one[arch], got, rows, got["placements"])
        if arch == archs[0]:
            # the tensor forms of pos: the same writes, the same bits
            out["pos_forms_equal"] = all(
                _same_bits(got, serve_steps(
                    cfg, mesh.device, batch=BATCH, seq=PROMPT, steps=STEPS,
                    slots=SLOTS, mesh=mesh, model=got["model"],
                    pos_form=form)) for form in ("scalar", "rows"))
    return out


def _same_bits(a: dict, b: dict) -> bool:
    """Two runs' tokens, logits and cache blocks equal bit for bit."""
    return (np.array_equal(a["tokens"], b["tokens"])
            and np.array_equal(a["logits"].view(np.int32),
                               b["logits"].view(np.int32))
            and all(np.array_equal(x.view(np.int32), y.view(np.int32))
                    for (_, x), (_, y) in zip(_leaves(a["cache"]),
                                              _leaves(b["cache"]))))


def _cfg(arch: str):
    import dataclasses

    from repro_torch.configs import get_config
    return dataclasses.replace(get_config(arch).reduced(),
                               compute_dtype="float32")


def one_device(archs, device) -> dict:
    """Each arch's one-device run (tokens, logits, cache)."""
    out = {}
    for arch in archs:
        r = serve_steps(_cfg(arch), device, batch=BATCH, seq=PROMPT,
                        steps=STEPS, slots=SLOTS)
        out[arch] = {k: r[k] for k in ("tokens", "logits", "cache")}
    return out


def run(archs, device, backend: str = "gloo") -> tuple[dict, list]:
    one = one_device(archs, device if backend == "gloo" else "cuda")
    ranks = spawn_mesh(_rank, RANKS, device, backend=backend,
                       args=(list(archs), one), timeout=600)
    return one, ranks


def report(archs, ranks: list) -> bool:
    ok = True
    for arch in archs:
        rows = [r[arch] for r in ranks]
        tok = all(r["tokens_equal"] for r in rows)
        lrel = max(r["logit_rel"] for r in rows)
        crel = max(r["cache_rel"] for r in rows)
        good = tok and lrel <= GATE and crel <= GATE
        print(f"{arch} TOKENS {'equal' if tok else 'DIFFER'} LOGIT_REL "
              f"{lrel:.3e} CACHE_REL {crel:.3e} {'ok' if good else 'BAD'}")
        ok = ok and good
    forms = all(r["pos_forms_equal"] for r in ranks)
    print(f"POS_FORMS {'equal' if forms else 'DIFFER'}")
    ok = ok and forms
    print("OK" if ok else "FAIL")
    return ok


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="where the ranks run: cuda (default) or cpu")
    ap.add_argument("--arch", nargs="+", default=list(ARCHS))
    add_dist_backend(ap)
    args = ap.parse_args(argv)
    _, ranks = run(args.arch, args.device, args.dist_backend)
    return 0 if report(args.arch, ranks) else 1


if __name__ == "__main__":
    sys.exit(main())
