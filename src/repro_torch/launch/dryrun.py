"""Multi-pod dry-run: one device of every (arch x shape x mesh) cell,
traced on fake tensors, with its memory, flops, bytes and collectives.

**What the counterpart measures.**  The JAX package's dry-run lowers and
compiles every cell's step (train, prefill or decode) on 256 / 512 fake
XLA devices and reads, per device, XLA's ``memory_analysis`` (argument,
temp, output and alias bytes of the compiled program), ``cost_analysis``
(flops, which count elementwise work too, and bytes accessed after
fusion; the layer scan's body extrapolated from two shallow depths) and
the collectives of the compiled HLO (ring formulas per kind), then puts
them on a roofline with a TPU's constants.

**What this module measures.**  PyTorch has no compiler that plans a
whole step, so the port runs the step itself, eagerly, on fake tensors:
this process joins a fake process group (``torch.testing._internal.
distributed.fake_pg``; ``launch.mesh.make_production_mesh(...,
backend="fake")``) as rank 0 of 256 (``data=16 x model=16``) or 512
(``pod=2 x data=16 x model=16``), builds the rank's real arguments under
``FakeTensorMode`` (nothing is allocated or computed) and runs the rank's
real step on them:

* **train**: ``runtime.sharded.init_sharded`` blocks, AdamW's moments,
  the rank's rows of the batch, ``launch.train.make_train_step(cfg,
  AdamWConfig(), accum)`` with the reference's ``accum = max(1, per_dev
  // 4)`` (``sync_grads`` and AdamW inside);
* **prefill / decode**: sharded serving (``models.model.prefill`` /
  ``decode_step`` on bf16 blocks split over ``model`` and cache blocks
  placed by ``cache_pspecs``: the KV caches as the rank's slice of the
  sequence).

Every rank's blocks have one shape, so rank 0 stands for every device, as
"per device" does in the reference.  The fake tensors are on ``cuda``
when this PyTorch is built with CUDA, else on ``cpu``: CPU-only PyTorch
cannot index a fake CUDA tensor, and the model path takes no branch on
the device, so the numbers are the same (``fake_device`` in the JSON).

The keys keep the reference's names where the quantity has a
counterpart:

* ``per_device.argument_bytes``: the rank's blocks of parameters,
  optimizer state, batch and cache at entry; ``peak_bytes``: the largest
  total of live storages during the step (a dispatch mode counts every
  storage an op creates until it is freed), arguments included;
  ``temp_bytes = peak - argument``; ``output_bytes``: the step's outputs;
  ``alias_bytes``: the outputs that reuse argument storage in place (the
  parameters, moments, cache); ``fits_hbm``: peak < 80 GB.
* ``hlo_flops``: ``torch.utils.flop_counter.FlopCounterMode``'s count of
  the step: matmuls and attention products only (XLA's also counts
  elementwise work).
* ``hlo_bytes``: the input plus output bytes of every aten op that is not
  a view, what each eager launch reads and writes with no fusion (not
  XLA's post-fusion count).
* ``collective_bytes`` / ``_counts`` / ``_by_kind``: the port's census
  (``core.collectives.record_collectives``: kind, operand and group size
  of each call) turned into wire bytes by the reference's ring formulas
  (:func:`wire_bytes`).
* ``roofline``: ``t_compute_s`` (flops at the bf16 peak), ``t_memory_s``
  (bytes at HBM's rate), ``t_collective_s`` (each call's wire bytes at
  its group's link: NVLink when every rank of the group is on one 8-card
  node, else InfiniBand), the ``dominant`` term, ``model_flops_global``
  (6·N·T train, 2·N·T prefill, 2·N per decoded token: the reference's),
  ``hlo_flops_global`` and ``useful_flops_ratio``.
* ``setup_s`` / ``trace_s``: seconds to build the mesh and the fake
  arguments, and to trace the step (the reference's ``lower_s`` /
  ``compile_s``).

The eager trace runs every layer, so the reference's depth extrapolation
(``_depth_variants``) has no counterpart, and ``layer_unroll`` /
``DRYRUN_LAYER_UNROLL`` (which only unroll XLA's layer scan) are not
read.  The port's schedule gathers each weight whole where it is read and
duplicates compute over ``model``, so ``useful_flops_ratio`` sits near
1/16 and cells that the reference fits may not fit: findings of the
port's design, not faults.

Usage:
  python -m repro_torch.launch.dryrun --arch yi-34b --shape train_4k
      [--multi-pod] [--strategy tp|dp] [--remat-policy full|dots|none]
      [--out FILE]
  python -m repro_torch.launch.dryrun --all [--jobs 4] [--out FILE]
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import subprocess
import sys
import tempfile
import time
import warnings
import weakref
from typing import Any, Callable

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.configs import SHAPES, ShapeConfig, get_config

__all__ = ["ARCHS", "PEAK_FLOPS", "HBM_BW", "HBM_BYTES", "NVLINK_BW",
           "IB_BW", "NODE_CARDS", "skip_reason", "wire_bytes",
           "result_bytes", "Cell", "build_cell", "measure", "run_cell",
           "predict", "main", "sweep"]

ARCHS = ["yi-34b", "stablelm-1.6b", "qwen2.5-3b", "granite-3-8b",
         "chameleon-34b", "xlstm-350m", "granite-moe-3b-a800m",
         "qwen3-moe-30b-a3b", "zamba2-1.2b", "whisper-large-v3"]

# hardware constants: NVIDIA H100 SXM5 80 GB at 700 W, NVIDIA's datasheet
PEAK_FLOPS = 989e12       # bf16 dense FLOP/s per card
HBM_BW = 3.35e12          # HBM3 bytes/s per card
HBM_BYTES = 80e9          # HBM bytes per card
NVLINK_BW = 450e9         # NVLink bytes/s a direction, within one node
IB_BW = 50e9              # InfiniBand NDR (400 Gb/s) bytes/s per card
NODE_CARDS = 8            # cards per node (ranks r // 8 share one)

#: the reference's collective kinds, in its order
KINDS = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
         "collective-permute")


def skip_reason(arch: str, shape_name: str) -> str | None:
    cfg = get_config(arch)
    if shape_name == "long_500k" and not cfg.sub_quadratic:
        return ("full-attention arch: 500k-context decode requires "
                "sub-quadratic attention (DESIGN.md §Arch-applicability)")
    return None


def wire_bytes(kind: str, nbytes: float, g: int) -> float:
    """Per-device wire bytes of one collective by the reference's ring
    formulas, ``nbytes`` the bytes of its result as the HLO states it:
    all-reduce ``2n(g-1)/g``; all-gather ``n(g-1)/g`` (``n`` the gathered
    size); reduce-scatter ``n(g-1)`` (``n`` the scattered size);
    all-to-all ``n(g-1)/g``; collective-permute ``n``.  A group of one
    moves nothing."""
    if g <= 1:
        return 0.0
    if kind == "all-reduce":
        return 2 * nbytes * (g - 1) / g
    if kind == "all-gather":
        return nbytes * (g - 1) / g
    if kind == "reduce-scatter":
        return nbytes * (g - 1)
    if kind == "all-to-all":
        return nbytes * (g - 1) / g
    if kind == "collective-permute":
        return nbytes
    raise ValueError(kind)


def result_bytes(rec) -> float:
    """The result's bytes of a census record (``core.collectives.
    Collective`` of an LM mesh, whose operand is what this rank handed
    the call): an all-gather's result is ``group`` operands, a
    reduce-scatter's one ``group``-th of its operand."""
    n = rec.nbytes
    if rec.kind == "all-gather":
        return n * rec.group
    if rec.kind == "reduce-scatter":
        return n / rec.group
    return n


def _group_ranks(mesh, axes) -> list:
    """The ranks of rank 0's group along ``axes`` (row-major mesh)."""
    import itertools

    ranks = []
    for idx in itertools.product(*(range(mesh.shape[a]) for a in axes)):
        c = dict(zip(axes, idx))
        r = 0
        for a in mesh.axis_names:
            r = r * mesh.shape[a] + c.get(a, 0)
        ranks.append(r)
    return ranks


def link_bw(mesh, axes) -> float:
    """The link a group along ``axes`` runs on: NVLink when all its ranks
    share one node, else InfiniBand."""
    nodes = {r // NODE_CARDS for r in _group_ranks(mesh, axes)}
    return NVLINK_BW if len(nodes) == 1 else IB_BW


def collective_stats(records, mesh) -> dict:
    """The census ``records`` as the reference's ``parse_collectives``
    reports them (per-kind wire bytes and counts, the total), plus the
    seconds each call's wire takes on its group's link."""
    stats = dict.fromkeys(KINDS, 0.0)
    counts = dict.fromkeys(KINDS, 0)
    seconds = 0.0
    for rec in records:
        if rec.group is None or rec.group <= 1:
            continue
        w = wire_bytes(rec.kind, result_bytes(rec), rec.group)
        stats[rec.kind] += w
        counts[rec.kind] += 1
        seconds += w / link_bw(mesh, rec.axis)
    return {"bytes": stats, "counts": counts,
            "total_bytes": sum(stats.values()), "seconds": seconds}


# ---------------------------------------------------------------------- #
# the cell: the rank's arguments and its step
# ---------------------------------------------------------------------- #
@dataclasses.dataclass(eq=False)
class Cell:
    """One device of a cell: its config, shape and mesh, and the step
    ``fn`` with its arguments ``args`` (``fn(*args)`` runs the step on
    them; ``arguments``, their tensors)."""

    cfg: Any
    shape: ShapeConfig
    mesh: Any
    fn: Callable
    args: tuple

    @property
    def arguments(self) -> list:
        return list(_tensors(self.args))


def _tensors(obj):
    """Every tensor in a (nested) structure of dicts, lists, tuples and
    modules' parameters."""
    if isinstance(obj, torch.Tensor):
        yield obj
    elif isinstance(obj, dict):
        for v in obj.values():
            yield from _tensors(v)
    elif isinstance(obj, (list, tuple)):
        for v in obj:
            yield from _tensors(v)
    elif isinstance(obj, torch.nn.Module):
        from repro_torch.runtime.sharded import model_params
        yield from model_params(obj).values()


def _storages(tensors) -> dict:
    """``{storage key: bytes}`` of the tensors' distinct storages."""
    out = {}
    for t in tensors:
        st = t.untyped_storage()
        out[st._cdata] = st.nbytes()
    return out


def build_cell(arch: str, shape_name: str | None = None,
               multi_pod: bool = False, cfg=None,
               accum_override: int | None = None,
               strategy: str | None = None,
               remat_policy: str | None = None, *, mesh=None,
               shape: ShapeConfig | None = None, device="cuda",
               generator: torch.Generator | None = None) -> Cell:
    """The cell's rank: its arguments made on ``device`` in the ambient
    mode (fake tensors under ``FakeTensorMode``; real ones otherwise,
    drawn from ``generator``) and its step.  ``mesh``: the rank's
    ``LMMesh`` (default: rank 0 of a fake production mesh, which this
    joins); ``shape``: a ``ShapeConfig`` in place of ``SHAPES[shape_name]``
    (both let ``chip_smoke.py`` hold a prediction against a real run)."""
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.launch.train import make_train_step
    from repro_torch.models.common import use_mesh
    from repro_torch.models.model import decode_step, prefill
    from repro_torch.optim import AdamWConfig, init_opt
    from repro_torch.runtime import sharded
    from repro_torch.runtime.sharding import NamedSharding, batch_pspecs

    cfg = cfg or get_config(arch)
    if strategy:
        cfg = dataclasses.replace(cfg, shard_strategy=strategy)
    if remat_policy:
        cfg = dataclasses.replace(cfg, remat_policy=remat_policy)
    shape = shape or SHAPES[shape_name]
    device = torch.device(device)
    if mesh is None:
        mesh = make_production_mesh(multi_pod=multi_pod, device=device,
                                    backend="fake", rank=0,
                                    world_size=512 if multi_pod else 256)
    serving = shape.kind != "train"
    bspec = batch_pspecs(cfg, shape, mesh)
    rows = NamedSharding(mesh, bspec["tokens"])
    b, s = shape.global_batch, shape.seq_len
    b_local = rows.shard_shape((b, s))[0]
    shards = b // b_local

    def frames():
        return torch.zeros((b_local, cfg.n_audio_frames, cfg.d_model),
                           dtype=torch.bfloat16, device=device)

    if not serving:
        model = sharded.init_sharded(cfg, generator, mesh, device)
        opt = init_opt(sharded.model_params(model))
        n_batch_shards = mesh.size if cfg.shard_strategy == "dp" \
            else mesh.size // mesh.shape["model"]
        per_dev = max(1, b // n_batch_shards)
        accum = accum_override or max(1, per_dev // 4)
        batch = {"tokens": torch.zeros((b_local, s), dtype=torch.int32,
                                       device=device)}
        if cfg.is_encdec:
            batch["frames"] = frames()
        step = make_train_step(cfg, AdamWConfig(), accum=accum)

        def train_step(model, opt, batch):
            with use_mesh(mesh, shards):
                model, opt, loss, _ = step(model, opt, batch)
            return model, opt, loss

        return Cell(cfg, shape, mesh, train_step, (model, opt, batch))

    model = sharded.init_sharded(cfg, generator, mesh, device,
                                 trainable=False, serving=True)
    cache = sharded.init_cache_sharded(cfg, b, s, mesh, torch.bfloat16,
                                       device)
    if shape.kind == "prefill":
        tokens = torch.zeros((b_local, s), dtype=torch.int32, device=device)
        extra = frames() if cfg.is_encdec else None

        def prefill_step(model, tokens, cache, extra):
            with use_mesh(mesh, shards):
                return prefill(model, cfg, tokens, cache, frames=extra)

        return Cell(cfg, shape, mesh, prefill_step,
                    (model, tokens, cache, extra))
    tokens = torch.zeros((b_local, 1), dtype=torch.int32, device=device)
    pos = torch.full((), s - 1, dtype=torch.int32, device=device)

    def serve_step(model, tokens, cache, pos):
        with use_mesh(mesh, shards):
            return decode_step(model, cfg, tokens, cache, pos)

    return Cell(cfg, shape, mesh, serve_step, (model, tokens, cache, pos))


#: op namespaces whose calls move no tensor bytes of the step: metadata
#: queries (``prim.device``) and the collectives (the census counts them)
_UNCOUNTED = ("prim", "c10d", "_c10d_functional", "c10d_functional")


class _Trace(TorchDispatchMode):
    """A dispatch mode over one step: the bytes every non-view aten op
    reads and writes, and the live total of the storages ops create
    (each counted until it is freed) beside the storages ``alive`` at
    entry (keys of :func:`_storages`)."""

    def __init__(self, alive: dict):
        super().__init__()
        self.seen = set(alive)
        self.live = self.peak = 0
        self.bytes = 0

    def _free(self, key, n):
        self.seen.discard(key)
        self.live -= n

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if not func.is_view and func.namespace not in _UNCOUNTED:
            self.bytes += sum(t.numel() * t.element_size()
                              for t in _flat((args, kwargs or {}, out)))
        for t in _flat(out):
            st = t.untyped_storage()
            key = st._cdata
            if key in self.seen:
                continue
            self.seen.add(key)
            n = st.nbytes()
            self.live += n
            self.peak = max(self.peak, self.live)
            weakref.finalize(st, self._free, key, n)
        return out


def _flat(obj):
    """The tensors of an op's arguments or result."""
    from torch.utils._pytree import tree_leaves
    return [t for t in tree_leaves(obj) if isinstance(t, torch.Tensor)]


def measure(cell: Cell) -> dict:
    """Run the cell's step once under the counters: flops, bytes, the
    census, and the memory of its arguments, outputs and peak."""
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.core.collectives import record_collectives

    arg = _storages(cell.arguments)
    trace = _Trace(arg)
    t0 = time.perf_counter()
    with record_collectives() as log, FlopCounterMode(display=False) as fc, \
            trace:
        out = cell.fn(*cell.args)
    seconds = time.perf_counter() - t0
    outs = _storages(_tensors(out))
    alias = sum(n for k, n in outs.items() if k in arg)
    arg_b = sum(arg.values())
    peak = arg_b + trace.peak
    return {"argument_bytes": arg_b, "temp_bytes": peak - arg_b,
            "output_bytes": sum(outs.values()), "alias_bytes": alias,
            "peak_bytes": peak, "fits_hbm": bool(peak < HBM_BYTES),
            "hlo_flops": float(fc.get_total_flops()),
            "hlo_bytes": float(trace.bytes),
            "census": log, "trace_s": seconds, "result": out}


def model_flops(cfg, shape: ShapeConfig) -> float:
    """6·N·T (train), 2·N·T (prefill) or 2·N per decoded token, N the
    active parameters: the reference's."""
    n_active = cfg.n_active_params()
    if shape.kind == "train":
        return 6.0 * n_active * shape.global_batch * shape.seq_len
    if shape.kind == "prefill":
        return 2.0 * n_active * shape.global_batch * shape.seq_len
    return 2.0 * n_active * shape.global_batch


def fake_device() -> str:
    """The fake tensors' device: ``cuda`` when this PyTorch is built with
    CUDA (CPU-only PyTorch cannot index a fake CUDA tensor)."""
    return "cuda" if torch.backends.cuda.is_built() else "cpu"


def _report(cell: Cell, got: dict) -> dict:
    coll = collective_stats(got["census"], cell.mesh)
    n_chips = cell.mesh.size
    flops_dev, bytes_dev = got["hlo_flops"], got["hlo_bytes"]
    mf = model_flops(cell.cfg, cell.shape)
    t_compute = flops_dev / PEAK_FLOPS
    t_memory = bytes_dev / HBM_BW
    t_coll = coll["seconds"]
    dominant = max(("compute", t_compute), ("memory", t_memory),
                   ("collective", t_coll), key=lambda kv: kv[1])[0]
    per = {k: got[k] for k in ("argument_bytes", "temp_bytes",
                               "output_bytes", "alias_bytes", "peak_bytes",
                               "fits_hbm", "hlo_flops", "hlo_bytes")}
    per.update(collective_bytes=coll["total_bytes"],
               collective_counts=coll["counts"],
               collective_by_kind=coll["bytes"])
    return {"n_chips": n_chips, "per_device": per, "roofline": {
        "t_compute_s": t_compute, "t_memory_s": t_memory,
        "t_collective_s": t_coll, "dominant": dominant,
        "model_flops_global": mf, "hlo_flops_global": flops_dev * n_chips,
        "useful_flops_ratio": mf / max(flops_dev * n_chips, 1.0)}}


def _quiet():
    # the fake group's calls go through c10d's deprecated names
    warnings.filterwarnings("ignore", category=FutureWarning)
    warnings.filterwarnings("ignore", message=".*data pointer of FakeTensor")


def run_cell(arch: str, shape_name: str, multi_pod: bool,
             strategy: str | None = None,
             remat_policy: str | None = None) -> dict:
    from torch._subclasses.fake_tensor import FakeTensorMode

    mesh_name = "2x16x16" if multi_pod else "16x16"
    reason = skip_reason(arch, shape_name)
    if reason:
        return {"arch": arch, "shape": shape_name, "mesh": mesh_name,
                "status": "skip", "reason": reason}
    _quiet()
    dev = fake_device()
    t0 = time.perf_counter()
    with FakeTensorMode(allow_non_fake_inputs=True):
        cell = build_cell(arch, shape_name, multi_pod, strategy=strategy,
                          remat_policy=remat_policy, device=dev)
        setup_s = time.perf_counter() - t0
        got = measure(cell)
    return {"arch": arch, "shape": shape_name, "mesh": mesh_name,
            "status": "ok", "fake_device": dev,
            "setup_s": round(setup_s, 1), "trace_s": round(got["trace_s"], 1),
            **_report(cell, got)}


def predict(arch: str, kind: str, batch: int, seq: int, sizes: tuple,
            axes: tuple, remat_policy: str | None = None) -> dict:
    """The dry-run of one rank of a mesh ``sizes`` over ``axes`` (a fake
    group of ``prod(sizes)`` ranks, as rank 0; a virtual mesh for one) at
    a ``ShapeConfig(kind, seq, batch)``: the numbers ``chip_smoke.py``
    holds against the same step run for real.  Joins a fake process group
    when the mesh has more than one rank: call it in a process of its
    own."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.launch.mesh import make_mesh

    _quiet()
    dev = fake_device()
    world = math.prod(sizes)
    mesh = make_mesh(tuple(sizes), tuple(axes), device=dev) if world == 1 \
        else make_mesh(tuple(sizes), tuple(axes), device=dev,
                       backend="fake", rank=0, world_size=world)
    shape = ShapeConfig(kind, seq, batch, kind)
    with FakeTensorMode(allow_non_fake_inputs=True):
        cell = build_cell(arch, remat_policy=remat_policy,
                          mesh=mesh, shape=shape, device=dev)
        got = measure(cell)
    return {"arch": arch, "kind": kind, "batch": batch, "seq": seq,
            "mesh": dict(zip(axes, sizes)), "fake_device": dev,
            **_report(cell, got)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--strategy", default=None, help="tp|dp override")
    ap.add_argument("--remat-policy", default=None,
                    help="full|dots|none override")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--jobs", type=int, default=4)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    if args.all:
        return sweep(args.jobs, args.out or "dryrun_results.json")

    res = run_cell(args.arch, args.shape, args.multi_pod,
                   strategy=args.strategy, remat_policy=args.remat_policy)
    js = json.dumps(res, indent=2)
    print(js)
    if args.out:
        with open(args.out, "w") as f:
            f.write(js)
    return 0 if res["status"] in ("ok", "skip") else 1


def sweep(jobs: int, out: str) -> int:
    """Run every cell in its own subprocess (isolation + parallelism)."""
    cells = [(a, s, mp) for a in ARCHS for s in SHAPES for mp in
             (False, True)]
    results = []
    cells_iter = iter(cells)
    tmp = tempfile.mkdtemp(prefix="dryrun_")

    def path(cell):
        a, s, mp = cell
        return os.path.join(tmp, f"{a}_{s}_{int(mp)}.json")

    def launch(cell):
        a, s, mp = cell
        cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
               "--arch", a, "--shape", s, "--out", path(cell)]
        if mp:
            cmd.append("--multi-pod")
        with open(path(cell) + ".err", "w") as err:
            return subprocess.Popen(cmd, stdout=subprocess.DEVNULL,
                                    stderr=err)

    active = {}
    try:
        while True:
            while len(active) < jobs:
                try:
                    cell = next(cells_iter)
                except StopIteration:
                    break
                active[launch(cell)] = cell
            if not active:
                break
            for p in list(active):
                if p.poll() is not None:
                    cell = active.pop(p)
                    a, s, mp = cell
                    f = path(cell)
                    if p.returncode == 0 and os.path.exists(f):
                        with open(f) as fh:
                            results.append(json.load(fh))
                    else:
                        with open(f + ".err") as fh:
                            err = fh.read()[-2000:]
                        results.append({
                            "arch": a, "shape": s,
                            "mesh": "2x16x16" if mp else "16x16",
                            "status": "error", "error": err})
                    r = results[-1]
                    print(f"[{len(results)}/{len(cells)}] {a} x {s} x "
                          f"{r['mesh']}: {r['status']}", flush=True)
            time.sleep(0.5)
    finally:
        for p in active:
            p.kill()
    with open(out, "w") as f:
        json.dump(results, f, indent=2)
    n_ok = sum(r["status"] == "ok" for r in results)
    n_skip = sum(r["status"] == "skip" for r in results)
    n_err = len(results) - n_ok - n_skip
    print(f"ok={n_ok} skip={n_skip} error={n_err} -> {out}")
    return 0 if n_err == 0 else 1


if __name__ == "__main__":
    sys.exit(main())
