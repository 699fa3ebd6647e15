"""One run of one cell: set-up, window, the check against the plain
reference, and the result line.

Everything is found by name.  ``BENCHMARK.json`` names the cell's
configuration (``perfbench/configs/<config>.json``), its traffic mix
(``perfbench/traffic/<traffic>.json``, which names its generator) and the
metrics it reports; each metric is read from the run's record by
``perfbench/metrics/<metric>.py`` (``read(record) -> float | None``;
``None`` leaves the metric out).  A configuration names its operator
generator (``perfbench/operators/``).  So a later change adds a cell, a
mix, a configuration or a metric as new files and an entry in
``BENCHMARK.json``, and edits no file.

The record the readers see: ``setup_s`` (process start to the first
timed solve), ``plan_build_s``, ``window_s``, ``solves``, ``iters`` (per
window solve), ``solve_wall_s``, ``peak_bytes``, ``n``, ``nnz``; in a
traced run ``profile`` (one more solve under the profiler: ``busy_s``,
``window_s``, ``launches``, ``iters``, ``idle_share``) and ``spmv_ms``
(one plan SpMV, CUDA events over back-to-back calls) with
``bytes_per_s`` (the card's peak, ``perfbench/peaks.py``).
"""
from __future__ import annotations

import importlib.util
import json
import statistics
import sys
import time
from pathlib import Path

import torch

from perfbench import peaks, system, traffic
from perfbench.operators import generate
from perfbench.reference import DeviceCSR

__all__ = ["ROOT", "Dirs", "run", "load_cell", "metric_entries",
           "read_metric"]

ROOT = Path(__file__).resolve().parents[1]


class Dirs:
    """Where the harness finds things by name (a test points it at its
    own benchmark file and configurations), and where it keeps the
    operators it has made."""

    def __init__(self, bench: Path = ROOT / "BENCHMARK.json",
                 configs: Path = ROOT / "perfbench" / "configs",
                 traffic_dir: Path = traffic.DIR,
                 metrics: Path = ROOT / "perfbench" / "metrics",
                 cache: Path = ROOT / "build" / "perfbench" / "operators"):
        self.bench, self.configs = Path(bench), Path(configs)
        self.traffic, self.metrics = Path(traffic_dir), Path(metrics)
        self.cache = Path(cache)


def load_cell(name: str, dirs: Dirs) -> tuple[dict, dict, dict, dict]:
    """``(benchmark, cell, configuration, traffic mix)`` of cell ``name``."""
    bench = json.loads(dirs.bench.read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in {dirs.bench.name}; have "
                       f"{sorted(cells)}")
    cell = cells[name]
    cfg = json.loads((dirs.configs / f"{cell['config']}.json").read_text())
    return bench, cell, cfg, traffic.load(cell["traffic"], dirs.traffic)


def metric_entries(bench: dict, cell: str, trace: bool) -> list:
    """The metrics cell ``cell`` reports: its per-layer ones in a traced
    run, its end-to-end ones otherwise (an entry without ``workloads``
    is every cell's)."""
    group = bench["per_layer" if trace else "end_to_end"]
    return [m for m in group if cell in m.get("workloads", [cell])]


def read_metric(entry: dict, record: dict, directory: Path):
    """The value ``perfbench/metrics/<name>.py`` reads from ``record``, or
    ``None``."""
    path = Path(directory) / f"{entry['name']}.py"
    spec = importlib.util.spec_from_file_location(
        "perfbench_metric_" + entry["name"].replace(".", "_").replace("-", "_"),
        path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read(record)


def run(workload: str, seed: int, seconds: float, trace: bool, *,
        device: torch.device, t0: float, dirs: Dirs | None = None,
        plant: str | None = None, grace_s: float = 60.0,
        warmup_grace_s: float = 240.0, spmv_calls: int = 200
        ) -> tuple[dict, dict]:
    """One run of cell ``workload``.  Returns ``(result line, checks)``:
    ``checks`` is ``{name: {"value", "limit", "ok"}}``, which the line
    carries last, under ``checks``.

    ``t0`` is the process's start on ``time.time()``.  ``plant`` is a
    test's fault (``module:function``), called before the program solves.
    A window solve that has not returned ``grace_s`` after the window's
    close, or a warm-up solve after ``warmup_grace_s``, is an answer that
    never came."""
    dirs = dirs or Dirs()
    bench, cell, cfg, mix = load_cell(workload, dirs)
    t = time.perf_counter()
    op = generate(cfg["operator"], cache=dirs.cache)
    log(f"operator {op.n} rows {op.nnz} nnz in {time.perf_counter() - t:.3f} s")
    gen = traffic.generator(mix)
    A = DeviceCSR.of(op, device)
    load = gen.Traffic(mix, A, seed)
    del A
    if device.type == "cuda":
        # the peak is the program's and its inputs', not the reference's
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)
    plan, layout, plan_s = system.build_plan(op, cfg["plan"], device)
    g = layout["global_row_of"]
    job = {"seed": seed, "seconds": seconds, "trace": trace, "plant": plant,
           "grace_s": grace_s, "warmup_grace_s": warmup_grace_s,
           "spmv_calls": spmv_calls}
    rec = gen.drive(plan, g, load, cfg, job, device)
    del plan, layout
    rec.update(plan_build_s=plan_s, n=op.n, nnz=op.nnz,
               device_name=(torch.cuda.get_device_name(device)
                            if device.type == "cuda" else "cpu"))
    if rec.get("profile"):
        p = rec["profile"]
        p["idle_share"] = 1 - p["busy_s"] / p["window_s"]
    if rec.get("window_start_time") is not None:
        rec["setup_s"] = rec["window_start_time"] - t0
    p = peaks.peaks(rec["device_name"])
    if p is not None:
        rec["bytes_per_s"] = p["bytes_per_s"]
    log(f"plan {rec['plan_build_s']:.3f} s, set-up {rec.get('setup_s')} s, "
        f"window {rec.get('window_s')} s, {rec.get('solves')} solves, "
        f"{rec['late']} late, peak {rec['peak_bytes']} B")
    if len(rec.get("solve_wall_s") or []) >= 2:
        q = statistics.quantiles(rec["solve_wall_s"], n=4)
        log(f"solve seconds: quartiles {q}, min {min(rec['solve_wall_s'])}, "
            f"max {max(rec['solve_wall_s'])}; first half mean "
            f"{statistics.fmean(rec['solve_wall_s'][:rec['solves'] // 2])}, "
            f"second {statistics.fmean(rec['solve_wall_s'][rec['solves'] // 2:])}")
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t = time.perf_counter()
    answers = {i: torch.from_numpy(system.assemble(x, g, op.n)).to(device)
               for i, x in rec.pop("kept").items()}
    A = DeviceCSR.of(op, device)
    checks = gen.check(load, A, answers, rec, cfg)
    log(f"reference check of {len(answers)} answers in "
        f"{time.perf_counter() - t:.3f} s")
    return line(bench, cell, rec, checks, trace, dirs), checks


def log(msg: str) -> None:
    print(f"perfbench: {msg}", file=sys.stderr, flush=True)


def line(bench: dict, cell: dict, rec: dict, checks: dict, trace: bool,
         dirs: Dirs) -> dict:
    metrics = {}
    for entry in metric_entries(bench, cell["name"], trace):
        v = read_metric(entry, rec, dirs.metrics)
        if v is not None:
            metrics[entry["name"]] = {"value": v, "unit": entry["unit"]}
    correct = all(c["ok"] for c in checks.values())
    device = {"platform": "gpu", "kind": rec["device_name"],
              "count": cell["chips"], "memory_peak_bytes": rec["peak_bytes"]}
    out = {"correct": correct,
           "attempted": rec.get("solves", 0) + rec["late"],
           "failed": (checks["unconverged_solves"]["value"] + rec["late"]
                      + rec["wrong"]),
           "metrics": metrics, "device": device}
    prof = rec.get("profile")
    if trace and prof:
        device.update(busy_s=prof["busy_s"], window_s=prof["window_s"])
        out["breakdown"] = {"device_ops": prof["device_ops"],
                            "idle_gaps": prof["idle_gaps"]}
    out["checks"] = {k: {"value": c["value"], "limit": c["limit"]}
                     for k, c in checks.items()}
    return out
