#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Run from the root of a checkout; needs one CUDA card and ``nvcc``, and
exits non-zero otherwise.  Every phase prints one JSON line; any failed
check raises, so the exit code is not 0.

1. device   the card's name and power limit (``nvidia-smi``) and the
            rates the bounds use (3.35 TB/s and 67 TFLOP/s f32 for H100
            SXM, 2.0 TB/s and 51.2 TFLOP/s for PCIe);
2. build    ``nvcc`` builds ``src/repro_torch/kernels/csrc/spmv.cu`` for
            ``sm_90a`` (with ``-Xptxas -v``);
3. kernels  each kernel against its plain PyTorch version on the card, at
            the full-size plans' shapes (B1/B2 on the 4x2 plans, B3/B4 on
            the halo-free 1x8 plans), f32 and bf16 storage; median times of
            20 runs (CUDA events) of kernel and plain version, and the
            bound of each: the larger of its bytes over the memory rate
            and its flops over the f32 rate;
4. golden   CG (jacobi, tol 1e-6, maxiter 400) on the golden matrix at 4x2,
            ell and sell: iterations within ±1 of the fixture's
            (``tests/golden_square_hashes.json``);
5. full     the main path at full size: ``graded_extruded_mesh_matrix(
            20_000, 64)`` (1.28M rows, 28.7M nnz) -> ``build_spmv_plan``
            (4x2 and 1x8, ell and sell, a2a) -> ``to_dist`` -> SpMV
            (against a host float64 CSR matvec, rel <= 1e-5) -> fused CG
            (``make_solver``, jacobi, tol 1e-6, maxiter 10,000; true
            relative residual < 1e-4) -> ``from_dist``; the unfused
            ``make_cg`` too on the 4x2 plans.  ``ms_per_iter`` divides by
            the iterations run: whole blocks of ``CHECK_EVERY``, so the
            gated no-op tail after convergence counts.  Launch counts are
            zeroed just before this phase and read just after it: every
            kernel must have launched;
6. profile  ``torch.profiler`` device time by kernel over 64 fused-CG
            iterations on the 4x2 plans, against phase 5's unprofiled
            ms/iteration (the device's busy share);
7. the ``kernels`` line, the ``nvidia-smi`` line, and the last line
   ``{"ok": true, "device": {...}}``.

``library_ms`` is one ``torch.sparse`` CSR matvec of the same global
matrix (cuSPARSE) — the yardstick only; the port never calls it.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"
N_SURFACE, LAYERS, SEED = 20_000, 64, 0
DEVICE = "cuda"
REPS = 20
CHECK_EVERY = 16          # gated CG iterations per host sync
KERNELS = {   # name -> (plan key, TPU kernel it replaces)
    "fused_ell_spmv": ("ell/4x2", "src/repro/kernels/spmv_bcsr.py:103"),
    "fused_sell_spmv": ("sell/4x2", "src/repro/kernels/spmv_bcsr.py:211"),
    "ell_spmv": ("ell/1x8", "src/repro/kernels/spmv_bcsr.py:58"),
    "sell_spmv": ("sell/1x8", "src/repro/kernels/spmv_bcsr.py:189"),
}
SOURCE = "src/repro_torch/kernels/csrc/spmv.cu"


def emit(phase: str, **kw) -> None:
    print(json.dumps({"phase": phase, **kw}), flush=True)


def check(ok: bool, msg: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke: check failed: {msg}")


def time_ms(fn, reps: int = REPS, warmup: int = 3) -> float:
    """Median of ``reps`` CUDA-event timings of ``fn()`` on the current
    stream, after ``warmup`` calls."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts if t is not None)


def read_fields(fmt, x_ghost) -> tuple[str, ...]:
    """The plan arrays a kernel reads: values, columns and (SELL) slice
    descriptors of the diag stream, and of the offd stream with a halo.
    The SELL ``rows`` streams are never read."""
    streams = ("d", "o") if x_ghost is not None else ("d",)
    if fmt.name == "ell":
        names = {"d": "diag", "o": "offd"}
        return tuple(f"{names[s]}_{f}" for s in streams
                     for f in ("vals", "cols"))
    return tuple(f"sell_{s}{f}" for s in streams
                 for f in ("vals", "cols", "start", "width"))


# ---------------------------------------------------------------------- #
# phases
# ---------------------------------------------------------------------- #
def phase_device() -> tuple[str, float, float]:
    import torch

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    name = torch.cuda.get_device_name(0)
    pcie = "pcie" in name.lower()
    bw = 2.0e12 if pcie else 3.35e12
    f32_peak = 51.2e12 if pcie else 67e12
    emit("device", nvidia_smi=smi, name=name,
         count=torch.cuda.device_count(),
         bandwidth_tb_s=bw / 1e12, f32_tflop_s=f32_peak / 1e12,
         peaks_source="H100 PCIe data sheet" if pcie
         else "H100 SXM data sheet",
         torch=torch.__version__, cuda=torch.version.cuda)
    return smi, bw, f32_peak


def phase_build() -> None:
    from repro_torch.kernels import spmv_cuda

    t0 = time.perf_counter()
    path, log = spmv_cuda.build(verbose=True)
    spmv_cuda.library()
    emit("build", seconds=round(time.perf_counter() - t0, 3),
         library=str(path.relative_to(ROOT)),
         flags=" ".join(spmv_cuda.NVCC_FLAGS),
         ptxas=[ln.strip() for ln in log.splitlines()
                if "registers" in ln or "spill" in ln])


def build_plans(A) -> dict:
    from repro_torch.core import build_spmv_plan

    plans = {}
    for key in ("ell/4x2", "sell/4x2", "ell/1x8", "sell/1x8"):
        fmt, grid = key.split("/")
        n_node, n_core = (int(v) for v in grid.split("x"))
        t0 = time.perf_counter()
        plan, layout = build_spmv_plan(A, n_node, n_core, mode="balanced",
                                       format=fmt, transport="a2a",
                                       device=DEVICE)
        plans[key] = (plan, layout)
        emit("plan", plan=key, seconds=round(time.perf_counter() - t0, 3),
             rc_pad=plan.rc_pad, nl_pad=plan.nl_pad, g_pad=plan.g_pad,
             hs=plan.hs, nnz_stored=plan.nnz_stored(),
             padding_waste=layout["stats"]["padding_waste"],
             fields={k: list(v.shape) for k, v in plan.fmt_data.items()})
    return plans


def phase_kernels(plans, x, bw, f32_peak) -> dict:
    """Each kernel vs its plain version on its plan's main-path inputs."""
    import torch

    from repro_torch.core import make_shard_body, to_dist
    from repro_torch.sparse import get_format

    results = {}
    for name, (key, _) in KERNELS.items():
        plan, layout = plans[key]
        fmt = get_format(plan.format)
        body = make_shard_body(plan)
        xl, xg = body.inputs(to_dist(x, layout, plan))
        for dtype in (torch.float32, torch.bfloat16):
            F = {k: (v.to(dtype) if v.is_floating_point() else v)
                 for k, v in plan.fmt_data.items()}

            def kern():
                return fmt.matvec_kernel(F, xl, xg, plan.rc_pad)

            def plain():
                return fmt.matvec_plain(F, xl, xg, plan.rc_pad)

            y, want = kern(), plain()
            torch.cuda.synchronize()
            err = float((y - want).abs().max())
            # both accumulate in f32 on the same values, whatever the
            # storage dtype: only the summation order differs
            tol = 2e-5 * max(1.0, float(want.abs().max()))
            fields = read_fields(fmt, xg)
            byts = nbytes(*(F[k] for k in fields), xl, xg, y)
            # one multiply and one add per stored entry, f32 outside the
            # tensor cores
            flops = 2 * sum(F[k].numel() for k in fields
                            if k.endswith("vals"))
            bytes_ms, flops_ms = byts / bw * 1e3, flops / f32_peak * 1e3
            row = {"kernel": name, "plan": key, "dtype": str(dtype)[6:],
                   "max_abs_err": err, "tol": tol,
                   "ms": time_ms(kern), "plain_ms": time_ms(plain),
                   "bytes": byts, "flops": flops,
                   "bound_ms": max(bytes_ms, flops_ms),
                   "bound_by": "bytes" if bytes_ms >= flops_ms
                   else "operations"}
            emit("kernel", **row)
            check(y.shape == want.shape and err <= tol,
                  f"{name} {dtype}: max|err| {err} > {tol}")
            results.setdefault(name, row)        # f32 first: the main path
            del F
    return results


def phase_golden() -> None:
    import numpy as np

    from repro_torch.core import build_spmv_plan, to_dist
    from repro_torch.solvers import make_solver
    from repro_torch.sparse import graded_extruded_mesh_matrix

    fixture = json.loads((ROOT / "tests" / "golden_square_hashes.json")
                         .read_text())
    A = graded_extruded_mesh_matrix(48, 6, seed=0)
    rng = np.random.default_rng(7)
    rng.standard_normal(A.n_rows)                      # the fixture's x
    b = rng.standard_normal(A.n_rows).astype(np.float32)
    for fmt in ("ell", "sell"):
        plan, layout = build_spmv_plan(
            A, fixture["n_node"], fixture["n_core"], mode="balanced",
            format=fmt, device=DEVICE)
        _, iters, rel = make_solver(plan)(to_dist(b, layout, plan),
                                          tol=1e-6, maxiter=400)
        want = fixture["entries"][f"{fmt}/a2a"]["cg"]["iters"]
        emit("golden", format=fmt, iters=int(iters), fixture_iters=want,
             rel=float(rel))
        check(abs(int(iters) - want) <= 1,
              f"golden {fmt}: {int(iters)} iterations, fixture {want} ±1")


def phase_full(A, plans, x, b) -> tuple[dict, dict]:
    """The main path at full size; returns the launch counts and each
    plan's row of results."""
    import numpy as np
    import torch

    from repro_torch.core import from_dist, make_cg, make_spmv, to_dist
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.solvers import make_solver

    y_host = A.matvec(x.astype(np.float64))
    b64 = b.astype(np.float64)
    rows = {}
    reset_launches()
    for key, (plan, layout) in plans.items():
        spmv = make_spmv(plan)
        xd = to_dist(x, layout, plan)
        y = from_dist(spmv(xd), layout, plan)
        spmv_rel = float(np.abs(y - y_host).max() / np.abs(y_host).max())
        check(spmv_rel <= 1e-5, f"{key}: SpMV rel err {spmv_rel} > 1e-5")
        row = {"plan": key, "spmv_rel_err": spmv_rel,
               "spmv_ms": time_ms(lambda: spmv(xd))}
        bd = to_dist(b, layout, plan)
        solvers = {"fused": make_solver(plan, solver="cg", precond="jacobi",
                                        check_every=CHECK_EVERY)}
        if key.endswith("4x2"):
            solvers["unfused"] = make_cg(plan, fused=False,
                                         check_every=CHECK_EVERY)
        for kind, solve in solvers.items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            xs, iters, rel = solve(bd, tol=1e-6, maxiter=10_000)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            xg = from_dist(xs, layout, plan).astype(np.float64)
            true_rel = float(np.linalg.norm(A.matvec(xg) - b64)
                             / np.linalg.norm(b64))
            # whole blocks of CHECK_EVERY gated iterations run, so up to
            # CHECK_EVERY - 1 no-op iterations follow convergence
            iters_run = -(-int(iters) // CHECK_EVERY) * CHECK_EVERY
            row[kind] = {"iters": int(iters), "iters_run": iters_run,
                         "rel": float(rel), "true_rel": true_rel, "ms": ms,
                         "ms_per_iter": ms / max(iters_run, 1)}
            check(np.isfinite(xg).all() and xg.shape == (A.n_rows,),
                  f"{key} {kind}: non-finite or misshapen solution")
            check(float(rel) <= 1e-6, f"{key} {kind}: CG stopped at "
                  f"{int(iters)} iterations, rel {float(rel)}")
            check(true_rel < 1e-4, f"{key} {kind}: true rel {true_rel}")
        row["max_memory_allocated"] = torch.cuda.max_memory_allocated()
        emit("full", **row)
        rows[key] = row
    launches = dict(LAUNCHES)
    emit("launches", **launches)
    for name in KERNELS:
        check(launches[name] > 0, f"{name} never launched on the main path")
    return launches, rows


def phase_profile(plans, b, full_rows, iters: int = 64) -> None:
    """Device time by kernel over ``iters`` fused-CG iterations of each 4x2
    plan (``torch.profiler``), against the unprofiled ms/iteration of
    phase ``full``: their ratio is the device's busy share."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core import to_dist
    from repro_torch.solvers import make_solver

    for key in ("ell/4x2", "sell/4x2"):
        plan, layout = plans[key]
        solve = make_solver(plan, check_every=CHECK_EVERY)
        bd = to_dist(b, layout, plan)
        solve(bd, tol=0.0, maxiter=CHECK_EVERY)         # warm
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            _, k, _ = solve(bd, tol=0.0, maxiter=iters)
            torch.cuda.synchronize()
        check(int(k) == iters, f"profile {key}: {int(k)} != {iters} iters")
        by_name = {}
        for ev in prof.events():
            if ev.device_type == torch.autograd.DeviceType.CUDA:
                by_name[ev.name] = (by_name.get(ev.name, 0.0)
                                    + ev.device_time_total / 1e3)
        device_ms = sum(by_name.values()) / iters
        wall = full_rows[key]["fused"]["ms_per_iter"]
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
        emit("profile", plan=key, iters=iters,
             device_ms_per_iter=device_ms, ms_per_iter_unprofiled=wall,
             busy_share=device_ms / wall,
             kernels_ms_per_iter={n[:60]: t / iters for n, t in top},
             launches_per_iter=sum(1 for ev in prof.events()
                                   if ev.device_type
                                   == torch.autograd.DeviceType.CUDA)
             / iters)


def library_ms(A, x) -> float:
    """One torch.sparse CSR matvec of the global matrix (the yardstick)."""
    import torch

    csr = torch.sparse_csr_tensor(
        torch.from_numpy(A.indptr), torch.from_numpy(A.indices),
        torch.from_numpy(A.data.astype("float32")), size=A.shape,
        device=DEVICE)
    xv = torch.from_numpy(x).to(DEVICE)
    return time_ms(lambda: csr @ xv)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs an NVIDIA card", file=sys.stderr)
        return 2
    if not (SRC / "repro_torch").is_dir():
        print(f"chip_smoke: {SRC / 'repro_torch'} not found; run from the "
              "root of a checkout", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    import numpy as np

    from repro_torch.sparse import graded_extruded_mesh_matrix

    smi, bw, f32_peak = phase_device()
    phase_build()
    t0 = time.perf_counter()
    A = graded_extruded_mesh_matrix(N_SURFACE, LAYERS, seed=SEED)
    emit("matrix", rows=A.n_rows, nnz=A.nnz,
         seconds=round(time.perf_counter() - t0, 3))
    plans = build_plans(A)
    rng = np.random.default_rng(SEED + 1)
    x = rng.standard_normal(A.n_rows).astype(np.float32)
    b = rng.standard_normal(A.n_rows).astype(np.float32)
    kern = phase_kernels(plans, x, bw, f32_peak)
    lib = library_ms(A, x)
    emit("library", what="torch.sparse CSR matvec, global matrix, f32",
         ms=lib)
    phase_golden()
    launches, rows = phase_full(A, plans, x, b)
    phase_profile(plans, b, rows)
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": SOURCE,
         "replaces": KERNELS[name][1], "launches": launches[name],
         "max_abs_err": kern[name]["max_abs_err"], "ms": kern[name]["ms"],
         "plain_ms": kern[name]["plain_ms"],
         "bound_ms": kern[name]["bound_ms"],
         "bound_by": kern[name]["bound_by"],
         "library_ms": lib} for name in KERNELS]}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
