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
            and its flops over the f32 rate.  The ELL kernel reads only
            each row's real entries (its row lengths), so its bytes are
            the real entries' values and columns, the lengths, x and y,
            and its flops two per real entry; ``bound_stored_ms`` beside
            it counts every stored slot, padding included.  SELL counts
            its stored entries (about nnz) and slice descriptors;
3b. balanced the single-device kernel path on the full-size matrix of
            phase 5: ``BalancedCOO`` (``partition_balanced`` and
            ``partition_equal_rows`` bounds, 16, 64 and 8 x SM-count bins)
            -> ``balanced_spmv`` (B5), and the global ``ELLMatrix`` -> flat
            ``ell_spmv`` with its ``row_lens`` (B3's kernel as one shard;
            its bound counts real entries, as in phase 3), each against the
            host float64 CSR matvec (rel <= 1e-5).  Launch counts are
            zeroed just before this path and read just after it.  Then each
            kernel against its plain version (2e-5·max|y|), two launches
            bit for bit equal, and timed, f32 and bf16 storage, with its
            padding, imbalance and bound.  B5 reads the real entries'
            values and columns, the row lengths and the warp map (and x,
            y); ``bound_coo_ms`` beside it counts the binned COO's value,
            column and bin-local row per entry, the bin lengths and the row
            map, as the TPU kernel's layout does.  Each B5 line also has its
            launched warps and the host seconds of its warp map;
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
6b. transports  the halo-exchange layer on the full-size 4x2 ell and sell
            plans (B1, B2): every registered transport x wire dtype (f32,
            bf16, int8).  The ``make_exchange`` ghost buffer must be bit
            for bit ``a2a``'s at the same wire dtype at every real slot,
            and its ``host_exchange``'s; lossy ghosts within
            ``rel_bound·max|x|`` of the f32 ghosts; ``make_spmv`` bit for
            bit ``a2a``'s.  With f32 wire, the fused CG (jacobi, tol 1e-6)
            gives ``a2a``'s iterations and ``x`` bit for bit.  Each line
            has the SpMV's median ms (20 CUDA-event runs), the CG's
            ms/iteration where run, the census's predicted wire bytes and
            collective counts (as if each node were its own device: one
            card has no wire) and the device launches per SpMV
            (``torch.profiler``).  ``faulty`` (registered, then
            unregistered) must fail the ghost and SpMV checks.
            ``autotune_transport`` on each plan: its winner, min and
            median times, and ``make_spmv(transport="auto")`` giving the
            winner's output.  Launch counts are zeroed just before and
            read just after;
6c. refine   ``make_refine`` (cg + jacobi, inner tol 1e-4, tol 1e-7 against
            the host f64 matvec; at most 2,000 inner iterations and 20
            cycles) for each wire dtype on the full-size sell 4x2 plan:
            cycles, inner iterations, the true residual and its history,
            seconds.  f32 wire must converge; bf16/int8 at full
            size are reported.  Then at ``refine_check``'s size (graded
            80x6, 4x2, ell, its inner tolerances) every wire dtype must
            reach 1e-7 and the f64 CG oracle.  Launch counts as in 6b;
6d. solvers  the registry solvers ``cg``, ``pipelined_cg`` and ``chebyshev``
            (jacobi, a2a, f32) on the full-size ell and sell 4x2 plans at
            tol 1e-5: iterations, wall ms/iteration (host clock around the
            solve, blocks of ``CHECK_EVERY``), device ms/iteration and device
            launches per iteration (``torch.profiler`` over 64 iterations),
            the reduction census (one loop body), the true relative
            residual; for chebyshev its bounds and the host seconds of the
            f64 Lanczos estimate (made once, on the first plan, and passed
            to the second as ``options``).  cg and pipelined_cg must reach
            tol; chebyshev must run its a-priori budget (at this size the
            estimated bounds miss the bottom of the spectrum and the budget
            ends above tol).  Then the golden matrix at 4x2, ell and sell,
            with the RHS ``default_rng(7).normal``: chebyshev exactly 906 /
            994 iterations at 1e-5 / 3e-6 with the reference's bounds, cg
            within ±1 of 39 / 40, every solver converged with a true
            residual on the f32 plateau (< 1e-3).  pipelined_cg's counts
            are printed beside the reference's 84 / 86 (ell) and 84 / 85
            (sell) and not gated: below the plateau its count is set by
            rounding (the reference's own moves by 3 between its plans).
            Launch counts as in 6b;
6e. resilience  ``resilient_solve`` on the full-size sell 4x2 plan with
            ``check_every`` 50, per solver: the clean chunked ``x`` bit for
            bit the monolithic ``make_solver``'s, ``nan@60`` rolled back and
            converged, one ``bitflip`` chunk (``FaultyTransport`` on the
            card) caught and converged (chebyshev: at the clean run's
            residual), and chunked against monolithic ms/iteration.  The guard reads the chunk's device probe (no
            host matrix: a host f64 matvec per chunk would dominate).  Then
            ``python -m repro_torch.testing.resilience_check --device cuda``
            (48x6, victim SIGKILLed, resume on 2x2 sell ring) must print
            ``OK``.  Launch counts as in 6b, for the in-process part;
6f. example  ``examples/cg_solve_torch.py --device cuda`` at its default size
            as a subprocess: its closing assert holds and its JSON line
            parses;
6g. rect     rectangular plans at full size: ``check_plan`` and
            ``check_kernel_streams`` (what ``verify=True`` runs) on the 4x2
            ell and sell plans with no error; the agg-16 restriction R
            (80,000 x 1.28M, columns pinned to A's row space) and P = Rᵀ
            (rows pinned to A's, columns to R's) built with
            ``verify=True``, each against a host f64 CSR matvec (rel <=
            1e-5), every transport bit for bit ``a2a``, a pinned rebuild
            bit for bit; ``rect_check --device cuda`` at 4x2 and
            halo-free 1x8 printing ``OK``.  Launch counts are zeroed
            before and read after that path: every kernel must have
            launched.  Then the kernel at each of R's and P's shapes
            against its plain version (2e-5·max|y|), timed as in phase 3,
            with the library's time for the same R or P;
6h. precond  (TF32 matmuls must be off) ``precond_check --device cuda`` on
            graded, single and halofree printing ``OK``, and failing with
            ``--include-faulty``; ``--scaling`` with its counts beside the
            reference's (two_level gated within ±1 of 24 / 26 / 25 and
            flat; block_jacobi's, on the f32 plateau at the first mesh,
            printed); cg to tol 1e-6 with jacobi, block_jacobi and
            two_level (agg 8, block_jacobi smoother) on
            ``graded_extruded_mesh_matrix(500, 64)`` (32,000 rows) at 4x2
            ell and sell, and jacobi then two_level (agg 256, jacobi
            smoother) on the full sell 4x2 plan.  Each solve: iterations,
            wall and device ms/iteration, launches per iteration, the
            census (2), the true residual (< 1e-4), the host seconds of
            the build; for two_level one apply's device time by kernel,
            and the coarse correction's device ms per iteration (its
            solve's less its smoother's alone) and share.  Launch counts
            as in 6b;
6i. serve    the batched kernels (B1-B4 under ``vmap``: one launch for k
            right-hand sides) on the full-size 4x2 and 1x8 plans at k = 1,
            3, 4, 8 and 16, f32 and bf16 storage: every column bit for bit
            the single-column kernel on that column, the whole within
            2e-5·max|y| of the batched plain version; in f32 the median ms
            of 20 CUDA-event runs of the wrapper (its interleave copy of x
            included), the same per call of 20 back to back
            (``loop_ms``: no host gaps between them) and the copy alone
            (``interleave_ms``), the bound
            (matrix bytes once + k x (x_local + x_ghost + y bytes) over the
            memory rate) and cuSPARSE SpMM (``torch.sparse`` CSR x dense
            (n, k)) as the library; the batched shard body on the 4x2
            plans, each column bit for bit the unbatched body for every
            transport x wire dtype.  Then the serving path, launch counts
            zeroed just before it and read just after (every batched
            kernel must have launched): ``make_solver(nrhs=4)`` (cg +
            jacobi, tol 1e-5) on each full plan, each column within ±1 of
            its ``nrhs=None`` solve and a true residual < 2e-4, and on
            sell 4x2 wall and
            device ms and launches per iteration against four sequential
            solves; the service (``SolveService``, sell 4x2, a2a f32, cg +
            jacobi, nrhs 4, check_every 25) on 16 requests with tols
            cycling 1e-5 / 3e-5 / 1e-4: all converge with a host-f64 true
            residual < 2e-4, makespan at least 1.05x the same requests one
            at a time through a warm ``make_solver``, p50/p99 latency,
            ``recompiles == 0``, a second service over the same cache a
            pure hit, one splice leaving the survivors' per-chunk iterates
            byte-identical; ``serve_check --device cuda`` (2x4, 48x8)
            printing ``OK``;
7. the ``kernels`` line (B1-B4, B5 and the flat ELL, then B1/B2 at R's
   and P's shapes with phase 6g's launches and the library's time on R or
   P, then the batched B1-B4 at k = 4 with phase 6i's launches and SpMM's
   time), the ``nvidia-smi`` line, and the last line ``{"ok": true,
   "device": {...}}``.

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
#: the single-device path's kernels; B5's row on the ``kernels`` line is
#: the 64-bin nnz-balanced f32 one, the flat ELL's the global ELLMatrix's
BALANCED = ("balanced_spmv", "src/repro/kernels/spmv_bcsr.py:268",
            "balanced/64")
FLAT_ELL = ("ell_spmv/flat", "src/repro/kernels/spmv_bcsr.py:58",
            "ell/global")
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


def loop_ms(fn, reps: int = REPS, warmup: int = 3) -> float:
    """Per call, ``reps`` calls of ``fn()`` back to back between two CUDA
    events, after ``warmup`` calls: the host's launch gaps hide behind the
    device's work, as in a solve's loop."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts if t is not None)


def read_fields(fmt, x_ghost) -> tuple[str, ...]:
    """The plan arrays a kernel reads: values, columns and (ELL) row
    lengths or (SELL) slice descriptors of the diag stream, and of the offd
    stream with a halo.  The SELL ``rows`` streams are never read."""
    streams = ("d", "o") if x_ghost is not None else ("d",)
    if fmt.name == "ell":
        names = {"d": "diag", "o": "offd"}
        return tuple(f"{names[s]}_{f}" for s in streams
                     for f in ("vals", "cols", "len"))
    return tuple(f"sell_{s}{f}" for s in streams
                 for f in ("vals", "cols", "start", "width"))


def ell_bytes(vals, cols, lens, xs) -> tuple[int, int, int]:
    """ELL inputs as the kernel reads them: ``(bytes, flops, stored
    bytes)``.  Only each row's real entries are read (value and column),
    with the row lengths and x; the stored bytes count every slot."""
    real = sum(int(n.sum()) for n in lens)
    per = vals[0].element_size() + cols[0].element_size()
    return (real * per + nbytes(*lens, *xs), 2 * real,
            nbytes(*vals, *cols, *xs))


def kernel_cost(fmt, F, xl, xg) -> tuple[int, int, int | None]:
    """``(bytes, flops, stored bytes or None)`` of one local matvec on
    ``F``: ELL as ``ell_bytes`` counts it; SELL its stored entries and
    slice descriptors, one multiply and one add per stored entry (f32,
    outside the tensor cores)."""
    fields = read_fields(fmt, xg)
    if fmt.name == "ell":
        return ell_bytes(*([F[k] for k in fields if k.endswith(f)]
                           for f in ("vals", "cols", "len")), [xl, xg])
    return (nbytes(*(F[k] for k in fields), xl, xg),
            2 * sum(F[k].numel() for k in fields if k.endswith("vals")),
            None)


def run_cli(main, argv) -> tuple[int, list[str]]:
    """A checker's ``main(argv)`` in this process: ``(exit code, stdout
    lines)``."""
    import contextlib
    import io

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = main(argv)
    return rc, out.getvalue().strip().splitlines()


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


def measure(phase: str, row: dict, kern, plain, in_bytes: int, flops: int,
            bw: float, f32_peak: float, other_bytes: dict | None = None
            ) -> dict:
    """Hold ``kern()`` against ``plain()`` on the same inputs and time both;
    emit ``row`` with the results as one ``phase`` line and return it.

    Both accumulate in f32 on the same values, whatever the storage dtype,
    so only the summation order differs: the limit is 2e-5·max|y|.  The
    bound is the larger of the bytes moved (``in_bytes`` read once, the
    output written once) over the memory rate and ``flops`` over the f32
    rate.  Each entry ``name: bytes`` of ``other_bytes`` (ELL's every
    stored slot, B5's COO layout) adds ``bound_<name>_ms``, those bytes and
    the output over the memory rate.  Two launches of ``kern`` must give the
    same bits."""
    import torch

    y, want = kern(), plain()
    same = torch.equal(kern(), y)
    torch.cuda.synchronize()
    err = float((y - want).abs().max())
    tol = 2e-5 * max(1.0, float(want.abs().max()))
    byts = in_bytes + nbytes(y)
    bytes_ms, flops_ms = byts / bw * 1e3, flops / f32_peak * 1e3
    row = {**row, "max_abs_err": err, "tol": tol, "ms": time_ms(kern),
           "plain_ms": time_ms(plain), "bytes": byts, "flops": flops,
           "bound_ms": max(bytes_ms, flops_ms),
           "bound_by": "bytes" if bytes_ms >= flops_ms else "operations"}
    for name, b in (other_bytes or {}).items():
        row[f"bound_{name}_ms"] = (b + nbytes(y)) / bw * 1e3
    row["bitwise_repeat"] = same
    emit(phase, **row)
    what = (f"{row['kernel']} {row.get('plan', row.get('matrix'))} "
            f"{row['dtype']}")
    check(y.shape == want.shape and err <= tol,
          f"{what}: max|err| {err} > {tol}")
    check(same, f"{what}: two launches differ")
    return row


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
            byts, flops, stored = kernel_cost(fmt, F, xl, xg)
            row = measure(
                "kernel", {"kernel": name, "plan": key,
                           "dtype": str(dtype)[6:]},
                lambda: fmt.matvec_kernel(F, xl, xg, plan.rc_pad),
                lambda: fmt.matvec_plain(F, xl, xg, plan.rc_pad),
                byts, flops, bw, f32_peak,
                None if stored is None else {"stored": stored})
            results.setdefault(name, row)        # f32 first: the main path
            del F
    return results


def phase_balanced(A, x, bw, f32_peak) -> tuple[dict, dict]:
    """The single-device kernel path on the full-size matrix; returns the
    path's launch counts and the f32 rows of ``balanced_spmv`` and of the
    flat ``ell_spmv`` by label."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.core.partition import (imbalance, partition_balanced,
                                            partition_equal_rows)
    from repro_torch.kernels import (LAUNCHES, balanced_spmv, ell_spmv, ref,
                                     reset_launches)
    from repro_torch.sparse import BalancedCOO, ELLMatrix, balanced_warp_map

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    y_host = A.matvec(x.astype(np.float64))
    scale = float(np.abs(y_host).max())
    xd = torch.from_numpy(x).to(DEVICE)
    built = {}
    reset_launches()
    for nbins in (16, 64, 8 * sms):
        for kind in ("balanced", "rows"):
            bounds = (partition_balanced(A.row_nnz, nbins)
                      if kind == "balanced"
                      else partition_equal_rows(A.n_rows, nbins))
            t0 = time.perf_counter()
            bcoo = BalancedCOO.from_csr(A, bounds, device=DEVICE)
            build_s = time.perf_counter() - t0
            y = balanced_spmv(bcoo, xd).cpu().numpy()
            rel = float(np.abs(y - y_host).max() / scale)
            check(y.shape == (A.n_rows,) and rel <= 1e-5,
                  f"balanced {kind}/{nbins}: rel err {rel} > 1e-5")
            # the warp map alone, again from the host arrays
            host = [t.cpu().numpy() for t in (bcoo.lrows, bcoo.bin_starts,
                                              bcoo.out_gather)]
            t0 = time.perf_counter()
            balanced_warp_map(host[0], np.asarray(bcoo.bin_nnz), host[1],
                              host[2], bcoo.n_rows, bcoo.rows_pad)
            map_s = time.perf_counter() - t0
            del host
            built[f"{kind}/{nbins}"] = (bcoo, {
                "nbins": nbins, "bounds": kind, "build_s": build_s,
                "map_s": map_s, "warps": bcoo.warp_map.shape[0],
                "blocks": -(-bcoo.warp_map.shape[0] // 8),
                "imbalance": imbalance(A.row_nnz, bounds),
                "host_rel_err": rel})
    t0 = time.perf_counter()
    ell = ELLMatrix.from_csr(A, device=DEVICE)
    build_s = time.perf_counter() - t0
    y = ell_spmv(ell.vals, ell.cols, xd,
                 lens=ell.row_lens)[:A.n_rows].cpu().numpy()
    rel = float(np.abs(y - y_host).max() / scale)
    check(rel <= 1e-5, f"flat ell_spmv: rel err {rel} > 1e-5")
    torch.cuda.synchronize()
    launches = dict(LAUNCHES)
    emit("balanced_launches", **launches)
    check(launches["balanced_spmv"] > 0 and launches["ell_spmv"] > 0,
          "the single-device path never launched its kernels")

    rows = {}
    for label, (bcoo, info) in built.items():
        for dtype in (torch.float32, torch.bfloat16):
            B = dataclasses.replace(bcoo, vals=bcoo.vals.to(dtype))
            per = B.vals.element_size() + 4       # value + int32 column
            # the real entries only (the kernel never reads the padding):
            # value and column each, the row lengths, the warp map and x;
            # the COO count adds the bin-local row per entry, the bin
            # lengths and the row map, and drops the map and row lengths
            row = measure(
                "balanced", {"kernel": "balanced_spmv", "matrix": label,
                             **info, "dtype": str(dtype)[6:],
                             "padding_waste": B.padding_waste,
                             "nnz_pad": B.nnz_pad, "rows_pad": B.rows_pad,
                             "bytes_stored": nbytes(B.vals, B.cols,
                                                    B.lrows)},
                lambda: balanced_spmv(B, xd),
                lambda: ref.balanced_spmv_ref(B, xd),
                A.nnz * per + nbytes(B.row_lens, B.warp_map, xd),
                2 * A.nnz, bw, f32_peak,
                {"coo": A.nnz * (per + 4) + 4 * B.nbins
                 + nbytes(B.out_gather, xd)})
            rows.setdefault(label, row)          # f32 first
            del B
    # balanced against equal-row bins of one count, timed in turns
    # (balanced, rows, rows, balanced, twice) so that a drift of the card
    # falls on both
    for nbins in (16, 64, 8 * sms):
        for dtype in (torch.float32, torch.bfloat16):
            Bs = {kind: dataclasses.replace(
                built[f"{kind}/{nbins}"][0],
                vals=built[f"{kind}/{nbins}"][0].vals.to(dtype))
                for kind in ("balanced", "rows")}
            times = {"balanced": [], "rows": []}
            for kind in ("balanced", "rows", "rows", "balanced") * 2:
                times[kind].append(time_ms(
                    lambda: balanced_spmv(Bs[kind], xd)))
            bal, eq = (statistics.median(times[k])
                       for k in ("balanced", "rows"))
            emit("balanced_vs_rows", nbins=nbins, dtype=str(dtype)[6:],
                 balanced_ms=bal, rows_ms=eq, ratio=bal / eq,
                 balanced_runs=times["balanced"], rows_runs=times["rows"],
                 warps={k: B.warp_map.shape[0] for k, B in Bs.items()})
            del Bs
    del built
    for dtype in (torch.float32, torch.bfloat16):
        vals = ell.vals.to(dtype)
        byts, flops, stored = ell_bytes([vals], [ell.cols], [ell.row_lens],
                                        [xd])
        row = measure(
            "balanced", {"kernel": "ell_spmv", "matrix": FLAT_ELL[2],
                         "dtype": str(dtype)[6:], "build_s": build_s,
                         "host_rel_err": rel, "width": ell.width,
                         "padding_waste": 1.0 - A.nnz / vals.numel()},
            lambda: ell_spmv(vals, ell.cols, xd, lens=ell.row_lens),
            lambda: ref.ell_spmv_ref(vals, ell.cols, xd),
            byts, flops, bw, f32_peak, {"stored": stored})
        rows.setdefault(FLAT_ELL[2], row)        # f32 first
        del vals
    del ell
    return launches, rows


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


def solve_timed(solve, bd, tol: float = 1e-6):
    """One solve to ``tol``: ``(x, iters, rel, wall ms, iterations
    run)``.  Whole blocks of ``CHECK_EVERY`` gated iterations run, so up
    to ``CHECK_EVERY - 1`` no-op iterations follow convergence."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    xs, iters, rel = solve(bd, tol=tol, maxiter=10_000)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    iters_run = -(-int(iters) // CHECK_EVERY) * CHECK_EVERY
    return xs, int(iters), float(rel), ms, iters_run


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
            xs, iters, rel, ms, iters_run = solve_timed(solve, bd)
            xg = from_dist(xs, layout, plan).astype(np.float64)
            true_rel = float(np.linalg.norm(A.matvec(xg) - b64)
                             / np.linalg.norm(b64))
            row[kind] = {"iters": iters, "iters_run": iters_run,
                         "rel": rel, "true_rel": true_rel, "ms": ms,
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


def device_profile(fn) -> tuple[dict, int]:
    """``torch.profiler`` over one call of ``fn`` (then a synchronise):
    device ms by kernel name and the number of device launches (kernels,
    copies and fills on the card)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    by_name, launches = {}, 0
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            by_name[ev.name] = (by_name.get(ev.name, 0.0)
                                + ev.device_time_total / 1e3)
            launches += 1
    return by_name, launches


def profile_solve(solve, bd, iters: int = 64) -> tuple[dict, int]:
    """Device time by kernel and launches over exactly ``iters``
    iterations of ``solve`` (tol 0, after a warm block)."""
    solve(bd, tol=0.0, maxiter=CHECK_EVERY)             # warm
    box = {}

    def run():
        box["k"] = int(solve(bd, tol=0.0, maxiter=iters)[1])
    by_name, launches = device_profile(run)
    check(box["k"] == iters, f"profile: {box['k']} != {iters} iterations")
    return by_name, launches


def phase_profile(plans, b, full_rows, iters: int = 64) -> None:
    """Device time by kernel over ``iters`` fused-CG iterations of each 4x2
    plan (``torch.profiler``), against the unprofiled ms/iteration of
    phase ``full``: their ratio is the device's busy share."""
    from repro_torch.core import to_dist
    from repro_torch.solvers import make_solver

    for key in ("ell/4x2", "sell/4x2"):
        plan, layout = plans[key]
        solve = make_solver(plan, check_every=CHECK_EVERY)
        by_name, launches = profile_solve(solve, to_dist(b, layout, plan),
                                          iters)
        device_ms = sum(by_name.values()) / iters
        wall = full_rows[key]["fused"]["ms_per_iter"]
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
        emit("profile", plan=key, iters=iters,
             device_ms_per_iter=device_ms, ms_per_iter_unprofiled=wall,
             busy_share=device_ms / wall,
             kernels_ms_per_iter={n[:60]: t / iters for n, t in top},
             launches_per_iter=launches / iters)


def device_launches(fn, calls: int = 5) -> float:
    """Device launches per call of ``fn`` (``torch.profiler``: kernels,
    copies and fills on the card)."""
    fn()
    _, launches = device_profile(lambda: [fn() for _ in range(calls)])
    return launches / calls


def phase_transports(plans, x, b) -> None:
    """Every transport x wire dtype on the full-size 4x2 plans, held bit
    for bit against a2a at the same wire dtype; faulty caught; autotune."""
    from repro_torch.core import (make_exchange, make_spmv,
                                  resolve_transport, to_dist)
    from repro_torch.core.transport import (FaultyTransport,
                                            autotune_transport,
                                            available_transports,
                                            available_wire_dtypes, get_codec,
                                            register_transport,
                                            transport_census,
                                            unregister_transport)
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.solvers import make_solver
    from repro_torch.testing.transport_check import bits_equal

    reset_launches()
    wires = ("f32",) + tuple(w for w in available_wire_dtypes()
                             if w != "f32")
    for key in ("ell/4x2", "sell/4x2"):
        plan, layout = plans[key]
        xd, bd = to_dist(x, layout, plan), to_dist(b, layout, plan)
        g = plan.g_pad
        x_max = float(xd.abs().max())
        exact = make_exchange(plan, transport="a2a",
                              wire_dtype="f32")(xd)[..., :g]
        cg_ref = None
        for wd in wires:
            codec = get_codec(wd)
            ghost_ref = make_exchange(plan, transport="a2a",
                                      wire_dtype=wd)(xd)[..., :g]
            y_ref = make_spmv(plan, transport="a2a", wire_dtype=wd)(xd)
            err = float((ghost_ref - exact).abs().max())
            check(err == 0.0 if codec.exact
                  else err <= codec.rel_bound * x_max,
                  f"{key} {wd}: ghost error {err} over the codec's bound")
            census = transport_census(plan, wire_dtype=wd)
            for name in available_transports():
                spmv = make_spmv(plan, transport=name, wire_dtype=wd)
                ghost = make_exchange(plan, transport=name,
                                      wire_dtype=wd)(xd)
                tr, state = resolve_transport(name, plan, wire_dtype=wd)
                host = tr.host_exchange(
                    xd.cpu().numpy(), plan.send_own.cpu().numpy(),
                    plan.recv_own.cpu().numpy(), g, state)
                row = {"plan": key, "transport": name, "wire_dtype": wd,
                       "ghost_bitwise": bits_equal(ghost[..., :g], ghost_ref),
                       "host_bitwise": host[..., :g].tobytes()
                       == ghost[..., :g].cpu().numpy().tobytes(),
                       "spmv_bitwise": bits_equal(spmv(xd), y_ref),
                       "ghost_err": err,
                       "ghost_bound": codec.rel_bound * x_max,
                       "spmv_ms": time_ms(lambda: spmv(xd)),
                       "launches_per_spmv": device_launches(
                           lambda: spmv(xd)),
                       **{f"census_{k}": v
                          for k, v in census[name].items()}}
                if wd == "f32":
                    solve = make_solver(plan, solver="cg", precond="jacobi",
                                        transport=name,
                                        check_every=CHECK_EVERY)
                    xs, iters, rel, ms, iters_run = solve_timed(solve, bd)
                    if cg_ref is None:
                        cg_ref = (xs, iters)
                    row.update(cg_iters=iters, cg_rel=rel,
                               cg_ms_per_iter=ms / max(iters_run, 1),
                               cg_x_bitwise=bits_equal(xs, cg_ref[0]))
                    check(iters == cg_ref[1] and row["cg_x_bitwise"],
                          f"{key} {name}: CG {iters} iterations / x differ "
                          f"from a2a's {cg_ref[1]}")
                    check(rel <= 1e-6, f"{key} {name}: CG rel {rel}")
                emit("transports", **row)
                for k in ("ghost_bitwise", "host_bitwise", "spmv_bitwise"):
                    check(row[k], f"{key} {name} {wd}: {k} fails")
            register_transport(FaultyTransport())
            try:
                bad_ghost = make_exchange(plan, transport="faulty",
                                          wire_dtype=wd)(xd)[..., :g]
                bad_y = make_spmv(plan, transport="faulty",
                                  wire_dtype=wd)(xd)
            finally:
                unregister_transport("faulty")
            caught = {"ghost": not bits_equal(bad_ghost, ghost_ref),
                      "spmv": not bits_equal(bad_y, y_ref)}
            emit("transports_faulty", plan=key, wire_dtype=wd, caught=caught,
                 registered_after=sorted(available_transports()))
            check(all(caught.values()), f"{key} {wd}: faulty not caught")
        res = autotune_transport(plan)
        stamped = plan.transport
        # "auto" tunes again and stamps that run's winner
        auto = make_spmv(plan, transport="auto")
        same = (auto.transport == plan.transport
                and bits_equal(auto(xd), make_spmv(
                    plan, transport=auto.transport)(xd))
                and bits_equal(auto(xd), res.spmv(xd)))
        emit("autotune", plan=key, winner=res.winner, stamped=stamped,
             min_us=res.timings_min_us, median_us=res.timings_us,
             reps_us=res.reps_us, auto_winner=auto.transport,
             auto_is_winner=same)
        check(stamped == res.winner and same,
              f"{key}: transport='auto' is not the autotune winner")
        plan.transport = "a2a"          # later phases run the a2a stamp
    launches = dict(LAUNCHES)
    emit("transports_launches", **launches)
    for name in ("fused_ell_spmv", "fused_sell_spmv"):
        check(launches[name] > 0, f"{name} never launched in transports")


def refine_row(A, plan, layout, b, wd, inner_tol, maxiter_inner,
               max_cycles, xh=None) -> dict:
    """One ``make_refine`` solve to 1e-7; the emitted row."""
    import numpy as np
    import torch

    from repro_torch.solvers import make_refine

    refine = make_refine(plan, solver="cg", precond="jacobi", A=A,
                         layout=layout, inner_tol=inner_tol,
                         maxiter_inner=maxiter_inner, wire_dtype=wd,
                         check_every=CHECK_EVERY)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = refine(b, tol=1e-7, max_cycles=max_cycles)
    seconds = time.perf_counter() - t0
    true_rel = float(np.linalg.norm(b - A.matvec(res.x))
                     / np.linalg.norm(b))
    row = {"rows": A.n_rows, "plan": f"{plan.format}/{plan.n_node}x"
           f"{plan.n_core}", "wire_dtype": wd, "inner_tol": inner_tol,
           "cycles": res.cycles, "inner_iters": res.inner_iters,
           "rel": res.rel, "true_rel": true_rel, "converged": res.converged,
           "history": [r for _, r in res.history], "seconds": seconds}
    if xh is not None:
        row["dx_host"] = float(np.linalg.norm(res.x - xh)
                               / np.linalg.norm(xh))
    check(np.isfinite(res.x).all(), f"refine {wd}: non-finite solution")
    return row


def phase_refine(A, plans, b) -> None:
    """f64 refinement over each wire dtype: full size on the sell 4x2
    plan (f32 must converge), and at refine_check's size (all must)."""
    import numpy as np

    from repro_torch.core import build_spmv_plan
    from repro_torch.core.transport import available_wire_dtypes
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.sparse import graded_extruded_mesh_matrix
    from repro_torch.testing.refine_check import host_cg, inner_tol_for

    reset_launches()
    plan, layout = plans["sell/4x2"]
    b64 = b.astype(np.float64)
    for wd in available_wire_dtypes():
        row = refine_row(A, plan, layout, b64, wd, 1e-4, 2000, 20)
        emit("refine", size="full", **row)
        if wd == "f32":
            check(row["converged"] and row["true_rel"] <= 1e-7,
                  f"refine f32 at full size: rel {row['rel']}")
    # refine_check's size, where the reference set its bf16/int8 gate
    As = graded_extruded_mesh_matrix(80, 6, seed=0)
    bs = np.random.default_rng(1).normal(size=As.n_rows)
    xh = host_cg(As, bs, tol=1e-12, maxiter=40_000)
    for wd in available_wire_dtypes():
        ps, ls = build_spmv_plan(As, 4, 2, wire_dtype=wd, device=DEVICE)
        row = refine_row(As, ps, ls, bs, wd, inner_tol_for(wd), 1000, 40,
                         xh=xh)
        emit("refine", size="refine_check", **row)
        check(row["converged"] and row["dx_host"] < 100 * 1e-7,
              f"refine {wd} at refine_check size: rel {row['rel']}, "
              f"dx {row['dx_host']}")
    launches = dict(LAUNCHES)
    emit("refine_launches", **launches)
    for name in ("fused_ell_spmv", "fused_sell_spmv"):
        check(launches[name] > 0, f"{name} never launched in refine")


SOLVERS = ("cg", "pipelined_cg", "chebyshev")
#: the reference's iteration counts on the golden matrix (4x2, jacobi,
#: RHS default_rng(7).normal) at tol 1e-5 / 3e-6, and its bounds
GOLDEN_REF = {"ell": {"cg": (39, 40), "pipelined_cg": (84, 86),
                      "chebyshev": (906, 994)},
              "sell": {"cg": (39, 40), "pipelined_cg": (84, 85),
                       "chebyshev": (906, 994)}}
#: the gate on each count; pipelined_cg's is reported and not gated: below
#: the f32 plateau its count is set by rounding (PERF.md, Findings)
GOLDEN_SLACK = {"cg": 1, "pipelined_cg": None, "chebyshev": 0}
GOLDEN_BOUNDS = (1.127487e-4, 1.703558)


def phase_solvers(A, plans, b) -> dict:
    """The three registry solvers on the full-size 4x2 plans, then the
    golden gates; returns Chebyshev's options (its bounds) for later
    phases."""
    import numpy as np

    from repro_torch.core import build_spmv_plan, from_dist, to_dist
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.solvers import (chebyshev_iters_for_tol, make_solver,
                                     reduction_census)
    from repro_torch.sparse import graded_extruded_mesh_matrix

    b64 = b.astype(np.float64)
    cheb_opts = None
    reset_launches()
    for key in ("sell/4x2", "ell/4x2"):
        plan, layout = plans[key]
        bd = to_dist(b, layout, plan)
        for name in SOLVERS:
            t0 = time.perf_counter()
            solve = make_solver(plan, solver=name, precond="jacobi", A=A,
                                layout=layout, check_every=CHECK_EVERY,
                                options=(cheb_opts if name == "chebyshev"
                                         else None))
            build_s = time.perf_counter() - t0
            xs, iters, rel, ms, iters_run = solve_timed(solve, bd, tol=1e-5)
            xg = from_dist(xs, layout, plan).astype(np.float64)
            true_rel = float(np.linalg.norm(A.matvec(xg) - b64)
                             / np.linalg.norm(b64))
            by_name, launches = profile_solve(solve, bd)
            row = {"plan": key, "solver": name, "iters": iters,
                   "iters_run": iters_run, "rel": rel, "true_rel": true_rel,
                   "ms": ms, "ms_per_iter": ms / max(iters_run, 1),
                   "device_ms_per_iter": sum(by_name.values()) / 64,
                   "launches_per_iter": launches / 64,
                   "census": reduction_census(solve, bd, tol=1e-5),
                   "build_s": build_s}
            if name == "chebyshev":
                row.update(lmin=solve.options["lmin"],
                           lmax=solve.options["lmax"],
                           estimate_s=build_s if cheb_opts is None else None)
                cheb_opts = dict(solve.options)
            emit("solvers", **row)
            check(np.isfinite(xg).all(), f"{key} {name}: non-finite x")
            if name == "chebyshev":
                # the a-priori budget; where the estimated bounds miss the
                # bottom of the spectrum it ends above tol (PERF.md)
                want = chebyshev_iters_for_tol(row["lmin"], row["lmax"],
                                               1e-5)
                check(iters == want, f"{key} chebyshev: {iters} iterations, "
                      f"budget {want}")
            else:
                check(rel <= 1e-5, f"{key} {name}: {iters} iterations, "
                      f"rel {rel}")
            check(row["census"] == {"cg": 2, "pipelined_cg": 1,
                                    "chebyshev": 0}[name],
                  f"{key} {name}: census {row['census']}")
            check(true_rel < (1.0 if name == "chebyshev" else 1e-3),
                  f"{key} {name}: true rel {true_rel}")
    launches = dict(LAUNCHES)
    emit("solvers_launches", **launches)
    for kname in ("fused_ell_spmv", "fused_sell_spmv"):
        check(launches[kname] > 0, f"{kname} never launched in solvers")

    # the golden matrix, against the reference's counts
    Ag = graded_extruded_mesh_matrix(48, 6, seed=0)
    bg = np.random.default_rng(7).normal(size=Ag.n_rows)
    for fmt in ("ell", "sell"):
        plan, layout = build_spmv_plan(Ag, 4, 2, mode="balanced",
                                       node_partition="nnz", format=fmt,
                                       device=DEVICE)
        bd = to_dist(bg, layout, plan)
        for name in SOLVERS:
            solve = make_solver(plan, solver=name, precond="jacobi", A=Ag,
                                layout=layout)
            runs = [solve(bd, tol=tol, maxiter=2000) for tol in (1e-5, 3e-6)]
            iters = [int(it) for _, it, _ in runs]
            rels = [float(rel) for _, _, rel in runs]
            xg = from_dist(runs[0][0], layout, plan).astype(np.float64)
            true_rel = float(np.linalg.norm(Ag.matvec(xg) - bg)
                             / np.linalg.norm(bg))
            want, slack = GOLDEN_REF[fmt][name], GOLDEN_SLACK[name]
            emit("solvers_golden", format=fmt, solver=name, iters=iters,
                 reference_iters=list(want), slack=slack, rel=rels,
                 true_rel=true_rel,
                 **({"lmin": solve.options["lmin"],
                     "lmax": solve.options["lmax"]}
                    if name == "chebyshev" else {}))
            check(slack is None or all(abs(i - w) <= slack
                                       for i, w in zip(iters, want)),
                  f"golden {fmt} {name}: {iters} vs the reference's {want} "
                  f"± {slack}")
            check(all(r <= t for r, t in zip(rels, (1e-5, 3e-6)))
                  and true_rel < 1e-3,
                  f"golden {fmt} {name}: rel {rels}, true rel {true_rel}")
            if name == "chebyshev":
                for got, ref in zip((solve.options["lmin"],
                                     solve.options["lmax"]), GOLDEN_BOUNDS):
                    check(abs(got - ref) <= 1e-6 * ref,
                          f"golden {fmt} chebyshev bound {got} vs {ref}")
    return cheb_opts


def phase_resilience(plans, b, cheb_opts) -> None:
    """Chunked solves on the full sell 4x2 plan against the monolithic
    ones, NaN and bitflip faults caught, then the kill-and-resume CLI."""
    import os

    import numpy as np
    import torch

    from repro_torch.core import from_dist, to_dist
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.runtime.fault import FaultInjector
    from repro_torch.solvers import (make_resilient, make_solver,
                                     resilient_solve)

    plan, layout = plans["sell/4x2"]
    bd = to_dist(b, layout, plan)
    b64 = b.astype(np.float64)
    every = 50
    reset_launches()
    for name in SOLVERS:
        opts = cheb_opts if name == "chebyshev" else None
        solve = make_solver(plan, solver=name, options=opts,
                            check_every=CHECK_EVERY)
        xs, iters, _, mono_ms, _ = solve_timed(solve, bd, tol=1e-5)
        rs = make_resilient(plan, solver=name, layout=layout, options=opts)
        kw = dict(layout=layout, tol=1e-5, maxiter=10_000,
                  check_every=every, programs=rs)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        clean = resilient_solve(plan, b64, **kw)
        chunk_ms = (time.perf_counter() - t0) * 1e3
        same = (int(clean.iters) == iters
                and np.array_equal(clean.x, from_dist(xs, layout, plan)))
        nan = resilient_solve(plan, b64, injector=FaultInjector.parse(
            "nan@60", shard=(1, 1)), **kw)
        flip = resilient_solve(plan, b64, injector=FaultInjector.parse(
            "bitflip@60"), **kw)
        row = {"plan": "sell/4x2", "solver": name, "check_every": every,
               "iters": iters, "chunks": clean.chunks, "rel": float(clean.rel),
               "converged": clean.converged,
               "x_bitwise_monolithic": same,
               "chunked_ms_per_iter": chunk_ms / max(iters, 1),
               "monolithic_ms_per_iter": mono_ms / max(iters, 1),
               "nan_rollbacks": nan.rollbacks, "nan_converged": nan.converged,
               "nan_rel": float(nan.rel),
               "nan_iters": int(nan.iters), "nan_true_rel": nan.true_rel,
               "bitflip_rollbacks": flip.rollbacks,
               "bitflip_converged": flip.converged, "bitflip_rel": float(flip.rel),
               "bitflip_iters": int(flip.iters),
               "bitflip_true_rel": flip.true_rel}
        emit("resilience", **row)
        check(same, f"resilience {name}: chunked x/iterations differ from "
              f"the monolithic solve's ({int(clean.iters)} vs {iters})")
        for kind, res in (("nan@60", nan), ("bitflip@60", flip)):
            # Chebyshev's budget may end above tol at this size (its
            # bounds): a faulted run is held to the clean run's residual
            ok = res.converged or (name == "chebyshev"
                                   and res.rel <= 1.01 * clean.rel)
            check(res.rollbacks >= 1 and ok,
                  f"resilience {name}: {kind} not rolled back, or rel "
                  f"{res.rel} (clean {clean.rel})")
    launches = dict(LAUNCHES)
    emit("resilience_launches", **launches)
    check(launches["fused_sell_spmv"] > 0,
          "fused_sell_spmv never launched in resilience")

    env = dict(os.environ, PYTHONPATH=str(SRC))
    t0 = time.perf_counter()
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.testing.resilience_check",
         "--device", "cuda"], capture_output=True, text=True, env=env,
        cwd=ROOT, timeout=600)
    lines = res.stdout.strip().splitlines()
    emit("resilience_check", rc=res.returncode, seconds=time.perf_counter()
         - t0, lines=lines, stderr_tail=res.stderr[-2000:])
    check(res.returncode == 0 and lines and lines[-1] == "OK",
          "resilience_check --device cuda did not print OK")


def phase_example() -> None:
    """``examples/cg_solve_torch.py --device cuda`` at its default size."""
    import os

    env = dict(os.environ, PYTHONPATH=str(SRC))
    t0 = time.perf_counter()
    res = subprocess.run(
        [sys.executable, str(ROOT / "examples" / "cg_solve_torch.py"),
         "--device", "cuda"], capture_output=True, text=True, env=env,
        cwd=ROOT, timeout=900)
    seconds = time.perf_counter() - t0
    lines = res.stdout.strip().splitlines()
    check(res.returncode == 0 and lines,
          f"example failed ({res.returncode}): {res.stderr[-3000:]}")
    results = json.loads(lines[-1])
    emit("example", seconds=seconds, lines=lines[:-1], results=results)
    check(results["resilient/cg"]["faulted_rollbacks"] > 0
          and results["resilient/cg"]["faulted_converged"],
          "example: nan@60 not rolled back")
    check([results[f"solver/{n}"]["allreduce_per_iter"] for n in SOLVERS]
          == [2, 1, 0], "example: reduction census is not 2 / 1 / 0")


#: fine rows per aggregate of phase rect's restriction R (80,000 x 1.28M)
RECT_AGG = 16


def restriction(n: int, agg: int):
    """The two-level preconditioner's 0/1 restriction: row ``a`` sums
    fine rows ``[a * agg, (a + 1) * agg)``."""
    import numpy as np

    from repro_torch.sparse import CSRMatrix

    agg_of = np.arange(n, dtype=np.int64) // agg
    return CSRMatrix.from_coo(agg_of, np.arange(n, dtype=np.int64),
                              np.ones(n), (int(agg_of[-1]) + 1, n))


def phase_rect(A, plans, bw, f32_peak) -> tuple[dict, dict]:
    """Rectangular plans at full size: the static checks on A's 4x2 plans,
    R (agg 16, columns pinned to A's rows) and P = Rᵀ (rows pinned to A's,
    columns to R's) built with ``verify=True``, each against a host f64
    matvec, every transport bit for bit a2a, a pinned rebuild bit for bit;
    then ``rect_check --device cuda``.  Launch counts are zeroed before
    and read after that path.  Then each kernel at R's and P's shapes
    against its plain version, timed, with its bound and the library's
    time for the same matrix.  Returns the path's launch counts and the
    kernel rows by label."""
    import numpy as np

    from repro_torch.analysis import check_kernel_streams, check_plan
    from repro_torch.core import (available_transports, build_spmv_plan,
                                  from_dist, make_shard_body, make_spmv,
                                  to_dist)
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.sparse import get_format
    from repro_torch.testing import rect_check
    from repro_torch.testing.transport_check import bits_equal

    R = restriction(A.n_rows, RECT_AGG)
    mats = {"R": R, "P": R.transpose()}
    rng = np.random.default_rng(SEED + 2)
    xs = {k: rng.standard_normal(M.n_cols).astype(np.float32)
          for k, M in mats.items()}
    built = {}
    reset_launches()
    for fmt in ("ell", "sell"):
        plan_A, layout_A = plans[f"{fmt}/4x2"]
        t0 = time.perf_counter()
        rep = check_plan(plan_A, layout_A)
        rep.extend(check_kernel_streams(plan_A).violations)
        emit("rect_verify", plan=f"{fmt}/4x2", checks=rep.checks,
             errors=len(rep.errors), warnings=len(rep.warnings),
             seconds=time.perf_counter() - t0)
        check(not rep.errors, f"{fmt}/4x2: {rep.summary()}")
        pins = {"R": {"col_space": layout_A["row_space"]}}
        for key in ("R", "P"):
            M, x = mats[key], xs[key]
            if key == "P":
                pins["P"] = {"row_space": layout_A["row_space"],
                             "col_space": built[(fmt, "R")][1]["row_space"]}
            t0 = time.perf_counter()
            plan, layout = build_spmv_plan(
                M, 4, 2, mode="balanced", node_partition="nnz", format=fmt,
                verify=True, device=DEVICE, **pins[key])
            build_s = time.perf_counter() - t0
            built[(fmt, key)] = (plan, layout)
            xd = to_dist(x, layout, plan, space="col")
            y_ref = make_spmv(plan, transport="a2a")(xd)
            y_host = M.matvec(x.astype(np.float64))
            y = from_dist(y_ref, layout, plan, space="row")
            rel = float(np.abs(y - y_host).max() / np.abs(y_host).max())
            xident = {t: bits_equal(make_spmv(plan, transport=t)(xd), y_ref)
                      for t in available_transports()}
            t0 = time.perf_counter()
            plan2, layout2 = build_spmv_plan(
                M, 4, 2, mode="balanced", node_partition="nnz", format=fmt,
                row_space=layout["row_space"],
                col_space=layout["col_space"], device=DEVICE)
            pin_s = time.perf_counter() - t0
            pin = bits_equal(make_spmv(plan2)(
                to_dist(x, layout2, plan2, space="col")), y_ref)
            del plan2, layout2
            emit("rect", plan=f"{fmt}/4x2", matrix=key, shape=list(M.shape),
                 nnz=M.nnz, rc_pad=plan.rc_pad, cc_pad=plan.cc_pad,
                 nl_pad=plan.nl_pad, g_pad=plan.g_pad, hs=plan.hs,
                 fields={k: list(v.shape) for k, v in plan.fmt_data.items()},
                 build_verify_s=build_s, pinned_build_s=pin_s,
                 host_rel_err=rel, xident=xident, pinned_bitwise=pin)
            check(rel <= 1e-5, f"rect {fmt} {key}: rel err {rel} > 1e-5")
            check(all(xident.values()), f"rect {fmt} {key}: {xident}")
            check(pin, f"rect {fmt} {key}: pinned rebuild differs")
    # rect_check's grid, then halo-free (1x8: B3, B4)
    for grid in ((4, 2), (1, 8)):
        t0 = time.perf_counter()
        rc, lines = run_cli(rect_check.main, [
            "--device", "cuda", "--n-node", str(grid[0]),
            "--n-core", str(grid[1])])
        emit("rect_check", grid=list(grid), rc=rc,
             seconds=time.perf_counter() - t0,
             lines=[ln for ln in lines if not ln.startswith("  ")])
        check(rc == 0 and lines and lines[-1] == "OK",
              f"rect_check --device cuda at {grid} did not print OK")
    launches = dict(LAUNCHES)
    emit("rect_launches", **launches)
    for name in KERNELS:
        check(launches[name] > 0, f"{name} never launched in rect")

    rows = {}
    for (fmt, key), (plan, layout) in built.items():
        fobj = get_format(fmt)
        xl, xg = make_shard_body(plan).inputs(
            to_dist(xs[key], layout, plan, space="col"))
        F = plan.fmt_data
        byts, flops, stored = kernel_cost(fobj, F, xl, xg)
        kname = {("ell", True): "fused_ell_spmv", ("ell", False): "ell_spmv",
                 ("sell", True): "fused_sell_spmv",
                 ("sell", False): "sell_spmv"}[(fmt, xg is not None)]
        row = measure(
            "rect_kernel", {"kernel": kname, "plan": f"{fmt}/4x2/{key}",
                            "dtype": "float32",
                            "x_local": list(xl.shape),
                            "x_ghost": None if xg is None else list(xg.shape)},
            lambda: fobj.matvec_kernel(F, xl, xg, plan.rc_pad),
            lambda: fobj.matvec_plain(F, xl, xg, plan.rc_pad),
            byts, flops, bw, f32_peak,
            None if stored is None else {"stored": stored})
        row["library_ms"] = library_ms(mats[key], xs[key])
        emit("rect_library", plan=row["plan"], ms=row["library_ms"])
        rows[f"{fmt}/{key}"] = row
    del built
    return launches, rows


#: the reference's scaling counts under jax 0.9.0 (ROADMAP A0): CG tol
#: 1e-6 on graded (48, 6/12/24), 4x2 rows-partition ell
SCALING_REF = {"block_jacobi": [43, 37, 41], "two_level": [24, 26, 25]}


def precond_solve(A, plan, layout, b, label: str, pname: str,
                  po: dict | None, base: dict | None = None) -> dict:
    """One cg solve to 1e-6 with a preconditioner: the emitted row.  For
    two_level, the device time of one apply by kernel (10 warm calls),
    and, given ``base`` (the row of its smoother alone on the same plan),
    the coarse correction's device ms per iteration: the difference of
    the two solves' device ms per iteration, and its share."""
    import numpy as np

    from repro_torch.core import from_dist, to_dist
    from repro_torch.solvers import make_solver, reduction_census

    t0 = time.perf_counter()
    solve = make_solver(plan, solver="cg", precond=pname, A=A,
                        layout=layout, precond_options=po,
                        check_every=CHECK_EVERY)
    build_s = time.perf_counter() - t0
    bd = to_dist(b, layout, plan)
    xs, iters, rel, ms, iters_run = solve_timed(solve, bd)
    xg = from_dist(xs, layout, plan).astype(np.float64)
    b64 = b.astype(np.float64)
    true_rel = float(np.linalg.norm(A.matvec(xg) - b64)
                     / np.linalg.norm(b64))
    by_name, launches = profile_solve(solve, bd)
    device_ms = sum(by_name.values()) / 64
    row = {"plan": label, "precond": pname, "options": po, "iters": iters,
           "iters_run": iters_run, "rel": rel, "true_rel": true_rel,
           "ms_per_iter": ms / max(iters_run, 1),
           "device_ms_per_iter": device_ms,
           "launches_per_iter": launches / 64,
           "census": reduction_census(solve, bd, tol=1e-6),
           "build_s": build_s,
           "host_s": getattr(solve.papply, "host_seconds", None)}
    if pname == "two_level":
        r = bd[None]

        def apply():
            return solve.papply(solve.pdata, r)
        apply()
        per, _ = device_profile(lambda: [apply() for _ in range(10)])
        top = sorted(per.items(), key=lambda kv: -kv[1])[:8]
        row.update(apply_device_ms=sum(per.values()) / 10,
                   apply_kernels_ms={n[:60]: t / 10 for n, t in top},
                   nc=int(solve.pdata["ainv_c"].shape[-1]),
                   **{f"{k}_plan": {"rc_pad": pl.rc_pad, "cc_pad": pl.cc_pad,
                                    "hs": pl.hs, "g_pad": pl.g_pad}
                      for k, (pl, _) in solve.papply.plans.items()})
        if base is not None:
            coarse = device_ms - base["device_ms_per_iter"]
            row.update(coarse_device_ms=coarse,
                       coarse_share=coarse / device_ms if device_ms else None,
                       coarse_against=base["precond"])
    emit("precond", **row)
    check(np.isfinite(xg).all(), f"precond {label} {pname}: non-finite x")
    check(rel <= 1e-6, f"precond {label} {pname}: {iters} iterations, "
          f"rel {rel}")
    check(true_rel < 1e-4, f"precond {label} {pname}: true rel {true_rel}")
    check(row["census"] == 2, f"precond {label} {pname}: census "
          f"{row['census']}")
    return row


def phase_precond(A, plans, b) -> dict:
    """The preconditioners on the card: ``precond_check`` (graded, single,
    halofree; faulty caught), the scaling regression beside the
    reference's counts, cg with jacobi / block_jacobi / two_level on the
    32,000-row 4x2 plans, and jacobi then two_level (agg 256, jacobi
    smoother) on the full sell 4x2 plan.  Launch counts are zeroed before
    and read after; returns them."""
    import numpy as np
    import torch

    from repro_torch.core import build_spmv_plan
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.sparse import graded_extruded_mesh_matrix
    from repro_torch.testing import precond_check

    check(not torch.backends.cuda.matmul.allow_tf32,
          "TF32 matmuls are on: the dense products must run in f32")
    reset_launches()
    for case in precond_check.CASES:
        t0 = time.perf_counter()
        rc, lines = run_cli(precond_check.main,
                            ["--device", "cuda", "--case", case])
        emit("precond_check", case=case, rc=rc, lines=lines,
             seconds=time.perf_counter() - t0)
        check(rc == 0 and lines[-1] == "OK",
              f"precond_check --case {case} did not print OK")
    rc, lines = run_cli(precond_check.main,
                        ["--device", "cuda", "--include-faulty"])
    emit("precond_check", case="graded", include_faulty=True, rc=rc,
         lines=[ln for ln in lines if "faulty" in ln or ln == lines[-1]])
    check(rc == 1 and lines[-1] == "FAIL",
          "precond_check --include-faulty did not fail")

    rc, lines = run_cli(precond_check.main, ["--device", "cuda",
                                             "--scaling"])
    sc = json.loads(next(ln for ln in lines
                         if ln.startswith("SCALING "))[len("SCALING "):])
    emit("precond_scaling", rc=rc, last=lines[-1],
         block_jacobi=sc["block_jacobi"]["iters"],
         two_level=sc["two_level"]["iters"], reference=SCALING_REF,
         tl_flat_ratio=sc["tl_flat_ratio"])
    check(sc["tl_flat_ratio"] <= sc["flat_bound"]
          and all(abs(i - w) <= 1 for i, w in
                  zip(sc["two_level"]["iters"], SCALING_REF["two_level"])),
          f"scaling: two_level {sc['two_level']['iters']} against "
          f"{SCALING_REF['two_level']} ± 1")

    Am = graded_extruded_mesh_matrix(500, 64, seed=0)
    bm = np.random.default_rng(SEED + 3).standard_normal(
        Am.n_rows).astype(np.float32)
    for fmt in ("ell", "sell"):
        t0 = time.perf_counter()
        plan, layout = build_spmv_plan(Am, 4, 2, mode="balanced",
                                       node_partition="rows", format=fmt,
                                       device=DEVICE)
        emit("precond_plan", plan=f"{fmt}/4x2", rows=Am.n_rows, nnz=Am.nnz,
             rc_pad=plan.rc_pad, seconds=time.perf_counter() - t0)
        rows = {}
        for pname, po in (("jacobi", None), ("block_jacobi", None),
                          ("two_level", {"agg_size": 8,
                                         "smoother": "block_jacobi"})):
            rows[pname] = precond_solve(Am, plan, layout, bm,
                                        f"{fmt}/4x2/{Am.n_rows}", pname, po,
                                        base=rows.get("block_jacobi"))
        del plan, layout
    plan, layout = plans["sell/4x2"]
    jacobi = precond_solve(A, plan, layout, b, "sell/4x2", "jacobi", None)
    row = precond_solve(A, plan, layout, b, "sell/4x2", "two_level",
                        {"agg_size": 256, "smoother": "jacobi"}, base=jacobi)
    emit("precond_full", two_level_iters=row["iters"],
         jacobi_iters=jacobi["iters"], ratio=row["iters"] / jacobi["iters"],
         time_to_tol_ms={"jacobi": jacobi["ms_per_iter"]
                         * jacobi["iters_run"],
                         "two_level": row["ms_per_iter"] * row["iters_run"]})
    launches = dict(LAUNCHES)
    emit("precond_launches", **launches)
    # two_level's R and P are ELL plans, halo-free on halofree's 1x8 grid;
    # the solves run A's own kernel (sell_spmv runs on no plan here)
    for name in ("fused_ell_spmv", "ell_spmv", "fused_sell_spmv"):
        check(launches[name] > 0, f"{name} never launched in precond")
    return launches


#: the batched kernels (B1-B4 under vmap): name -> (plan key, the TPU
#: kernel it replaces, batched by vmap over the shard body)
BATCHED = {
    "fused_ell_spmv_batched": (
        "ell/4x2", "src/repro/kernels/spmv_bcsr.py:103 via "
        "src/repro/solvers/base.py:419"),
    "fused_sell_spmv_batched": (
        "sell/4x2", "src/repro/kernels/spmv_bcsr.py:211 via "
        "src/repro/solvers/base.py:419"),
    "ell_spmv_batched": (
        "ell/1x8", "src/repro/kernels/spmv_bcsr.py:58 via "
        "src/repro/solvers/base.py:419"),
    "sell_spmv_batched": (
        "sell/1x8", "src/repro/kernels/spmv_bcsr.py:189 via "
        "src/repro/solvers/base.py:419"),
}
#: the service's batch (nrhs) and chunk; its rows of the ``kernels`` line
#: are the batched kernels at this k
SERVE_NRHS, SERVE_CHECK_EVERY = 4, 25
#: the batch sizes the batched kernels are checked and timed at: every
#: column tile (4, 8, 16), full and with pad columns
SERVE_KS = (1, 3, 4, 8, 16)
SERVE_TOLS = (1e-5, 3e-5, 1e-4)


def spmm_ms(A, k: int) -> float:
    """One torch.sparse CSR x dense (n, k) product of the global matrix
    (cuSPARSE SpMM) — the batched kernels' yardstick only."""
    import torch

    csr = torch.sparse_csr_tensor(
        torch.from_numpy(A.indptr), torch.from_numpy(A.indices),
        torch.from_numpy(A.data.astype("float32")), size=A.shape,
        device=DEVICE)
    X = torch.randn((A.n_cols, k), device=DEVICE)
    return time_ms(lambda: csr @ X)


def serve_kernels(A, plans, bw, f32_peak) -> dict:
    """Each batched kernel at k = SERVE_KS on its full-size plan, f32 and
    bf16: every column bit for bit the single-column kernel, the whole
    within 2e-5·max|y| of the plain version; f32 timed, with the interleave
    copy alone beside it.  Returns the k = SERVE_NRHS rows by kernel
    name."""
    import numpy as np
    import torch

    from repro_torch.core import make_shard_body, to_dist
    from repro_torch.kernels import ops
    from repro_torch.sparse import get_format

    rng = np.random.default_rng(SEED + 5)
    lib = {k: spmm_ms(A, k) for k in SERVE_KS}
    rows = {}
    for name, (key, _) in BATCHED.items():
        plan, layout = plans[key]
        fmt = get_format(plan.format)
        body = make_shard_body(plan)
        for k in SERVE_KS:
            X = torch.stack([to_dist(rng.standard_normal(A.n_rows), layout,
                                     plan) for _ in range(k)])
            xl, xg = body.inputs(X)
            for dtype in (torch.float32, torch.bfloat16):
                F = {kk: (v.to(dtype) if v.is_floating_point() else v)
                     for kk, v in plan.fmt_data.items()}
                y = fmt.matvec_kernel(F, xl, xg, plan.rc_pad)
                same = all(torch.equal(y[j], fmt.matvec_kernel(
                    F, xl[j], None if xg is None else xg[j], plan.rc_pad))
                    for j in range(k))
                torch.cuda.synchronize()
                what = f"{name} k={k} {str(dtype)[6:]}"
                check(same, f"{what}: a column differs from the "
                      "single-column kernel")
                if dtype == torch.bfloat16:
                    want = fmt.matvec_plain(F, xl, xg, plan.rc_pad)
                    err = float((y - want).abs().max())
                    tol = 2e-5 * max(1.0, float(want.abs().max()))
                    emit("serve_kernel", kernel=name, plan=key,
                         dtype="bfloat16", k=k, columns_bitwise_single=same,
                         max_abs_err=err, tol=tol)
                    check(err <= tol, f"{what}: max|err| {err} > {tol}")
                    continue
                x1 = (xl[0], None if xg is None else xg[0])
                one_bytes, one_flops, _ = kernel_cost(fmt, F, *x1)
                mat_bytes = one_bytes - nbytes(*x1)
                inter_ms = time_ms(lambda: (ops.interleave_rhs(xl),
                                            None if xg is None
                                            else ops.interleave_rhs(xg)))
                row = measure(
                    "serve_kernel",
                    {"kernel": name, "plan": key, "dtype": "float32",
                     "k": k, "columns_bitwise_single": same,
                     "interleave_ms": inter_ms,
                     "loop_ms": loop_ms(lambda: fmt.matvec_kernel(
                         F, xl, xg, plan.rc_pad)),
                     "library_ms": lib[k],
                     "library": "torch.sparse CSR x dense (n, k), global "
                                "matrix (cuSPARSE SpMM)"},
                    lambda: fmt.matvec_kernel(F, xl, xg, plan.rc_pad),
                    lambda: fmt.matvec_plain(F, xl, xg, plan.rc_pad),
                    mat_bytes + k * nbytes(*x1), k * one_flops, bw,
                    f32_peak)
                if k == SERVE_NRHS:
                    rows[name] = row
                del F
    return rows


def serve_bodies(plans) -> None:
    """The batched shard body on the full 4x2 plans: each column bit for
    bit the unbatched body, every transport x wire dtype."""
    import numpy as np
    import torch

    from repro_torch.core import make_shard_body, to_dist
    from repro_torch.core.transport import (available_transports,
                                            available_wire_dtypes)

    rng = np.random.default_rng(SEED + 6)
    for key in ("ell/4x2", "sell/4x2"):
        plan, layout = plans[key]
        X = torch.stack([to_dist(rng.standard_normal(plan.n), layout, plan)
                         for _ in range(SERVE_NRHS)])
        bad = []
        for tr in available_transports():
            for wd in available_wire_dtypes():
                body = make_shard_body(plan, transport=tr, wire_dtype=wd)
                y = body(X)
                if not all(torch.equal(y[j], body(X[j]))
                           for j in range(SERVE_NRHS)):
                    bad.append(f"{tr}/{wd}")
        emit("serve_body", plan=key, k=SERVE_NRHS,
             transports=list(available_transports()),
             wire_dtypes=list(available_wire_dtypes()), differ=bad)
        check(not bad, f"{key}: batched body columns differ from the "
              f"unbatched body for {bad}")


def batched_cg(A, plans, B) -> None:
    """make_solver(nrhs=SERVE_NRHS) (cg + jacobi, tol 1e-5) on each
    full-size plan: each column's count within ±1 of its nrhs=None solve,
    true residuals, and (sell 4x2) wall and device ms and launches per
    iteration against SERVE_NRHS sequential solves."""
    import numpy as np
    import torch

    from repro_torch.core import from_dist, to_dist
    from repro_torch.solvers import make_solver
    from repro_torch.solvers.base import from_dist_batch, to_dist_batch

    k = SERVE_NRHS
    for key, (plan, layout) in plans.items():
        solve_b = make_solver(plan, nrhs=k, check_every=CHECK_EVERY)
        solve_1 = make_solver(plan, check_every=CHECK_EVERY)
        bd = to_dist_batch(B, layout, plan)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        xb, ib, rb = solve_b(bd, tol=1e-5, maxiter=10_000)
        torch.cuda.synchronize()
        wall_b = (time.perf_counter() - t0) * 1e3
        ib = [int(v) for v in ib]
        seq = [solve_timed(solve_1, to_dist(B[j], layout, plan), tol=1e-5)
               for j in range(k)]
        X = from_dist_batch(xb, layout, plan).astype(np.float64)
        true_rel = [float(np.linalg.norm(A.matvec(X[j]) - B[j])
                          / np.linalg.norm(B[j])) for j in range(k)]
        seq_true = [float(np.linalg.norm(
            A.matvec(from_dist(x, layout, plan).astype(np.float64)) - B[j])
            / np.linalg.norm(B[j])) for j, (x, *_rest) in enumerate(seq)]
        row = {"plan": key, "nrhs": k, "iters": ib,
               "iters_single": [it for _, it, *_ in seq],
               "true_rel": true_rel, "true_rel_single": seq_true,
               "wall_ms": wall_b,
               "iters_run": -(-max(ib) // CHECK_EVERY) * CHECK_EVERY,
               "sequential_wall_ms": sum(r[3] for r in seq),
               "sequential_iters_run": sum(r[4] for r in seq)}
        row["ms_per_iter"] = wall_b / row["iters_run"]
        row["sequential_ms_per_iter"] = (row["sequential_wall_ms"]
                                         / row["sequential_iters_run"])
        if key == "sell/4x2":
            dev = {}
            for tag, solve, b0 in (("batched", solve_b, bd),
                                   ("single", solve_1,
                                    to_dist(B[0], layout, plan))):
                solve(b0, tol=0.0, maxiter=CHECK_EVERY)          # warm
                box = {}

                def run():
                    box["it"] = solve(b0, tol=0.0, maxiter=64)[1]
                by_name, launches = device_profile(run)
                check(bool((box["it"] == 64).all()),
                      f"{key} {tag} profile: {box['it']} != 64")
                dev[tag] = (sum(by_name.values()) / 64, launches / 64)
            row.update(device_ms_per_iter=dev["batched"][0],
                       launches_per_iter=dev["batched"][1],
                       single_device_ms_per_iter=dev["single"][0],
                       single_launches_per_iter=dev["single"][1])
        emit("serve_batched_cg", **row)
        for j in range(k):
            check(abs(ib[j] - row["iters_single"][j]) <= 1,
                  f"{key} batched cg column {j}: {ib[j]} iterations, alone "
                  f"{row['iters_single'][j]}")
            check(true_rel[j] < 2e-4, f"{key} batched cg column {j}: true "
                  f"rel {true_rel[j]}")
        check(bool((rb <= 1e-5).all()), f"{key} batched cg rel {rb}")


def serve_engine(A, B, N: int) -> dict:
    """The service at full size: N requests (tols cycling SERVE_TOLS)
    through SolveService (sell 4x2, a2a f32, cg + jacobi, nrhs
    SERVE_NRHS, check_every SERVE_CHECK_EVERY) against the same requests
    one at a time through a warm make_solver; a second service over the
    same cache; one splice's survivors against a run without it.
    Returns the service's row."""
    import numpy as np
    import torch

    from repro_torch.core import to_dist
    from repro_torch.serve import EngineConfig, PlanCache, SolveService
    from repro_torch.solvers import make_solver

    tols = [SERVE_TOLS[i % 3] for i in range(N)]
    cache = PlanCache()
    cfg = EngineConfig(nrhs=SERVE_NRHS, n_node=4, n_core=2, format="sell",
                       transport="a2a", wire_dtype="f32", solver="cg",
                       precond="jacobi", check_every=SERVE_CHECK_EVERY)
    t0 = time.perf_counter()
    svc = SolveService(A, cfg, cache=cache, device=DEVICE)
    build_s = time.perf_counter() - t0
    engine = svc.engine
    plan, layout = engine.plan, engine.layout
    seq = make_solver(plan, A=A, layout=layout,
                      neighbor_offsets=layout["neighbor_offsets"])
    seq(to_dist(B[0], layout, plan), tol=1e-5, maxiter=50)       # warm
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    seq_iters = []
    for i in range(N):
        seq_iters.append(seq(to_dist(B[i], layout, plan), tol=tols[i],
                             maxiter=cfg.maxiter)[1])
    torch.cuda.synchronize()
    t_seq = time.perf_counter() - t0
    seq_iters = [int(v) for v in seq_iters]

    futs = [svc.submit(B[i], tol=tols[i]) for i in range(N)]
    t0 = time.perf_counter()
    results = svc.drain()
    torch.cuda.synchronize()
    t_cont = time.perf_counter() - t0
    res = [f.result() for f in futs]
    st = svc.stats()
    latency = [r.queue_s + r.solve_s for r in res]
    row = {"requests": N, "nrhs": SERVE_NRHS,
           "check_every": SERVE_CHECK_EVERY, "tols": list(SERVE_TOLS),
           "build_s": build_s, "served": len(results),
           "iters": [r.iterations for r in res], "iters_sequential":
           seq_iters, "true_rel": [r.residual for r in res],
           "sequential_s": t_seq, "continuous_s": t_cont,
           "speedup": t_seq / t_cont,
           "latency_p50_s": float(np.percentile(latency, 50)),
           "latency_p99_s": float(np.percentile(latency, 99)),
           "solve_p50_s": float(np.percentile([r.solve_s for r in res], 50)),
           "solve_p99_s": float(np.percentile([r.solve_s for r in res], 99)),
           **{k: st[k] for k in ("splices", "chunks", "retired", "failed",
                                 "recompiles", "executables", "cache")}}
    before = dict(cache.stats.as_dict())
    SolveService(A, cfg, cache=cache, device=DEVICE)
    after = cache.stats.as_dict()
    row["second_service_cache"] = after
    hit = (after["plan_hits"] == before["plan_hits"] + 1
           and after["program_hits"] == before["program_hits"] + 1
           and after["plan_misses"] == before["plan_misses"]
           and after["program_misses"] == before["program_misses"]
           and after["compile_s"] == before["compile_s"])
    row["splice_survivors_bitwise"], row["splice_chunks"] = splice_check(
        A, cache, cfg, B)
    emit("serve", **row)
    check(len(results) == N and all(r.iterations > 0 for r in res),
          f"served {len(results)} of {N}")
    check(max(row["true_rel"]) < 2e-4,
          f"service true rel {max(row['true_rel'])}")
    check(st["splices"] >= N, f"{st['splices']} splices for {N} requests")
    check(row["speedup"] >= 1.05, f"continuous {t_cont:.3f} s against "
          f"sequential {t_seq:.3f} s: {row['speedup']:.3f}x < 1.05x")
    check(st["recompiles"] == 0, f"recompiles {st['recompiles']}")
    check(hit, f"second service not a pure cache hit: {before} -> {after}")
    check(row["splice_survivors_bitwise"], "a splice moved a survivor")
    return row


def splice_check(A, cache, cfg, B) -> tuple[bool, int]:
    """Three requests (slot 0's tol loose, so it retires first), with and
    without a fourth spliced into slot 0 mid-solve: the survivors' (slots
    1 and 2) per-chunk iterates must be byte-identical."""
    import torch

    from repro_torch.serve import SolveEngine

    def run(splice: bool) -> list:
        e = SolveEngine(A, cfg, device=DEVICE, cache=cache)
        for i, tol in enumerate((1e-2, 1e-5, 3e-5)):
            e.submit(B[i], tol=tol)
        snaps, added = [], False
        while not e.idle():
            retired = e.step()
            if splice and retired and not added:
                e.submit(B[3], tol=1e-5)
                added = True
            snaps.append(e._state["x"][1:3].clone())
        check(not splice or added, "the splice never happened")
        return snaps

    base, spl = run(False), run(True)
    n = min(len(base), len(spl))
    return all(torch.equal(base[c], spl[c]) for c in range(n)), n


def phase_serve(A, plans, bw, f32_peak) -> tuple[dict, dict]:
    """The batched kernels and body against their single-column versions,
    then the serving path — batched CG on every full-size plan, the
    service, its splice, ``serve_check --device cuda`` — with launch
    counts zeroed just before it and read just after.  Returns the
    batched kernels' launches on that path and their k = SERVE_NRHS
    rows."""
    import numpy as np

    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.testing import serve_check

    rows = serve_kernels(A, plans, bw, f32_peak)
    serve_bodies(plans)
    rng = np.random.default_rng(SEED + 7)
    N = 4 * SERVE_NRHS
    B = rng.standard_normal((N, A.n_rows))
    reset_launches()
    batched_cg(A, plans, B[:SERVE_NRHS])
    serve_engine(A, B, N)
    rc, lines = run_cli(serve_check.main, ["--device", "cuda"])
    launches = dict(LAUNCHES)
    emit("serve_check", rc=rc, lines=lines)
    emit("serve_launches", **launches)
    check(rc == 0 and lines[-1] == "OK", f"serve_check: rc {rc}, {lines}")
    for name in BATCHED:
        check(launches[name] > 0, f"{name} never launched on the serving "
              "path")
    return launches, rows


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
    bal_launches, bal = phase_balanced(A, x, bw, f32_peak)
    lib = library_ms(A, x)
    emit("library", what="torch.sparse CSR matvec, global matrix, f32",
         ms=lib)
    phase_golden()
    launches, rows = phase_full(A, plans, x, b)
    phase_profile(plans, b, rows)
    phase_transports(plans, x, b)
    phase_refine(A, plans, b)
    cheb_opts = phase_solvers(A, plans, b)
    phase_resilience(plans, b, cheb_opts)
    phase_example()
    rect_launches, rect = phase_rect(A, plans, bw, f32_peak)
    phase_precond(A, plans, b)
    serve_launches, serve_rows = phase_serve(A, plans, bw, f32_peak)
    entries = [(name, KERNELS[name][1], launches[name], kern[name])
               for name in KERNELS]
    # the batched kernels at the service's k, with their serving launches
    entries += [(name, BATCHED[name][1], serve_launches[name],
                 serve_rows[name]) for name in BATCHED]
    # each kernel at R's and P's shapes, with its launches in phase rect
    for label, row in rect.items():
        name = row["kernel"]
        entries.append((f"{name}/{label}", KERNELS[name][1],
                        rect_launches[name], row))
    entries.append((BALANCED[0], BALANCED[1], bal_launches[BALANCED[0]],
                    bal[BALANCED[2]]))
    entries.append((FLAT_ELL[0], FLAT_ELL[1], bal_launches["ell_spmv"],
                    bal[FLAT_ELL[2]]))
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": SOURCE,
         "replaces": replaces, "launches": n,
         **{k: row[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                                "bound_by")},
         "library_ms": row.get("library_ms", lib)}
        for name, replaces, n, row in entries]}),
          flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
