"""Kill-and-resume elastic restart check on the port.

Usage (parent):  python -m repro_torch.testing.resilience_check
                     [--device cuda|cpu] [--ckpt-dir DIR]

The parent orchestrates three **child** processes (the parent itself never
touches the device):

  1. *victim*   — a 4×2 resilient solve (ell, a2a) with a ``preempt@K``
                  fault armed: the driver checkpoints every healthy chunk,
                  then SIGKILLs its own process mid-solve.  The parent
                  checks the child died by SIGKILL and left a checkpoint.
  2. *resumed*  — a 2×2 solve of the *same* system with ``--resume-from``:
                  another grid, shard format (sell) and transport (ring).
                  The plan is rebuilt from scratch and the solve re-enters
                  at the checkpointed x and iteration; it must converge
                  against the numpy f64 oracle.
  3. *clean*    — the same 2×2 configuration solved uninterrupted: the
                  iteration baseline the resumed run must stay near.

Every child runs on ``--device`` (default ``cuda``).  Each prints one
``CHILD ...`` line; the parent prints its verdicts and ``OK``/``FAIL``.
"""
import argparse
import os
import signal
import subprocess
import sys
import tempfile

#: f32 true-residual / solution-error bounds per solver
BOUNDS = {"cg": (2e-4, 1e-2), "pipelined_cg": (1e-3, 3e-2),
          "chebyshev": (2e-3, 5e-2)}


def child_main(args) -> int:
    import numpy as np

    from repro_torch.runtime.fault import FaultInjector
    from repro_torch.solvers import resilient_solve
    from repro_torch.sparse import graded_extruded_mesh_matrix
    from repro_torch.testing.refine_check import host_cg

    # the system is grid-independent: every child solves the same (A, b)
    A = graded_extruded_mesh_matrix(args.n_surface, args.layers, seed=0)
    b = np.random.default_rng(1).normal(size=A.n_rows)
    inj = (FaultInjector.parse(args.inject_fault)
           if args.inject_fault else None)

    res = resilient_solve(
        A, b, solver=args.solver, precond=args.precond,
        n_node=args.n_node, n_core=args.n_core, format=args.format,
        transport=args.transport, tol=args.tol, maxiter=5000,
        check_every=args.check_every, checkpoint_dir=args.checkpoint_dir,
        resume_from=args.resume_from, injector=inj, device=args.device)

    xh = host_cg(A, b, tol=1e-10, maxiter=20_000)
    dxh = float(np.linalg.norm(res.x - xh)
                / max(float(np.linalg.norm(xh)), 1e-30))
    tr_max, dx_max = BOUNDS.get(args.solver, (2e-3, 5e-2))
    ok = (res.converged and res.true_rel < tr_max and dxh < dx_max)
    print(f"CHILD SOLVER {args.solver} ITERS {int(np.max(res.iters))} "
          f"CHUNKS {res.chunks} ROLLBACKS {res.rollbacks} "
          f"RESUMED_FROM {-1 if res.resumed_from is None else res.resumed_from} "
          f"TRUE_REL {res.true_rel:.3e} DX_HOST {dxh:.3e} "
          f"{'ok' if ok else 'BAD'}")
    return 0 if ok else 1


def _spawn(extra, timeout=600):
    argv = [sys.executable, "-m", "repro_torch.testing.resilience_check",
            "--child"] + extra
    return subprocess.run(argv, capture_output=True, text=True,
                          timeout=timeout)


def _field(out: str, key: str):
    for line in out.splitlines():
        toks = line.split()
        if "CHILD" in toks and key in toks:
            return toks[toks.index(key) + 1]
    return None


def parent_main(args) -> int:
    ckpt = args.ckpt_dir or tempfile.mkdtemp(prefix="resilience_ckpt_")
    common = ["--solver", args.solver, "--precond", args.precond,
              "--tol", str(args.tol), "--check-every",
              str(args.check_every), "--n-surface", str(args.n_surface),
              "--layers", str(args.layers), "--device", args.device]
    ok = True

    # 1) victim: 4x2 grid, ell/a2a, SIGKILLed mid-solve by the injector
    r = _spawn(common + ["--n-node", "4", "--n-core", "2",
                         "--format", "ell", "--transport", "a2a",
                         "--checkpoint-dir", ckpt,
                         "--inject-fault", f"preempt@{args.preempt_at}"])
    killed = r.returncode == -signal.SIGKILL
    print(f"VICTIM rc={r.returncode} "
          f"{'killed-by-SIGKILL ok' if killed else 'BAD (survived?)'}")
    if not killed:
        sys.stderr.write(r.stdout + r.stderr)
    ok &= killed

    steps = sorted(n for n in os.listdir(ckpt) if n.startswith("step_"))
    have_ckpt = bool(steps)
    last = int(steps[-1].split("_")[1]) if steps else -1
    print(f"CHECKPOINT steps={len(steps)} last={last} "
          f"{'ok' if have_ckpt and last > 0 else 'BAD'}")
    ok &= have_ckpt and last > 0

    # 2) resumed: 2x2 grid, sell/ring — another grid shape, partition,
    #    format and transport; re-enters at the checkpointed iteration
    r2 = _spawn(common + ["--n-node", "2", "--n-core", "2",
                          "--format", "sell", "--transport", "ring",
                          "--resume-from", ckpt])
    sys.stdout.write(r2.stdout)
    resumed_ok = r2.returncode == 0
    resumed_from = int(_field(r2.stdout, "RESUMED_FROM") or -1)
    it_resumed = int(_field(r2.stdout, "ITERS") or -1)
    print(f"RESUMED rc={r2.returncode} from={resumed_from} "
          f"{'ok' if resumed_ok and resumed_from > 0 else 'BAD'}")
    if not resumed_ok:
        sys.stderr.write(r2.stderr)
    ok &= resumed_ok and resumed_from > 0

    # 3) clean baseline on the resume configuration
    r3 = _spawn(common + ["--n-node", "2", "--n-core", "2",
                          "--format", "sell", "--transport", "ring"])
    sys.stdout.write(r3.stdout)
    clean_ok = r3.returncode == 0
    it_clean = int(_field(r3.stdout, "ITERS") or -1)
    if not clean_ok:
        sys.stderr.write(r3.stderr)
    ok &= clean_ok

    # the resumed run re-enters with a fresh Krylov space (β-chain reset),
    # so it may spend about a restart's worth of extra iterations on top
    # of per-chunk granularity, but it must genuinely resume: strictly
    # fewer new iterations than a whole clean solve
    slack = 2 * args.check_every + 10
    within = (0 < it_resumed <= it_clean + slack
              and it_resumed - resumed_from < it_clean)
    print(f"ITERS resumed={it_resumed} clean={it_clean} "
          f"new={it_resumed - resumed_from} slack={slack} "
          f"{'ok' if within else 'BAD'}")
    ok &= within

    print("OK" if ok else "FAIL")
    return 0 if ok else 1


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--child", action="store_true")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--n-node", type=int, default=4)
    ap.add_argument("--n-core", type=int, default=2)
    ap.add_argument("--format", default="ell")
    ap.add_argument("--transport", default="a2a")
    ap.add_argument("--solver", default="cg")
    ap.add_argument("--precond", default="jacobi")
    ap.add_argument("--tol", type=float, default=1e-5)
    ap.add_argument("--check-every", type=int, default=10)
    ap.add_argument("--preempt-at", type=int, default=25)
    ap.add_argument("--n-surface", type=int, default=48)
    ap.add_argument("--layers", type=int, default=6)
    ap.add_argument("--inject-fault", default=None)
    ap.add_argument("--checkpoint-dir", default=None)
    ap.add_argument("--resume-from", default=None)
    args = ap.parse_args(argv)
    return child_main(args) if args.child else parent_main(args)


if __name__ == "__main__":
    sys.exit(main())
