"""Kill-and-resume elastic restart check on the port.

Usage (parent):  python -m repro_torch.testing.resilience_check
                     [--device cuda|cpu] [--ckpt-dir DIR]

The parent orchestrates two **child** processes (the parent itself never
touches the device), which run three solves:

  1. *victim*   — a 4×2 resilient solve (ell, a2a) with a ``preempt@K``
                  fault armed: the driver checkpoints every healthy chunk,
                  then SIGKILLs its own process mid-solve.  The parent
                  checks the child died by SIGKILL and left a checkpoint.
  2. *resumed*  — a 2×2 solve of the *same* system with ``--resume-from``:
                  another grid, shard format (sell) and transport (ring).
                  The plan is rebuilt from scratch and the solve re-enters
                  at the checkpointed x and iteration; it must converge
                  against the numpy f64 oracle.
  3. *clean*    — the same 2×2 configuration solved uninterrupted, by
                  the resumed child after its resumed solve (on a process
                  mesh: on the same spawned ranks): the iteration baseline
                  the resumed run must stay near.

Every child runs on ``--device`` (default ``cuda``).  Each prints one
``CHILD ...`` line; the parent prints its verdicts and ``OK``/``FAIL``.

``--mesh process`` runs each child's solve on a process mesh
(``repro_torch.launch.mesh``): the child spawns one rank per shard
(``--dist-backend``: gloo, or nccl with a card per rank, 8 for the victim)
and every rank runs the resilient driver on its shard.  The victim's
``preempt@K`` kills every rank at one chunk boundary, after rank 0 wrote
the checkpoint; the child reports the ranks' exit codes (``CHILD KILLED
[...]``) and the parent checks each is SIGKILL's.  The ``CHILD`` line of a
solve adds ``RANKS ok`` when every rank reports the same iterations.
"""
import argparse
import os
import signal
import subprocess
import sys
import tempfile

from repro_torch.launch.mesh import add_dist_backend, dist_backend

#: f32 true-residual / solution-error bounds per solver
BOUNDS = {"cg": (2e-4, 1e-2), "pipelined_cg": (1e-3, 3e-2),
          "chebyshev": (2e-3, 5e-2)}


def _system(args):
    """The system every child solves: grid-independent ``(A, b)``."""
    import numpy as np

    from repro_torch.sparse import graded_extruded_mesh_matrix

    A = graded_extruded_mesh_matrix(args.n_surface, args.layers, seed=0)
    return A, np.random.default_rng(1).normal(size=A.n_rows)


def solve(args, mesh=None):
    """The child's resilient solve (on a process ``mesh``: this rank's)."""
    from repro_torch.runtime.fault import FaultInjector
    from repro_torch.solvers import resilient_solve

    A, b = _system(args)
    inj = (FaultInjector.parse(args.inject_fault)
           if args.inject_fault else None)
    return resilient_solve(
        A, b, solver=args.solver, precond=args.precond,
        n_node=args.n_node, n_core=args.n_core, format=args.format,
        transport=args.transport, tol=args.tol, maxiter=5000,
        check_every=args.check_every, checkpoint_dir=args.checkpoint_dir,
        resume_from=args.resume_from, injector=inj,
        device=args.device if mesh is None else mesh.device, mesh=mesh)


def _solves(args) -> list:
    """The child's solves: its own, then with ``--with-clean`` the same
    configuration from scratch."""
    out = [args]
    if args.with_clean:
        out.append(argparse.Namespace(**{**vars(args), "resume_from": None,
                                         "with_clean": False}))
    return out


def _rank_solve(mesh, args):
    return [solve(a, mesh) for a in _solves(args)]


def child_main(args) -> int:
    import numpy as np

    from repro_torch.testing.refine_check import host_cg

    A, b = _system(args)
    if args.mesh == "process":
        from repro_torch.launch.mesh import RanksKilled, spawn_cg_mesh
        try:
            ranks = spawn_cg_mesh(_rank_solve, args.n_node, args.n_core,
                                  args.device, backend=args.dist_backend,
                                  args=(args,), timeout=600)
        except RanksKilled as e:
            print(f"CHILD KILLED {e.exitcodes}")
            return 3
        results = []
        for i in range(len(ranks[0])):
            res = ranks[0][i]
            same = all(np.array_equal(r[i].iters, res.iters)
                       for r in ranks)
            results.append((same, res, f" RANKS {'ok' if same else 'BAD'}"))
    else:
        results = [(True, solve(a), "") for a in _solves(args)]

    xh = host_cg(A, b, tol=1e-10, maxiter=20_000)
    rc = 0
    for (same, res, tail), label in zip(results, ("", "CLEAN ")):
        rc |= _report(args, res, same, xh, tail, label)
    return rc


def _report(args, res, same, xh, tail, label) -> int:
    """One solve's ``CHILD`` line (``label`` marks the clean baseline of a
    ``--with-clean`` child); 1 if it failed."""
    import numpy as np

    dxh = float(np.linalg.norm(res.x - xh)
                / max(float(np.linalg.norm(xh)), 1e-30))
    tr_max, dx_max = BOUNDS.get(args.solver, (2e-3, 5e-2))
    ok = (same and res.converged and res.true_rel < tr_max
          and dxh < dx_max)
    print(f"CHILD {label}SOLVER {args.solver} ITERS {int(np.max(res.iters))} "
          f"CHUNKS {res.chunks} ROLLBACKS {res.rollbacks} "
          f"RESUMED_FROM {-1 if res.resumed_from is None else res.resumed_from} "
          f"TRUE_REL {res.true_rel:.3e} DX_HOST {dxh:.3e}{tail} "
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
              "--layers", str(args.layers), "--device", args.device,
              "--mesh", args.mesh, "--dist-backend", args.dist_backend]
    ok = True

    # 1) victim: 4x2 grid, ell/a2a, SIGKILLed mid-solve by the injector
    #    (on a process mesh: every rank, each by its own SIGKILL)
    r = _spawn(common + ["--n-node", "4", "--n-core", "2",
                         "--format", "ell", "--transport", "a2a",
                         "--checkpoint-dir", ckpt,
                         "--inject-fault", f"preempt@{args.preempt_at}"])
    if args.mesh == "process":
        codes = [ln.split("CHILD KILLED", 1)[1].strip()
                 for ln in r.stdout.splitlines() if "CHILD KILLED" in ln]
        codes = codes[0] if codes else None
        killed = codes == str([-signal.SIGKILL] * 8)
        print(f"VICTIM rc={r.returncode} ranks {codes} "
              f"{'killed-by-SIGKILL ok' if killed else 'BAD (survived?)'}")
    else:
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
    #    format and transport; re-enters at the checkpointed iteration;
    # 3) then, in the same child (on the same ranks), the clean baseline
    #    on the resume configuration
    r2 = _spawn(common + ["--n-node", "2", "--n-core", "2",
                          "--format", "sell", "--transport", "ring",
                          "--resume-from", ckpt, "--with-clean"])
    sys.stdout.write(r2.stdout)
    resumed = [ln for ln in r2.stdout.splitlines()
               if "CHILD" in ln.split() and "CLEAN" not in ln.split()]
    clean = [ln for ln in r2.stdout.splitlines() if "CHILD CLEAN" in ln]
    resumed_ok = r2.returncode == 0
    resumed_from = int(_field("\n".join(resumed), "RESUMED_FROM") or -1)
    it_resumed = int(_field("\n".join(resumed), "ITERS") or -1)
    print(f"RESUMED rc={r2.returncode} from={resumed_from} "
          f"{'ok' if resumed_ok and resumed_from > 0 else 'BAD'}")
    if not resumed_ok:
        sys.stderr.write(r2.stderr)
    ok &= resumed_ok and resumed_from > 0
    clean_ok = bool(clean) and "BAD" not in clean[0].split()
    it_clean = int(_field("\n".join(clean), "ITERS") or -1)
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
    ap.add_argument("--with-clean", action="store_true",
                    help="child: after its solve, the same configuration "
                         "from scratch (the parent's baseline)")
    ap.add_argument("--mesh", default="virtual",
                    choices=["virtual", "process"],
                    help="virtual: each child's grid on one device; "
                         "process: one spawned rank per shard")
    add_dist_backend(ap)
    args = ap.parse_args(argv)
    # the victim's 4x2 mesh is the widest
    dist_backend(ap, args, max(8, args.n_node * args.n_core))
    return child_main(args) if args.child else parent_main(args)


if __name__ == "__main__":
    sys.exit(main())
