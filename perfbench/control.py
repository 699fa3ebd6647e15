"""The readings a configuration's correctness limit is set from, at the
cell's own size, in one process:

* the program's: the number the mix's check compares (the true relative
  residual, or the iterate's error against the plain reference's float64
  iterate), for the answers the program gives to the mix's right-hand
  sides, one solve after another (``--solves``);
* the control's: the plain reference's Jacobi CG put in the program's
  place and computed in bfloat16, the precision below the configuration's
  float32, on the first ``--control-solves`` of the same solves;
* the plain reference's own CG in float32 on the first solve, beside them.

    python3 perfbench/control.py --config fluidity-graded-6.7m \
        --traffic ksp [--solves 12] [--control-solves 3] [--seed N]

One JSON line per reading, the last a summary with the lower reading (the
program's largest) and the upper one (the control's smallest).  The
benchmark's own runs never run this.
"""
import time

T0 = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
for _p in (str(ROOT / "src"), str(ROOT)):
    if _p not in sys.path:
        sys.path.insert(0, _p)


def readings(cfg: dict, mix: dict, seed: int, solves: int,
             control_solves: int, device, emit=print,
             cache: Path | None = None) -> dict:
    """Program readings on solves ``0 .. solves - 1`` of run ``seed``,
    control readings on the first ``control_solves``; each emitted as it
    comes.  Returns the summary."""
    import torch

    from perfbench import system, traffic
    from perfbench.operators import generate
    from perfbench.reference import DeviceCSR, pcg
    from repro_torch.solvers import make_solver

    op = generate(cfg["operator"], cache=cache)
    gen = traffic.generator(mix)
    A64 = DeviceCSR.of(op, device)
    load = gen.Traffic(mix, A64, seed)
    plan, layout, _ = system.build_plan(op, cfg["plan"], device)
    g = layout["global_row_of"]
    place = system.Placement(g, device)
    s = cfg["solver"]
    solve = make_solver(plan, solver=s["solver"], precond=s["precond"],
                        check_every=s["check_every"])
    prog = []
    for i in range(solves):
        x, it, rel = solve(place(load.rhs(i)), tol=load.tol,
                           maxiter=load.maxiter)
        xg = torch.from_numpy(system.assemble(x.cpu().numpy(), g, op.n))
        r = load.judge(A64, i, xg.to(device))
        prog.append(r)
        emit({"side": "program", "solve": i, "system": load.system(i),
              "iters": int(it), "rel": float(rel), load.judged: r})
    del solve, plan
    ctrl = []
    for dtype, n in ((torch.float32, 1), (torch.bfloat16, control_solves)):
        A = DeviceCSR.of(op, device, dtype=dtype)
        for i in range(n):
            t = time.perf_counter()
            x, it = pcg(A, load.rhs(i), load.tol, load.maxiter,
                        check_every=s["check_every"])
            r = load.judge(A64, i, x)
            if dtype == torch.bfloat16:
                ctrl.append(r)
            emit({"side": f"reference_{str(dtype).split('.')[-1]}",
                  "solve": i, "system": load.system(i), "iters": it,
                  load.judged: r, "seconds": time.perf_counter() - t})
        del A
    return {"config": cfg["name"], "traffic": mix["name"],
            "judged": load.judged, "lower": max(prog),
            "upper": min(ctrl) if ctrl else None, "program": prog,
            "control": ctrl}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", required=True)
    ap.add_argument("--traffic", required=True)
    ap.add_argument("--solves", type=int, default=12)
    ap.add_argument("--control-solves", type=int, default=3)
    ap.add_argument("--seed", type=int, default=3_000_000_017)
    args = ap.parse_args(argv)

    import torch

    from perfbench import harness, traffic

    if not torch.cuda.is_available():
        print("control: no card", file=sys.stderr)
        return 2
    cfg = json.loads((ROOT / "perfbench" / "configs"
                      / f"{args.config}.json").read_text())

    def emit(d):
        print(json.dumps(d), flush=True)
    summary = readings(cfg, traffic.load(args.traffic), args.seed,
                       args.solves, args.control_solves,
                       torch.device("cuda", 0), emit, harness.Dirs().cache)
    summary["seconds"] = time.time() - T0
    emit(summary)
    return 0


if __name__ == "__main__":
    sys.exit(main())
