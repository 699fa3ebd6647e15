"""Run one cell of ``BENCHMARK.json`` on this machine's cards.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

From the root of a checkout.  Makes (or loads) the cell's operator and
the traffic's right-hand sides, builds the program's plan and solver
(``repro_torch``), warms up, runs the traffic's loop for ``--seconds``,
checks the answers against the plain reference (``perfbench/reference.py``) and prints one JSON line last on
standard output: ``correct``, ``attempted``, ``failed``, ``metrics``
(the cell's end-to-end metrics, or with ``--trace 1`` its per-layer
ones), ``device`` and, traced, ``breakdown``; then ``checks``, each
compared number beside its limit, which also end standard error.

Exits 2 without a result when no card, or fewer cards than the cell
asks for, is present; 3 when the JAX package or JAX was loaded.
"""
import time

T0 = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
for _p in (str(ROOT / "src"), str(ROOT)):
    if _p not in sys.path:
        sys.path.insert(0, _p)
# the program's kernel caches stay inside the checkout, at fixed paths
# (the SpMV library builds under build/kernels by itself)
os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(ROOT / "build" / "torch_extensions"))
os.environ.setdefault("TRITON_CACHE_DIR", str(ROOT / "build" / "triton"))
os.environ.setdefault("USE_FLAX", "0")


def power_limits() -> list:
    """Each card's name and power limit, as ``nvidia-smi`` reads them."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=30).stdout
    except (OSError, subprocess.TimeoutExpired):
        return []
    return [ln.strip() for ln in out.splitlines() if ln.strip()]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from perfbench import harness, system

    _, cell, _, _ = harness.load_cell(args.workload, harness.Dirs())
    present = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if present < cell["chips"]:
        print(f"perfbench: {args.workload} needs {cell['chips']} card(s), "
              f"{present} present", file=sys.stderr)
        return 2
    out, checks = harness.run(args.workload, args.seed, args.seconds,
                              bool(args.trace), device=torch.device("cuda", 0),
                              t0=T0)
    found = system.forbidden_modules()
    if found:
        print(f"perfbench: loaded {found}: the run imports the JAX package "
              f"or JAX", file=sys.stderr)
        return 3
    out["device"]["cards"] = power_limits()
    out["checks"] = out.pop("checks")           # the line's last key
    for name, c in checks.items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r} "
              f"{'ok' if c['ok'] else 'FAIL'}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
