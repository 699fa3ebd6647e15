"""Golden square-case hashes, re-derived by the port.

Usage:  python -m repro_torch.testing.square_golden [--device cpu] \
            --check tests/golden_square_hashes.json
        python -m repro_torch.testing.square_golden [--device cpu] \
            --write PATH

The port of ``repro.testing.square_golden``.  For the graded matrix
``graded_extruded_mesh_matrix(48, 6)`` at ell+sell x every registered
transport on the ``--n-node x --n-core`` grid it sha256-hashes

  plan    every data array of the packed ``SpMVPlan`` (fmt_data, halo
          tables, x_gather, diag_a, mask) — host numpy construction, the
          same bytes in both packages;
  spmv    ``make_spmv`` output on a fixed seeded input vector;
  cg      the fused CG solve (solution bytes + iteration count) with
          jacobi preconditioning.

``--check`` asserts every plan hash and meta unconditionally.  The spmv/cg
hashes depend on the program that computed them: they are compared only
when the fixture was stamped by this package on the same torch version and
device; otherwise (the reference's fixture stamps ``jax_version``) each is
reported as ``SKIP`` with the reason, never silently passed.  ``--write``
writes a fixture stamped with torch's version and the device name; it
refuses to overwrite a fixture that the JAX package wrote.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import os
import sys

import numpy as np

FORMATS = ("ell", "sell")
PLAN_META = ("n", "n_node", "n_core", "rc_pad", "nl_pad", "g_pad", "hs")


def _hash(arr) -> str:
    """sha256 of an array's dtype, shape and bytes (the fixture's hash)."""
    if hasattr(arr, "detach"):
        arr = arr.detach().cpu().numpy()
    a = np.ascontiguousarray(np.asarray(arr))
    h = hashlib.sha256()
    h.update(str(a.dtype).encode())
    h.update(str(a.shape).encode())
    h.update(a.tobytes())
    return h.hexdigest()


def build_entries(n_node: int, n_core: int, device) -> dict:
    from repro_torch.core import (available_transports, build_spmv_plan,
                                  from_dist, make_spmv, to_dist)
    from repro_torch.core.spmv import plan_fields, plan_shard_arrays
    from repro_torch.solvers import make_solver
    from repro_torch.sparse import graded_extruded_mesh_matrix

    A = graded_extruded_mesh_matrix(48, 6, seed=0)
    rng = np.random.default_rng(7)
    x = rng.standard_normal(A.n_rows).astype(np.float32)
    b = rng.standard_normal(A.n_rows).astype(np.float32)

    out: dict = {}
    for fmt in FORMATS:
        for tr in sorted(available_transports()):
            plan, layout = build_spmv_plan(
                A, n_node, n_core, mode="balanced", node_partition="nnz",
                format=fmt, transport=tr, device=device)
            entry: dict = {"meta": {k: int(getattr(plan, k))
                                    for k in PLAN_META}}
            entry["plan"] = {name: _hash(arr)
                             for name, arr in zip(plan_fields(plan),
                                                  plan_shard_arrays(plan))}
            entry["plan"]["mask"] = _hash(plan.mask)
            entry["plan"]["diag_a"] = _hash(plan.diag_a)

            y = from_dist(make_spmv(plan)(to_dist(x, layout, plan)),
                          layout, plan)
            entry["spmv"] = _hash(np.asarray(y, np.float32))

            solve = make_solver(plan, solver="cg", precond="jacobi",
                                A=A, layout=layout)
            xs, iters, _ = solve(to_dist(b, layout, plan), tol=1e-6,
                                 maxiter=400)
            xg = from_dist(xs, layout, plan)
            entry["cg"] = {"x": _hash(np.asarray(xg, np.float32)),
                           "iters": int(iters)}
            out[f"{fmt}/{tr}"] = entry
    return out


def check(doc: dict, got: dict, stamp: dict) -> tuple[list, list]:
    """``(failures, skips)`` of ``got`` against the fixture ``doc``."""
    same_program = all(doc.get(k) == v for k, v in stamp.items())
    why = ", ".join(f"{k} {doc.get(k)!r}" for k in ("jax_version",
                                                    *stamp) if k in doc)
    fails, skips = [], []
    for key, want in doc["entries"].items():
        if key not in got:
            fails.append(f"{key}: missing from current tree")
            continue
        cur = got[key]
        if cur["meta"] != want["meta"]:
            fails.append(f"{key}: plan meta drift {want['meta']} -> "
                         f"{cur['meta']}")
        for name, h in want["plan"].items():
            if cur["plan"].get(name) != h:
                fails.append(f"{key}: plan array {name!r} hash drift")
        for name in ("spmv", "cg"):
            if same_program:
                if cur[name] != want[name]:
                    fails.append(f"{key}: {name} output hash drift")
            else:
                skips.append(f"{key}: {name} (fixture from {why}; this "
                             f"run {stamp})")
    return fails, skips


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n-node", type=int, default=4)
    ap.add_argument("--n-core", type=int, default=2)
    ap.add_argument("--write", default=None, metavar="PATH")
    ap.add_argument("--check", default=None, metavar="PATH")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if (args.write is None) == (args.check is None):
        ap.error("exactly one of --write / --check is required")

    import torch

    from repro_torch.util import device_name

    stamp = {"torch_version": torch.__version__,
             "device": device_name(args.device)}
    if args.write and os.path.exists(args.write):
        with open(args.write) as f:
            if "jax_version" in json.load(f):
                ap.error(f"{args.write} is the JAX package's fixture; "
                         "write the port's to another path")
    got = build_entries(args.n_node, args.n_core, args.device)

    if args.write:
        doc = {**stamp, "n_node": args.n_node, "n_core": args.n_core,
               "entries": got}
        with open(args.write, "w") as f:
            json.dump(doc, f, indent=1, sort_keys=True)
            f.write("\n")
        print(f"square_golden: wrote {len(got)} entries -> {args.write}")
        return 0

    with open(args.check) as f:
        doc = json.load(f)
    fails, skips = check(doc, got, stamp)
    for s in skips:
        print(f"SKIP {s}")
    for msg in fails:
        print(f"FAIL {msg}")
    print(f"square_golden: {len(doc['entries'])} entries, "
          f"{len(fails)} failures, {len(skips)} skipped")
    return 1 if fails else 0


if __name__ == "__main__":
    sys.exit(main())
