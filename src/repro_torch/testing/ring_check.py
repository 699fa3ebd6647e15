"""Multi-rank numerics check for the ring collective-matmul.

The port of ``src/repro/testing/ring_check.py``:

    python -m repro_torch.testing.ring_check [--device cuda|cpu]
        [--dist-backend gloo|nccl]

spawns 4 ranks as a ``model=4`` mesh (``launch.mesh.spawn_mesh``; gloo on
any device, or NCCL one rank per card), multiplies the reference's ``x``
(8, 64) by ``w`` (64, 32) (normal draws from ``default_rng(0)``, float32)
with ``make_ring_linear`` (K split over the 4 ranks) and holds every
rank's ``y`` to ``x @ w`` in float64: ``RING_REL_ERR`` is the largest
rank's ``max|y - x@w| / max|x@w|``, gated at ``< 1e-5``.  It also prints
each rank's error, the spread of the ranks' ``y`` (each accumulates in its
own ring order), and whether ``ring_linear_rs`` equals the local product
bit for bit; then ``OK`` or ``FAIL``.
"""
from __future__ import annotations

import argparse
import sys

import numpy as np

from repro_torch.launch.mesh import add_dist_backend, spawn_mesh

RANKS = 4
GATE = 1e-5


def inputs() -> tuple[np.ndarray, np.ndarray]:
    rng = np.random.default_rng(0)
    x = rng.normal(size=(8, 64)).astype(np.float32)
    w = rng.normal(size=(64, 32)).astype(np.float32)
    return x, w


def _rank(mesh) -> dict:
    import torch

    from repro_torch.runtime.overlap import make_ring_linear, ring_linear_rs

    x, w = (torch.from_numpy(a).to(mesh.device) for a in inputs())
    y = make_ring_linear(mesh, "model")(x, w)
    # the row-parallel form: this rank's columns of w, x whole
    cols = w.shape[1] // mesh.shape["model"]
    m = mesh.coords["model"]
    ws = w[:, m * cols:(m + 1) * cols]
    rs = ring_linear_rs(x, ws)
    return {"y": y.cpu().numpy(),
            "rs_equal": bool(torch.equal(rs, torch.matmul(x, ws)))}


def run(device, backend: str = "gloo") -> list:
    """Every rank's result of the ring on :func:`inputs`."""
    return spawn_mesh(_rank, RANKS, device, model=RANKS, backend=backend,
                      timeout=300)


def report(ranks: list) -> bool:
    """Print the check's lines for the ranks' results; True if it holds."""
    x, w = inputs()
    want = x.astype(np.float64) @ w.astype(np.float64)
    top = np.abs(want).max()
    errs = [float(np.abs(r["y"] - want).max() / top) for r in ranks]
    spread = max(float(np.abs(r["y"] - ranks[0]["y"]).max())
                 for r in ranks) / top
    err = max(errs)
    rs_ok = all(r["rs_equal"] for r in ranks)
    print("RING_RANK_REL_ERR " + " ".join(f"{e:.3e}" for e in errs))
    print(f"RING_SPREAD {spread:.3e}")
    print(f"RING_RS_LOCAL {'ok' if rs_ok else 'BAD'}")
    print(f"RING_REL_ERR {err:.3e}")
    ok = err < GATE and rs_ok
    print("OK" if ok else "FAIL")
    return ok


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    add_dist_backend(ap)
    args = ap.parse_args(argv)
    return 0 if report(run(args.device, args.dist_backend)) else 1


if __name__ == "__main__":
    sys.exit(main())
