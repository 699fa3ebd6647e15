"""Multi-rank local-SGD sync check: 2 pods.

The port of ``src/repro/testing/localsgd_check.py``:

    python -m repro_torch.testing.localsgd_check [--device cuda|cpu]
        [--dist-backend gloo|nccl]

spawns 2 ranks as a ``pod=2`` mesh (``launch.mesh.spawn_mesh``; gloo on
any device, or NCCL one rank per card) and checks, with the reference's
draws from ``numpy.random.default_rng(0)`` in the reference's order:
(1) with codec ``none``, after each pod applied its own drift to the
anchor, the sync gives ``anchor + (drift0 + drift1) / 2`` within 1e-6
(``EXACT_AVG_ERR``) and both ranks hold the same parameters bit for bit;
(2) over ten int8 rounds the error-feedback residual stays below 0.1
(``EF_RESIDUAL_MAX``).  Then ``OK`` or ``FAIL``.
"""
from __future__ import annotations

import argparse
import sys

import numpy as np

from repro_torch.launch.mesh import add_dist_backend, spawn_mesh

RANKS = 2
EXACT_GATE, RESIDUAL_GATE = 1e-6, 0.1
ROUNDS = 10


def draws() -> dict:
    """The reference's draws, in its order: the anchor, each pod's drift,
    then one step per int8 round."""
    rng = np.random.default_rng(0)
    anchor = rng.normal(size=(16,)).astype(np.float32)
    drift0 = rng.normal(size=(16,)).astype(np.float32) * 0.1
    drift1 = rng.normal(size=(16,)).astype(np.float32) * 0.1
    steps = [rng.normal(size=(16,)).astype(np.float32) for _ in range(ROUNDS)]
    return {"anchor": anchor, "drift": [drift0, drift1], "steps": steps}


def _rank(mesh, d: dict) -> dict:
    import torch

    from repro_torch.runtime.localsgd import pod_sync

    dev = mesh.device

    def t(a):
        return torch.from_numpy(np.asarray(a, np.float32)).to(dev)

    anchor = {"w": t(d["anchor"])}
    params = {"w": anchor["w"] + t(d["drift"][mesh.coords["pod"]])}
    residual = {"w": torch.zeros(16, dtype=torch.float32, device=dev)}
    new, _, _ = pod_sync(params, anchor, residual, mesh, codec="none")
    exact = new["w"].cpu().numpy()

    residual = {"w": torch.zeros(16, dtype=torch.float32, device=dev)}
    p, a = {"w": anchor["w"]}, {"w": anchor["w"]}
    for step in d["steps"]:
        # the reference's step: float32 draw times a python 0.1
        p = {"w": p["w"] + t(step) * 0.1}
        p, a, residual = pod_sync(p, a, residual, mesh, codec="int8")
    return {"exact": exact, "residual_max": float(residual["w"].abs().max()),
            "params": p["w"].cpu().numpy()}


def run(device, backend: str = "gloo") -> list:
    """Every rank's result on :func:`draws`."""
    return spawn_mesh(_rank, RANKS, device, backend=backend,
                      axes={"pod": RANKS}, args=(draws(),), timeout=300)


def report(ranks: list) -> bool:
    d = draws()
    want = d["anchor"] + (d["drift"][0] + d["drift"][1]) / 2.0
    err = max(float(np.abs(r["exact"] - want).max()) for r in ranks)
    same = all(np.array_equal(r["exact"].view(np.int32),
                              ranks[0]["exact"].view(np.int32))
               and np.array_equal(r["params"].view(np.int32),
                                  ranks[0]["params"].view(np.int32))
               for r in ranks)
    rmax = max(r["residual_max"] for r in ranks)
    print(f"EXACT_AVG_ERR {err:.3e}")
    print(f"RANKS_BITS_EQUAL {same}")
    print(f"EF_RESIDUAL_MAX {rmax:.3e}")
    ok = err < EXACT_GATE and same and rmax < RESIDUAL_GATE
    print("OK" if ok else "FAIL")
    return ok


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="where the ranks run: cuda (default) or cpu")
    add_dist_backend(ap)
    args = ap.parse_args(argv)
    return 0 if report(run(args.device, args.dist_backend)) else 1


if __name__ == "__main__":
    sys.exit(main())
