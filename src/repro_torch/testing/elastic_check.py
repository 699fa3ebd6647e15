"""Elastic checkpoint restore: save sharded on 4 ranks, restore on a
different mesh and on a different rank count.

The port of ``src/repro/testing/elastic_check.py``, over
``repro_torch.checkpoint`` (``save``; ``load(..., cut=)``):

    python -m repro_torch.testing.elastic_check PATH [--device cuda|cpu]
        [--dist-backend gloo|nccl]

1. 4 spawned ranks as a ``data=4`` mesh; ``w`` (8, 16) float32 from
   ``numpy.random.default_rng(0)``, each rank holding its
   ``P("data", None)`` block.  The leaf is gathered whole
   (``runtime.sharded.full_tensor``) and rank 0 saves it at step 7 with
   ``{"step": 7}`` under ``PATH``.
2. The same 4 ranks as a ``data=2 x model=2`` mesh restore it under
   ``P("model", "data")`` (the reference's case): each rank reads the leaf
   through its cut and keeps only its block.
3. 2 new ranks as a ``data=2`` mesh restore it under ``P(None, "data")``:
   the node count changed.

Every rank's block must equal its slice of ``w`` bit for bit
(``ELASTIC_ERR``, the largest difference), have the shape its spec gives
it (``SHARDING_OK``), and read ``extra["step"] == 7``.  Then ``OK`` or
``FAIL``.
"""
from __future__ import annotations

import argparse
import sys

import numpy as np

from repro_torch.launch.mesh import add_dist_backend, make_mesh, spawn_mesh

STEP = 7


def weights() -> np.ndarray:
    rng = np.random.default_rng(0)
    return rng.normal(size=(8, 16)).astype(np.float32)


def _restore(mesh, path: str, spec) -> dict:
    """This rank's block of the saved leaf under ``spec`` on ``mesh``,
    against its slice of :func:`weights`."""
    import torch

    from repro_torch.checkpoint import load
    from repro_torch.runtime.sharding import NamedSharding

    pl = NamedSharding(mesh, spec)
    like = {"w": torch.empty((8, 16), dtype=torch.float32, device="meta")}
    loaded, extra = load(path, STEP, like, device=mesh.device,
                         cut={"w": lambda a: np.ascontiguousarray(
                             pl.shard(a))})
    got = loaded["w"].cpu().numpy()
    want = pl.shard(weights())
    return {"mesh": mesh.shape, "spec": repr(spec),
            "err": float(np.abs(got - want).max()),
            "shape_ok": tuple(got.shape) == pl.shard_shape((8, 16)),
            "step": extra.get("step")}


def _save_then_restore(mesh, path: str) -> list:
    import torch

    from repro_torch.checkpoint import save
    from repro_torch.runtime.sharded import full_tensor
    from repro_torch.runtime.sharding import NamedSharding, P

    pl = NamedSharding(mesh, P("data", None))
    block = torch.from_numpy(np.ascontiguousarray(
        pl.shard(weights()))).to(mesh.device)
    whole = full_tensor(block, pl)
    if mesh.rank == 0:
        save(path, STEP, {"w": whole}, {"step": STEP})
    mesh.barrier()
    other = make_mesh((2, 2), ("data", "model"), device=mesh.device,
                      backend=mesh.backend, rank=mesh.rank, world_size=4)
    return [_restore(other, path, P("model", "data"))]


def _restore_two(mesh, path: str) -> list:
    from repro_torch.runtime.sharding import P

    return [_restore(mesh, path, P(None, "data"))]


def run(path: str, device, backend: str = "gloo") -> list:
    """Every rank's rows: the 4-rank save and 2x2 restore, then the
    2-rank restore."""
    four = spawn_mesh(_save_then_restore, 4, device, backend=backend,
                      axes={"data": 4}, args=(path,), timeout=300)
    two = spawn_mesh(_restore_two, 2, device, backend=backend,
                     axes={"data": 2}, args=(path,), timeout=300)
    return [row for r in four + two for row in r]


def report(rows: list) -> bool:
    err = max(r["err"] for r in rows)
    shapes = all(r["shape_ok"] for r in rows)
    steps = all(r["step"] == STEP for r in rows)
    print(f"ELASTIC_ERR {err:.3e} SHARDING_OK {shapes} STEP_OK {steps} "
          f"RANKS {len(rows)}")
    ok = err == 0.0 and shapes and steps
    print("OK" if ok else "FAIL")
    return ok


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("path", help="the checkpoint directory")
    ap.add_argument("--device", default="cuda",
                    help="where the ranks run: cuda (default) or cpu")
    add_dist_backend(ap)
    args = ap.parse_args(argv)
    return 0 if report(run(args.path, args.device, args.dist_backend)) \
        else 1


if __name__ == "__main__":
    sys.exit(main())
