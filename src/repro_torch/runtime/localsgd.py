"""Local-SGD pod synchronisation with error-feedback compression.

The port of ``src/repro/runtime/localsgd.py``.  The ``pod`` axis carries
the slowest links — the paper's fat-node argument at pod granularity:
make inter-pod messages *fewer* (every H steps instead of every step) and
*smaller* (error-feedback int8 / top-k on the parameter delta).

Protocol (H-step local SGD / "post-local SGD"):
  * each pod trains independently for H steps from a common anchor;
  * at sync time each pod compresses ``params - anchor`` (float32), the
    deltas are averaged across pods (one all-reduce sum over the mesh's
    ``pod`` group, divided by the pod count, on ``core.collectives``'s
    wire, so ``WIRE`` and the census count it), and every pod applies the
    averaged delta to the anchor, cast back to each leaf's dtype;
  * the compression residual is carried into the next round (EF), so the
    noise does not bias the trajectory.

The trees are nested dicts of tensors, as the trainer keeps them; on an
``LMMesh`` with no process behind it (one pod) the average is the pod's
own delta.
"""
from __future__ import annotations

import torch

from repro_torch.runtime.compression import _map, ef_compress_tree

__all__ = ["pod_sync", "make_pod_sync"]


def pod_sync(params, anchor, residual, mesh, axis: str = "pod",
             codec: str = "int8", topk_frac: float = 0.05):
    """One sync round.  Returns ``(new_params, new_anchor,
    new_residual)``; the new anchor is a copy of the new parameters.

    ``params`` / ``anchor`` / ``residual``: trees replicated within each
    pod (they may be blocks of leaves split over other axes; only
    ``axis`` is reduced over)."""
    from repro_torch.runtime.sharded import all_reduce

    delta = _map(lambda p, a: p.to(torch.float32) - a.to(torch.float32),
                 params, anchor)
    comp, residual = ef_compress_tree(delta, residual, codec=codec,
                                      topk_frac=topk_frac)
    n = mesh.shape[axis]
    group = mesh.group((axis,))

    def mean_over_pods(x):
        return all_reduce(x.clone(), mesh, group) / n

    avg = _map(mean_over_pods, comp)
    new_params = _map(lambda a, d, p: (a.to(torch.float32) + d).to(p.dtype),
                      anchor, avg, params)
    return new_params, _map(torch.clone, new_params), residual


def make_pod_sync(mesh, axis: str = "pod", codec: str = "int8",
                  topk_frac: float = 0.05):
    """The sync closure ``(params, anchor, residual) -> same triple``, or
    ``None`` when the mesh has no ``axis``."""
    if axis not in mesh.axis_names:
        return None

    def sync(params, anchor, residual):
        return pod_sync(params, anchor, residual, mesh, axis=axis,
                        codec=codec, topk_frac=topk_frac)

    return sync
