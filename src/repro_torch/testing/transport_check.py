"""Halo-transport conformance harness for the port, on one device.

Usage:  python -m repro_torch.testing.transport_check --case graded \
            [--device cpu] [--wire-dtype all] [--autotune]

Every *registered* transport (``repro_torch.core.transport``) is swept
against the ``a2a`` reference on the same plan.  Three checks per (case,
format, wire dtype, transport):

  ghost   the assembled ghost buffer (``make_exchange`` probe) is
          **bit-identical** to a2a's at every real slot (< g_pad) on every
          (node, core) shard, and identical across the core axis;
  host    the transport's numpy ``host_exchange`` reference reproduces the
          device ghost buffer bit for bit (real slots);
  spmv    ``make_spmv`` output is bit-identical to a2a's.

The bit-identity checks hold *within* a wire dtype: every transport
encodes the same (sender core -> destination node) chunks.  The
**bounded-error tier** then holds each ghost against the exact f32 a2a
ghost: f32 wire must be bit-identical, a lossy codec within
``codec.rel_bound * max|x|``.

Plan cases cover the neighbour-structure regimes the transports
specialise for: ``graded`` (non-uniform two-level node bounds),
``uniform`` (equal-rows node bounds), ``single`` (banded extrusion
ordering — one neighbour each side), ``dense`` (random sparsity — every
pair communicates), ``halofree`` (hs == 0 — no exchange at all, SpMV check
only).  ``--autotune`` also runs ``autotune_transport`` and checks that
the stamped winner's SpMV is what ``transport="auto"`` returns.
``--include-faulty`` registers the corrupting ``faulty`` transport first:
on any case with halo traffic the run must then FAIL (exit 1).

Exit code 0 iff every check passed.  The virtual mesh holds the whole
``n_node x n_core`` grid on ``--device`` (default ``cuda``).

``--mesh process`` holds every rank of a process mesh
(``repro_torch.launch.mesh``: one spawned rank per shard, each on
``--device`` with its own shard of the plan; ``--dist-backend nccl``
puts rank ``r`` on ``cuda:r``) to the virtual mesh's
``a2a`` at the same wire dtype, per (case, format, wire dtype,
transport):

  ghost   each rank's assembled ghost buffer is **bit-identical** to its
          row of the virtual mesh's at every real slot;
  spmv    each rank's ``y`` is its row of the virtual mesh's, bit for bit;
  census  each rank's recorded collectives equal the transport's
          ``predicted_cost`` plus the shard body's one ``all_gather``.

One spawn covers every case (the halo-free case is a ``1 x (n_node *
n_core)`` mesh over the same ranks).  ``--autotune`` runs on the virtual
mesh only.
"""
from __future__ import annotations

import argparse
import sys
import tempfile

from repro_torch.launch.mesh import add_dist_backend, dist_backend

CASES = ("graded", "uniform", "single", "dense", "halofree")


def build_case(case: str, n_node: int, n_core: int, fmt: str, device):
    """``(A, plan, layout)`` of one conformance case."""
    from repro_torch.core import build_spmv_plan
    from repro_torch.sparse import (extruded_mesh_matrix,
                                    graded_extruded_mesh_matrix,
                                    random_spd_matrix)

    if case == "graded":        # skewed nnz -> non-uniform node_bounds
        A = graded_extruded_mesh_matrix(48, 6, seed=0)
        kw = dict(mode="balanced", node_partition="nnz")
    elif case == "uniform":     # equal-rows node split
        A = extruded_mesh_matrix(48, 6, seed=0)
        kw = dict(mode="balanced", node_partition="rows")
    elif case == "single":      # banded: one neighbour each side
        A = extruded_mesh_matrix(64, 4, seed=1)
        kw = dict(mode="task")
    elif case == "dense":       # random sparsity: all pairs communicate
        A = random_spd_matrix(640, nnz_per_row=9, seed=2)
        kw = dict(mode="balanced")
    elif case == "halofree":    # single node owns everything: hs == 0
        A = graded_extruded_mesh_matrix(48, 6, seed=0)
        n_node, n_core = 1, n_node * n_core
        kw = dict(mode="balanced")
    else:
        raise ValueError(f"unknown case {case!r}; one of {CASES}")
    plan, layout = build_spmv_plan(A, n_node, n_core, format=fmt,
                                   device=device, **kw)
    return A, plan, layout


def check_case(case: str, n_node: int, n_core: int, fmt: str, device,
               transports=None, wire_dtypes=("f32",),
               autotune: bool = False) -> bool:
    """Run every check on one (case, format); print one line per
    (wire dtype, transport); return whether all passed."""
    import numpy as np

    from repro_torch.core import (available_transports, make_exchange,
                                  make_spmv, resolve_transport, to_dist)
    from repro_torch.core.transport import autotune_transport, get_codec

    transports = transports or available_transports()
    A, plan, layout = build_case(case, n_node, n_core, fmt, device)
    rng = np.random.default_rng(7)
    xd = to_dist(rng.normal(size=A.n_rows), layout, plan)
    xd_np, g = xd.cpu().numpy(), plan.g_pad
    print(f"CASE {case} FORMAT {fmt} n_node={plan.n_node} "
        f"n_core={plan.n_core} hs={plan.hs} g_pad={g} "
        f"offsets={layout['neighbor_offsets']}")

    def ghost_of(name, wd):
        return make_exchange(plan, transport=name,
                             wire_dtype=wd)(xd).cpu().numpy()

    ok = True
    # the bounded-error tier's yardstick: the exact (f32-wire) ghost
    exact_ref = ghost_of("a2a", "f32") if plan.hs else None
    for wd in wire_dtypes:
        codec = get_codec(wd)
        ghost_ref = ghost_of("a2a", wd) if plan.hs else None
        y_ref = make_spmv(plan, transport="a2a", wire_dtype=wd)(xd)
        for name in transports:
            line = [f"TRANSPORT {name} WIRE {wd}"]
            if plan.hs:
                ghost = ghost_of(name, wd)
                # chunk identity: same codec, same chunks -> the decoded
                # ghosts agree to the bit across transports
                g_ok = bool(np.array_equal(ghost[..., :g],
                                           ghost_ref[..., :g]))
                g_ok &= all(np.array_equal(ghost[:, 0, :g], ghost[:, c, :g])
                            for c in range(plan.n_core))
                tr, state = resolve_transport(name, plan, wire_dtype=wd)
                host = tr.host_exchange(xd_np, plan.send_own.cpu().numpy(),
                                        plan.recv_own.cpu().numpy(), g,
                                        state)
                h_ok = bool(np.array_equal(host[..., :g], ghost[..., :g]))
                with np.errstate(invalid="ignore"):    # faulty: inf - inf
                    err = float(np.abs(ghost[..., :g]
                                       - exact_ref[..., :g]).max())
                bound = codec.rel_bound * float(np.abs(xd_np).max())
                e_ok = (err == 0.0 if codec.exact else err <= bound)
                line += [f"ghost={'ok' if g_ok else 'BAD'}",
                         f"host={'ok' if h_ok else 'BAD'}",
                         f"err={err:.2e}<={bound:.2e}="
                         f"{'ok' if e_ok else 'BAD'}"]
                ok &= g_ok and h_ok and e_ok
            y = make_spmv(plan, transport=name, wire_dtype=wd)(xd)
            s_ok = bool(bits_equal(y, y_ref))
            line.append(f"spmv={'ok' if s_ok else 'BAD'}")
            ok &= s_ok
            print(" ".join(line))

    if autotune:
        res = autotune_transport(plan, iters=5, warmup=1)
        a_ok = (plan.transport == res.winner
                and res.winner in available_transports())
        y_auto = make_spmv(plan, transport="auto")(xd)
        y_win = make_spmv(plan, transport=res.winner)(xd)
        a_ok &= bool(bits_equal(y_auto, y_win))
        t = " ".join(f"{k}={v:.0f}us" for k, v in
                     sorted(res.timings_us.items()))
        print(f"AUTOTUNE winner={res.winner} {t} {'ok' if a_ok else 'BAD'}")
        ok &= a_ok
    return ok


def bits_equal(a, b) -> bool:
    """Bit-level equality of two float32 tensors (NaNs and signed zeros
    included)."""
    import torch

    return a.shape == b.shape and torch.equal(a.view(torch.int32),
                                              b.view(torch.int32))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n-node", type=int, default=4)
    ap.add_argument("--n-core", type=int, default=2)
    ap.add_argument("--case", default="graded", choices=CASES + ("all",))
    ap.add_argument("--formats", default="ell,sell")
    ap.add_argument("--transports", default=None,
                    help="comma list (default: every registered transport)")
    ap.add_argument("--wire-dtype", default="f32",
                    help="halo wire codec(s) to sweep, comma list "
                         "(f32 | bf16 | int8, or 'all')")
    ap.add_argument("--autotune", action="store_true",
                    help="also run autotune_transport and verify the "
                         "stamped winner is what transport='auto' builds")
    ap.add_argument("--include-faulty", action="store_true",
                    help="register the corrupting 'faulty' transport "
                         "before the sweep; on any case with halo traffic "
                         "the harness is EXPECTED to fail it (exit 1)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--mesh", default="virtual",
                    choices=["virtual", "process"],
                    help="virtual: the grid on one device; process: one "
                         "spawned rank per shard, each held to its row "
                         "of the virtual mesh")
    add_dist_backend(ap)
    args = ap.parse_args(argv)
    dist_backend(ap, args, args.n_node * args.n_core)

    from repro_torch.core.transport import (FaultyTransport,
                                            available_wire_dtypes,
                                            register_transport,
                                            unregister_transport)

    wire_dtypes = (available_wire_dtypes() if args.wire_dtype == "all"
                   else tuple(args.wire_dtype.split(",")))
    transports = (tuple(args.transports.split(","))
                  if args.transports else None)
    cases = CASES if args.case == "all" else (args.case,)
    if args.mesh == "process":
        if args.autotune:
            print("transport_check: --autotune runs on the virtual mesh "
                  "only", file=sys.stderr)
            return 2
        ok = check_process(cases, args.formats.split(","), args.n_node,
                           args.n_core, args.device, transports,
                           wire_dtypes, args.include_faulty,
                           backend=args.dist_backend)
        print("OK" if ok else "FAIL")
        return 0 if ok else 1
    if args.include_faulty:
        register_transport(FaultyTransport())
    try:
        ok = True
        for case in cases:
            for fmt in args.formats.split(","):
                ok &= check_case(case, args.n_node, args.n_core, fmt,
                                 args.device, transports=transports,
                                 wire_dtypes=wire_dtypes,
                                 autotune=args.autotune)
    finally:
        if args.include_faulty:
            unregister_transport("faulty")
    print("OK" if ok else "FAIL")
    return 0 if ok else 1


# ---------------------------------------------------------------------- #
# --mesh process
# ---------------------------------------------------------------------- #
def rank_sweep(mesh, jobs: list, include_faulty: bool = False) -> list:
    """Each job's ghosts, ``y`` and census on this rank's shard, for every
    (wire dtype, transport)."""
    import numpy as np
    import torch

    from repro_torch.core import make_exchange, make_spmv
    from repro_torch.core.collectives import census, record_collectives
    from repro_torch.core.transport import (FaultyTransport,
                                            register_transport)
    from repro_torch.launch.mesh import make_cg_mesh, read_plan

    if include_faulty:
        register_transport(FaultyTransport())
    meshes = {(mesh.n_node, mesh.n_core): mesh}
    out = []
    for job in jobs:
        shape = job["shape"]
        if shape not in meshes:     # the halo-free 1 x world mesh
            meshes[shape] = make_cg_mesh(*shape, device=mesh.device,
                                         backend=mesh.backend, rank=mesh.rank,
                                         world_size=mesh.world_size)
        m = meshes[shape]
        plan = read_plan(job["dir"], m)
        x = torch.from_numpy(np.array(
            job["x"][m.node:m.node + 1, m.core:m.core + 1])).to(m.device)
        res = {}
        for wd, name in job["sweep"]:
            with record_collectives() as log:
                y = make_spmv(plan, transport=name, wire_dtype=wd)(x)
            ghost = (make_exchange(plan, name, wire_dtype=wd)(x)
                     if plan.hs else None)
            res[(wd, name)] = (None if ghost is None else
                               ghost.cpu().numpy(), y.cpu().numpy(),
                               census(log))
        out.append(res)
    return out


def prepare_process(cases, formats, n_node: int, n_core: int, device,
                    directory, transports=None, wire_dtypes=("f32",)):
    """Write each (case, format)'s plan under ``directory`` and compute
    the virtual mesh's yardsticks on ``device``: ``(virtual, jobs)``, the
    jobs for :func:`rank_sweep` and what :func:`report_process` holds its
    results to."""
    import numpy as np

    from repro_torch.core import to_dist

    virtual, jobs = [], []
    for case in cases:
        for fmt in formats:
            A, plan, layout = build_case(case, n_node, n_core, fmt, "cpu")
            xd = to_dist(np.random.default_rng(7).normal(size=A.n_rows),
                         layout, plan)
            want, job = prepare_plan(plan, xd, device,
                                     f"{directory}/{case}_{fmt}",
                                     transports, wire_dtypes)
            virtual.append((case, fmt, plan, want))
            jobs.append(job)
    return virtual, jobs


def prepare_plan(plan, xd, device, path, transports=None,
                 wire_dtypes=("f32",)):
    """One host plan's process sweep: write it to ``path`` and compute the
    virtual mesh's ghosts, ``y`` (``a2a`` at each wire dtype, which every
    honest transport equals) and predicted costs on ``device`` for input
    ``xd`` (host, distributed).  Returns ``(want, job)``: ``want[(wire
    dtype, transport)]`` for :func:`report_process`, the job for
    :func:`rank_sweep`."""
    from repro_torch.core import (available_transports, make_exchange,
                                  make_spmv, resolve_transport)
    from repro_torch.launch.mesh import write_plan

    names = transports or available_transports()
    write_plan(plan, path)
    sweep = [(wd, name) for wd in wire_dtypes for name in names]
    job = {"dir": path, "x": xd.numpy(), "shape": (plan.n_node, plan.n_core),
           "sweep": sweep}
    vplan = plan_on(plan, device)
    xv = xd.to(vplan.device)
    ref = {wd: (make_exchange(vplan, "a2a", wire_dtype=wd)(
        xv).cpu().numpy() if plan.hs else None,
        make_spmv(vplan, transport="a2a", wire_dtype=wd)(
            xv).cpu().numpy()) for wd in wire_dtypes}
    want = {}
    for wd, name in sweep:
        tr, st = resolve_transport(name, vplan, wire_dtype=wd)
        want[(wd, name)] = ref[wd] + (tr.predicted_cost(vplan, st),)
    return want, job


def report_process(virtual, ranks) -> bool:
    """Hold every rank's results (``ranks[r][j]``: rank ``r``'s
    :func:`rank_sweep` result of job ``j``) to the virtual mesh's; print
    one line per (case, format) and per (wire dtype, transport)."""
    import numpy as np

    ok = True
    for j, (case, fmt, plan, want) in enumerate(virtual):
        g = plan.g_pad
        print(f"CASE {case} FORMAT {fmt} n_node={plan.n_node} "
              f"n_core={plan.n_core} hs={plan.hs} g_pad={g} "
              f"MESH process RANKS {len(ranks)}")
        for key, (gv, yv, pred) in want.items():
            g_ok = s_ok = c_ok = True
            for r, res in enumerate(ranks):
                node, core = divmod(r, plan.n_core)
                ghost, y, cen = res[j][key]
                if gv is not None:
                    g_ok &= bool(np.array_equal(
                        ghost[0, 0, :g].view(np.int32),
                        gv[node, core, :g].view(np.int32)))
                s_ok &= bool(np.array_equal(y[0, 0].view(np.int32),
                                            yv[node, core].view(np.int32)))
                c_ok &= all(cen[k] == pred[k] + (k == "all-gather")
                            for k in ("all-to-all", "collective-permute",
                                      "all-gather")) \
                    and cen["all-reduce"] == 0
            line = [f"TRANSPORT {key[1]} WIRE {key[0]}"]
            if gv is not None:
                line.append(f"ghost={'ok' if g_ok else 'BAD'}")
            line += [f"spmv={'ok' if s_ok else 'BAD'}",
                     f"census={'ok' if c_ok else 'BAD'}"]
            print(" ".join(line))
            ok &= g_ok and s_ok and c_ok
    return ok


def check_process(cases, formats, n_node: int, n_core: int, device,
                  transports=None, wire_dtypes=("f32",),
                  include_faulty: bool = False,
                  backend: str = "gloo") -> bool:
    """Every (case, format, wire dtype, transport) on a process mesh of
    ``n_node * n_core`` spawned ranks (on ``backend``) against the virtual
    mesh on ``device``; print one line per (wire dtype, transport); return
    whether all passed."""
    from repro_torch.core.transport import (FaultyTransport,
                                            register_transport,
                                            unregister_transport)
    from repro_torch.launch.mesh import spawn_cg_mesh

    if include_faulty:
        register_transport(FaultyTransport())
    try:
        with tempfile.TemporaryDirectory(prefix="transport_check_") as d:
            virtual, jobs = prepare_process(cases, formats, n_node, n_core,
                                            device, d, transports,
                                            wire_dtypes)
            ranks = spawn_cg_mesh(rank_sweep, n_node, n_core, device,
                                  backend=backend,
                                  args=(jobs, include_faulty), timeout=600)
    finally:
        if include_faulty:
            unregister_transport("faulty")
    return report_process(virtual, ranks)


def plan_on(plan, device):
    """The whole plan on ``device`` (the virtual mesh's copy)."""
    from repro_torch.core.spmv import plan_arrays, plan_from_arrays, plan_meta

    return plan_from_arrays(plan_arrays(plan), plan_meta(plan),
                            device=device)


if __name__ == "__main__":
    sys.exit(main())
