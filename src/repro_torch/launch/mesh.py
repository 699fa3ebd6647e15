"""The ``(node, core)`` mesh of the distributed SpMV/CG: virtual or one
process per shard.

``make_cg_mesh(n_node, n_core)`` is the hybrid (MPI × OpenMP) mesh of the
paper's benchmark, the counterpart of the JAX package's ``make_cg_mesh``.
Two backends run it:

* the **virtual mesh** (no process arguments): one device holds the whole
  grid as the leading ``(n_node, n_core)`` axes of every tensor, and the
  collectives of ``repro_torch.core.collectives`` are index operations;
* the **process mesh** (``backend="gloo"`` or ``"nccl"``, ``rank``,
  ``world_size``, ``init_method``): one process per shard, rank ``r`` at
  ``(node, core) = divmod(r, n_core)`` (the JAX mesh's row-major device
  order).  Each rank holds only its own shard of every plan array and
  vector (leading axes ``(1, 1)``), and the four collectives are
  ``torch.distributed`` calls over the **node group** (same core, all
  nodes: ``all_to_all``, ``ppermute``, node-axis ``all_gather``), the
  **core group** (same node, all cores: core-axis ``all_gather``) and the
  world (``psum``).  gloo moves host tensors, so a rank on a card stages
  every collective through host memory.  NCCL puts **one rank on each
  card** of this host (rank ``r`` on ``cuda:r``) and moves the payloads
  card to card, never through the host.

Above the collectives, a process mesh carries **host control**: one
decision taken on rank 0 and held by every rank (:meth:`CGMesh.agree`),
every rank's object (:meth:`CGMesh.allgather`), a rank's rows of a host
vector gathered into the whole vector (:meth:`CGMesh.gather_rows`) and a
barrier.  The upper layers (the resilient driver's verdicts and
checkpoints, the solve service's admission, the autotuner's timings) use
them so that ranks never decide apart.  They are not collectives of the
shard bodies: no census records them, and ``WIRE`` times them under
``CONTROL``.  They move pickled host objects, so they go through a gloo
**control group** over every rank: the world itself on a gloo mesh, a gloo
side group beside the NCCL world on an NCCL mesh.  On the virtual mesh
each is the identity.

``spawn_cg_mesh(fn, n_node, n_core, device)`` starts the ``n_node ·
n_core`` ranks on this host, runs ``fn(mesh, *args)`` on each and returns
every rank's result; ranks that die without one (a preemption's SIGKILL)
end it with :class:`RanksKilled`, naming every rank's exit code.
``write_plan`` / ``read_plan`` hand a plan built once by the launcher to
the ranks: each rank maps the arrays and reads only its own shard
(``plan_from_arrays(..., mesh=)``).

An NCCL mesh needs a card for every rank: ``make_cg_mesh`` and
``spawn_cg_mesh`` refuse, before any process group or process exists,
when the device is not a card or this host has fewer cards than ranks
(NCCL rejects two ranks on one card).  Nothing falls back to gloo.

The LM trainer's meshes are :class:`LMMesh`: named axes ``data x model``
(``pod x data x model`` for two pods), the counterparts of the JAX
package's ``make_production_mesh`` (16x16, 2x16x16: descriptions the
sharding rules read, no process behind them) and ``make_host_mesh``
(``data x model`` over this process mesh's ranks, ``model`` 2 for an
even rank count above 1).  Over a process group an ``LMMesh`` holds the
group of every tuple of its axes; ``spawn_mesh`` starts its ranks with
``spawn_cg_mesh``'s launcher (the same rendezvous, refusal, failure and
timeout handling).
"""
from __future__ import annotations

import dataclasses
import datetime
import json
import os
import pickle
import shutil
import signal
import sys
import tempfile
import time
from pathlib import Path
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.util import resolve_device

__all__ = ["CGMesh", "make_cg_mesh", "spawn_cg_mesh", "write_plan",
           "LMMesh", "make_mesh", "make_production_mesh", "make_host_mesh",
           "spawn_mesh",
           "read_plan", "require_cards", "add_dist_backend",
           "dist_backend", "BACKENDS", "RanksKilled"]

#: the process mesh's backends: gloo on any device (host-staged on a
#: card), NCCL one rank per card; and ``fake``, only for an LM mesh that
#: ``launch.dryrun`` joins as one rank of a fake process group
#: (``torch.testing._internal.distributed.fake_pg``: every collective
#: returns at once, nothing moves)
BACKENDS = ("gloo", "nccl", "fake")
#: the backends whose ranks are real processes
_SPAWNED = BACKENDS[:2]


class _HostControl:
    """Host control over a mesh's ``control`` group (see the module
    docstring); on a mesh with no process group each is the identity."""

    def agree(self, obj):
        """Rank 0's ``obj`` on every rank (every rank calls this; the
        others' ``obj`` is ignored).  No process group: ``obj``."""
        if not self.is_process:
            return obj
        import torch.distributed as dist

        from repro_torch.core.collectives import host_control
        box = [obj]
        with host_control():
            dist.broadcast_object_list(box, src=0, group=self.control)
        return box[0]

    def barrier(self) -> None:
        """Every rank has reached this point (no process group: a
        no-op)."""
        if self.is_process:
            import torch.distributed as dist

            from repro_torch.core.collectives import host_control
            with host_control():
                dist.barrier(group=self.control)

    def destroy(self) -> None:
        """Tear down the process group (no process group: a no-op)."""
        if self.is_process:
            import torch.distributed as dist
            if dist.is_initialized():
                dist.destroy_process_group()


@dataclasses.dataclass(frozen=True, eq=False)
class CGMesh(_HostControl):
    """A ``(n_node, n_core)`` mesh.  On the virtual mesh ``node``/``core``
    and the groups are ``None``; on a process mesh they are this rank's
    shard and its process groups."""

    n_node: int
    n_core: int
    device: torch.device
    backend: str = "virtual"
    node: int | None = None
    core: int | None = None
    node_group: Any = None      # same core, every node
    core_group: Any = None      # same node, every core
    world: Any = None           # every rank
    control: Any = None         # every rank, gloo: host control

    @property
    def is_process(self) -> bool:
        return self.backend != "virtual"

    @property
    def world_size(self) -> int:
        return self.n_node * self.n_core

    @property
    def rank(self) -> int | None:
        return None if self.node is None else self.rank_of(self.node,
                                                           self.core)

    @property
    def shard_shape(self) -> tuple[int, int]:
        """The mesh axes of a tensor this mesh holds: the whole grid on the
        virtual mesh, ``(1, 1)`` on a rank."""
        return (1, 1) if self.is_process else (self.n_node, self.n_core)

    def rank_of(self, node: int, core: int) -> int:
        """Global rank of shard ``(node, core)``."""
        return node * self.n_core + core

    # -- host control (see the module docstring) ------------------------ #
    def allgather(self, obj) -> list:
        """Every rank's ``obj``, in rank order, on every rank.  The virtual
        mesh: ``[obj]``."""
        if not self.is_process:
            return [obj]
        import torch.distributed as dist

        from repro_torch.core.collectives import host_control
        out = [None] * self.world_size
        with host_control():
            dist.all_gather_object(out, obj, group=self.control)
        return out

    def gather_rows(self, values: np.ndarray, rows: np.ndarray, n: int, *,
                    to: int | None = 0) -> np.ndarray | None:
        """The whole host vector ``(..., n)`` from every rank's ``values``
        ``(..., m)`` at its global ``rows`` ``(m,)`` (rows no rank holds
        are 0), bit for bit: on rank ``to`` (``None`` on the others), or on
        every rank with ``to=None``.  The virtual mesh holds every row:
        ``values`` scattered to ``rows``."""
        values, rows = np.asarray(values), np.asarray(rows)
        parts = [(values, rows)]
        if self.is_process:
            import torch.distributed as dist

            from repro_torch.core.collectives import host_control
            with host_control(values.nbytes + rows.nbytes):
                if to is None:
                    parts = self.allgather((values, rows))
                else:
                    got = [None] * self.world_size if self.rank == to \
                        else None
                    dist.gather_object((values, rows), got, dst=to,
                                       group=self.control)
                    if got is None:
                        return None
                    parts = got
        out = np.zeros(values.shape[:-1] + (n,), values.dtype)
        for v, r in parts:
            out[..., r] = v
        return out


def require_cards(world: int, device=None) -> None:
    """Raise unless an NCCL mesh of ``world`` ranks can start here: one
    card per rank, so ``device`` must be a card and this host must have
    ``world`` of them.  The error names the cards needed and present."""
    device = resolve_device(device)
    present = torch.cuda.device_count()
    if device.type == "cuda" and present >= world:
        return
    raise ValueError(
        f"backend='nccl' runs one rank per card: {world} rank(s) need "
        f"{world} card(s), and this host has {present} present"
        + ("" if device.type == "cuda"
           else f"; device {str(device)!r} is not a card")
        + " (NCCL rejects two ranks on one card; gloo runs any number "
        "of ranks on any device)")


def add_dist_backend(ap) -> None:
    """A CLI's ``--dist-backend``: the backend of its ``--mesh
    process`` (default gloo)."""
    ap.add_argument("--dist-backend", default="gloo", choices=_SPAWNED,
                    help="with --mesh process: gloo (any device, payloads "
                         "through the host) or nccl (one rank per card)")


def dist_backend(ap, args, world: int) -> str:
    """A CLI's checked ``--dist-backend``: NCCL only with ``--mesh
    process``, and refused (``require_cards``) before any work unless
    ``--device`` is a card and this host has ``world`` of them."""
    if args.dist_backend != "gloo" and args.mesh != "process":
        ap.error(f"--dist-backend {args.dist_backend} runs a process mesh: "
                 "add --mesh process")
    if args.dist_backend == "nccl":
        require_cards(world, args.device)
    return args.dist_backend


def make_cg_mesh(n_node: int, n_core: int, *, device=None,
                 backend: str | None = None, rank: int | None = None,
                 world_size: int | None = None,
                 init_method: str | None = None,
                 timeout: float = 60.0) -> CGMesh:
    """The hybrid (MPI × OpenMP) mesh.  With no process arguments, the
    virtual mesh on ``device`` (default ``cuda``).  With ``backend``
    (``"gloo"`` or ``"nccl"``) this process joins a process mesh as
    ``rank`` of ``world_size == n_node * n_core`` through ``init_method``
    (``file://...`` or ``tcp://host:port``), and builds the node, core and
    control groups (every rank must call this, in the same order).  On
    NCCL, rank ``r`` binds itself to ``cuda:r`` (``device`` must be a card
    with no other index) and the groups' communicators are started here.
    A process already in a group of ``world_size`` ranks builds a further
    mesh over it without ``init_method`` (a 2x2 and a 1x4 mesh of one
    four-rank group), on the same backend.  ``timeout`` (seconds) bounds
    every collective, so a rank that dies does not leave the others
    blocked."""
    if n_node < 1 or n_core < 1:
        raise ValueError(f"mesh must be at least 1x1, got {n_node}x{n_core}")
    device = resolve_device(device)
    if backend is None and rank is None and world_size is None \
            and init_method is None:
        return CGMesh(n_node, n_core, device)
    if backend not in _SPAWNED:
        raise ValueError(f"process mesh backend must be one of {_SPAWNED} "
                         f"(or no backend for the virtual mesh), got "
                         f"{backend!r}")
    world = n_node * n_core
    if world_size != world:
        raise ValueError(f"world_size {world_size} != n_node * n_core = "
                         f"{world}")
    if rank is None or not 0 <= rank < world:
        raise ValueError(f"rank must be in [0, {world}), got {rank!r}")
    if backend == "nccl":
        require_cards(world, device)
        if device.index not in (None, rank):
            raise ValueError(f"NCCL rank {rank} runs on cuda:{rank}, not "
                             f"{device}")
        device = torch.device("cuda", rank)
        torch.cuda.set_device(device)
    import torch.distributed as dist

    if not dist.is_initialized():
        if init_method is None:
            raise ValueError("a process mesh needs an init_method "
                             "('file://<path>' or 'tcp://<host>:<port>')")
        # an NCCL world bound to its card starts its communicator now
        dist.init_process_group(
            backend, init_method=init_method, rank=rank, world_size=world,
            timeout=datetime.timedelta(seconds=timeout),
            **({"device_id": device} if backend == "nccl" else {}))
    elif (dist.get_rank(), dist.get_world_size()) != (rank, world):
        raise ValueError(
            f"the process group is rank {dist.get_rank()} of "
            f"{dist.get_world_size()}, not {rank} of {world}")
    elif dist.get_backend() != backend:
        raise ValueError(f"the process group runs {dist.get_backend()}, "
                         f"not {backend}")
    node, core = divmod(rank, n_core)
    node_group = core_group = None
    # new_group is collective over the world: every rank builds every group
    for c in range(n_core):
        g = dist.new_group([n * n_core + c for n in range(n_node)])
        if c == core:
            node_group = g
    for n in range(n_node):
        g = dist.new_group([n * n_core + c for c in range(n_core)])
        if n == node:
            core_group = g
    control = dist.group.WORLD
    if backend == "nccl":
        control = dist.new_group(backend="gloo")
        # a group's first point-to-point batch must involve all of it: one
        # collective on each group first, so that ppermute's pairs (and a
        # rank with no pair) may issue their batches alone
        one = torch.zeros(1, device=device)
        for g in (node_group, core_group, dist.group.WORLD):
            dist.all_reduce(one, group=g)
        torch.cuda.synchronize(device)
    return CGMesh(n_node, n_core, device, backend, node, core, node_group,
                  core_group, dist.group.WORLD, control)


# ---------------------------------------------------------------------- #
# the LM meshes: data x model (x pod)
# ---------------------------------------------------------------------- #
@dataclasses.dataclass(frozen=True, eq=False)
class LMMesh(_HostControl):
    """The LM trainer's mesh: named axes (``("data", "model")``, or
    ``("pod", "data", "model")``) of the sizes ``sizes``, rank ``r`` at the
    row-major index ``coords`` (the JAX mesh's device order).  The
    sharding rules read only ``shape`` and ``axis_names``.

    With ``backend`` ``"virtual"`` no process group stands behind it: a
    mesh of one shard (this process holds everything; every collective
    is the identity), or a description of a larger one (``coords`` is
    ``None``: rules only).  On a process mesh (``"gloo"`` or ``"nccl"``)
    ``groups`` holds, for every tuple of axes (in mesh order), the
    process group of this rank's fellows along those axes (the others'
    coordinates fixed), ranks in row-major order of the tuple; a group of
    one is ``None``.  ``control`` is the gloo group of host control, as on
    :class:`CGMesh`."""

    axis_names: tuple
    sizes: tuple
    device: torch.device
    backend: str = "virtual"
    rank: int | None = None
    groups: dict = dataclasses.field(default_factory=dict)
    world: Any = None
    control: Any = None

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.sizes))

    @property
    def size(self) -> int:
        return int(np.prod(self.sizes))

    @property
    def is_process(self) -> bool:
        return self.backend != "virtual"

    @property
    def coords(self) -> dict | None:
        """This rank's index on every axis (``None`` for a description)."""
        r = self.rank if self.is_process else (0 if self.size == 1
                                               else None)
        if r is None:
            return None
        out = {}
        for a, n in zip(reversed(self.axis_names), reversed(self.sizes)):
            r, out[a] = divmod(r, n)
        return {a: out[a] for a in self.axis_names}

    def group(self, axes: tuple):
        """The process group along ``axes`` (``None``: one member)."""
        key = tuple(a for a in self.axis_names if a in axes)
        return self.groups.get(key)


def make_mesh(sizes: tuple, axis_names: tuple, *, device=None,
              backend: str | None = None, rank: int | None = None,
              world_size: int | None = None, init_method: str | None = None,
              timeout: float = 600.0) -> LMMesh:
    """An :class:`LMMesh` of ``sizes`` over ``axis_names``.  With no
    process arguments, the virtual mesh on ``device`` (default ``cuda``):
    one shard, or a description of a larger mesh.  With ``backend`` this
    process joins a process mesh as ``rank`` of ``world_size ==
    prod(sizes)``, as :func:`make_cg_mesh` joins one (NCCL: rank ``r`` on
    ``cuda:r``, refused before any process group without a card per rank;
    a gloo control group beside it), and builds the group of every tuple
    of axes (every rank must call this, in the same order).  With
    ``backend="fake"`` this process alone is ``rank`` of a fake group of
    ``world_size`` (no ``init_method``; the device is not checked): the
    dry-run's stand-in for one device of a production mesh."""
    import itertools

    sizes, axis_names = tuple(int(n) for n in sizes), tuple(axis_names)
    device = resolve_device(device)
    world = int(np.prod(sizes))
    if backend is None and rank is None and world_size is None \
            and init_method is None:
        return LMMesh(axis_names, sizes, device)
    if backend not in BACKENDS:
        raise ValueError(f"process mesh backend must be one of {BACKENDS}, "
                         f"got {backend!r}")
    if world_size != world:
        raise ValueError(f"world_size {world_size} != prod{sizes} = {world}")
    if rank is None or not 0 <= rank < world:
        raise ValueError(f"rank must be in [0, {world}), got {rank!r}")
    if backend == "nccl":
        require_cards(world, device)
        if device.index not in (None, rank):
            raise ValueError(f"NCCL rank {rank} runs on cuda:{rank}, not "
                             f"{device}")
        device = torch.device("cuda", rank)
        torch.cuda.set_device(device)
    import torch.distributed as dist

    if not dist.is_initialized() and backend == "fake":
        from torch.testing._internal.distributed.fake_pg import FakeStore
        dist.init_process_group("fake", store=FakeStore(), rank=rank,
                                world_size=world)
    elif not dist.is_initialized():
        if init_method is None:
            raise ValueError("a process mesh needs an init_method "
                             "('file://<path>' or 'tcp://<host>:<port>')")
        dist.init_process_group(
            backend, init_method=init_method, rank=rank, world_size=world,
            timeout=datetime.timedelta(seconds=timeout),
            **({"device_id": device} if backend == "nccl" else {}))
    elif (dist.get_rank(), dist.get_world_size()) != (rank, world):
        raise ValueError(
            f"the process group is rank {dist.get_rank()} of "
            f"{dist.get_world_size()}, not {rank} of {world}")
    mesh = LMMesh(axis_names, sizes, device, backend, rank)
    coords = mesh.coords
    groups = {}
    for k in range(1, len(axis_names) + 1):
        for axes in itertools.combinations(axis_names, k):
            if int(np.prod([mesh.shape[a] for a in axes])) == 1:
                continue
            if len(axes) == len(axis_names):
                groups[axes] = dist.group.WORLD
                continue
            rest = [a for a in axis_names if a not in axes]
            # new_group is collective over the world: every rank builds
            # every group
            for fixed in itertools.product(*(range(mesh.shape[a])
                                             for a in rest)):
                members = []
                for idx in itertools.product(*(range(mesh.shape[a])
                                               for a in axes)):
                    c = dict(zip(rest, fixed)) | dict(zip(axes, idx))
                    r = 0
                    for a in axis_names:
                        r = r * mesh.shape[a] + c[a]
                    members.append(r)
                g = dist.new_group(sorted(members))
                if all(coords[a] == f for a, f in zip(rest, fixed)):
                    groups[axes] = g
    control = dist.group.WORLD
    if backend == "nccl":
        control = dist.new_group(backend="gloo")
        # every communicator started now, by one collective on each group
        one = torch.zeros(1, device=device)
        for g in {id(g): g for g in (*groups.values(),
                                      dist.group.WORLD)}.values():
            dist.all_reduce(one, group=g)
        torch.cuda.synchronize(device)
    return dataclasses.replace(mesh, groups=groups, world=dist.group.WORLD,
                               control=control)


def make_production_mesh(*, multi_pod: bool = False, **process) -> LMMesh:
    """The production mesh: ``data=16 x model=16`` (one pod of 256), or
    ``pod=2 x data=16 x model=16`` (512).  With no ``process`` arguments
    (those of :func:`make_mesh`) a description for the rules."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, **process)


def make_host_mesh(*, model: int | None = None, **process) -> LMMesh:
    """The ``data x model`` mesh over this process mesh's ranks
    (``world_size``; one without process arguments): ``model`` is 2 when
    the rank count is even and above 1, else 1, unless given."""
    n = process.get("world_size") or 1
    m = model or (2 if n % 2 == 0 and n > 1 else 1)
    if n % m:
        raise ValueError(f"model={m} does not divide {n} ranks")
    return make_mesh((n // m, m), ("data", "model"), **process)


def spawn_mesh(fn: Callable, world: int, device="cuda", *,
               model: int | None = None, backend: str = "gloo",
               args: tuple = (), timeout: float = 600.0,
               axes: dict | None = None) -> list:
    """:func:`spawn_cg_mesh` for the LM mesh: ``fn(mesh, *args)`` on
    ``world`` spawned ranks of ``make_host_mesh(model=model)`` (or, with
    ``axes``, ``{name: size}`` in mesh order, of ``make_mesh`` over those
    axes, e.g. ``{"pod": 2}``), with the same rendezvous, refusal,
    failure and timeout handling."""
    if axes is not None:
        return _spawn(fn, world, device, backend, args, timeout, make_mesh,
                      {"sizes": tuple(axes.values()),
                       "axis_names": tuple(axes)})
    return _spawn(fn, world, device, backend, args, timeout,
                  make_host_mesh, {"model": model})


# ---------------------------------------------------------------------- #
# the launcher
# ---------------------------------------------------------------------- #
def _rank_main(rank: int, world: int, device, backend: str,
               init_method: str, out_dir: str) -> None:
    """One spawned rank: join the mesh the call ``out_dir`` holds names,
    run the call, write its result there."""
    # every rank is on this host: gloo's sockets (the whole gloo mesh, or
    # an NCCL mesh's control group) bind to the loopback
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    # an NCCL set-up or transport failure says why on stderr
    os.environ.setdefault("NCCL_DEBUG", "WARN")
    torch.set_num_threads(1)
    with open(Path(out_dir) / "call.pkl", "rb") as f:
        fn, args, build, build_kw = pickle.load(f)
    mesh = build(**build_kw, device=device, backend=backend, rank=rank,
                 world_size=world, init_method=init_method)
    result = fn(mesh, *args)
    tmp = Path(out_dir) / f"result_{rank}.tmp"
    with open(tmp, "wb") as f:
        pickle.dump(result, f)
    os.replace(tmp, Path(out_dir) / f"result_{rank}.pkl")
    import torch.distributed as dist
    dist.barrier(group=mesh.control)    # every rank is done with every other
    mesh.destroy()
    sys.stdout.flush()
    sys.stderr.flush()
    # skip the interpreter's teardown: a gloo group's threads met there
    # can abort the process after its result is written
    os._exit(0)


class RanksKilled(RuntimeError):
    """Ranks of a :func:`spawn_cg_mesh` that ended without a result and
    without a Python traceback: killed by a signal (a preemption's
    SIGKILL, ``-9``) or exited non-zero.  ``exitcodes`` holds every
    rank's exit code, in rank order (a negative code is the signal)."""

    def __init__(self, exitcodes: list):
        self.exitcodes = list(exitcodes)
        super().__init__(f"ranks ended without a result; exit codes by "
                         f"rank: {self.exitcodes}")


#: the thread-count variables of the BLAS libraries numpy may load
_BLAS_THREADS = ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS",
                 "MKL_NUM_THREADS")

#: seconds the other ranks get to end on their own once one has died (a
#: preemption kills every rank at one chunk boundary)
_GRACE_S = 5.0


def spawn_cg_mesh(fn: Callable, n_node: int, n_core: int, device="cuda",
                  *, backend: str = "gloo", args: tuple = (),
                  timeout: float = 120.0) -> list:
    """Run ``fn(mesh, *args)`` on ``n_node * n_core`` spawned ranks of a
    process mesh on this host (``backend`` gloo, every rank on ``device``;
    or NCCL, rank ``r`` on ``cuda:r``); return the ranks' results in rank
    order (each must pickle).  An NCCL launch with too few cards is
    refused before any process starts.

    ``fn`` must be importable by name (a module-level function).  The
    rendezvous is a ``file://`` in a fresh temporary directory, so
    concurrent launches never share a port.  When one rank raises, the
    others are ended and this raises with its traceback; when one dies
    without a traceback (killed by a signal), the others get a few
    seconds to end on their own, the rest are ended, and this raises
    :class:`RanksKilled` with every rank's exit code (also when a rank
    raised and another died by SIGKILL: the preemption is the cause).  When the ranks
    have not all finished after ``timeout`` seconds, every rank is killed
    and this raises ``TimeoutError``.  On a card the kernel library is
    built here once, before any rank starts."""
    return _spawn(fn, n_node * n_core, device, backend, args, timeout,
                  make_cg_mesh, {"n_node": n_node, "n_core": n_core},
                  kernels=True)


def _spawn(fn: Callable, world: int, device, backend: str, args: tuple,
           timeout: float, build: Callable, build_kw: dict,
           kernels: bool = False) -> list:
    """The launcher of :func:`spawn_cg_mesh` and :func:`spawn_mesh`: each
    of ``world`` ranks joins ``build(**build_kw, <process arguments>)``
    and runs ``fn(mesh, *args)``.  ``kernels``: build the kernel library
    first when the ranks are on cards."""
    import torch.multiprocessing as mp

    device = resolve_device(device)
    if backend not in _SPAWNED:
        raise ValueError(f"process mesh backend must be one of {_SPAWNED}, "
                         f"got {backend!r}")
    if backend == "nccl":
        require_cards(world, device)
    if kernels and device.type == "cuda":
        from repro_torch.kernels import spmv_cuda
        spmv_cuda.build()
    tmp = tempfile.mkdtemp(prefix="cg_mesh_")
    # one BLAS thread per rank (unless the caller set a count): the ranks
    # share this host's cores, and pools that each size themselves to the
    # whole host oversubscribe it (a dense inverse then takes seconds)
    blas = {k: os.environ.get(k) for k in _BLAS_THREADS}
    try:
        # the call goes through a file: arguments larger than a pipe's
        # buffer would make each rank's start wait for the one before
        with open(Path(tmp) / "call.pkl", "wb") as f:
            pickle.dump((fn, tuple(args), build, build_kw), f)
        for k in _BLAS_THREADS:
            os.environ.setdefault(k, "1")
        try:
            ctx = mp.start_processes(
                _rank_main, args=(world,
                                  # NCCL: each rank binds its own card
                                  str(device) if backend == "gloo"
                                  else device.type, backend,
                                  f"file://{tmp}/rendezvous", tmp),
                nprocs=world, join=False, start_method="spawn")
        finally:                # the ranks have read their environment
            for k, v in blas.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v
        deadline = time.monotonic() + timeout
        try:
            while not ctx.join(timeout=0.1, grace_period=_GRACE_S):
                if time.monotonic() > deadline:
                    raise TimeoutError(
                        f"spawn: {world} ranks not done after "
                        f"{timeout} s")
        except mp.ProcessExitedException:
            # join ended every rank before raising: all exit codes are in
            raise RanksKilled([p.exitcode for p in ctx.processes]) from None
        except mp.ProcessRaisedException as e:
            # a rank whose peer was SIGKILLed (a preemption) can fail in
            # the collective it was finishing before its own kill: the
            # signal is the cause (join ends the others with SIGTERM, and
            # SIGKILLs only a rank that outlives the grace)
            codes = [p.exitcode for p in ctx.processes]
            if -signal.SIGKILL in codes:
                raise RanksKilled(codes) from e
            raise
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
                p.join()
        out = []
        for r in range(world):
            with open(Path(tmp) / f"result_{r}.pkl", "rb") as f:
                out.append(pickle.load(f))
        return out
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


# ---------------------------------------------------------------------- #
# plans handed from the launcher to the ranks
# ---------------------------------------------------------------------- #
def write_plan(plan, directory) -> Path:
    """Write a whole plan's arrays (``plan_arrays``, one ``.npy`` each) and
    meta (``meta.json``) into ``directory``, for :func:`read_plan`."""
    from repro_torch.core.spmv import plan_arrays, plan_meta

    d = Path(directory)
    d.mkdir(parents=True, exist_ok=True)
    for name, a in plan_arrays(plan).items():
        np.save(d / f"{name}.npy", a)
    (d / "meta.json").write_text(json.dumps(plan_meta(plan)))
    return d


def read_plan(directory, mesh: CGMesh):
    """This rank's shard of the plan :func:`write_plan` wrote: the arrays
    are memory-mapped and only the rank's rows are read."""
    from repro_torch.core.spmv import plan_from_arrays

    d = Path(directory)
    meta = json.loads((d / "meta.json").read_text())
    arrays = {p.stem: np.load(p, mmap_mode="r") for p in d.glob("*.npy")}
    return plan_from_arrays(arrays, meta, device=mesh.device, mesh=mesh)
