"""Traced proofs of the collective contracts — the port's counterpart of
the JAX package's ``repro.analysis.jaxpr_pass``.

The reference traces a shard body to a jaxpr under an axis environment and
reads its collective primitives without a device.  The port has no
tracer: a *trace* here is one run of the body, the exchange or one solver
``loop_body`` on zeros, on the plan's device, under two recorders at once:

* ``repro_torch.core.collectives.record_collectives`` — every collective
  the virtual mesh issues, in the reference's vocabulary, with the shape
  and dtype of the tensor handed to it (the census);
* a ``TorchDispatchMode`` — every aten operation, by name (the op stream
  the lints read; ``view.dtype`` is the counterpart of
  ``bitcast_convert_type``, ``_to_copy`` of ``convert_element_type``).

On the CPU a trace is device-free in the reference's sense: it runs the
plain PyTorch versions on a host plan.  Proven here (codes in
``repro_torch.analysis.report``, the reference's):

* the SpMV shard body issues **zero all-reduces** for every format x
  transport (``J_SPMV_ALLREDUCE``), and its per-kind census equals the
  transport's ``predicted_cost`` plus exactly one core-axis ``all_gather``
  for the node-local x assembly (``J_CENSUS_MISMATCH``);
* inter-node wire bytes derived from the traced exchange — the dtype and
  shape of each payload actually handed to a collective, after the wire
  codec's encode — equal the ``predicted_cost`` table
  (``J_WIRE_MISMATCH``), so a bf16/int8 wire is proven to shrink the
  traffic, not just the table;
* an ``exact_wire`` transport's exchange contains only data-movement,
  single-writer-assembly and *declared codec* operations; on a lossy wire
  the codec's quantise ops (``PAYLOAD_QUANTISE``) are accepted, but a
  bit manipulation outside them (``FaultyTransport``'s ``bitwise_xor``) is
  caught (``J_PAYLOAD_TRANSFORM`` / ``J_PAYLOAD_UNKNOWN_OP``);
* each solver's ``loop_body`` issues exactly its declared
  ``reductions_per_iter`` all-reduces (``J_SOLVER_REDUCTIONS`` /
  ``J_SOLVER_UNDECLARED``);
* a ``local_only`` preconditioner's apply is collective-free
  (``J_PRECOND_COLLECTIVE``), a non-local one issues its
  ``reductions_per_apply`` (``J_PRECOND_REDUCTIONS``);
* advisory lints: silent float downcasts (``J_DOWNCAST``) and
  accumulating scatters (``J_SCATTER_UNORDERED``);
* :func:`check_solver_hlo`: the real ``make_solver`` (on the card, B1-B4
  as the Hopper kernels) issues in one ``check_every`` block what the
  trace promised (``J_HLO_CENSUS``).
"""
from __future__ import annotations

import contextlib
import dataclasses

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.analysis.report import Report, Violation
from repro_torch.core.collectives import (COLLECTIVE_OPS,
                                          SOLVER_REDUCTION_OPS, Collective,
                                          census, record_collectives)
from repro_torch.core.spmv import make_shard_body
from repro_torch.core.transport import (get_codec, get_transport,
                                        plan_wire_dtype, resolve_transport)
from repro_torch.solvers.base import Solver, SolverCtx, get_solver
from repro_torch.solvers.precond import get_precond

__all__ = ["Op", "Trace", "tracing", "trace_shard_body", "trace_exchange",
           "derived_wire_bytes", "check_spmv_static", "check_solver_static",
           "check_precond_static", "check_solver_hlo", "PAYLOAD_ALLOW",
           "PAYLOAD_DENY", "PAYLOAD_QUANTISE"]

#: aten operations an exact-wire exchange may use: data movement, index
#: arithmetic, predication, and the single-writer assembly scatter + sum
PAYLOAD_ALLOW = frozenset({
    # movement / layout / creation
    "gather", "scatter", "index", "index_select", "take", "slice", "select",
    "narrow", "cat", "stack", "view", "_unsafe_view", "reshape", "expand",
    "transpose", "permute", "t", "squeeze", "unsqueeze", "clone", "copy",
    "alias", "detach", "lift_fresh", "contiguous", "new_zeros", "new_empty",
    "zeros", "zeros_like", "empty", "empty_like", "full", "full_like",
    "fill", "arange",
    # the sanctioned assembly sum (each real slot has one writer, so the
    # sum only combines one value with zeros) + index arithmetic
    "add", "sub", "remainder", "sum", "where", "clamp", "minimum",
    "maximum", "lt", "le", "gt", "ge", "eq", "ne", "logical_and",
    "logical_or", "logical_not", "bitwise_and", "bitwise_or",
    "bitwise_not", "_to_copy",
})

#: operations that *transform* the payload: one of these in an exchange
#: that claims ``exact_wire`` breaks the contract — how FaultyTransport's
#: reinterpret + xor corruption is caught
PAYLOAD_DENY = frozenset({
    "view.dtype", "bitwise_xor", "bitwise_left_shift",
    "bitwise_right_shift", "__lshift__", "__rshift__", "mul", "div", "neg",
    "pow", "exp", "log", "sqrt", "rsqrt", "abs", "sign", "round", "floor",
    "ceil", "nextafter",
})

#: the declared quantise/dequantise operations of a *lossy* wire codec
#: (``WireCodec``): absmax scale (``abs`` + ``amax``), scale/apply
#: (``div``, ``mul``), rounding, and the ``view.dtype`` that packs the f32
#: scale into the int8 payload.  Accepted **only when the wire dtype is
#: lossy**; ops outside this set stay violations at every wire dtype.
PAYLOAD_QUANTISE = frozenset({
    "abs", "amax", "div", "mul", "round", "view.dtype",
})

#: accumulating scatters: the summation order of repeated indices is the
#: implementation's (on the card, atomics)
_ACCUMULATING = frozenset({"scatter_add", "index_add", "scatter_reduce"})

#: overloads whose meaning differs from their packet's (a reinterpreting
#: view is a bitcast, a plain view is movement)
_OVERLOADS = frozenset({"view.dtype"})


@dataclasses.dataclass(frozen=True)
class Op:
    """One aten operation of a trace: its name (the overload dropped, an
    in-place op's trailing ``_`` too, except names in ``_OVERLOADS``), its
    first input's dtype, ``_to_copy``'s target dtype and whether an
    ``index_put`` accumulates."""

    name: str
    src: torch.dtype | None = None
    dst: torch.dtype | None = None
    accumulate: bool = False


@dataclasses.dataclass
class Trace:
    """What one traced run issued: collectives and aten operations."""

    collectives: list[Collective]
    ops: list[Op]

    def census(self) -> dict[str, int]:
        return census(self.collectives)


def _op_name(func) -> str:
    full = func.__name__                        # e.g. "view.dtype"
    if full in _OVERLOADS:
        return full
    name = full.split(".")[0]
    if name.endswith("_") and not name.startswith("__"):
        name = name[:-1]                        # in-place: scatter_ -> scatter
    return name


class _OpRecorder(TorchDispatchMode):
    def __init__(self, ops: list[Op]):
        super().__init__()
        self.ops = ops

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        name = _op_name(func)
        src = next((a.dtype for a in args if isinstance(a, torch.Tensor)),
                   None)
        acc = name == "index_put" and bool(
            kwargs.get("accumulate", len(args) > 3 and args[3]))
        self.ops.append(Op(name, src, kwargs.get("dtype"), acc))
        return func(*args, **kwargs)


@contextlib.contextmanager
def tracing():
    """``with tracing() as trace: ...`` records the block's collectives
    and aten operations into ``trace`` (a :class:`Trace`)."""
    with record_collectives() as log:
        trace = Trace(log, [])
        with _OpRecorder(trace.ops):
            yield trace


def _zeros(plan, shape) -> torch.Tensor:
    return torch.zeros(shape, dtype=plan.mask.dtype, device=plan.device)


def trace_shard_body(plan, transport=None, backend: str = "plain",
                     wire_dtype: str | None = None) -> Trace:
    """One run of the two-phase SpMV body on a zero input (the plan's
    ``x_shape``, the column space), traced.  ``backend="plain"`` is the
    reference's default ``"jnp"``; ``"kernel"`` runs the kernel wrappers."""
    body = make_shard_body(plan, transport=transport, backend=backend,
                           wire_dtype=wire_dtype)
    x = _zeros(plan, plan.x_shape)
    with tracing() as trace:
        body(x)
    return trace


def trace_exchange(plan, transport, wire_dtype: str | None = None) -> Trace:
    """One run of the transport's ghost exchange alone (the wire
    microscope), traced.  Raises on halo-free plans — there is no
    exchange."""
    if plan.hs == 0:
        raise ValueError("plan has no halo traffic (hs == 0)")
    tr, state = resolve_transport(transport, plan, wire_dtype=wire_dtype)
    F = {"send_own": plan.send_own, "recv_own": plan.recv_own,
         **tr.extra_arrays(plan, state)}
    x = _zeros(plan, plan.x_shape)
    with tracing() as trace:
        tr.exchange(x, F, state=state, n_node=plan.n_node, g_pad=plan.g_pad)
    return trace


def derived_wire_bytes(trace, n_node: int, n_core: int) -> int:
    """Total inter-node wire bytes of one exchange, derived from the traced
    collectives' payloads (a :class:`Trace` or its collective records).

    The model matches how ``predicted_cost`` counts: a node-axis
    ``all_to_all`` moves each shard's operand minus its own share; a
    node-axis ``ppermute`` moves one operand per (src != dst) pair; the
    node axis is replicated across ``n_core`` core rows, which each pay
    the traffic; core-axis collectives are intra-node (0 wire).
    """
    records = getattr(trace, "collectives", trace)
    wire = 0
    for c in records:
        if "node" not in c.axis or c.kind not in (
                "all-to-all", "collective-permute", "all-gather"):
            continue                      # intra-node: no wire
        if c.kind == "all-to-all":
            wire += n_core * c.nbytes * (n_node - 1)
        elif c.kind == "collective-permute":
            wire += n_core * c.nbytes * c.pairs
        else:                             # node-axis all_gather
            wire += n_core * n_node * c.nbytes * (n_node - 1)
    return wire


def _lint_payload(plan, transport, out: Report,
                  wire_dtype: str | None = None) -> None:
    tr = get_transport(transport)
    codec = get_codec(wire_dtype if wire_dtype is not None
                      else plan_wire_dtype(plan))
    trace = trace_exchange(plan, tr, wire_dtype=codec.name)
    ctx = {"format": plan.format, "transport": tr.name,
           "wire_dtype": codec.name}
    out.count(1)
    exact_wire = tr.exact_wire
    for op in trace.ops:
        if not codec.exact and op.name in PAYLOAD_QUANTISE:
            continue            # the declared lossy-wire codec ops
        if op.name in PAYLOAD_DENY:
            out.add(Violation(
                "J_PAYLOAD_TRANSFORM",
                f"exchange emits payload-transforming operation "
                f"{op.name!r} outside the declared wire codec "
                f"({codec.name!r}) while the transport declares "
                f"exact_wire={exact_wire}", ctx,
                severity=None if exact_wire else "warning"))
        elif op.name not in PAYLOAD_ALLOW:
            out.add(Violation(
                "J_PAYLOAD_UNKNOWN_OP",
                f"exchange uses operation {op.name!r} outside the known "
                "data-movement allowlist", ctx))


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).removeprefix("torch.")


def _lint_numerics(trace: Trace, ctx: dict, out: Report,
                   declared: tuple[str, ...] = ()) -> None:
    """Advisory downcast + scatter-ordering lints over any trace.
    ``declared`` lists "src->dst" float conversions the resolved wire
    codec declares (bf16's ``float32->bfloat16``) — not silent, so not
    flagged."""
    seen_downcast: set[str] = set(declared)
    seen_scatter = False
    for op in trace.ops:
        if op.name == "_to_copy" and op.src is not None \
                and op.dst is not None:
            key = f"{_dtype_name(op.src)}->{_dtype_name(op.dst)}"
            if (op.src.is_floating_point and op.dst.is_floating_point
                    and op.dst.itemsize < op.src.itemsize
                    and key not in seen_downcast):
                seen_downcast.add(key)
                out.add(Violation(
                    "J_DOWNCAST",
                    f"silent float downcast {key} in traced program", ctx))
        elif (op.name in _ACCUMULATING or op.accumulate) \
                and not seen_scatter:
            seen_scatter = True
            out.add(Violation(
                "J_SCATTER_UNORDERED",
                f"accumulating scatter {op.name!r}: the summation order of "
                "repeated indices is implementation-defined "
                "(bit-reproducibility advisory)", ctx))


def check_spmv_static(plan, transport=None, backend: str = "plain",
                      wire_dtype: str | None = None) -> Report:
    """Prove the SpMV body's collective contract for one (plan,
    transport, wire_dtype): zero all-reduces, census == predicted_cost
    (+ the one core-axis assembly all_gather), derived wire bytes ==
    predicted (dtype-aware, so a compressed wire proves its shrink),
    payload lint, numeric lints.  Returns a :class:`Report`."""
    out = Report()
    tr = get_transport(transport if transport is not None
                       else plan.transport)
    codec = get_codec(wire_dtype if wire_dtype is not None
                      else plan_wire_dtype(plan))
    ctx = {"format": plan.format, "transport": tr.name,
           "wire_dtype": codec.name}

    trace = trace_shard_body(plan, transport=tr, backend=backend,
                             wire_dtype=codec.name)
    counts = trace.census()

    out.count(1)
    reductions = sum(counts[k] for k in SOLVER_REDUCTION_OPS)
    if reductions:
        out.add(Violation(
            "J_SPMV_ALLREDUCE",
            f"SpMV shard body emits {reductions} reduction "
            f"collective(s); the zero-all-reduce contract requires 0", ctx))

    out.count(1)
    _, state = resolve_transport(tr, plan, wire_dtype=codec.name)
    predicted = tr.predicted_cost(plan, state)
    for kind in COLLECTIVE_OPS:
        want = int(predicted.get(kind, 0))
        if kind == "all-gather":
            want += 1                 # the node-local x assembly gather
        if counts[kind] != want:
            out.add(Violation(
                "J_CENSUS_MISMATCH",
                f"{kind}: traced {counts[kind]}, predicted_cost implies "
                f"{want}", {**ctx, "kind": kind}))

    if plan.hs > 0:
        out.count(1)
        derived = derived_wire_bytes(
            trace_exchange(plan, tr, wire_dtype=codec.name),
            plan.n_node, plan.n_core)
        want_wire = int(predicted.get("wire_bytes", 0))
        if derived != want_wire:
            out.add(Violation(
                "J_WIRE_MISMATCH",
                f"derived wire bytes {derived} != predicted {want_wire}",
                ctx))
        _lint_payload(plan, tr, out, wire_dtype=codec.name)

    _lint_numerics(trace, ctx, out, declared=codec.declared_downcasts)
    return out


def check_solver_static(plan, solver, precond="jacobi", transport=None,
                        A=None, layout: dict | None = None,
                        options: dict | None = None,
                        precond_options: dict | None = None,
                        wire_dtype: str | None = None) -> Report:
    """Prove one solver's reductions-per-iteration contract on this plan:
    run ``loop_setup`` on a zero right-hand side, then trace one
    ``loop_body`` — the port's while body — and count its reductions
    against the solver's declared ``reductions_per_iter``.  The numeric
    lints read the setup and the body.

    The reference's "traced to no while loop" verdict has as counterpart
    a solver whose ``loop_body`` is the protocol's unimplemented stub:
    every registered solver implements it, so for them it cannot fire
    (a Python loop always has a body to trace)."""
    out = Report()
    sol = get_solver(solver)
    pre = get_precond(precond)
    codec = get_codec(wire_dtype if wire_dtype is not None
                      else plan_wire_dtype(plan))
    body = make_shard_body(plan, transport=transport, backend="plain",
                           wire_dtype=codec.name)
    pdata, papply = pre.bind(plan, layout=layout, A=A, backend="plain",
                             options=precond_options)
    opts = sol.prepare(plan, pre, pdata, A=A, layout=layout,
                       options=options)
    ctx_info = {"format": plan.format, "transport": body.transport,
                "solver": sol.name, "precond": pre.name,
                "wire_dtype": codec.name}

    out.count(1)
    if sol.reductions_per_iter is None:
        out.add(Violation(
            "J_SOLVER_UNDECLARED",
            f"solver {sol.name!r} declares no reductions_per_iter — "
            "the census contract cannot be checked", ctx_info))
        return out

    out.count(1)
    if type(sol).loop_body is Solver.loop_body:
        out.add(Violation(
            "J_SOLVER_REDUCTIONS",
            f"solver {sol.name!r} has no loop_body to trace — not a "
            "fused iteration", ctx_info))
        return out

    sctx = SolverCtx(spmv=body, precond=lambda r: papply(pdata, r),
                     options=opts)
    b = _zeros(plan, (1,) + plan.cg_shape)
    tol = torch.tensor(1e-6, dtype=torch.float32, device=plan.device)
    maxiter = torch.tensor(100, dtype=torch.int32, device=plan.device)
    with tracing() as trace:
        aux, state = sol.loop_setup(sctx, b, tol, maxiter)
        with record_collectives() as body_log:
            sol.loop_body(sctx, aux, state)
    got = sum(c.kind in SOLVER_REDUCTION_OPS for c in body_log)
    if got != sol.reductions_per_iter:
        out.add(Violation(
            "J_SOLVER_REDUCTIONS",
            f"loop body carries {got} reduction collective(s); "
            f"{sol.name!r} declares reductions_per_iter="
            f"{sol.reductions_per_iter}", ctx_info))

    _lint_numerics(trace, ctx_info, out, declared=codec.declared_downcasts)
    return out


def check_precond_static(plan, precond, A=None, layout: dict | None = None,
                         options: dict | None = None) -> Report:
    """Prove a preconditioner's collective contract on one traced apply:

    - ``local_only`` preconds must be collective-free
      (``J_PRECOND_COLLECTIVE``);
    - non-local preconds must issue exactly their declared
      ``reductions_per_apply`` reductions (``J_PRECOND_REDUCTIONS``) —
      every registered precond declares 0, which keeps the solver census
      invariant across preconds.
    """
    out = Report()
    pre = get_precond(precond)
    pdata, papply = pre.bind(plan, layout=layout, A=A, backend="plain",
                             options=options)
    r = _zeros(plan, (1,) + plan.cg_shape)
    with record_collectives() as log:
        papply(pdata, r)
    out.count(1)
    counts = census(log)
    total = sum(counts.values())
    ctx = {"format": plan.format, "precond": pre.name}
    if pre.local_only:
        if total:
            out.add(Violation(
                "J_PRECOND_COLLECTIVE",
                f"preconditioner {pre.name!r} declares local_only but "
                f"apply emits {total} collective(s): "
                f"{ {k: v for k, v in counts.items() if v} }", ctx))
    else:
        out.count(1)
        got = sum(counts[k] for k in SOLVER_REDUCTION_OPS)
        want = int(getattr(pre, "reductions_per_apply", 0))
        if got != want:
            out.add(Violation(
                "J_PRECOND_REDUCTIONS",
                f"preconditioner {pre.name!r} apply emits {got} "
                f"reduction collective(s); declares "
                f"reductions_per_apply={want}", ctx))
    return out


def check_solver_hlo(plan, solver, precond="jacobi", A=None,
                     layout: dict | None = None,
                     options: dict | None = None,
                     precond_options: dict | None = None) -> Report:
    """Live spot check: the real ``make_solver`` on the plan's device (on
    the card, B1-B4 through the Hopper kernels) runs one ``check_every``
    block of gated iterations under ``record_collectives``; its reductions
    must be ``check_every x reductions_per_iter``, the statically proven
    contract.  The port's "the program runs what the trace promised"."""
    from repro_torch.solvers.base import make_solver

    out = Report()
    sol = get_solver(solver)
    solve = make_solver(plan, solver=solver, precond=precond, A=A,
                        layout=layout, options=options,
                        precond_options=precond_options)
    _, ctx, b, tol, maxiter = solve.parts(plan.mask, 1e-6, 10)
    aux, state = sol.loop_setup(ctx, b, tol, maxiter)
    with record_collectives() as log:
        for _ in range(solve.check_every):
            state = sol.loop_body(ctx, aux, state)
    out.count(1)
    got = sum(c.kind in SOLVER_REDUCTION_OPS for c in log)
    want = solve.check_every * (sol.reductions_per_iter or 0)
    if sol.reductions_per_iter is None or got != want:
        out.add(Violation(
            "J_HLO_CENSUS",
            f"one block of {solve.check_every} iterations issued {got} "
            f"reduction collective(s); {sol.name!r} declares "
            f"{sol.reductions_per_iter} per iteration",
            {"format": plan.format, "solver": sol.name,
             "precond": get_precond(precond).name}))
    return out
