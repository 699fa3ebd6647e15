"""Violation vocabulary + structured report for the static verifier.

Every check in ``repro_torch.analysis`` reports through a
:class:`Violation` carrying a **code** from the closed vocabulary below —
the JAX package's, code for code, so the two packages' reports compare
equal.  Codes are namespaced by the layer that proves the invariant —
``P_*`` plan data, ``K_*`` kernel index streams, ``J_*`` traces of the
device programs (the JAX package's jaxpr layer; the port has none of its
checks yet) — and each has a default severity:

``error``    a broken contract: the program would race, read out of
             bounds, silently change its collective cost, or corrupt the
             wire payload.  Errors gate the analyzer's exit code (CI
             fails).
``warning``  an advisory the contract language tracks but does not gate
             on (bit-reproducibility lints, undeclared metadata).  The
             ``--strict`` CLI flag promotes warnings to gate status.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Any, Iterable

__all__ = ["CODES", "ERROR", "WARNING", "Violation", "Report"]

ERROR = "error"
WARNING = "warning"

#: code -> (layer, default severity, one-line description).  The closed
#: vocabulary: a Violation with an unknown code is a bug in the checker
#: itself, so the constructor rejects it.
CODES: dict[str, tuple[str, str, str]] = {
    # -- plan layer (host numpy data) ---------------------------------- #
    "P_GHOST_MULTI_WRITER": (
        "plan", ERROR,
        "a real ghost slot has more than one writer across the receive "
        "table — the gather+add assembly becomes a race"),
    "P_GHOST_STALE_READ": (
        "plan", ERROR,
        "a nonzero off-diagonal entry reads a ghost slot no receive-table "
        "entry writes — the matvec would consume stale zeros"),
    "P_SEND_OOB": (
        "plan", ERROR,
        "a send-table index falls outside the core's (rc_pad,) shard"),
    "P_RECV_OOB": (
        "plan", ERROR,
        "a receive-table slot falls outside [0, g_pad] (dump slot "
        "included)"),
    "P_SLOT_PERM": (
        "plan", ERROR,
        "x_gather is not a true permutation onto the node's valid vector "
        "slots (or is not replicated across the core axis)"),
    "P_NODE_BOUNDS": (
        "plan", ERROR,
        "node_bounds is not monotone over [0, n] or disagrees with the "
        "plan's per-node valid-row counts"),
    "P_MASK_COUNT": (
        "plan", ERROR,
        "the mask's valid-slot count does not equal the matrix dimension"),
    "P_ACCOUNTING": (
        "plan", ERROR,
        "format storage accounting is inconsistent (nnz_stored vs array "
        "shapes, stored nonzeros, or padding_waste out of [0, 1))"),
    "P_HALO_FREE": (
        "plan", ERROR,
        "a halo-free plan (hs == 0) still carries ghost machinery "
        "(g_pad != 0 or nonzero off-diagonal data), or vice versa"),
    # -- kernel layer (static index streams) --------------------------- #
    "K_INDEX_OOB": (
        "kernel", ERROR,
        "a gather index stream exceeds its vector-buffer extent — an "
        "out-of-bounds read on hardware"),
    "K_ROW_OOB": (
        "kernel", ERROR,
        "a scatter (accumulation-slot) stream exceeds rc_pad — an "
        "out-of-bounds write on hardware"),
    "K_DUMP_READ": (
        "kernel", ERROR,
        "a nonzero-valued entry reads the ghost dump slot, which is "
        "write-only garbage by contract"),
    "K_STREAM_SHAPE": (
        "kernel", ERROR,
        "the vals/cols/rows arrays of one declared stream disagree in "
        "shape"),
    "K_NONFINITE": (
        "kernel", ERROR,
        "a stored matrix value is NaN or infinite"),
    "K_UNDECLARED_FIELDS": (
        "kernel", WARNING,
        "format fields not covered by any declared index stream — the "
        "bounds checker cannot see them"),
    # -- jaxpr/HLO layer ------------------------------------------------ #
    "J_SPMV_ALLREDUCE": (
        "jaxpr", ERROR,
        "the SpMV shard body emits an all-reduce — the zero-all-reduce "
        "contract every census attribution rests on is broken"),
    "J_CENSUS_MISMATCH": (
        "jaxpr", ERROR,
        "the traced shard body's collective census does not equal the "
        "transport's predicted_cost (+ the one core-axis assembly "
        "all_gather)"),
    "J_WIRE_MISMATCH": (
        "jaxpr", ERROR,
        "inter-node wire bytes derived from the traced exchange disagree "
        "with the transport's predicted_cost table"),
    "J_PAYLOAD_TRANSFORM": (
        "jaxpr", ERROR,
        "the traced exchange transforms the wire payload (bit "
        "manipulation / non-assembly arithmetic) while the transport "
        "declares exact_wire"),
    "J_PAYLOAD_UNKNOWN_OP": (
        "jaxpr", WARNING,
        "the traced exchange uses a primitive outside the known "
        "data-movement allowlist — extend the allowlist or justify it"),
    "J_SOLVER_REDUCTIONS": (
        "jaxpr", ERROR,
        "the solver while-body all-reduce count does not equal the "
        "solver's declared reductions_per_iter"),
    "J_SOLVER_UNDECLARED": (
        "jaxpr", ERROR,
        "a registered solver declares no reductions_per_iter contract"),
    "J_PRECOND_COLLECTIVE": (
        "jaxpr", ERROR,
        "a preconditioner declaring local_only emits a collective in "
        "apply()"),
    "J_PRECOND_REDUCTIONS": (
        "jaxpr", ERROR,
        "a non-local preconditioner's apply() emits a number of "
        "reduction collectives different from its declared "
        "reductions_per_apply"),
    "J_DOWNCAST": (
        "jaxpr", WARNING,
        "a traced program silently narrows float precision "
        "(f64->f32/bf16/f16) — an accuracy cliff the tol floor hides"),
    "J_SCATTER_UNORDERED": (
        "jaxpr", WARNING,
        "a scatter-add with unsorted, non-unique indices — summation "
        "order is implementation-defined, a bit-reproducibility hazard"),
    "J_HLO_CENSUS": (
        "jaxpr", ERROR,
        "the compiled-HLO while-body census disagrees with the statically "
        "proven contract (spot check)"),
}


@dataclasses.dataclass(frozen=True)
class Violation:
    """One broken (or advisory) contract, locatable by code + context."""

    code: str
    message: str
    #: where it was found: combo identifiers (format, transport, solver,
    #: precond, node, slot, field, ...) — JSON-serialisable values only
    context: dict[str, Any] = dataclasses.field(default_factory=dict)
    #: override of the code's default severity (declared-lossy transports
    #: downgrade J_PAYLOAD_TRANSFORM, --strict upgrades warnings)
    severity: str | None = None

    def __post_init__(self) -> None:
        if self.code not in CODES:
            raise ValueError(f"unknown violation code {self.code!r}; the "
                             "vocabulary is closed — add new codes to "
                             "repro_torch.analysis.report.CODES")
        if self.severity is None:
            object.__setattr__(self, "severity", CODES[self.code][1])

    @property
    def layer(self) -> str:
        return CODES[self.code][0]

    def as_dict(self) -> dict[str, Any]:
        return {"code": self.code, "layer": self.layer,
                "severity": self.severity, "message": self.message,
                "context": dict(self.context)}

    def __str__(self) -> str:
        ctx = " ".join(f"{k}={v}" for k, v in self.context.items())
        return f"[{self.severity.upper()}] {self.code} {ctx}: {self.message}"


@dataclasses.dataclass
class Report:
    """Accumulated violations + check counters, JSON-serialisable."""

    violations: list[Violation] = dataclasses.field(default_factory=list)
    checks: int = 0

    def add(self, violation: Violation) -> None:
        self.violations.append(violation)

    def extend(self, violations: Iterable[Violation]) -> None:
        self.violations.extend(violations)

    def count(self, n: int = 1) -> None:
        """Record ``n`` executed checks (for the report's denominator)."""
        self.checks += n

    @property
    def errors(self) -> list[Violation]:
        return [v for v in self.violations if v.severity == ERROR]

    @property
    def warnings(self) -> list[Violation]:
        return [v for v in self.violations if v.severity == WARNING]

    def ok(self, strict: bool = False) -> bool:
        return not (self.violations if strict else self.errors)

    def summary(self) -> dict[str, int]:
        out: dict[str, int] = {}
        for v in self.violations:
            out[v.code] = out.get(v.code, 0) + 1
        return dict(sorted(out.items()))

    def as_dict(self) -> dict[str, Any]:
        return {"checks": self.checks,
                "errors": len(self.errors),
                "warnings": len(self.warnings),
                "summary": self.summary(),
                "violations": [v.as_dict() for v in self.violations]}

    def to_json(self, **extra: Any) -> str:
        return json.dumps({**self.as_dict(), **extra})
