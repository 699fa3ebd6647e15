"""Fault tolerance: step watchdog (straggler detection), emergency
checkpoints, resumable run loop, deterministic fault injection.

At 1000+ node scale the dominant failure modes are (a) node loss —
handled by checkpoint/restart with the deterministic seekable data pipeline,
(b) stragglers — detected here by an EMA watchdog over step wall-times
(on real fleets the signal feeds the scheduler; here it is logged and
surfaced in metrics so tests can assert on it), and (c) corrupted steps —
guarded by non-finite loss detection with automatic rollback-to-checkpoint.

:class:`FaultInjector` is the test driver for all three: a seeded,
deterministic fault source the resilient Krylov driver
(``repro_torch.solvers.resilient``) consults between solve chunks — NaN
injection into a named shard of a named state vector at iteration ``k``,
payload bit-flips in the halo exchange (via the ``faulty`` wrapping
``HaloTransport``, ``repro_torch.core.transport.FaultyTransport``), and
simulated preemption that SIGKILLs the process mid-solve so the elastic
restore path can be exercised end-to-end.
"""
from __future__ import annotations

import dataclasses
import logging
import os
import signal
import time

__all__ = ["Watchdog", "StepGuard", "FaultInjector", "FAULT_KINDS"]

_log = logging.getLogger(__name__)


@dataclasses.dataclass
class Watchdog:
    """EMA step-time watchdog: flags steps slower than ``threshold`` x EMA."""
    threshold: float = 3.0
    alpha: float = 0.1
    warmup: int = 3
    ema: float = 0.0
    n: int = 0
    stragglers: int = 0

    def observe(self, dt: float) -> bool:
        """Record one step time; True if this step was a straggler."""
        self.n += 1
        if self.n <= self.warmup:
            self.ema = dt if self.ema == 0 else \
                (1 - self.alpha) * self.ema + self.alpha * dt
            return False
        slow = dt > self.threshold * self.ema
        if slow:
            self.stragglers += 1
        else:  # stragglers don't poison the EMA
            self.ema = (1 - self.alpha) * self.ema + self.alpha * dt
        return slow


class StepGuard:
    """Context helper around the train loop body: times steps, feeds the
    watchdog, and triggers emergency checkpoints on exceptions.

    ``slow`` is always defined after ``__exit__`` — ``False`` on the
    exception path (the failed step's wall-time never reaches the
    watchdog, so it cannot be a straggler verdict).  A failing
    ``on_emergency`` callback is logged with its traceback and recorded on
    ``emergency_error``; the *original* step exception still propagates —
    masking the real failure with the checkpoint failure would be worse
    than either alone.
    """

    def __init__(self, watchdog: Watchdog, on_emergency=None):
        self.watchdog = watchdog
        self.on_emergency = on_emergency
        self.last_dt = 0.0
        self.slow = False
        self.emergency_error: BaseException | None = None

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb):
        self.last_dt = time.perf_counter() - self._t0
        if exc_type is not None:
            self.slow = False
            if self.on_emergency is not None:
                try:
                    self.on_emergency()
                except Exception as e:  # noqa: BLE001 - re-surfaced below
                    self.emergency_error = e
                    _log.exception(
                        "emergency checkpoint failed while handling %r",
                        exc)
            return False
        self.slow = self.watchdog.observe(self.last_dt)
        return False


FAULT_KINDS = ("nan", "bitflip", "preempt")


@dataclasses.dataclass
class FaultInjector:
    """Deterministic, seeded fault source for resilient-solve testing.

    One injector describes one fault: ``kind`` ∈ :data:`FAULT_KINDS`,
    armed when the solve's iteration counter first reaches
    ``at_iteration``.  The resilient driver calls :meth:`crossed` at every
    chunk boundary and acts on the kind:

    ``nan``      poison ``state_key`` (a named Krylov state vector, e.g.
                 ``"x"`` or ``"r"``) of the named ``(node, core)`` shard —
                 the seeded RNG picks which slot.  Detection must follow
                 within ``check_every`` iterations via the host guard.
    ``bitflip``  run the *next* chunk through the ``faulty`` wrapping
                 transport (``repro_torch.core.transport.FaultyTransport``),
                 which XORs an exponent bit into the exchanged halo
                 payload — transport-level corruption the true-residual
                 guard has to catch.
    ``preempt``  SIGKILL the process (:meth:`preempt`) — no teardown, no
                 atexit, exactly like a scheduler preemption.  The elastic
                 restore path resumes from the last on-disk checkpoint.

    ``repeat=True`` re-arms after every firing (persistent corruption) —
    used to drive the bounded-retry ``SolveFailure`` path under test.
    """

    kind: str
    at_iteration: int
    state_key: str = "x"
    shard: tuple[int, int] = (0, 0)
    seed: int = 0
    repeat: bool = False
    fired: int = 0

    def __post_init__(self):
        if self.kind not in FAULT_KINDS:
            raise ValueError(f"fault kind must be one of {FAULT_KINDS}, "
                             f"got {self.kind!r}")

    @classmethod
    def parse(cls, spec: str, **kw) -> "FaultInjector":
        """Build from the CLI syntax ``<kind>@<iteration>``."""
        try:
            kind, at = spec.split("@", 1)
            return cls(kind=kind, at_iteration=int(at), **kw)
        except ValueError as e:
            if "fault kind" in str(e):
                raise
            raise ValueError(
                f"bad fault spec {spec!r}; expected '<kind>@<iteration>' "
                f"with kind in {FAULT_KINDS}") from None

    # ------------------------------------------------------------------ #
    def crossed(self, k_lo: int, k_hi: int) -> bool:
        """True (and consume one firing) when the iteration span
        ``[k_lo, k_hi]`` reaches ``at_iteration`` for the first time —
        or on every crossing with ``repeat=True``."""
        if self.fired and not self.repeat:
            return False
        if k_hi >= self.at_iteration:
            self.fired += 1
            return True
        return False

    def poison_slot(self, n_slots: int) -> int:
        """The seeded index (into the caller's candidate slots — the
        resilient driver passes only mask-valid ones) the ``nan`` kind
        corrupts."""
        import numpy as np
        return int(np.random.default_rng(self.seed).integers(0, n_slots))

    def preempt(self) -> None:
        """Simulate scheduler preemption: SIGKILL — uncatchable, no
        cleanup, the checkpoint on disk is all that survives."""
        _log.warning("FaultInjector: simulating preemption (SIGKILL)")
        os.kill(os.getpid(), signal.SIGKILL)
