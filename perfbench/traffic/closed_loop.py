"""A closed loop of one caller: it sends its next solve when the last has
returned.  The generator that the mixes ``ksp`` and ``cgsets`` name.

A mix's parameters (``perfbench/traffic/<mix>.json``):

``callers``          1
``exact``            the exact solutions the right-hand sides are made
                     from, ``b = A u``: ``"ones"`` (``u = 1``) or
                     ``"uniform"`` (``u`` uniform in [0, 1))
``systems``          how many ``(u, b)`` pairs the caller solves over and
                     over, in an order drawn from ``--seed``
``stop``             ``{"rtol", "maxiter"}``: stop at ``rtol`` on the
                     solver's recursive residual, judged by the true
                     residual (``true_rel_residual``); or
                     ``{"iterations"}``: exactly that many iterations
                     (tolerance 0), judged against the plain reference's
                     float64 iterate after as many (``iterate_rel_error``)
``warmup_solves``    solves run in set-up, before the window
``checked_solves``   window solves kept for the check, drawn from the seed

Every solve starts from ``x0 = 0``.  System ``j``'s ``u`` is drawn from
``j`` alone, on the device, in float64, and ``b = A u`` is the plain
reference's float64 product (``perfbench.reference``) rounded to float32.
So every seed solves the same systems: the seed orders them and draws the
sample the check reads.
"""
from __future__ import annotations

import random
import time

import torch

from perfbench import system, timing
from perfbench.reference import DeviceCSR, pcg, true_residual

__all__ = ["Traffic", "Reservoir", "drive", "check"]


class Traffic:
    """The mix's right-hand sides on the device, ``(systems, n)`` float32,
    made from the plain reference's operator ``A`` (float64), and the
    order in which run ``seed`` sends them."""

    def __init__(self, mix: dict, A: DeviceCSR, seed: int):
        if mix["callers"] != 1:
            raise ValueError("closed_loop drives one caller")
        self.mix, self.seed = mix, seed
        stop = mix["stop"]
        if "iterations" in stop:
            self.tol, self.maxiter = 0.0, int(stop["iterations"])
            self.judged = "iterate_rel_error"
        else:
            self.tol, self.maxiter = float(stop["rtol"]), int(stop["maxiter"])
            self.judged = "true_rel_residual"
        dev = A.vals.device
        self.b = torch.empty((mix["systems"], A.n), dtype=torch.float32,
                             device=dev)
        for j in range(mix["systems"]):
            if mix["exact"] == "ones":
                u = torch.ones(A.n, dtype=torch.float64, device=dev)
            elif mix["exact"] == "uniform":
                gen = torch.Generator(device=dev)
                gen.manual_seed(j)
                u = torch.rand(A.n, generator=gen, dtype=torch.float64,
                               device=dev)
            else:
                raise ValueError(f"exact solution {mix['exact']!r}")
            self.b[j] = A.matvec(u)
        self.order = list(range(mix["systems"]))
        random.Random(f"perfbench-order:{seed}").shuffle(self.order)
        self._iterate: dict = {}

    def system(self, index: int) -> int:
        return self.order[index % len(self.order)]

    def rhs(self, index: int) -> torch.Tensor:
        """Solve ``index``'s right-hand side, ``(n,)`` float32."""
        return self.b[self.system(index)]

    def met_stop(self, iters: int, rel: float) -> bool:
        """Whether a solve that reports ``iters`` and its recursive
        relative residual ``rel`` kept the mix's stopping rule."""
        if self.judged == "iterate_rel_error":
            return iters == self.maxiter
        return rel <= self.tol and iters < self.maxiter

    def judge(self, A: DeviceCSR, index: int, x: torch.Tensor) -> float:
        """The number compared for solve ``index``'s answer ``x``
        (``(n,)``), with ``A`` in float64."""
        b = self.rhs(index)
        if self.judged == "true_rel_residual":
            return true_residual(A, b, x)
        j = self.system(index)
        if j not in self._iterate:
            self._iterate[j] = pcg(A, b, 0.0, self.maxiter)[0]
        ref = self._iterate[j]
        return float(torch.linalg.vector_norm(x.to(torch.float64) - ref)
                     / torch.linalg.vector_norm(ref))


class Reservoir:
    """A uniform sample of ``k`` of the window's solves, drawn from the
    seed as they complete (reservoir sampling): ``offer(index)`` returns
    the slot to keep solve ``index`` in, or ``None``."""

    def __init__(self, k: int, seed: int):
        self.k, self.seen = k, 0
        self.rng = random.Random(f"perfbench-sample:{seed}")
        self.slots: list = [None] * k

    def offer(self, index: int) -> int | None:
        self.seen += 1
        if self.seen <= self.k:
            slot = self.seen - 1
        else:
            slot = self.rng.randrange(self.seen)
            if slot >= self.k:
                return None
        self.slots[slot] = index
        return slot

    def kept(self) -> list:
        """``(slot, solve index)`` of every kept solve."""
        return [(s, i) for s, i in enumerate(self.slots) if i is not None]


def drive(plan, g, load: Traffic, cfg: dict, job: dict, device) -> dict:
    """Warm up, run the window, and (``job["trace"]``) profile one more
    solve and time the SpMV.  ``g`` is the layout's ``global_row_of``.
    Returns the raw record: iterations and seconds of every window solve,
    the kept answers (blocks of the solver's layout), the peak, the
    profile."""
    from repro_torch import solvers
    from repro_torch.core import make_spmv

    system.plant(job.get("plant"))
    s = cfg["solver"]
    solve = solvers.make_solver(plan, solver=s["solver"],
                                precond=s["precond"],
                                check_every=s["check_every"])
    place = system.Placement(g, device)
    k = load.mix["checked_solves"]
    keep = torch.zeros((k,) + tuple(plan.cg_shape), dtype=torch.float32,
                       device=device)
    res = Reservoir(k, load.seed)
    rec = {"iters": [], "rels": [], "solve_wall_s": [], "late": 0,
           "kept": {}}

    def one(index: int):
        x, it, rel = solve(place(load.rhs(index)), tol=load.tol,
                           maxiter=load.maxiter)
        return x, int(it), float(rel)

    def peak() -> int:
        return (torch.cuda.max_memory_allocated(device)
                if device.type == "cuda" else 0)

    try:
        for w in range(load.mix["warmup_solves"]):
            with system.deadline(job["warmup_grace_s"]):
                one(w)
    except system.Late:
        rec.update(late=rec["late"] + 1, peak_bytes=peak())
        return rec
    timing.sync(device)
    rec["window_start_time"] = time.time()
    t0 = time.perf_counter()
    index = 0
    try:
        with system.deadline(job["seconds"] + job["grace_s"]):
            while time.perf_counter() - t0 < job["seconds"]:
                ts = time.perf_counter()
                x, it, rel = one(index)
                rec["solve_wall_s"].append(time.perf_counter() - ts)
                rec["iters"].append(it)
                rec["rels"].append(rel)
                slot = res.offer(index)
                if slot is not None:
                    keep[slot].copy_(x)
                index += 1
    except system.Late:
        rec["late"] += 1
    timing.sync(device)
    rec["window_s"] = time.perf_counter() - t0
    rec["solves"] = len(rec["iters"])
    rec["peak_bytes"] = peak()
    rec["kept"] = {i: keep[slot].cpu().numpy() for slot, i in res.kept()}
    del keep
    if job["trace"] and not rec["late"]:
        # the card's busy share from a trace of the card alone; the host's
        # part in the idle gaps from a second solve traced on both sides
        prof = timing.profile_call(lambda: one(index), device, host=False)
        both = timing.profile_call(lambda: one(index + 1), device, host=True)
        rec["profile"] = {kk: v for kk, v in prof.items() if kk != "result"}
        rec["profile"].update(iters=prof["result"][1],
                              idle_gaps=both["idle_gaps"])
        spmv = make_spmv(plan)
        xd = place(load.rhs(index + 2))
        rec["spmv_ms"] = timing.loop_ms(lambda: spmv(xd), device,
                                        calls=job["spmv_calls"])
        del spmv, xd
    del solve
    return rec


def check(load: Traffic, A: DeviceCSR, answers: dict, rec: dict,
          cfg: dict) -> dict:
    """The comparison that decides ``correct``: each kept answer
    (``answers``: solve index -> ``(n,)`` on the device) judged against
    the configuration's limit on the mix's number; every window solve kept
    the stopping rule by the program's own report; none late.  Sets
    ``rec["wrong"]``."""
    limit = cfg["check"][load.judged]
    readings = [load.judge(A, i, x) for i, x in sorted(answers.items())]
    rec["wrong"] = sum(1 for r in readings if not r <= limit)
    off_rule = sum(1 for it, rel in zip(rec.get("iters", []),
                                        rec.get("rels", []))
                   if not load.met_stop(it, rel))
    return {load.judged: {"value": max(readings, default=float("nan")),
                          "limit": limit,
                          "ok": bool(readings) and rec["wrong"] == 0},
            "checked_solves": {"value": len(answers), "limit": 1,
                               "ok": len(answers) >= 1},
            "unconverged_solves": {"value": off_rule, "limit": 0,
                                   "ok": off_rule == 0},
            "late_solves": {"value": rec["late"], "limit": 0,
                            "ok": rec["late"] == 0}}
