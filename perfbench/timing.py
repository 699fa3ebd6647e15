"""Timing helpers: CUDA events over back-to-back calls, and one call under
``torch.profiler`` reduced to busy time, idle gaps and top device ops.

The profiler's summary is what the ``--trace 1`` run's per-layer readers
and its ``breakdown`` read.  Busy time is the union of the device
operations' intervals (kernels, copies, fills) inside the traced window;
an idle gap is a stretch of that window in which none runs, named by the
innermost host operation in progress at its midpoint.
"""
from __future__ import annotations

import time
from collections import defaultdict

import torch

__all__ = ["loop_ms", "profile_call", "sync"]

#: the host span around the profiled call; gaps inside no other host op
#: are named after it
SPAN = "perfbench.traced_call"


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def loop_ms(fn, device: torch.device, calls: int, warmup: int = 3) -> float:
    """Milliseconds per call of ``fn()``, ``calls`` calls back to back
    between two CUDA events (the host clock on a CPU), after ``warmup``
    calls."""
    for _ in range(warmup):
        fn()
    sync(device)
    if device.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        return (time.perf_counter() - t0) * 1e3 / calls
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(calls):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / calls


def _union(intervals: list) -> tuple[float, list]:
    """Total length of the union of ``(start, end)`` intervals, and the
    merged intervals in order."""
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return sum(e - s for s, e in merged), merged


def _host_at(host: list, points: list) -> list:
    """For each time in ``points`` (ascending), the name of the innermost
    host event covering it.  ``host`` holds ``(start, end, name)`` of one
    thread's events, which nest."""
    host = sorted(host, key=lambda h: (h[0], -h[1]))
    out, stack, j = [], [], 0
    for t in points:
        while j < len(host) and host[j][0] <= t:
            while stack and stack[-1][1] < host[j][0]:
                stack.pop()
            stack.append(host[j])
            j += 1
        while stack and stack[-1][1] < t:
            stack.pop()
        out.append(stack[-1][2] if stack else SPAN)
    return out


def profile_call(fn, device: torch.device, host: bool, top: int = 10
                 ) -> dict:
    """``fn()`` once under ``torch.profiler``, then a synchronise.

    ``host=False`` traces the card alone, which costs the host next to
    nothing: ``window_s`` is then the host clock around the call.
    ``host=True`` traces host operations too (which slows the host's
    side of the call), ``window_s`` being the host span around it.
    Returns ``window_s``, ``busy_s`` (the union of device operations
    inside the window), ``launches`` (device operations), ``device_ops``
    (seconds by name, the ``top`` largest), ``idle_gaps`` (with ``host``:
    idle seconds by the host operation in progress, the ``top`` largest)
    and ``result``, what ``fn`` returned."""
    from torch.profiler import ProfilerActivity, profile, record_function

    acts = [ProfilerActivity.CUDA] if device.type == "cuda" else []
    if host or not acts:
        acts.append(ProfilerActivity.CPU)
    sync(device)
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        with record_function(SPAN):
            result = fn()
            sync(device)
        wall = time.perf_counter() - t0
    events = prof.events()
    cpu = torch.autograd.DeviceType.CPU
    span = next((ev for ev in events
                 if ev.name == SPAN and ev.device_type == cpu), None)
    dev, hosts = [], []
    by_op = defaultdict(float)
    for ev in events:
        s, e = ev.time_range.start, ev.time_range.end
        if ev.name == SPAN or getattr(ev, "is_user_annotation", False):
            continue            # the span's own mirror on the device
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            dev.append((s, e))
            by_op[ev.name] += (e - s) / 1e6
        elif span is not None and ev.thread == span.thread:
            hosts.append((s, e, ev.name))
    if span is not None:
        w0, w1 = span.time_range.start, span.time_range.end
        dev = [(max(s, w0), min(e, w1)) for s, e in dev
               if min(e, w1) > max(s, w0)]
    busy, merged = _union(dev)
    by_gap = defaultdict(float)
    if host and span is not None:
        gaps, edge = [], w0
        for s, e in merged:
            if s > edge:
                gaps.append((edge, s))
            edge = max(edge, e)
        if w1 > edge:
            gaps.append((edge, w1))
        names = _host_at(hosts, [(s + e) / 2 for s, e in gaps])
        for (s, e), name in zip(gaps, names):
            by_gap[name] += (e - s) / 1e6

    def largest(d: dict) -> list:
        return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])
                ][:top]

    return {"window_s": (w1 - w0) / 1e6 if span is not None else wall,
            "busy_s": busy / 1e6, "launches": len(dev),
            "device_ops": largest(by_op), "idle_gaps": largest(by_gap),
            "result": result}
