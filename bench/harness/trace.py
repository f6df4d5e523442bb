"""The traced run's device timeline, from ``torch.profiler``.

In a ``--trace 1`` run the harness opens a host range (``record_function``)
around each call it makes into a layer of the program: ``bench.admit``
(the scheduler's admission pass), ``bench.prefill``, ``bench.gather``,
``bench.compute``, ``bench.scatter`` (the pool write of a decode step),
``bench.swap`` (a preemption to the host tier or a restore), and
``bench.step`` around the rest of a decode step (its bookkeeping and the
read-back of the next tokens); ``bench.client`` covers the client loop.
The profiler records a slice of the window; its Chrome trace gives every
device operation with the correlation id of the call that launched it,
so each operation is charged to the innermost range open on the host when
it was launched, and each idle gap to the range open when it began.
"""
from __future__ import annotations

import bisect
import json
import os
import tempfile
from collections import defaultdict

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


class Timeline:
    """Device operations ``(name, start_us, dur_us, range)`` and host
    ranges of one traced slice."""

    def __init__(self, ops: list[tuple], window_us: tuple[float, float],
                 innermost):
        self.ops = ops
        self.t0, self.t1 = window_us
        self.innermost = innermost      # host time -> the open range

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) / 1e6

    def busy_intervals(self) -> list[tuple[float, float]]:
        spans = sorted((s, s + d) for _, s, d, _ in self.ops)
        merged: list[list[float]] = []
        for s, e in spans:
            s, e = max(s, self.t0), min(e, self.t1)
            if e <= s:
                continue
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        return [tuple(m) for m in merged]

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals()) / 1e6

    def device_s(self, where=lambda op: True) -> float:
        return sum(d for op in self.ops if where(op)
                   for d in [op[2]]) / 1e6

    def count(self, where=lambda op: True) -> int:
        return sum(1 for op in self.ops if where(op))


def from_chrome(trace: dict, window_us=None) -> Timeline:
    """Reduce a Chrome trace to the slice's timeline."""
    events = [e for e in trace.get("traceEvents", []) if e.get("ph") == "X"]
    ranges = sorted((e["ts"], e["ts"] + e["dur"], e["name"]) for e in events
                    if e.get("cat") == "user_annotation"
                    and e["name"].startswith("bench.")
                    and e["name"] != "bench.window")
    launch = {}
    for e in events:
        if e.get("cat") == "cuda_runtime" and "correlation" in e.get(
                "args", {}):
            launch[e["args"]["correlation"]] = e["ts"]
    starts = [r[0] for r in ranges]

    def innermost(t: float) -> str:
        best = "bench.client"
        i = bisect.bisect_right(starts, t)
        width = float("inf")
        for s, end, name in ranges[max(0, i - 64):i]:
            if s <= t <= end and end - s < width:
                best, width = name, end - s
        return best

    ops = []
    for e in events:
        if e.get("cat") not in DEVICE_CATS:
            continue
        at = launch.get(e.get("args", {}).get("correlation"), e["ts"])
        ops.append((e["name"], float(e["ts"]), float(e["dur"]),
                    innermost(at)))
    if window_us is None:
        window_us = (min(r[0] for r in ranges), max(r[1] for r in ranges))
    return Timeline(ops, window_us, innermost)


def from_profiler(prof) -> Timeline:
    """Export the profiler's Chrome trace to a temporary file and reduce
    it; the window is the span of the harness's ``bench.window`` range."""
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            trace = json.load(f)
    finally:
        os.unlink(path)
    marks = [e for e in trace.get("traceEvents", [])
             if e.get("ph") == "X" and e.get("name") == "bench.window"]
    window = (marks[0]["ts"], marks[0]["ts"] + marks[0]["dur"]) \
        if marks else None
    return from_chrome(trace, window)


def breakdown(tl: Timeline, top: int = 10) -> dict:
    """The device operations that took most time, and the idle time by the
    host range open when each gap began."""
    by_op: dict[str, float] = defaultdict(float)
    for name, _, dur, _ in tl.ops:
        by_op[name[:120]] += dur / 1e6
    idle: dict[str, float] = defaultdict(float)
    prev = tl.t0
    for s, e in tl.busy_intervals() + [(tl.t1, tl.t1)]:
        if s > prev:
            idle[tl.innermost(prev)] += (s - prev) / 1e6
        prev = max(prev, e)
    return dict(
        device_ops=[[k, v] for k, v in sorted(by_op.items(),
                                              key=lambda kv: -kv[1])[:top]],
        idle_gaps=[[k, v] for k, v in sorted(idle.items(),
                                             key=lambda kv: -kv[1])[:top]])
