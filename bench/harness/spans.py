"""The program's own spans on a traced slice's device timeline.

While the program's tracer (``repro_torch.obs.tracing``) is on, each of its
spans is also a profiler range (a ``user_annotation`` in the Chrome trace)
named without the harness's ``bench.`` prefix: ``engine.poll``,
``sched.tick``, ``engine.step`` and its phases, ``engine.prefill`` and
its, ``model.attn`` / ``.mlp`` / ``.moe`` / ``.head``. This module keeps
them beside the harness's timeline (:func:`trace.from_chrome`, which reads
the ``bench.*`` ranges alone and is not changed by them) and charges each
device operation to the chain of program spans open when it was launched,
found by a sweep with a stack over the ranges sorted by start, however
many ranges opened in between. A launch is a ``cuda_runtime`` call or, as
cuBLAS launches, a ``cuda_driver`` one.

:class:`ProgramTracer` is the harness's slice tracer with the program's
tracer on for the slice; ``bench/spans.py`` runs a cell with it.
"""
from __future__ import annotations

import json
import os
import statistics
import tempfile
from collections import defaultdict

from harness import runner, trace

LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
NO_SPAN = "none"            # outside every program span


def open_chains(spans: list[tuple], times: list[float]) -> list[tuple]:
    """For each host time, the names of the program spans open at it,
    outermost first. ``spans`` are ``(start, end, name)`` sorted by start,
    the longer first on a tie; ranges of one thread nest, so one sweep
    with a stack finds every enclosing span."""
    out: list[tuple] = [()] * len(times)
    stack: list[tuple] = []
    j = 0
    for i in sorted(range(len(times)), key=times.__getitem__):
        t = times[i]
        while j < len(spans) and spans[j][0] <= t:
            while stack and stack[-1][1] < spans[j][1]:
                stack.pop()
            stack.append(spans[j])
            j += 1
        while stack and stack[-1][1] < t:
            stack.pop()
        out[i] = tuple(sp[2] for sp in stack)
    return out


def _window(chrome: dict):
    marks = [e for e in chrome.get("traceEvents", [])
             if e.get("ph") == "X" and e.get("name") == "bench.window"]
    return (marks[0]["ts"], marks[0]["ts"] + marks[0]["dur"]) \
        if marks else None


class Program:
    """The harness's timeline ``tl`` of a slice, its program spans
    ``(start_us, end_us, name)``, for each of ``tl.ops`` the chain of
    program spans open at its launch, and the durations of the harness's
    ``bench.step`` ranges."""

    def __init__(self, tl: trace.Timeline, spans: list[tuple],
                 chains: list[tuple], bench_steps_us: list[float]):
        self.tl, self.spans, self.chains = tl, spans, chains
        self.bench_steps_us = bench_steps_us

    def idle_gaps(self) -> list[tuple[float, float]]:
        """``(start_us, length_us)`` of each stretch of the slice with no
        device operation."""
        gaps = []
        prev = self.tl.t0
        for s, e in self.tl.busy_intervals() + [(self.tl.t1, self.tl.t1)]:
            if s > prev:
                gaps.append((prev, s - prev))
            prev = max(prev, e)
        return gaps

    def device_s(self, name: str) -> float:
        """Device seconds of the operations launched inside a program span
        of this name, at any depth."""
        return sum(op[2] for op, chain in zip(self.tl.ops, self.chains)
                   if name in chain) / 1e6

    def durations_us(self, name: str, less: str) -> list[float]:
        """Each span of this name's duration, less the durations of the
        spans named ``less`` that start inside it."""
        inner = sorted((s, e) for s, e, n in self.spans if n == less)
        return [(e - s) - sum(b - a for a, b in inner if s <= a <= e)
                for s, e, n in self.spans if n == name]

    def share(self, name: str) -> float | None:
        """Device time launched inside ``name`` over the busy time, %."""
        busy = self.tl.busy_s
        return 100.0 * self.device_s(name) / busy \
            if self.spans and busy > 0 else None

    def host_ms_per_step(self) -> float | None:
        """Median over the slice's decode steps of ``engine.step`` less its
        ``engine.step.readback`` (the step's one wait for the card): the
        host's own work a step, launches included."""
        steps = self.durations_us("engine.step", less="engine.step.readback")
        return statistics.median(steps) / 1e3 if steps else None

    def readings(self) -> dict:
        return {"engine.unpack_share": self.share("engine.step.unpack"),
                "model.attn_share": self.share("model.attn"),
                "model.moe_share": self.share("model.moe"),
                "engine.host_ms_per_step": self.host_ms_per_step()}

    def by_span(self, top: int = 12) -> dict:
        """Device seconds by the innermost program span open at each
        operation's launch, and idle seconds by the innermost program span
        open when each gap began (``"none"``: outside every span)."""
        device: dict[str, float] = defaultdict(float)
        for op, chain in zip(self.tl.ops, self.chains):
            device[chain[-1] if chain else NO_SPAN] += op[2] / 1e6
        gaps = self.idle_gaps()
        idle: dict[str, float] = defaultdict(float)
        for (_, length), chain in zip(gaps, open_chains(
                self.spans, [g[0] for g in gaps])):
            idle[chain[-1] if chain else NO_SPAN] += length / 1e6
        return {k: [[n, v] for n, v in sorted(d.items(),
                                               key=lambda kv: -kv[1])[:top]]
                for k, d in (("device", device), ("idle", idle))}


def from_chrome(chrome: dict, window_us=None) -> Program:
    """Reduce a Chrome trace to the harness's timeline and the program's
    spans on it; the window is the ``bench.window`` range's unless given."""
    window_us = window_us or _window(chrome)
    tl = trace.from_chrome(chrome, window_us)
    events = [e for e in chrome.get("traceEvents", []) if e.get("ph") == "X"]
    spans = sorted(((e["ts"], e["ts"] + e["dur"], e["name"])
                    for e in events if e.get("cat") == "user_annotation"
                    and not e["name"].startswith("bench.")),
                   key=lambda r: (r[0], -r[1]))
    called = {e["args"]["correlation"]: e["ts"] for e in events
              if e.get("cat") in LAUNCH_CATS
              and "correlation" in e.get("args", {})}
    # the operations in ``tl.ops``'s order
    launched = [called.get(e.get("args", {}).get("correlation"), e["ts"])
                for e in events if e.get("cat") in trace.DEVICE_CATS]
    steps = [e["dur"] for e in events if e.get("cat") == "user_annotation"
             and e["name"] == "bench.step"]
    return Program(tl, spans, open_chains(spans, launched), steps)


def export(prof) -> dict:
    """The profiler's Chrome trace, through a temporary file."""
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            return json.load(f)
    finally:
        os.unlink(path)


class ProgramTracer(runner._Tracer):
    """The harness's slice tracer with the program's tracer on while the
    profiler records the slice (``program`` True), and off, its buffer
    reset, at the slice's end. ``last`` holds the last slice's
    :class:`Program`."""

    program = True
    last: Program | None = None

    def start(self) -> None:
        super().start()
        if self.program:
            from repro_torch.obs import tracing
            tracing.enable()

    def stop(self) -> None:
        if self.active and self.program:
            from repro_torch.obs import tracing
            tracing.disable()
            tracing.reset()
        super().stop()

    def finish(self) -> None:
        if self.prof is not None:
            chrome = export(self.prof)
            type(self).last = from_chrome(chrome)
            # a profiler exports its trace once: the harness's reduction
            # reads the same trace again
            self.prof = _Exported(chrome)
        super().finish()


class _Exported:
    """A profiler's trace already exported, exported again on demand."""

    def __init__(self, chrome: dict):
        self.chrome = chrome

    def export_chrome_trace(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.chrome, f)
