"""Hot-path tracing: nestable spans with a Perfetto/chrome-tracing export.

Port of ``repro/obs/tracing.py``. Spans are recorded as chrome-tracing
*complete events* (``"ph": "X"``) with microsecond timestamps, so the
export loads directly in Perfetto (https://ui.perfetto.dev) or
``chrome://tracing``. Nesting comes for free: chrome's trace viewer stacks
events on the same tid by containment, and a thread-local depth counter is
recorded in ``args.depth`` for tools that want it explicitly.

Disabled (the default), :func:`span` returns a shared null context — one
boolean read per call site, no allocation, no clock reads — so tracing can
stay compiled into every hot path.

**One clock.** Spans, :func:`instant` markers and CREAM-Lens's access
records (:mod:`repro_torch.obs.memprof`) are stamped by :func:`now_us`:
Unix time in microseconds, the clock of ``torch.profiler``'s Chrome trace,
whose ``ts`` is Unix time less the trace's ``baseTimeNanoseconds``. A
span's ``ts`` less ``baseTimeNanoseconds / 1e3`` falls within its profiler
range. Checked by
``tests/test_torch_tracing_profiler.py`` on the CPU (within 2 ms) and on
the card by profiling a span around CUDA work with CUDA activity on and
comparing the span's ``ts`` with its range's (under 1 ms).

**Profiler ranges.** While tracing is on, each span also enters
``torch.profiler.record_function(name)``: under the torch profiler it is a
``user_annotation`` range of the same name, and every device operation
launched inside it carries its correlation id.

PyTorch queues work on the card and returns. The reference waits for a
span's device work with ``jax.block_until_ready``; here :func:`blocked_span`
and :func:`traced_call` record a ``torch.cuda.Event`` on the current stream
of each held CUDA tensor's device and close the span once those events
have completed (CPU tensors are complete when they exist). A blocking span
synchronises the host with the card: the spans split a step's time by
phase, and a traced step is not the same step untraced. With tracing
disabled nothing records an event and nothing synchronises, and while the
torch profiler records (``torch.autograd._profiler_enabled()``) nothing
does either: the profiler times the device work itself, and a step traced
under it is the step untraced.
"""
from __future__ import annotations

import contextlib
import json
import os
import threading
import time

import torch


class _NullSpan:
    """Shared do-nothing context for the disabled path."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL = _NullSpan()


def now_us() -> float:
    """Microseconds on the trace's clock: Unix time, as the torch
    profiler's Chrome trace stamps (before its ``baseTimeNanoseconds`` is
    taken off)."""
    return time.time_ns() / 1e3


def _profiling() -> bool:
    return torch.autograd._profiler_enabled()


class _Span:
    __slots__ = ("tracer", "name", "args", "t0", "rf")

    def __init__(self, tracer: "Tracer", name: str, args: dict):
        self.tracer = tracer
        self.name = name
        self.args = args

    def __enter__(self):
        tl = self.tracer._tls
        tl.depth = getattr(tl, "depth", 0) + 1
        # the clock is read inside the profiler range, which takes a while
        # to open: the span then lies within its range
        self.rf = torch.profiler.record_function(self.name)
        self.rf.__enter__()
        self.t0 = now_us()
        return self

    def __exit__(self, *exc):
        dur_us = now_us() - self.t0
        self.rf.__exit__(None, None, None)
        tl = self.tracer._tls
        depth = getattr(tl, "depth", 1)
        tl.depth = depth - 1
        args = dict(self.args)
        args["depth"] = depth - 1
        self.tracer._events.append({
            "name": self.name, "ph": "X", "cat": "cream",
            "ts": self.t0, "dur": dur_us,
            "pid": os.getpid(), "tid": threading.get_ident(),
            "args": args,
        })
        return False


class Tracer:
    """An event buffer. The process-global one is :data:`TRACER`."""

    def __init__(self, enabled: bool = False):
        self.enabled = enabled
        self._events: list[dict] = []
        self._tls = threading.local()

    def span(self, name: str, **args):
        if not self.enabled:
            return _NULL
        return _Span(self, name, args)

    def instant(self, name: str, **args) -> None:
        """A zero-duration marker event."""
        if not self.enabled:
            return
        self._events.append({
            "name": name, "ph": "i", "cat": "cream", "s": "t",
            "ts": now_us(),
            "pid": os.getpid(), "tid": threading.get_ident(),
            "args": args,
        })

    @property
    def events(self) -> list[dict]:
        return self._events

    def extend(self, events: list[dict]) -> None:
        """Append pre-built chrome-tracing events (e.g. CREAM-Lens counter
        tracks, ``"ph": "C"``) so they export alongside the spans.
        Unconditional: exporters inject into a buffer they already own."""
        self._events.extend(events)

    def reset(self) -> None:
        self._events = []

    def to_dict(self) -> dict:
        return {"traceEvents": list(self._events),
                "displayTimeUnit": "ms"}

    def to_json(self) -> str:
        return json.dumps(self.to_dict())

    def export(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.to_dict(), f)

    def span_names(self) -> set[str]:
        return {e["name"] for e in self._events}


#: The process-global tracer every subsystem emits into.
TRACER = Tracer(enabled=False)


def enabled() -> bool:
    return TRACER.enabled


def enable(on: bool = True) -> None:
    TRACER.enabled = on


def disable() -> None:
    TRACER.enabled = False


def span(name: str, **args):
    """Open a span on the global tracer (null context when disabled)."""
    if not TRACER.enabled:
        return _NULL
    return _Span(TRACER, name, args)


def instant(name: str, **args) -> None:
    TRACER.instant(name, **args)


def reset() -> None:
    TRACER.reset()


def export(path: str) -> None:
    TRACER.export(path)


def _events_for(values) -> list:
    """A completion event on the current stream of each CUDA tensor in
    ``values`` (a tensor, or nested tuples / lists / dicts of them)."""
    if isinstance(values, torch.Tensor):
        if values.device.type != "cuda":
            return []
        ev = torch.cuda.Event()
        ev.record(torch.cuda.current_stream(values.device))
        return [ev]
    if isinstance(values, dict):
        values = list(values.values())
    if isinstance(values, (list, tuple)):
        return [ev for v in values for ev in _events_for(v)]
    return []


def traced_call(name: str, fn, *args, **kwargs):
    """Run ``fn`` under dispatch / block_until_ready spans.

    ``<name>.dispatch`` covers the host's work up to the launches;
    ``<name>.block_until_ready`` covers the wait for the device work of
    the tensors ``fn`` returns. With tracing disabled this is a plain
    call — no events, no waiting — so it is safe on hot paths; under the
    torch profiler the second span waits for nothing.
    """
    if not TRACER.enabled:
        return fn(*args, **kwargs)
    with span(f"{name}.dispatch"):
        out = fn(*args, **kwargs)
    with span(f"{name}.block_until_ready"):
        if not _profiling():
            for ev in _events_for(out):
                ev.synchronize()
    return out


def _no_hold(*_) -> None:
    return None


@contextlib.contextmanager
def blocked_span(name: str, **args):
    """Span that waits for the device work of the values the body hands
    back via ``hold``.

    Usage::

        with blocked_span("engine.step.gather") as hold:
            pages = pool.read(phys)
            hold(pages)

    ``hold(t)`` records an event on the current stream of each held CUDA
    tensor's device; the span closes after those events have completed,
    so its duration covers device execution, not just the launches. When
    tracing is disabled the body still runs; ``hold`` is a no-op and
    nothing waits. Under the torch profiler the span is a plain one:
    ``hold`` is a no-op and the profiler times the device work.
    """
    if not TRACER.enabled:
        yield _no_hold
        return
    if _profiling():
        with span(name, **args):
            yield _no_hold
        return
    with span(name, **args):
        events: list = []
        yield lambda *values: events.extend(_events_for(values))
        for ev in events:
            ev.synchronize()
