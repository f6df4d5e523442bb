"""The port's spans under the torch profiler, and the serving step's and
the model's spans.

  * a span is a ``user_annotation`` range of the same name in the
    profiler's Chrome trace, holding the operations run inside it; its
    ``ts`` and a CREAM-Lens record taken inside it lie on the trace's
    clock (``baseTimeNanoseconds`` put back);
  * under the profiler, blocking spans and ``traced_call`` record no CUDA
    event (the profiler times the device work);
  * a dense and an MoE engine on the CPU with tracing on emit each of the
    step's, the prefill's and the model's spans as often as the table of
    ``tests/torch_spans.py`` says, nested by containment as it says; the
    tokens equal those of tracing off, which records nothing.
"""
from __future__ import annotations

import collections
import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch import obs
from repro_torch.configs import ModelConfig, get_config
from repro_torch.core.layouts import Layout
from repro_torch.serve import Engine, ServeRequest

sys.path.insert(0, str(Path(__file__).resolve().parent))

from torch_spans import PORT_SPANS, parents  # noqa: E402

SERVE_TEST = dict(name="serve-test", family="dense", num_layers=2,
                  d_model=64, num_heads=4, num_kv_heads=2, d_ff=128,
                  vocab_size=256, head_dim=16, dtype="float32")
CLOCK_US = 2000.0           # the CPU's bound on span against range


@pytest.fixture(autouse=True)
def _planes():
    def reset():
        obs.tracing.disable()
        obs.tracing.reset()
        obs.memprof.disable()
        obs.memprof.clear()
    reset()
    yield
    reset()


def _chrome(prof, tmp_path) -> dict:
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    return json.loads(path.read_text())


def test_a_span_is_a_profiler_range_on_the_trace_clock(tmp_path):
    # the profiler's first range in a process sets it up inside the range
    # (about 1 ms idle, several on a loaded host) before the span reads the
    # clock; the benchmark opens its own ranges first, as this warm-up does
    with profile(activities=[ProfilerActivity.CPU]):
        with torch.profiler.record_function("warm"):
            torch.ones(64).sum()
    obs.tracing.enable()
    obs.memprof.enable()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with obs.tracing.span("probe", pages=4):
            torch.ones(64).sum()
            obs.memprof.PROFILER.record(
                "gather", np.arange(4), layout=Layout.INTERWRAP,
                num_rows=32, boundary=16)
    trace = _chrome(prof, tmp_path)
    base_us = trace["baseTimeNanoseconds"] / 1e3
    ranges = [e for e in trace["traceEvents"] if e.get("ph") == "X"
              and e.get("cat") == "user_annotation"
              and e["name"] == "probe"]
    assert len(ranges) == 1
    rng = ranges[0]
    ops = [e for e in trace["traceEvents"] if e.get("ph") == "X"
           and e.get("cat") == "cpu_op" and e["name"] == "aten::sum"]
    assert ops
    for op in ops:
        assert rng["ts"] <= op["ts"]
        assert op["ts"] + op["dur"] <= rng["ts"] + rng["dur"]
    (span,) = obs.tracing.TRACER.events
    assert span["name"] == "probe" and span["args"]["pages"] == 4
    assert abs(span["ts"] - base_us - rng["ts"]) < CLOCK_US
    assert abs(span["ts"] + span["dur"] - base_us
               - rng["ts"] - rng["dur"]) < CLOCK_US
    (rec,) = obs.memprof.records()
    assert span["ts"] - CLOCK_US <= rec.t_us
    assert rec.t_us <= span["ts"] + span["dur"] + CLOCK_US
    # a marker between two spans stamps between them
    obs.tracing.instant("mark")
    with obs.tracing.span("later"):
        pass
    _, mark, later = obs.tracing.TRACER.events
    assert span["ts"] + span["dur"] <= mark["ts"] <= later["ts"]


def test_tracing_off_enters_no_profiler_range(tmp_path):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with obs.tracing.span("quiet"):
            torch.ones(4).sum()
    names = {e["name"] for e in _chrome(prof, tmp_path)["traceEvents"]}
    assert "quiet" not in names
    assert obs.tracing.TRACER.events == []


class _FakeCuda(torch.Tensor):
    """A CPU tensor that says it lives on the card, so that the tracer
    would record a completion event for it."""

    @property
    def device(self):
        return torch.device("cuda", 0)


def _stub_events(monkeypatch) -> list:
    made: list = []

    class Event:
        def __init__(self):
            made.append(self)

        def record(self, stream):
            pass

        def synchronize(self):
            pass
    monkeypatch.setattr(torch.cuda, "Event", Event)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda dev: None)
    return made


def _blocking(held) -> None:
    with obs.tracing.blocked_span("held") as hold:
        hold(held)
    obs.tracing.traced_call("call", lambda: held)


def test_profiled_blocking_spans_record_no_cuda_event(monkeypatch):
    made = _stub_events(monkeypatch)
    held = torch.Tensor._make_subclass(_FakeCuda, torch.zeros(2))
    obs.tracing.enable()
    _blocking(held)
    assert len(made) == 2           # the stub sees what the tracer records
    made.clear()
    with profile(activities=[ProfilerActivity.CPU]):
        _blocking(held)
    assert made == []
    assert [e["name"] for e in obs.tracing.TRACER.events][-3:] == [
        "held", "call.dispatch", "call.block_until_ready"]


# ---------------------------------------------------------------------------
# The engine's and the model's spans
# ---------------------------------------------------------------------------


def _dense():
    return Engine(ModelConfig(**SERVE_TEST), max_batch=4, max_len=32,
                  mode="cream", num_rows=32, row_words=64, secded_rows=8,
                  seed=0, device="cpu")


def _moe():
    cfg = get_config("olmoe-1b-7b").smoke()
    return Engine(cfg, max_batch=4, max_len=32, mode="cream", num_rows=48,
                  row_words=2 * cfg.num_kv_heads * cfg.head_dim_, seed=0,
                  device="cpu")


ENGINES = {"dense": (_dense, "model.mlp"), "moe": (_moe, "model.moe")}


def _serve(make) -> tuple[list, list, int, int]:
    """Serve 6 requests to the end -> (tokens, the tracer's events, polls,
    decode steps)."""
    eng = make()
    rng = np.random.default_rng(3)
    reqs = [ServeRequest(f"s{i}", rng.integers(0, 256, 10).astype(np.int32),
                         6) for i in range(6)]
    for r in reqs:
        eng.submit(r)
    polls = 0
    while eng.sched.has_work():
        eng.poll()
        polls += 1
    return ([r.generated for r in reqs], list(obs.tracing.TRACER.events),
            polls, eng.steps)


@pytest.mark.parametrize("family", list(ENGINES))
def test_engine_spans_count_and_nest_as_the_table_says(family):
    make, mixer = ENGINES[family]
    tokens_off, events_off, _, _ = _serve(make)
    assert events_off == []
    obs.tracing.enable()
    tokens, events, polls, steps = _serve(make)
    assert tokens == tokens_off
    n_layers = make().n_layers
    count = collections.Counter(e["name"] for e in events)
    prefills = count["engine.prefill"]
    assert steps > 0 and prefills == 6
    assert count["engine.poll"] == count["sched.tick"] == polls
    for name in ("engine.step", "engine.step.unpack", "engine.step.model",
                 "engine.step.insert", "engine.step.readback",
                 "engine.step.gather", "engine.step.compute",
                 "engine.step.scatter"):
        assert count[name] == steps, name
    for name in ("engine.prefill.model", "engine.prefill.pack",
                 "engine.prefill.write"):
        assert count[name] == prefills, name
    forwards = steps + prefills
    assert count["model.attn"] == count[mixer] == n_layers * forwards
    assert count["model.head"] == forwards
    other = "model.moe" if mixer == "model.mlp" else "model.mlp"
    assert count[other] == 0
    moe = [e for e in events if e["name"] == "model.moe"]
    assert all(e["args"]["tokens"] > 0 for e in moe)
    assert sorted({e["args"]["layer"] for e in events
                   if e["name"] == "model.attn"}) == list(range(n_layers))

    # nesting by containment, as the table says
    up = parents(events)
    inner: dict = collections.defaultdict(collections.Counter)
    for e, p in zip(events, up):
        want = PORT_SPANS.get(e["name"])
        got = None if p is None else p["name"]
        if e["name"] in PORT_SPANS:
            assert got in (want if isinstance(want, tuple) else (want,)), \
                (e["name"], got)
        if p is not None:
            inner[id(p)][e["name"]] += 1
    for e in events:
        kids = inner[id(e)]
        if e["name"] == "engine.step":
            assert kids["engine.step.readback"] == 1
            assert kids["engine.step.compute"] == 1
        elif e["name"] == "engine.step.compute":
            assert [kids[n] for n in ("engine.step.unpack",
                                      "engine.step.model",
                                      "engine.step.insert")] == [1, 1, 1]
        elif e["name"] in ("engine.step.model", "engine.prefill.model"):
            assert kids == {"model.attn": n_layers, mixer: n_layers,
                            "model.head": 1}
        elif e["name"] == "engine.prefill":
            assert kids == {"engine.prefill.model": 1,
                            "engine.prefill.pack": 1,
                            "engine.prefill.write": 1}
        elif e["name"] == "engine.poll":
            assert kids["sched.tick"] == 1 and kids["engine.step"] <= 1


def test_engine_spans_are_profiler_ranges_holding_the_steps_work(tmp_path):
    """Under the profiler every span of a step is a range, and the step's
    operations fall inside ``engine.step``."""
    eng = _dense()
    rng = np.random.default_rng(4)
    for i in range(2):
        eng.submit(ServeRequest(f"s{i}", rng.integers(0, 256, 8)
                                .astype(np.int32), 4))
    eng.poll()
    obs.tracing.enable()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        eng.poll()
    trace = _chrome(prof, tmp_path)
    ranges = collections.Counter(
        e["name"] for e in trace["traceEvents"]
        if e.get("ph") == "X" and e.get("cat") == "user_annotation")
    spans = collections.Counter(e["name"] for e in obs.tracing.TRACER.events)
    assert ranges == spans
    (step,) = [e for e in trace["traceEvents"] if e.get("ph") == "X"
               and e["name"] == "engine.step"]
    argmax = [e for e in trace["traceEvents"] if e.get("ph") == "X"
              and e["name"] == "aten::argmax"]
    assert argmax and all(
        step["ts"] <= e["ts"] <= step["ts"] + step["dur"] for e in argmax)

