"""The program's spans on the traced slice's timeline
(``bench/harness/spans.py``): the sweep that finds each operation's
enclosing spans, the readings of where the card's time and idle go, the
harness's readers unchanged by program ranges, and whole runs on the CPU
with the program's tracer on for the slice and with the harness as it is."""
import json
import time

import pytest

from harness import runner, spans, spec, trace
from conftest import tiny_cell

BENCH = json.loads((spec.ROOT / "BENCHMARK.json").read_text())
SEED = 3141592653


def _x(ev, cat, name, ts, dur, corr=None, pid=0):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
         "pid": pid, "args": {}}
    if corr is not None:
        e["args"]["correlation"] = corr
    ev.append(e)


def _kernel(ev, name, launch, start, dur, corr):
    _x(ev, "cuda_runtime", "cudaLaunchKernel", launch, 0.5, corr=corr)
    _x(ev, "kernel", name, start, dur, corr=corr, pid=1)


def _trace(program: bool = True) -> dict:
    """Two decode steps and a prefill in a 2000 us window. The first step
    opens 70 ``model.attn`` ranges before the MoE whose kernel is launched
    four spans deep under it."""
    ev: list = []
    _x(ev, "user_annotation", "bench.window", 0, 2000)
    _x(ev, "user_annotation", "bench.step", 10, 990)
    _x(ev, "user_annotation", "bench.gather", 20, 10)
    _x(ev, "user_annotation", "bench.compute", 40, 800)
    _x(ev, "user_annotation", "bench.scatter", 850, 40)
    _x(ev, "user_annotation", "bench.prefill", 1100, 300)
    _x(ev, "user_annotation", "bench.step", 1500, 400)
    p = []
    _x(p, "user_annotation", "engine.poll", 5, 1415)
    _x(p, "user_annotation", "sched.tick", 6, 2)
    _x(p, "user_annotation", "engine.step", 10, 990)
    _x(p, "user_annotation", "engine.step.compute", 40, 800)
    _x(p, "user_annotation", "engine.step.unpack", 41, 9)
    _x(p, "user_annotation", "engine.step.model", 50, 750)
    for i in range(70):
        _x(p, "user_annotation", "model.attn", 51 + 9 * i, 8)
    _x(p, "user_annotation", "model.moe", 700, 90)
    _x(p, "user_annotation", "experts", 705, 80)
    _x(p, "user_annotation", "experts.gemm", 710, 70)
    _x(p, "user_annotation", "engine.step.readback", 900, 100)
    _x(p, "user_annotation", "engine.prefill", 1100, 300)
    _x(p, "user_annotation", "engine.prefill.model", 1110, 200)
    _x(p, "user_annotation", "model.attn", 1120, 50)
    _x(p, "user_annotation", "engine.poll", 1500, 450)
    _x(p, "user_annotation", "engine.step", 1500, 400)
    _x(p, "user_annotation", "engine.step.readback", 1800, 50)
    _x(p, "gpu_user_annotation", "engine.step", 1500, 400, pid=1)
    if program:
        ev += p
    _kernel(ev, "mixed_read_correct_kernel", 21, 25, 10, 1)
    _kernel(ev, "unpack_copy", 42, 45, 20, 2)
    _kernel(ev, "attn_gemv", 52, 70, 30, 3)
    _kernel(ev, "moe_gemm", 720, 730, 40, 4)
    _kernel(ev, "index_put", 860, 870, 20, 5)
    _kernel(ev, "prefill_attn", 1130, 1140, 50, 6)
    _kernel(ev, "host_side", 1450, 1460, 10, 7)
    return {"traceEvents": ev}


def _run(tl, **kw):
    cell = spec.Cell("x", 1, {}, {}, {}, [], [])
    return runner.Run(cell, 1.0, {"seconds": 1.0, "gaps": [1.0],
                                  "ttft": [1.0], "tokens": 6}, timeline=tl,
                      traced_steps=2, gathers=[(4, 2, 1)],
                      scatters=[(2, 2, 1)], row_words=8,
                      peaks={"fp32_flops": 1.0, "hbm_bytes": 1e6},
                      slice_tokens=3, slice_flops=6.0, steps=2, bound=4,
                      max_batch=4, **kw)


def test_an_operation_four_spans_deep_under_a_step_64_ranges_back():
    prog = spans.from_chrome(_trace(), (0, 2000))
    chains = dict(zip((op[0] for op in prog.tl.ops), prog.chains))
    assert chains["moe_gemm"] == (
        "engine.poll", "engine.step", "engine.step.compute",
        "engine.step.model", "model.moe", "experts", "experts.gemm")
    assert chains["unpack_copy"] == ("engine.poll", "engine.step",
                                     "engine.step.compute",
                                     "engine.step.unpack")
    assert chains["attn_gemv"][-1] == "model.attn"
    assert chains["mixed_read_correct_kernel"] == ("engine.poll",
                                                   "engine.step")
    assert chains["prefill_attn"] == ("engine.poll", "engine.prefill",
                                      "engine.prefill.model", "model.attn")
    assert chains["host_side"] == ()
    # the device's own annotation is not a program span
    assert len([s for s in prog.spans if s[2] == "engine.step"]) == 2
    # the harness's ranges give the bench.step durations
    assert prog.bench_steps_us == [990, 400]


def test_the_window_is_the_harness_window_range():
    prog = spans.from_chrome(_trace())
    assert (prog.tl.t0, prog.tl.t1) == (0, 2000)


def test_a_culaunchkernel_charges_its_kernel_to_the_span_it_left():
    """cuBLAS launches with ``cuLaunchKernel``: the kernel belongs to the span
    open at that call, though the card runs it later; the harness's own
    ranges keep charging runtime launches alone."""
    ev: list = []
    _x(ev, "user_annotation", "bench.window", 0, 100)
    _x(ev, "user_annotation", "bench.prefill", 50, 40)
    _x(ev, "user_annotation", "model.mlp", 10, 10)
    _x(ev, "cuda_driver", "cuLaunchKernel", 12, 0.5, corr=9)
    _x(ev, "kernel", "sgemm", 60, 10, corr=9, pid=1)
    prog = spans.from_chrome({"traceEvents": ev}, (0, 100))
    assert prog.tl.ops == [("sgemm", 60.0, 10.0, "bench.prefill")]
    assert prog.chains == [("model.mlp",)]


def test_readings_by_program_span():
    prog = spans.from_chrome(_trace(), (0, 2000))
    busy = 10 + 20 + 30 + 40 + 20 + 50 + 10
    assert prog.tl.busy_s == pytest.approx(busy / 1e6)
    assert prog.readings() == pytest.approx({
        "engine.unpack_share": 100 * 20 / busy,
        "model.attn_share": 100 * (30 + 50) / busy,
        "model.moe_share": 100 * 40 / busy,
        # steps of 990 and 400 us less readbacks of 100 and 50 us
        "engine.host_ms_per_step": (890 + 350) / 2 / 1e3})
    by = prog.by_span()
    device = dict(by["device"])
    assert device == pytest.approx({
        "experts.gemm": 40e-6, "engine.step.unpack": 20e-6,
        "model.attn": 80e-6, "engine.step": 30e-6, "none": 10e-6})
    idle = dict(by["idle"])
    # gaps begin at 0 and 1470 outside every span, at 35 and 890 in the
    # step, at 65 and 100 in an attention layer, at 770 in the expert
    # products and at 1190 in the prefill's model
    assert idle == pytest.approx({
        "none": 555e-6, "engine.step": 260e-6, "model.attn": 635e-6,
        "experts.gemm": 100e-6, "engine.prefill.model": 270e-6})
    assert sum(idle.values()) == pytest.approx(
        prog.tl.window_s - prog.tl.busy_s)


def test_readings_without_program_spans_give_nothing():
    prog = spans.from_chrome(_trace(program=False), (0, 2000))
    assert set(prog.readings().values()) == {None}
    ((name, secs),) = prog.by_span()["device"]
    assert name == "none" and secs == pytest.approx(prog.tl.busy_s)


def test_program_ranges_change_no_reading_of_the_harness():
    """The program's ranges in a trace leave the harness's timeline and
    every metric the benchmark reads as they were."""
    with_p = trace.from_chrome(_trace(), (0, 2000))
    without = trace.from_chrome(_trace(program=False), (0, 2000))
    assert with_p.ops == without.ops
    assert trace.breakdown(with_p) == trace.breakdown(without)
    assert [with_p.innermost(t) for t in range(0, 2000, 7)] == \
        [without.innermost(t) for t in range(0, 2000, 7)]
    names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(names) == 18
    for name in names:
        a = spec.reader(name).read(_run(with_p))
        b = spec.reader(name).read(_run(without))
        assert a == b, name


def _whole(traced: bool, device_metric: bool = False):
    from repro_torch.obs import tracing
    cell = tiny_cell("olmoe")
    if device_metric:
        cell.end_to_end = [{"name": "device_ms_per_token",
                            "source": "device_trace"}]
    out = runner.run_cell(cell, SEED, 1.5, traced, "cpu",
                          time.perf_counter())
    assert out["correct"], out["checks"]
    assert not tracing.enabled() and tracing.TRACER.events == []
    return out["run"]


def test_a_slice_with_the_programs_tracer_has_its_spans(monkeypatch):
    monkeypatch.setattr(runner, "_Tracer", spans.ProgramTracer)
    monkeypatch.setattr(spans.ProgramTracer, "last", None)
    _whole(True)
    prog = spans.ProgramTracer.last
    names = {s[2] for s in prog.spans}
    assert {"engine.poll", "sched.tick", "engine.step",
            "engine.step.unpack", "engine.step.model",
            "engine.step.insert", "engine.step.readback", "model.attn",
            "model.moe", "model.head"} <= names
    assert all(not n.startswith("bench.") for n in names)
    moe = [s for s, _, n in prog.spans if n == "model.moe"]
    for chain in spans.open_chains(prog.spans, moe):
        assert chain[0] == "engine.poll" and chain[-1] == "model.moe"
        assert {"engine.step.model", "engine.prefill.model"} & set(chain)
    assert prog.host_ms_per_step() > 0
    assert len(prog.bench_steps_us) == len(
        [s for s in prog.spans if s[2] == "engine.step"])
    # the CPU launches no device operation: no share to read
    assert not prog.tl.ops and prog.share("model.moe") is None
    assert prog.by_span()["idle"][0][1] == pytest.approx(prog.tl.window_s)


def test_the_programs_tracer_off_leaves_the_slice_without_spans(
        monkeypatch):
    monkeypatch.setattr(runner, "_Tracer", spans.ProgramTracer)
    monkeypatch.setattr(spans.ProgramTracer, "program", False)
    monkeypatch.setattr(spans.ProgramTracer, "last", None)
    _whole(True)
    prog = spans.ProgramTracer.last
    assert prog.spans == [] and prog.bench_steps_us
    assert prog.host_ms_per_step() is None


@pytest.mark.parametrize("traced,device_metric",
                         [(True, False), (False, False), (False, True)])
def test_the_benchmarks_runs_keep_the_programs_tracer_off(
        monkeypatch, traced, device_metric):
    """The harness as it is, traced or not, the profiled slice of a device
    metric too: no program range reaches its trace."""
    seen = []
    real = trace.from_chrome

    def keep(chrome, window_us=None):
        seen.append(chrome)
        return real(chrome, window_us)
    monkeypatch.setattr(trace, "from_chrome", keep)
    run = _whole(traced, device_metric)
    assert (run.timeline is not None) == (traced or device_metric)
    assert len(seen) == (1 if traced or device_metric else 0)
    for chrome in seen:
        assert not [e for e in chrome["traceEvents"]
                    if e.get("cat") == "user_annotation"
                    and not e["name"].startswith("bench.")]


@pytest.mark.card
def test_a_span_lies_on_its_profiler_range_on_the_card(card, tmp_path):
    """The program's span and its ``user_annotation`` range, with CUDA
    activity on: under 1 ms apart at both ends once the trace's
    ``baseTimeNanoseconds`` is put back, and the span's kernels charged to
    it; its blocking form waits for nothing under the profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.obs import tracing
    a = torch.randn(2048, 2048, device="cuda")
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=acts):          # the profiler's first start
        (a @ a).sum().item()
    tracing.enable()
    try:
        with profile(activities=acts) as prof:
            for _ in range(4):
                with tracing.span("probe.span"):
                    b = a @ a
                with tracing.blocked_span("probe.blocked") as hold:
                    c = b @ a
                    hold(c)
            torch.cuda.synchronize()
        events = [e for e in tracing.TRACER.events if e["ph"] == "X"]
    finally:
        tracing.disable()
        tracing.reset()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    chrome = json.loads(path.read_text())
    base = chrome["baseTimeNanoseconds"] / 1e3
    ranges = sorted((e["ts"], e["dur"], e["name"])
                    for e in chrome["traceEvents"] if e.get("ph") == "X"
                    and e.get("cat") == "user_annotation")
    assert [r[2] for r in ranges] == [e["name"] for e in events]
    gaps = []
    for (ts, dur, _), e in zip(ranges, events):
        gaps += [abs(e["ts"] - base - ts),
                 abs(e["ts"] + e["dur"] - base - ts - dur)]
    print(json.dumps({"span_vs_range_us": max(gaps),
                      "torch": torch.__version__}))
    assert max(gaps) < 1000.0
    # every kernel is charged to its span by its launch (cuBLAS launches
    # with cuLaunchKernel), not by when the card ran it
    launched = {e["args"]["correlation"]: e["cat"]
                for e in chrome["traceEvents"]
                if e.get("cat") in spans.LAUNCH_CATS
                and "correlation" in e.get("args", {})}
    prog = spans.from_chrome(chrome, (ranges[0][0], ranges[-1][0] + 1e4))
    kernels = [e for e in chrome["traceEvents"] if e.get("cat") == "kernel"
               and e["args"].get("correlation") in launched]
    print(json.dumps({"launch_cats": sorted(
        {launched[k["args"]["correlation"]] for k in kernels})}))
    assert len(kernels) >= 8
    chains = dict(zip((op[1] for op in prog.tl.ops), prog.chains))
    for k in kernels:
        assert chains[float(k["ts"])][-1].startswith("probe."), k["name"]
