"""Each metric's arithmetic, and the metric files against BENCHMARK.json."""
import json

import numpy as np
import pytest

from harness import client, runner, spec, trace, work

BENCH = json.loads((spec.ROOT / "BENCHMARK.json").read_text())
ALL = BENCH["end_to_end"] + BENCH["per_layer"]


def _log(submit, times, work_=None):
    lg = client.TurnLog(0, submit)
    lg.times = list(times)
    lg.work = list(work_ or [10] * len(times))
    return lg


def _run(window, **kw):
    cell = spec.Cell("x", 1, {}, {}, {}, [], [])
    return runner.Run(cell, 1.0, window, **kw)


def test_rate_over_the_whole_window():
    logs = [_log(0.0, [0.5, 1.0, 1.5, 2.5, 11.0]), _log(1.0, [2.0, 3.0])]
    w = client.window_stats(logs, 1.0, 11.0)
    assert w["tokens"] == 6 and w["seconds"] == 10.0
    r = spec.reader("tokens_per_s").read(_run(w))
    assert r == pytest.approx(0.6)


def test_one_planted_stall_moves_the_tails():
    steady = [_log(float(i), [i + 0.1 * k for k in range(1, 40)])
              for i in range(20)]
    w = client.window_stats(steady, 0.0, 100.0)
    itl = spec.reader("itl_p95_ms").read(_run(w))
    assert itl == pytest.approx(100.0)
    stalled = [_log(float(i), [i + 0.1 * k + (2.0 if k > 20 else 0)
                               for k in range(1, 40)]) for i in range(20)]
    w2 = client.window_stats(stalled, 0.0, 100.0)
    # one stall in every turn: 1 gap in 38 is long, under the 95th
    # percentile; two stalls in every turn move it
    twice = [_log(float(i), [i + 0.1 * k + (2.0 if k > 10 else 0)
                             + (2.0 if k > 30 else 0)
                             for k in range(1, 40)]) for i in range(20)]
    w3 = client.window_stats(twice, 0.0, 100.0)
    assert spec.reader("itl_p95_ms").read(_run(w2)) >= itl
    assert spec.reader("itl_p95_ms").read(_run(w3)) > 1000.0
    assert max(w2["gaps"]) == pytest.approx(2.1)


def test_ttft_counts_every_turn_submitted_in_the_window():
    logs = [_log(float(i), [i + 0.05]) for i in range(40)]
    logs.append(_log(39.5, [41.5]))              # first token after the end
    logs.append(_log(-1.0, [0.5]))               # sent before the window
    w = client.window_stats(logs, 0.0, 40.0)
    assert w["attempted"] == 41 and w["failed"] == 0
    assert len(w["ttft"]) == 41
    assert max(w["ttft"]) == pytest.approx(2.0)
    p95 = spec.reader("ttft_p95_ms").read(_run(w))
    assert p95 == pytest.approx(float(np.percentile(w["ttft"], 95)) * 1e3)
    logs.append(_log(20.0, []))                  # never served
    assert client.window_stats(logs, 0.0, 40.0)["failed"] == 1


def test_mfu_counts_routed_experts_and_last_logits():
    cfg = {"hidden_size": 8, "num_attention_heads": 2,
           "num_key_value_heads": 1, "intermediate_size": 4,
           "num_hidden_layers": 3, "vocab_size": 10, "num_experts": 4,
           "num_experts_per_tok": 2}
    per_layer = 2 * 8 * (2 + 2) * 4 + 2 * 8 * 8 + 2 * 8 * 4 + 2 * 3 * 2 * 8 * 4
    assert work.decode_flops(cfg, 5) == 3 * (per_layer + 4 * 8 * 5) + 2 * 8 * 10
    assert work.prefill_flops(cfg, 4) == \
        3 * (4 * per_layer + 4 * 8 * 10) + 2 * 8 * 10
    logs = [_log(0.0, [1.0, 2.0], [-4, 5])]
    assert client.window_work(logs, 0.0, 3.0, cfg) == \
        work.prefill_flops(cfg, 4) + work.decode_flops(cfg, 5)
    run = _run({"seconds": 2.0}, flops=67e12, peaks=work.PEAKS[
        "NVIDIA H100 80GB HBM3"])
    assert spec.reader("model.mfu").read(run) == pytest.approx(50.0)


def _chrome():
    ev = []

    def x(cat, name, ts, dur, corr=None, pid=0):
        e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
             "pid": pid, "args": {}}
        if corr is not None:
            e["args"]["correlation"] = corr
        ev.append(e)
    x("user_annotation", "bench.window", 0, 100)
    x("user_annotation", "bench.step", 10, 60)
    x("user_annotation", "bench.gather", 12, 5)
    x("user_annotation", "bench.scatter", 40, 10)
    x("user_annotation", "bench.prefill", 75, 20)
    x("cuda_runtime", "cudaLaunchKernel", 13, 1, corr=1)
    x("cuda_runtime", "cudaLaunchKernel", 41, 1, corr=2)
    x("cuda_runtime", "cudaLaunchKernel", 76, 1, corr=3)
    x("kernel", "mixed_read_correct_kernel", 20, 10, corr=1, pid=1)
    x("kernel", "index_put", 45, 10, corr=2, pid=1)
    x("gpu_memcpy", "Memcpy HtoD", 50, 2, corr=2, pid=1)
    x("kernel", "gemm", 80, 10, corr=3, pid=1)
    x("gpu_user_annotation", "bench.step", 20, 40, pid=1)
    return {"traceEvents": ev}


def test_trace_reduction():
    tl = trace.from_chrome(_chrome(), (0, 100))
    assert [op[3] for op in tl.ops] == ["bench.gather", "bench.scatter",
                                        "bench.scatter", "bench.prefill"]
    assert tl.busy_s == pytest.approx(30 / 1e6)   # the copy overlaps
    assert tl.window_s == pytest.approx(100 / 1e6)
    assert tl.count() == 4
    bd = trace.breakdown(tl)
    assert bd["device_ops"][0][1] == pytest.approx(10 / 1e6)
    idle = dict(bd["idle_gaps"])
    assert idle == pytest.approx({"bench.client": 20e-6, "bench.step": 40e-6,
                                  "bench.prefill": 10e-6})
    assert sum(idle.values()) == pytest.approx(tl.window_s - tl.busy_s)
    run = _run({"seconds": 1.0}, timeline=tl, traced_steps=2,
               gathers=[(4, 2, 1)], scatters=[(2, 2, 1)], row_words=8,
               peaks={"fp32_flops": 1.0, "hbm_bytes": 1e6})
    assert spec.reader("engine.launches_per_step").read(run) == 2.0
    share = spec.reader("model.prefill_share").read(run)
    assert share == pytest.approx(100 * 10 / 30)
    g = spec.reader("kernel.gather_roofline").read(run)
    assert g == pytest.approx(100 * work.gather_bytes(4, 2, 1, 8) / 1e6
                              / 10e-6)
    s = spec.reader("kernel.scatter_roofline").read(run)
    assert s == pytest.approx(100 * work.scatter_bytes(2, 2, 1, 8) / 1e6
                              / 12e-6)
    idle_share = spec.reader("device.idle_share").read(run)
    assert idle_share == pytest.approx(70.0)
    for name in ("engine.launches_per_step", "model.prefill_share",
                 "kernel.gather_roofline", "kernel.scatter_roofline"):
        assert spec.reader(name + ".chat").read(run) == \
            spec.reader(name).read(run)


def test_device_time_per_token_and_busy_mfu():
    tl = trace.from_chrome(_chrome(), (0, 100))
    run = _run({"seconds": 1.0}, timeline=tl, slice_tokens=3,
               slice_flops=6.0, peaks={"fp32_flops": 1e6, "hbm_bytes": 1.0})
    assert spec.reader("device_ms_per_token").read(run) == \
        pytest.approx(1e3 * 30e-6 / 3)
    assert spec.reader("model.mfu.chat").read(run) == \
        pytest.approx(100 * 6.0 / (30e-6 * 1e6))
    # the host's idle time between the operations is not the card's
    late = trace.from_chrome(_chrome(), (0, 1000))
    run.timeline = late
    assert spec.reader("device_ms_per_token").read(run) == \
        pytest.approx(1e3 * 30e-6 / 3)


def test_readers_give_nothing_without_a_trace():
    run = _run({"seconds": 1.0, "gaps": [], "ttft": [], "tokens": 0})
    for name in ("engine.launches_per_step", "model.prefill_share",
                 "kernel.gather_roofline", "kernel.scatter_roofline",
                 "device.idle_share", "sched.resume_on_device_share",
                 "swap.ms_per_turn", "model.mfu", "itl_p95_ms",
                 "ttft_p95_ms", "device_ms_per_token", "model.mfu.chat",
                 "engine.launches_per_step.chat", "itl_p95_ms.chat",
                 "kernel.gather_roofline.chat"):
        assert spec.reader(name).read(run) is None, name


def test_scheduler_counters():
    run = _run({"seconds": 1.0}, steps=10, bound=300, max_batch=32,
               cont_admitted=40, restores=10, swap_s=0.5, turns_done=50)
    assert spec.reader("sched.batch_occupancy").read(run) == \
        pytest.approx(93.75)
    assert spec.reader("sched.resume_on_device_share").read(run) == \
        pytest.approx(75.0)
    assert spec.reader("swap.ms_per_turn").read(run) == pytest.approx(10.0)


@pytest.mark.parametrize("metric", ALL, ids=lambda m: m["name"])
def test_every_metric_has_its_reader(metric):
    mod = spec.reader(metric["name"])
    assert mod.UNIT == metric["unit"]
    if "layer" in metric:
        assert (mod.LAYER, mod.MOVES) == (metric["layer"], metric["moves"])


def test_moves_names_a_metric_its_cells_report():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    cells = [w["name"] for w in BENCH["workloads"]]
    for m in BENCH["per_layer"]:
        target = e2e[m["moves"]]
        for cell in m.get("workloads", cells):
            assert cell in cells
            assert "workloads" not in target or cell in target["workloads"]


def test_every_cell_has_its_files():
    for w in BENCH["workloads"]:
        cell = spec.load_cell(w["name"])
        assert cell.workload["limits"]
        assert set(cell.workload["limits"]) == {
            "gather_mismatch", "store_mismatch", "len_mismatch", "kv_err",
            "logit_err", "token_gap"}
