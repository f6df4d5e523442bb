"""One run of one cell: set-up, the measured window, the audit, the
comparison with the reference, and the numbers.

``run_cell`` takes a device, so that the tests drive the whole of it on
the CPU; ``bench/run.py`` looks for the card and prints the result.
"""
from __future__ import annotations

import gc
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from harness import audit, check, client, program, spec, trace, work


@dataclass
class Run:
    """What the metric readers read."""
    cell: spec.Cell
    setup_s: float
    window: dict
    steps: int = 0
    bound: int = 0
    max_batch: int = 0
    cont_admitted: int = 0
    restores: int = 0
    swap_s: float | None = None
    turns_done: int = 0
    flops: float = 0.0
    timeline: trace.Timeline | None = None
    traced_steps: int = 0
    slice_tokens: int = 0       # tokens stamped in the profiled slice
    slice_flops: float = 0.0    # their model FLOPs
    gathers: list = field(default_factory=list)    # (n, unique, secded)
    scatters: list = field(default_factory=list)
    row_words: int = 0
    peaks: dict | None = None


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _ranged(name: str, fn):
    def run(*a, **k):
        with torch.profiler.record_function(name):
            return fn(*a, **k)
    return run


class _Tracer:
    """The profiled slice's hooks: host ranges around the program's calls,
    the pages each traced read and write moves, and the time inside the
    host tier's calls (synced)."""

    def __init__(self, eng, run: Run, device):
        self.eng, self.run, self.dev = eng, run, device
        self.active = False
        self.counting = False
        self.in_step = False
        self.prof = None
        self.span: tuple[float, float] | None = None
        run.swap_s = 0.0
        e, kv, sched = eng, eng.kv, eng.sched
        e._do_prefill = _ranged("bench.prefill", e._do_prefill)
        sched.tick = _ranged("bench.admit", sched.tick)
        orig_gather, orig_attend = e._gather_pages, e._attend_fn
        orig_step, orig_write = e.step, e.pool.write

        def gather(phys):
            with torch.profiler.record_function("bench.gather"):
                out = orig_gather(phys)
            if self.active:
                self.pending.append(("g", np.array(phys)))
            return out

        def attend(*a):
            with torch.profiler.record_function("bench.compute"):
                return orig_attend(*a)

        def step():
            self.in_step = True
            try:
                with torch.profiler.record_function("bench.step"):
                    out = orig_step()
            finally:
                self.in_step = False
            if self.active:
                self.run.traced_steps += 1
            return out

        def write(pages, data, **kw):
            if not self.in_step:
                return orig_write(pages, data, **kw)
            if self.active:
                self.pending.append(("s", np.array(pages)))
            with torch.profiler.record_function("bench.scatter"):
                return orig_write(pages, data, **kw)

        def swap(fn):
            def go(*a, **k):
                with torch.profiler.record_function("bench.swap"):
                    t = time.perf_counter()
                    out = fn(*a, **k)
                    _sync(self.dev)
                    if self.counting:
                        self.run.swap_s += time.perf_counter() - t
                return out
            return go

        self.pending: list = []
        e._gather_pages, e._attend_fn, e.step = gather, attend, step
        e.pool.write = write
        kv.preempt, kv.restore = swap(kv.preempt), swap(kv.restore)

    def _activities(self):
        from torch.profiler import ProfilerActivity
        acts = [ProfilerActivity.CPU]
        if torch.device(self.dev).type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        return acts

    def warm(self) -> None:
        """Pay the profiler's first start (CUPTI's set-up, seconds) in
        set-up rather than in the window."""
        from torch.profiler import profile
        with profile(activities=self._activities()):
            torch.ones(8, device=self.dev).sum().item()

    def start(self) -> None:
        from torch.profiler import profile
        self.prof = profile(activities=self._activities())
        self.prof.start()
        self.window = torch.profiler.record_function("bench.window")
        self.window.__enter__()
        self.active = True
        self.span = (time.perf_counter(), float("inf"))

    def stop(self) -> None:
        if not self.active:
            return
        self.span = (self.span[0], time.perf_counter())
        _sync(self.dev)
        self.window.__exit__(None, None, None)
        self.prof.stop()
        self.active = False

    def finish(self) -> None:
        """Reduce the traced slice (after the window)."""
        if self.prof is None:
            return
        self.run.timeline = trace.from_profiler(self.prof)
        self.prof = None
        pool = self.eng.pool
        for kind, ids in self.pending:
            u = np.unique(ids)
            sec = int(((u >= pool.boundary) & (u < pool.num_rows)).sum())
            (self.run.gathers if kind == "g" else self.run.scatters).append(
                (len(ids), len(u), sec))
        self.pending.clear()


def run_cell(cell: spec.Cell, seed: int, seconds: float, traced: bool,
             device, t_start: float, control: bool = False) -> dict:
    """Run the cell once; returns the result's parts (``correct``,
    ``attempted``, ``failed``, ``metrics``, ``device``, ``breakdown``,
    ``checks``)."""
    from repro_torch.models import moe as port_moe
    cfg, mix, wk = cell.config, cell.traffic, cell.workload
    dev = torch.device(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # -- set-up: the engine, its weights, sessions opened, shapes warmed ----
    eng = program.build(cfg, wk, dev)
    program.load_weights(eng.model, cfg, seed)
    loop = client.Loop(eng, mix, seed, cfg["vocab_size"])
    rec = audit.Recorder(eng, port_moe if cfg.get("num_experts") else None)
    opened = []
    if loop.opened:
        rec.openings()
        loop.open_sessions()
        opened = rec.close_openings()
        loop.first.clear()
    run = Run(cell, 0.0, {}, max_batch=wk["max_batch"],
              row_words=wk["row_words"])
    # the slice is profiled in a traced run, and in every run of a cell
    # that reports an end-to-end metric from the device's trace
    profiled = traced or any(m["source"] == "device_trace"
                             for m in cell.end_to_end)
    tracer = _Tracer(eng, run, dev) if profiled else None
    if traced:
        tracer.warm()
    rec.watch()
    loop.start()
    for _ in range(wk["warmup_polls"]):
        loop.poll()
    _sync(dev)
    # what set-up built lives to the end: keep the collector from walking
    # it (the VM's page tables and block tables) in the window
    gc.collect()
    gc.freeze()

    # -- the window --------------------------------------------------------
    restores0, polls = eng.sched.restores, 0
    loop.counting = True
    if tracer:
        tracer.counting = True
    t0 = time.perf_counter()
    stamps = {"setup_end": t0 - t_start}
    first_log = len(loop.logs)
    while True:
        if tracer and polls == wk["trace"]["skip_polls"]:
            tracer.start()
        now = loop.poll()
        polls += 1
        if tracer and polls == wk["trace"]["skip_polls"] + wk["trace"][
                "polls"]:
            tracer.stop()
        if now - t0 >= seconds:
            break
    t1 = now
    loop.counting = False
    if tracer:
        tracer.counting = False
        tracer.stop()
        tracer.finish()
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    logs = loop.logs
    run.window = client.window_stats(logs, t0, t1)
    first_tokens = [lg.times[0] for lg in logs[first_log:] if lg.times
                    and lg.times[0] >= t0]
    run.setup_s = (min(first_tokens) if first_tokens else t1) - t_start
    run.steps, run.bound = loop.steps, loop.bound
    run.cont_admitted = loop.cont_admitted
    run.restores = eng.sched.restores - restores0
    run.turns_done = sum(1 for lg in logs if lg.done and t0 <= lg.done <= t1)
    run.flops = client.window_work(logs, t0, t1, cfg)
    if tracer and tracer.span:
        s0, s1 = tracer.span
        run.slice_tokens = client.window_stats(logs, s0, s1)["tokens"]
        run.slice_flops = client.window_work(logs, s0, s1, cfg)
    run.peaks = work.peaks(torch.cuda.get_device_name(dev)) \
        if dev.type == "cuda" else None

    # -- drain: every turn sent in the window gets its first token ----------
    deadline = time.perf_counter() + wk["drain_seconds"]
    while any(t0 <= lg.submit <= t1 and not lg.times for lg in logs) \
            and time.perf_counter() < deadline:
        loop.poll()
    run.window = client.window_stats(logs, t0, t1)
    stamps["window_end"] = t1 - t_start
    stamps["drain_end"] = time.perf_counter() - t_start

    # -- the audit: the same engine under the same load, recorded -----------
    aud = wk["audit"]
    rec.start(loop.opened_by)
    for _ in range(aud["max_polls"]):
        loop.poll()
        kinds = [ev["kind"] for ev in rec.events]
        if kinds.count("decode") >= aud["steps"] and \
                kinds.count("prefill") >= aud["prefills"]:
            break
    rec.finish()
    base = check.base_sites(rec, opened, aud.get("base", 0), seed,
                            dense=not cfg.get("num_experts"))
    stamps["audit_end"] = time.perf_counter() - t_start

    # -- free the program, then judge --------------------------------------
    del eng, loop, tracer
    gc.unfreeze()
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    with torch.no_grad():
        nums = check.compare(rec, cfg, seed, base, control=control)
    stamps["check_end"] = time.perf_counter() - t_start
    nums["stamps"] = stamps
    limits = wk["limits"]
    checks = {k: {"value": nums[k], "limit": limits[k]} for k in limits}
    correct = all(c["value"] <= c["limit"] for c in checks.values()) and \
        nums["tokens"] > 0
    return dict(run=run, numbers=nums, checks=checks, correct=correct,
                peak=peak)
