"""The port's telemetry plane (``repro_torch.obs``) against the reference's.

Both packages get the same calls, the same numpy inputs and the same
weights; every plane of both starts and ends each test off and empty (the
reference's autouse reset of ``tests/test_obs.py``). Held equal:

  * the registry, case by case: ``collect()`` and the ``snapshot()`` text
    after the same calls, and the same errors;
  * the tracer: span names, nesting depth, arguments and the Perfetto
    schema; blocking spans and ``traced_call`` on CPU tensors;
  * the read-status fold, pool-capacity gauges and the SLO tracker,
    including the repaired fault: ``add_pool`` / ``adopt_pool`` /
    ``repartition_with_migration`` / ``ErrorMonitor.record`` feed the
    tracker as the reference's do;
  * a ``serve-test`` engine of each package served with every plane on
    (cream and secded mode, a PARITY pool, a DAEC tier, planted single and
    double flips): the ``collect()`` snapshots, the step's read-status
    matrices, the span-name multisets restricted to the names the
    reference emits (the port's other names exactly the step's and the
    model's spans of ``tests/torch_spans.py``) and the SLO reports; a port
    engine on a pool in banks against a reference engine on the same global
    geometry, with flips and a scheduled migration; the dashboard
    text of the same snapshot; ``creamtop --snapshot`` against the
    reference tool;
  * what the metrics-on gather launches (a stubbed kernel library: one
    ``mixed_read_correct`` with a status pointer on a bare pool, the
    pool's status read on PARITY and DAEC-tier pools) and, as the
    deterministic stand-in for the reference's wall-clock overhead
    guards, the aten operations of one CPU decode step with metrics off
    and on.
"""
import collections
import contextlib
import dataclasses
import io
import json
import runpy
import sys
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import repro.obs as jobs
import repro_torch.obs as tobs
from repro.configs.base import ModelConfig as JConfig
from repro.core.layouts import Layout as JLayout
from repro.core.monitor import ErrorMonitor as JMonitor
from repro.core.pool import make_pool as jmake_pool
from repro.core.pool import read_pages_any_status as jread_status
from repro.core.scrubber import ScrubStats as JScrubStats
from repro.serve import Engine as JEngine
from repro.serve import ServeRequest as JRequest
from repro.vm.address_space import VirtualMemory as JVM
from repro.vm.migration import MigrationEngine as JMigration
from repro_torch.configs.base import ModelConfig as TConfig
from repro_torch.core.layouts import Layout as TLayout
from repro_torch.core.monitor import ErrorMonitor as TMonitor
from repro_torch.core.pool import PoolState
from repro_torch.core.pool import make_pool as tmake_pool
from repro_torch.core.scrubber import ScrubStats as TScrubStats
from repro_torch.kernels import common
from repro_torch.kernels.mixed import ops as mixed_ops
from repro_torch.kernels.mixed import ref as mixed_ref
from repro_torch.models import load_jax_params
from repro_torch.serve import Engine as TEngine
from repro_torch.serve import ServeRequest as TRequest
from repro_torch.serve import engine as tengine
from repro_torch.tools import creamtop as tcreamtop
from repro_torch.vm.address_space import VirtualMemory as TVM
from repro_torch.vm.migration import MigrationEngine as TMigration

sys.path.insert(0, str(Path(__file__).resolve().parent))

import torch_spans  # noqa: E402

SERVE_TEST = dict(name="serve-test", family="dense", num_layers=2,
                  d_model=64, num_heads=4, num_kv_heads=2, d_ff=128,
                  vocab_size=256, head_dim=16, dtype="float32")
PLANES = (jobs, tobs)
ROOT = Path(__file__).resolve().parents[1]


def _reset_all() -> None:
    for obs in PLANES:
        obs.metrics.disable()
        obs.metrics.REGISTRY.clear()
        obs.tracing.disable()
        obs.tracing.reset()
        obs.slo.TRACKER.reset()
        obs.memprof.disable()
        obs.memprof.clear()


@pytest.fixture(autouse=True)
def _clean_telemetry():
    """Every test starts and ends with both packages' planes off and empty."""
    _reset_all()
    yield
    _reset_all()


def _tlayout(layout: JLayout) -> TLayout:
    return TLayout(layout.value)


def _report(obs) -> list:
    return [dataclasses.astuple(s) for s in obs.slo.TRACKER.report()]


# ---------------------------------------------------------------------------
# The registry, case by case
# ---------------------------------------------------------------------------


def _counters(m):
    m.enable()
    c = m.counter("t_reads", "reads", labels=("pool", "cls"))
    c.labels(pool="kv", cls="secded").inc()
    c.labels(pool="kv", cls="none").inc(3)
    m.counter("t_plain", "no labels").inc(2.5)


def _disabled(m):
    m.counter("t_off", "off").inc(5)
    m.gauge("t_g", "g", labels=("k",)).labels(k="a").set(3)


def _reset_keeps_series(m):
    m.enable()
    m.counter("t_rst", "x", labels=("k",)).labels(k="a").inc(7)
    m.reset()


def _histogram(m):
    m.enable()
    h = m.histogram("t_lat", "us", buckets=(10.0, 100.0, float("inf")))
    for v in (5.0, 50.0, 500.0, 10.0):
        h.observe(v)
    m.histogram("t_default", "default buckets", labels=("op",)) \
        .labels(op="get").observe(1234.5)


def _gauges(m):
    m.enable()
    g = m.gauge("t_gauge", "g", labels=("pool",))
    g.labels(pool="a").set(4)
    g.labels(pool="a").set(1.5)
    g.labels(pool="b").set(-2)


def _clear(m):
    m.enable()
    m.counter("t_gone", "x").inc()
    m.REGISTRY.clear()
    m.counter("t_kept", "y").inc()


def _redeclare_same(m):
    m.enable()
    a = m.counter("t_same", "x", labels=("k",))
    b = m.counter("t_same", "other help", labels=("k",))
    assert a is b
    b.labels(k="1").inc()


def _touched(m):
    m.enable()
    m.touch_read_status()


REGISTRY_CASES = {f.__name__.strip("_"): f for f in (
    _counters, _disabled, _reset_keeps_series, _histogram, _gauges, _clear,
    _redeclare_same, _touched)}


@pytest.mark.parametrize("case", list(REGISTRY_CASES))
def test_registry_collect_and_snapshot_equal_the_reference(case):
    for obs in PLANES:
        REGISTRY_CASES[case](obs.metrics)
    assert tobs.metrics.collect() == jobs.metrics.collect()
    assert tobs.metrics.snapshot() == jobs.metrics.snapshot()
    assert json.loads(json.dumps(tobs.metrics.collect())) == \
        tobs.metrics.collect()


ERROR_CASES = {
    "label_mismatch": (ValueError, lambda m: m.counter(
        "t_lbl", "x", labels=("a",)).labels(b="1")),
    "redeclare_kind": (ValueError, lambda m: (m.counter("t_kind", "x"),
                                              m.gauge("t_kind", "x"))),
    "redeclare_labels": (ValueError, lambda m: (
        m.counter("t_l", "x", labels=("a",)),
        m.counter("t_l", "x", labels=("b",)))),
    "counter_negative": (ValueError, lambda m: m.counter("t_neg", "x")
                         .inc(-1)),
    "set_on_counter": (TypeError, lambda m: m.counter("t_c", "x").set(1)),
    "inc_on_gauge": (TypeError, lambda m: m.gauge("t_g", "x").inc()),
    "observe_on_counter": (TypeError, lambda m: m.counter("t_o", "x")
                           .observe(1)),
}


@pytest.mark.parametrize("case", list(ERROR_CASES))
def test_registry_refuses_what_the_reference_refuses(case):
    exc, call = ERROR_CASES[case]
    for obs in PLANES:
        obs.metrics.enable()
        with pytest.raises(exc):
            call(obs.metrics)
    assert tobs.metrics.collect() == jobs.metrics.collect()


def test_names_and_fold_classes_equal_the_reference():
    names = {k: v for k, v in vars(jobs.metrics).items()
             if k.startswith("NAME_")}
    assert {k: v for k, v in vars(tobs.metrics).items()
            if k.startswith("NAME_")} == names
    assert tobs.metrics.FOLD_CLASSES == jobs.metrics.FOLD_CLASSES
    assert tobs.metrics.DEFAULT_BUCKETS == jobs.metrics.DEFAULT_BUCKETS


@pytest.mark.parametrize("as_tensor", [False, True])
@pytest.mark.parametrize("enabled", [False, True])
def test_fold_read_status_feeds_tracker_always_registry_when_on(as_tensor,
                                                                enabled):
    classes = jobs.metrics.FOLD_CLASSES
    counts = np.zeros((len(classes), 2), np.int32)
    counts[classes.index("secded"), 0] = 4
    counts[classes.index("secded"), 1] = 1
    counts[classes.index("none"), 1] = 2
    counts[classes.index("daec"), 0] = 3
    for obs in PLANES:
        obs.metrics.enable(enabled)
        obs.metrics.touch_read_status()
    jobs.metrics.fold_read_status(jnp.asarray(counts))
    tobs.metrics.fold_read_status(torch.as_tensor(counts) if as_tensor
                                  else counts)
    assert tobs.metrics.collect() == jobs.metrics.collect()
    assert _report(tobs) == _report(jobs)
    assert not [s for s in tobs.slo.TRACKER.report()
                if s.scope == "class/secded"][0].ok


# ---------------------------------------------------------------------------
# The tracer
# ---------------------------------------------------------------------------


def _shape(events: list) -> list:
    """What two traces share: names, phases, categories and arguments in
    order (times and thread ids differ)."""
    return [(e["name"], e["ph"], e["cat"], e.get("args")) for e in events]


def _nested(t):
    t.enable()
    with t.span("outer", pages=3):
        with t.span("inner"):
            t.instant("marker", x=1)
    with t.span("after"):
        pass


def _disabled_spans(t):
    with t.span("x"):
        pass
    t.instant("y")
    assert t.span("a") is t.span("b")


def _blocked(t):
    t.enable()
    with t.blocked_span("b", k=2) as hold:
        hold(np.arange(4) if t is jobs.tracing else torch.arange(4))
    with t.blocked_span("empty"):
        pass


def _traced(t):
    t.enable()
    vals = (np.arange(3) if t is jobs.tracing else torch.arange(3))
    out = t.traced_call("fn", lambda v: v * 2, vals)
    assert list(out) == [0, 2, 4]


def _extend(t):
    t.enable()
    t.TRACER.extend([{"name": "c", "ph": "C", "cat": "cream", "ts": 1.0,
                      "pid": 1, "args": {"blp": 1.0}}])
    t.disable()
    t.TRACER.extend([{"name": "d", "ph": "C", "cat": "cream", "ts": 2.0,
                      "pid": 1, "args": {}}])


TRACER_CASES = {f.__name__.strip("_"): f for f in (
    _nested, _disabled_spans, _blocked, _traced, _extend)}


@pytest.mark.parametrize("case", list(TRACER_CASES))
def test_tracer_events_equal_the_reference(case):
    for obs in PLANES:
        TRACER_CASES[case](obs.tracing)
    got, want = tobs.tracing.TRACER.events, jobs.tracing.TRACER.events
    assert _shape(got) == _shape(want)
    assert tobs.tracing.TRACER.span_names() == \
        jobs.tracing.TRACER.span_names()
    d = json.loads(tobs.tracing.TRACER.to_json())
    assert d["displayTimeUnit"] == "ms"
    for e in d["traceEvents"]:
        assert {"name", "ph", "ts", "pid", "cat"} <= set(e)
        if e["ph"] == "X":
            assert e["dur"] >= 0 and {"tid", "args"} <= set(e)


def test_span_containment_and_export(tmp_path):
    _nested(tobs.tracing)
    ev = {e["name"]: e for e in tobs.tracing.TRACER.events}
    assert ev["inner"]["args"]["depth"] == 1
    assert ev["outer"]["args"]["depth"] == 0
    assert ev["outer"]["ts"] <= ev["inner"]["ts"]
    assert (ev["outer"]["ts"] + ev["outer"]["dur"]
            >= ev["inner"]["ts"] + ev["inner"]["dur"])
    p = tmp_path / "trace.json"
    tobs.tracing.export(str(p))
    assert json.loads(p.read_text()) == tobs.tracing.TRACER.to_dict()


def test_blocking_spans_wait_for_nothing_off_the_card(monkeypatch):
    """Only CUDA tensors get a completion event: CPU and meta tensors,
    nested in tuples, lists and dicts, record none, and with tracing off
    ``hold`` records nothing at all."""
    made = []
    monkeypatch.setattr(torch.cuda, "Event", lambda: made.append(1))
    held = ((torch.zeros(2), [torch.empty(3, device="meta")]),
            {"a": torch.ones(1)}, 5)
    with tobs.tracing.blocked_span("off") as hold:
        hold(*held)
    tobs.tracing.enable()
    with tobs.tracing.blocked_span("on") as hold:
        hold(*held)
    tobs.tracing.traced_call("call", lambda: held)
    assert made == []
    assert tobs.tracing.TRACER.span_names() == {
        "on", "call.dispatch", "call.block_until_ready"}


# ---------------------------------------------------------------------------
# Pool capacity, the monitor's feed and the SLO tracker
# ---------------------------------------------------------------------------


CAPACITY_POOLS = {
    "interwrap_mixed": (JLayout.INTERWRAP, 32, 16, 0),
    "interwrap_whole": (JLayout.INTERWRAP, 32, 32, 0),
    "baseline": (JLayout.BASELINE_ECC, 32, 0, 0),
    "parity": (JLayout.PARITY, 32, 24, 0),
    "daec_tier": (JLayout.INTERWRAP, 32, 16, 8),
}


@pytest.mark.parametrize("enabled", [False, True])
@pytest.mark.parametrize("case", list(CAPACITY_POOLS))
def test_record_pool_capacity_equals_the_reference(case, enabled):
    layout, rows, boundary, daec = CAPACITY_POOLS[case]
    jpool = jmake_pool(rows, layout, boundary=boundary, row_words=64,
                       daec_rows=daec)
    tpool = tmake_pool(rows, _tlayout(layout), boundary=boundary,
                       row_words=64, daec_rows=daec, device="cpu")
    for obs, pool in ((jobs, jpool), (tobs, tpool)):
        obs.metrics.enable(enabled)
        obs.metrics.record_pool_capacity("kv", pool)
    assert tobs.metrics.collect() == jobs.metrics.collect()
    assert _report(tobs) == _report(jobs)
    assert tobs.slo.TRACKER.capacity.keys() == {"kv"}


def _slo_sequence(pkg: str) -> None:
    """add_pool, adopt_pool, a repartition_with_migration and a scrub
    census through the monitor, in the named package."""
    if pkg == "jax":
        vm = JVM(row_words=64)
        vm.add_pool("kv", 32, JLayout.INTERWRAP, boundary=24)
        vm.adopt_pool("spare", jmake_pool(16, JLayout.PARITY, boundary=8,
                                          row_words=64))
        mig, mon, stats = JMigration(vm), JMonitor(), JScrubStats
    else:
        vm = TVM(row_words=64, device="cpu")
        vm.add_pool("kv", 32, TLayout.INTERWRAP, boundary=24)
        vm.adopt_pool("spare", tmake_pool(16, TLayout.PARITY, boundary=8,
                                          row_words=64, device="cpu"))
        mig, mon, stats = TMigration(vm), TMonitor(), TScrubStats
    vm.create_tenant("t")
    vm.alloc("t", 20, pool="kv")
    info = mig.repartition_with_migration("kv", 8)
    assert info["new_boundary"] == 8
    mon.record("kv", stats(beats_checked=4096, corrected_data=3,
                           detected_uncorrectable=1))
    mon.record("spare", stats(parity_lines_checked=512,
                              parity_corrupt_lines=2))


@pytest.mark.parametrize("enabled", [False, True])
def test_slo_tracker_is_fed_as_the_reference_is(enabled):
    """The port's pools, migrations and monitor feed the SLO tracker with
    every plane off, as the reference's do (the tracker used to see no
    capacity and no scrub census at all)."""
    for obs in PLANES:
        obs.metrics.enable(enabled)
    _slo_sequence("jax")
    _slo_sequence("torch")
    assert _report(tobs) == _report(jobs)
    assert tobs.slo.TRACKER.capacity.keys() == \
        jobs.slo.TRACKER.capacity.keys() == {"kv", "spare"}
    for name in ("kv", "spare"):
        assert vars(tobs.slo.TRACKER.capacity[name]) == \
            vars(jobs.slo.TRACKER.capacity[name])
    assert tobs.metrics.collect() == jobs.metrics.collect()


def test_scrub_sweep_span_and_monitor_metrics():
    for obs in PLANES:
        obs.tracing.enable()
        obs.metrics.enable()
    jpool = jmake_pool(16, JLayout.INTERWRAP, boundary=8, row_words=64)
    tpool = tmake_pool(16, TLayout.INTERWRAP, boundary=8, row_words=64,
                       device="cpu")
    jstate, jstats = jpool.scrub()
    tstate, tstats = tpool.scrub()
    JMonitor().record("kv", jstats)
    TMonitor().record("kv", tstats)
    assert _shape(tobs.tracing.TRACER.events) == \
        _shape(jobs.tracing.TRACER.events)
    assert tobs.metrics.collect() == jobs.metrics.collect()


# ---------------------------------------------------------------------------
# The serving engine with every plane on
# ---------------------------------------------------------------------------


def _prompts(n: int = 8) -> list:
    rng = np.random.default_rng(1)
    return [rng.integers(0, 256, size=12).astype(np.int32)
            for _ in range(n)]


def _vm_pair(layout: JLayout, boundary: int, daec: int):
    jvm = JVM(row_words=64)
    jvm.add_pool("kv", 32, layout, boundary=boundary, daec_rows=daec)
    tvm = TVM(row_words=64, device="cpu")
    tvm.add_pool("kv", 32, _tlayout(layout), boundary=boundary,
                  daec_rows=daec)
    return jvm, tvm


class Twin:
    """A reference and a port ``serve-test`` engine on the same weights
    and requests, every plane of both packages on."""

    def __init__(self, mode: str = "cream", pool=None):
        for obs in PLANES:
            obs.metrics.enable()
            obs.tracing.enable()
            obs.memprof.enable()
        kw = dict(max_batch=4, max_len=32, mode=mode, seed=0)
        if pool is None:
            kw.update(num_rows=32, row_words=64,
                      secded_rows=8 if mode == "cream" else 0)
            jvm = tvm = None
        else:
            jvm, tvm = _vm_pair(*pool)
        self.j = JEngine(JConfig(**SERVE_TEST), vm=jvm, **kw)
        self.t = TEngine(TConfig(**SERVE_TEST), vm=tvm, device="cpu", **kw)
        load_jax_params(self.t.model, jax.tree.map(np.asarray, self.j.params))
        tiers = ["paid" if i % 2 else "batch" for i in range(8)]
        self.jreqs = [JRequest(f"s{i}", p, 10, tier=tier)
                      for i, (p, tier) in enumerate(zip(_prompts(), tiers))]
        self.treqs = [TRequest(f"s{i}", p, 10, tier=tier)
                      for i, (p, tier) in enumerate(zip(_prompts(), tiers))]
        for a, b in zip(self.jreqs, self.treqs):
            self.j.submit(a)
            self.t.submit(b)
        self.matrices = []

    def poll(self) -> None:
        self.j.poll()
        self.t.poll()

    def step_matrices(self) -> None:
        """Both engines' read-status matrix of a gather over the bound
        slots' block tables (the call a step makes), the profilers off."""
        rows = np.asarray([s.row if s is not None else -1
                           for s in self.j.sched.slots])
        if not (rows >= 0).any():
            return
        phys = self.j.kv.gather_phys(rows).reshape(-1)
        for obs in PLANES:
            obs.memprof.disable()
        _, jc = self.j._gather_pages_counts(phys)
        _, tc = self.t._gather_pages_counts(phys)
        for obs in PLANES:
            obs.memprof.enable()
        np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
        self.matrices.append(tc.numpy())

    def plant(self, rows: list, double: int | None = None) -> None:
        """The same flips in both engines' pool: one data bit in each of
        ``rows``, two bits of one beat in ``double``."""
        jwords = np.asarray(self.j.pool.storage).copy()
        twords = self.t.pool.storage.numpy().copy().view(np.uint32)
        for words in (jwords, twords):
            for r in rows:
                words[r, 3, 5] ^= np.uint32(1 << 7)
            if double is not None:
                words[double, 2, 6] ^= np.uint32(0b11)
        self.j.vm.pools["kv"] = dataclasses.replace(
            self.j.pool, storage=jnp.asarray(jwords))
        self.t.vm.pools["kv"] = dataclasses.replace(
            self.t.pool, storage=torch.from_numpy(twords.view(np.int32)))

    def run(self, plant_at: int | None = None, rows=(), double=None) -> None:
        k = 0
        while self.j.sched.has_work():
            assert self.t.sched.has_work()
            if k == plant_at:
                self.plant(list(rows), double)
            self.step_matrices()
            self.poll()
            k += 1
        assert not self.t.sched.has_work()
        assert [r.generated for r in self.treqs] == \
            [r.generated for r in self.jreqs]

    def assert_planes_equal(self) -> None:
        assert tobs.metrics.collect() == jobs.metrics.collect()
        assert tobs.metrics.snapshot() == jobs.metrics.snapshot()
        shared, want, extra = torch_spans.split(
            tobs.tracing.TRACER.events, jobs.tracing.TRACER.events)
        assert shared == want
        assert extra == set(torch_spans.PORT_SPANS) - {"model.moe"}
        assert _report(tobs) == _report(jobs)
        recs = [(r.op, r.stream, r.step, r.pages.tolist())
                for r in tobs.memprof.records()]
        assert recs == [(r.op, r.stream, r.step, r.pages.tolist())
                        for r in jobs.memprof.records()]


def _secded_rows(twin: Twin) -> list:
    """Rows of protected pages the engines hold right now."""
    pool = twin.t.pool
    owned = sorted(p for p in twin.t.vm.allocators["kv"].owner
                   if pool.boundary <= p < pool.num_rows)
    assert owned, "no SECDED page in use"
    return owned


ENGINE_CASES = {
    "cream": dict(mode="cream"),
    "secded": dict(mode="secded"),
    "parity_pool": dict(mode="cream", pool=(JLayout.PARITY, 24, 0)),
    "daec_tier": dict(mode="cream", pool=(JLayout.INTERWRAP, 16, 8)),
}


@pytest.mark.parametrize("case", list(ENGINE_CASES))
def test_engine_with_every_plane_on_equals_the_reference(case):
    twin = Twin(**ENGINE_CASES[case])
    twin.run()
    twin.assert_planes_equal()
    snap = tobs.metrics.collect()
    series = {(r["labels"]["cls"], r["labels"]["status"])
              for r in snap[tobs.metrics.NAME_READ_STATUS]["series"]}
    assert series == {(c, s) for c in tobs.metrics.FOLD_CLASSES
                      for s in ("corrected", "uncorrectable")}
    assert tobs.metrics.REGISTRY.value(tobs.metrics.NAME_DECODE_STEPS) == \
        twin.t.steps
    assert {"engine.step.gather", "engine.step.compute",
            "engine.step.scatter", "serve.router.dispatch",
            "engine.prefill"} <= tobs.tracing.TRACER.span_names()


@pytest.mark.parametrize("mode", ["cream", "secded"])
def test_engine_with_planted_flips_equals_the_reference(mode):
    """Single flips in the protected pages the sessions hold, planted
    mid-run, and one double: the folded counts, the SLO verdicts and the
    tokens agree; the secded class's uncorrectable breaches its SLO."""
    twin = Twin(mode)
    for _ in range(3):
        twin.step_matrices()
        twin.poll()
    rows = _secded_rows(twin)
    twin.run(plant_at=0, rows=rows[1:], double=rows[0])
    twin.assert_planes_equal()
    total = sum(twin.matrices)
    sec = tobs.metrics.FOLD_CLASSES.index("secded")
    assert total[sec, 0] > 0 and total[sec, 1] > 0
    assert tobs.metrics.REGISTRY.value(
        tobs.metrics.NAME_READ_STATUS, cls="secded",
        status="uncorrectable") == total[sec, 1]
    breached = {s.scope for s in tobs.slo.TRACKER.breached()}
    assert "class/secded" in breached


SHARD_ONLY = (tobs.metrics.NAME_SHARD_DISPATCH,
              tobs.metrics.NAME_SHARD_RING_PAGES)


@pytest.mark.parametrize("shards,secded_rows", [(2, 16), (4, 32)])
def test_sharded_engine_with_every_plane_on_folds_as_the_reference(
        shards, secded_rows):
    """A port engine on a pool in banks against a reference engine on a
    local pool of the same global geometry (the reference's sharded pool
    is an oracle at one bank only), every plane on, the same single flips
    planted in protected pages mid-run and a scheduled migration between
    frames of a tenant of their own: equal tokens, per-step read-status
    matrices, SLO reports and ``collect()`` but for the sharded pool's
    own series; the migration step is ``engine.step.compute_ring``."""
    for obs in PLANES:
        obs.metrics.enable()
        obs.tracing.enable()
    kw = dict(max_batch=4, max_len=32, seed=0)
    j = JEngine(JConfig(**SERVE_TEST), mode="cream", num_rows=32,
                row_words=64, secded_rows=secded_rows, **kw)
    vm = TVM(row_words=64, device="cpu")
    vm.add_pool("kv", 32, TLayout.INTERWRAP, boundary=32 - secded_rows,
                shards=shards)
    t = TEngine(TConfig(**SERVE_TEST), vm=vm, pool="kv", **kw)
    load_jax_params(t.model, jax.tree.map(np.asarray, j.params))
    for v in (j.vm, t.vm):
        v.create_tenant("mig")
        v.alloc("mig", 8, allow_host=False)
    frames = [e.phys for _, e in sorted(t.vm.tenants["mig"].entries.items())]
    tiers = ["paid" if i % 2 else "batch" for i in range(8)]
    jreqs = [JRequest(f"s{i}", p, 10, tier=tier)
             for i, (p, tier) in enumerate(zip(_prompts(), tiers))]
    treqs = [TRequest(f"s{i}", p, 10, tier=tier)
             for i, (p, tier) in enumerate(zip(_prompts(), tiers))]
    for a, b in zip(jreqs, treqs):
        j.submit(a)
        t.submit(b)
    k = 0
    while j.sched.has_work():
        if k == 3:
            jw = np.asarray(j.pool.storage).copy()
            for page in (p for p in t.vm.allocators["kv"].owner
                         if j.pool.boundary <= p < 32):
                jw[page, page % 8, 3] ^= np.uint32(1 << 9)
                t.pool.storage[page % shards, page // shards, page % 8,
                               3] ^= 1 << 9
            j.vm.pools["kv"] = dataclasses.replace(
                j.pool, storage=jnp.asarray(jw))
            j.schedule_migration(frames[:4], frames[4:])
            t.schedule_migration(frames[:4], frames[4:])
        rows = np.asarray([s.row if s is not None else -1
                           for s in j.sched.slots])
        if (rows >= 0).any():
            phys = j.kv.gather_phys(rows).reshape(-1)
            np.testing.assert_array_equal(
                t._gather_pages_counts(phys)[1].numpy(),
                np.asarray(j._gather_pages_counts(phys)[1]))
        j.poll()
        t.poll()
        k += 1
    assert [r.generated for r in treqs] == [r.generated for r in jreqs]
    assert j.steps == t.steps
    got, want = tobs.metrics.collect(), jobs.metrics.collect()
    assert got[tobs.metrics.NAME_SHARD_RING_PAGES]["series"][0]["value"] \
        == 4
    assert {n: v for n, v in got.items() if n not in SHARD_ONLY} == want
    assert tobs.metrics.REGISTRY.value(
        tobs.metrics.NAME_READ_STATUS, cls="secded", status="corrected") > 0
    assert _report(tobs) == _report(jobs)
    shared, want, extra = torch_spans.split(
        tobs.tracing.TRACER.events, jobs.tracing.TRACER.events)
    names = torch_spans.names(tobs.tracing.TRACER.events)
    assert names["engine.step.compute_ring"] == 1
    assert names["shard.migrate.ring"] == 1
    assert shared["engine.step.compute"] + 1 == want["engine.step.compute"]
    shared["engine.step.compute"] += 1
    assert shared == want
    # the pool in banks: its own spans; the step's and the model's
    assert extra - set(torch_spans.PORT_SPANS) == {
        "engine.step.compute_ring", "shard.migrate.ring",
        "shard.fused.dispatch"}
    assert extra & set(torch_spans.PORT_SPANS) == \
        set(torch_spans.PORT_SPANS) - {"model.moe"}


def test_dashboard_and_creamtop_render_what_the_reference_renders(tmp_path):
    twin = Twin("cream")
    twin.run()
    snap = tobs.metrics.collect()
    assert tobs.dashboard.render() == jobs.dashboard.render()
    assert tobs.dashboard.render(snap=snap, statuses=[]) == \
        jobs.dashboard.render(snap=jobs.metrics.collect(), statuses=[])
    assert tobs.dashboard.render_slo(tobs.slo.TRACKER.report()) == \
        jobs.dashboard.render_slo(jobs.slo.TRACKER.report())
    path = tmp_path / "metrics.json"
    path.write_text(json.dumps(snap))
    assert _tool_output(["--snapshot", str(path)]) == \
        _tool_output(["--snapshot", str(path)], reference=True)


def _tool_output(argv: list, reference: bool = False) -> str:
    out = io.StringIO()
    old = sys.argv
    try:
        with contextlib.redirect_stdout(out):
            if reference:
                sys.argv = ["creamtop.py", *argv]
                runpy.run_path(str(ROOT / "tools" / "creamtop.py"),
                               run_name="__main__")
            else:
                tcreamtop.main(argv)
    finally:
        sys.argv = old
    return out.getvalue()


def test_creamtop_demo_needs_the_card_unless_told_otherwise():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        tcreamtop.main(["--demo"])
    text = tcreamtop.demo("cpu")
    assert "class/secded" in text and "cream_read_status_total" in text
    assert tobs.metrics.REGISTRY.value(
        tobs.metrics.NAME_READ_STATUS, cls="secded",
        status="corrected") > 0


# ---------------------------------------------------------------------------
# The mixed read's status output
# ---------------------------------------------------------------------------


def _flipped_pool(layout: JLayout, boundary: int):
    rng = np.random.default_rng(3)
    jpool = jmake_pool(32, layout, boundary=boundary, row_words=64)
    ids = np.arange(jpool.num_pages, dtype=np.int32)
    data = rng.integers(0, 2**32, (ids.size, jpool.page_words),
                        dtype=np.uint64).astype(np.uint32)
    jpool = jpool.write(ids, jnp.asarray(data))
    words = np.asarray(jpool.storage).copy()
    sec = np.arange(jpool.boundary, 32)
    for k, r in enumerate(sec[: len(sec) // 2]):
        words[r, k % 8, (7 * k) % 64] ^= np.uint32(1 << (k % 32))   # single
    if sec.size:
        words[sec[-1], 1, 3] ^= np.uint32(0b101)                     # double
        words[sec[-2], 8, 9] ^= np.uint32(1 << 4)                    # code
    return words, ids


@pytest.mark.parametrize("layout,boundary", [
    (JLayout.INTERWRAP, 16), (JLayout.INTERWRAP, 0), (JLayout.INTERWRAP, 32),
    (JLayout.BASELINE_ECC, 0), (JLayout.PACKED, 8),
    (JLayout.RANK_SUBSET, 24)])
def test_read_correct_status_equals_read_pages_any_status(layout, boundary):
    words, ids = _flipped_pool(layout, boundary)
    jpool = dataclasses.replace(
        jmake_pool(32, layout, boundary=boundary, row_words=64),
        storage=jnp.asarray(words))
    want_d, want_s = jread_status(jpool, jnp.asarray(ids))
    pages = torch.as_tensor(np.concatenate([ids, ids[::-1]]))
    got_d, got_s = mixed_ops.read_correct(
        torch.from_numpy(words.view(np.int32)), pages, _tlayout(layout), 32,
        jpool.boundary, status=True)
    n = ids.size
    np.testing.assert_array_equal(got_d[:n].numpy().view(np.uint32),
                                  np.asarray(want_d))
    np.testing.assert_array_equal(got_s[:n].numpy(), np.asarray(want_s))
    np.testing.assert_array_equal(got_s[n:].numpy(),
                                  np.asarray(want_s)[::-1])
    plain = mixed_ops.read_correct(torch.from_numpy(words.view(np.int32)),
                                   pages, _tlayout(layout), 32,
                                   jpool.boundary)
    assert torch.equal(plain, got_d)
    if jpool.boundary < 32:
        assert sorted(set(got_s.tolist())) == [0, 1, 2, 3]


class _Library:
    """Stands in for the built library: records each C call, returns 0."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        return lambda *args: self.calls.append((name, args)) or 0


def _meta_pool(layout: TLayout, boundary: int, daec: int = 0) -> PoolState:
    storage = torch.empty((32, 9, 64), dtype=torch.int32, device="meta")
    return PoolState(storage, boundary, layout, 64, daec)


@pytest.fixture
def stub_library(monkeypatch):
    lib = _Library()
    monkeypatch.setattr(common, "check_cuda_words", lambda *a, **k: None)
    monkeypatch.setattr(common, "library", lambda: lib)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda: type("S", (), {"cuda_stream": 7})())
    monkeypatch.setattr(torch.Tensor, "data_ptr", lambda self: 4096)
    monkeypatch.setattr(common, "LAUNCHES", common.collections.Counter())
    return lib


def _meta_engine(pool):
    """What ``Engine``'s gathers use of an engine, on meta tensors."""
    return types.SimpleNamespace(
        pool=pool, _ids=lambda a: torch.as_tensor(np.asarray(a, np.int32),
                                                  device="meta"))


@pytest.mark.parametrize("layout,boundary", [
    (TLayout.INTERWRAP, 24), (TLayout.INTERWRAP, 0),
    (TLayout.BASELINE_ECC, 0)])
def test_metrics_on_gather_is_one_launch_with_a_status_pointer(
        layout, boundary, stub_library):
    phys = np.arange(12)
    data, counts = tengine.Engine._gather_pages_counts(
        _meta_engine(_meta_pool(layout, boundary)), phys)
    [(name, args)] = stub_library.calls
    assert name == "mixed_read_correct"
    assert len(args) == len(common.ENTRIES[name])
    assert args[3] == 4096                              # status, not NULL
    assert args[4:] == (12, 64, int(layout == TLayout.INTERWRAP), 32,
                        boundary, args[-2], 7)
    assert common.LAUNCHES == {"mixed_read_correct": 1}
    assert data.shape == (12, 512)
    assert counts.shape == (len(tobs.metrics.FOLD_CLASSES), 2)


def test_metrics_off_gather_passes_a_null_status(stub_library):
    tengine.Engine._gather_pages(
        _meta_engine(_meta_pool(TLayout.INTERWRAP, 24)), np.arange(12))
    [(name, args)] = stub_library.calls
    assert name == "mixed_read_correct" and args[3] is None


@pytest.mark.parametrize("layout,boundary,daec", [
    (TLayout.PARITY, 24, 0), (TLayout.INTERWRAP, 16, 8)])
def test_parity_and_daec_pools_take_the_pools_status_read(
        layout, boundary, daec, monkeypatch, stub_library):
    pool = tmake_pool(32, layout, boundary=boundary, row_words=64,
                      daec_rows=daec, device="cpu")
    reads = []

    def read(self, pages, *, status=False):
        reads.append(status)
        return self.storage.new_zeros((len(pages), 512)), \
            self.storage.new_zeros(len(pages))

    monkeypatch.setattr(PoolState, "read", read)
    eng = types.SimpleNamespace(pool=pool, _ids=lambda a: torch.as_tensor(
        np.asarray(a, np.int32)))
    _, counts = tengine.Engine._gather_pages_counts(eng, np.arange(12))
    assert reads == [True] and stub_library.calls == []
    assert counts.sum() == 0


# ---------------------------------------------------------------------------
# Operations of one CPU decode step: metrics off against metrics on
# ---------------------------------------------------------------------------


class _OpCounter(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.ops = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops[str(func.overloadpacket)] += 1
        return func(*args, **(kwargs or {}))


def _ops(fn) -> collections.Counter:
    with _OpCounter() as c:
        fn()
    return c.ops


def _step_ops(metrics_on: bool) -> tuple[collections.Counter, object]:
    """The aten operations of one full-batch decode step of a CPU
    ``serve-test`` engine on a mixed SECDED / InterWrap pool."""
    tobs.metrics.enable(metrics_on)
    eng = TEngine(TConfig(**SERVE_TEST), max_batch=4, max_len=32,
                  num_rows=32, row_words=64, secded_rows=16, device="cpu")
    for i, p in enumerate(_prompts(4)):
        eng.submit(TRequest(f"s{i}", p, 8))
    eng.poll()                                      # prefills + one step
    seen = []
    walk = eng.kv.gather_phys
    eng.kv.gather_phys = lambda rows: seen.append(walk(rows)) or seen[-1]
    ops = _ops(eng.step)
    return ops, (eng, seen[0].reshape(-1))


def test_metrics_add_only_the_status_and_its_reduction_to_a_step():
    """Deterministic stand-in for the reference's wall-clock guards: with
    metrics on, a decode step runs the operations of the metrics-off step
    plus those of the plain status computation (the status read in place
    of the data-only read) and of the count reduction, and nothing else
    (the fold's ``numpy()`` of the counts is one ``detach``; on the card
    the copy to the host comes before it). The ids and the count rows
    share one upload, split by two views."""
    off, _ = _step_ops(False)
    on, (eng, phys) = _step_ops(True)
    pool = eng.pool
    storage, ids = pool.storage, torch.as_tensor(phys.astype(np.int32))
    args = (storage, ids, pool.layout, pool.num_rows, pool.boundary)
    read = _ops(lambda: mixed_ref.read_correct(*args))
    read_status = _ops(lambda: mixed_ref.read_correct(*args, status=True))
    _, status = mixed_ref.read_correct(*args, status=True)
    rows4 = torch.as_tensor(tengine._status_rows(pool, phys))
    reduction = _ops(lambda: tengine._status_counts(rows4, status))
    assert read_status != read
    views = collections.Counter({"aten.select": 2, "aten.detach": 1})
    assert on == off - read + read_status + reduction + views
    assert reduction.keys() <= {"aten.zeros", "aten.zero_", "aten.fill_",
                                "aten.empty", "aten.add", "aten.ones_like",
                                "aten.empty_like", "aten.index_add_",
                                "aten.index_add", "aten.view", "aten.select",
                                "aten.stack", "aten.cat", "aten.unsqueeze"}
