"""CREAM-Lens on the port (``repro_torch.obs.memprof`` and its bank model
``repro_torch.obs.dram_sim``) against the reference's.

The same numpy page ids and slices go to both packages; both profilers
start and end each test off and empty. Held equal:

  * capture: records, the ``MAX_RECORDS`` cap and its ``dropped`` count,
    reset / clear / publish, tensors and numpy ids alike;
  * attribution: ``page_coords_np`` / ``code_rows_np`` for every layout
    and boundary;
  * the bank model: the copied ``BankArray`` replay against
    ``benchmarks/dram_sim.py`` on the same seeded slices, counter for
    counter;
  * replay and export: ``profile()`` of the same records, the
    ``cream_dram_bank_*`` gauges, the Perfetto counter tracks, ``collect()``;
  * the hooks: the pool verbs' records equal the reference's verb for
    verb; a routed dispatch at S = 1 equals the reference's sharded pool,
    at S = 4 the records built from ``router.route_np`` (the reference's
    sharded pool is an oracle at S = 1 only); the object cache's stream;
    one ``decode`` gather and one scatter per engine step.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import benchmarks.dram_sim as jsim
import repro.obs as jobs
import repro_torch.obs as tobs
from repro.core.layouts import Layout as JLayout
from repro.core.layouts import extra_page_count
from repro.core.pool import make_pool as jmake_pool
from repro.obs import memprof as jmemprof
from repro.shard import pool as jshard
from repro_torch.core.layouts import Layout as TLayout
from repro_torch.core.pool import make_pool as tmake_pool
from repro_torch.obs import dram_sim as tsim
from repro_torch.obs import memprof as tmemprof
from repro_torch.shard import pool as tshard
from repro_torch.shard import router

LAYOUTS = tuple(JLayout)


@pytest.fixture(autouse=True)
def _clean():
    for obs in (jobs, tobs):
        obs.memprof.disable()
        obs.memprof.clear()
        obs.metrics.disable()
        obs.metrics.REGISTRY.clear()
        obs.tracing.disable()
        obs.tracing.reset()
    yield
    for obs in (jobs, tobs):
        obs.memprof.disable()
        obs.memprof.clear()
        obs.metrics.disable()
        obs.metrics.REGISTRY.clear()


def _t(layout: JLayout) -> TLayout:
    return TLayout(layout.value)


def _recs(mod) -> list:
    return [(r.step, r.op, r.pages.tolist(), r.layout.value, r.num_rows,
             r.boundary, r.row_words, r.pool, r.stream)
            for r in mod.records()]


def _as_jax(recs) -> list:
    """Port records as reference records (same ids, clock and geometry)."""
    return [jmemprof.AccessRecord(r.step, r.t_us, r.op, r.pages,
                                  JLayout(r.layout.value), r.num_rows,
                                  r.boundary, r.row_words, r.pool, r.stream)
            for r in recs]


# ---------------------------------------------------------------------------
# Capture
# ---------------------------------------------------------------------------


def test_capture_equals_the_reference():
    geo = dict(num_rows=32, boundary=16, row_words=16)
    for mod, layout in ((jmemprof, JLayout.INTERWRAP),
                        (tmemprof, TLayout.INTERWRAP)):
        mod.record("gather", np.arange(4), layout=layout, **geo)   # off
        mod.enable()
        mod.record("gather", np.arange(4), layout=layout, **geo)
        mod.next_step()
        ids = torch.arange(5, 9) if mod is tmemprof else np.arange(5, 9)
        mod.record("scatter", ids, layout=layout, stream="s", pool="p",
                   **geo)
        with pytest.raises(ValueError):
            mod.record("read", [1], layout=layout, **geo)
    assert _recs(tmemprof) == _recs(jmemprof)
    assert tmemprof.MAX_RECORDS == jmemprof.MAX_RECORDS


def test_cap_counts_drops_and_reset_keeps_published():
    geo = dict(layout=TLayout.INTERWRAP, num_rows=16, boundary=8)
    tmemprof.enable()
    for _ in range(tmemprof.MAX_RECORDS + 3):
        tmemprof.record("gather", [0], **geo)
    assert len(tmemprof.records()) == tmemprof.MAX_RECORDS
    assert tmemprof.PROFILER.dropped == 3
    tmemprof.publish("p", {"x": 1})
    tmemprof.reset()
    assert tmemprof.records() == [] and tmemprof.PROFILER.dropped == 0
    assert tmemprof.PROFILER.published == {"p": {"x": 1}}
    tmemprof.clear()
    assert tmemprof.PROFILER.published == {}


def test_suspended_records_nothing_and_restores():
    geo = dict(layout=TLayout.INTERWRAP, num_rows=16, boundary=8)
    tmemprof.enable()
    with tmemprof.suspended():
        tmemprof.record("gather", [0], **geo)
    tmemprof.record("gather", [1], **geo)
    assert [r.pages.tolist() for r in tmemprof.records()] == [[1]]
    tmemprof.disable()
    with tmemprof.suspended():
        pass
    assert not tmemprof.enabled()


# ---------------------------------------------------------------------------
# Attribution
# ---------------------------------------------------------------------------


def _boundaries(layout, num_rows):
    if layout == JLayout.BASELINE_ECC:
        return (0,)
    return (0, 8, num_rows // 2, num_rows)


@pytest.mark.parametrize("row_words", [16, 64])
@pytest.mark.parametrize("layout", LAYOUTS)
def test_attribution_equals_the_reference(layout, row_words):
    num_rows = 32
    for boundary in _boundaries(layout, num_rows):
        total = num_rows + extra_page_count(layout, boundary, row_words)
        pages = np.arange(total)
        for got, want in zip(
                tmemprof.page_coords_np(_t(layout), num_rows, boundary,
                                        pages, row_words),
                jmemprof.page_coords_np(layout, num_rows, boundary, pages,
                                        row_words)):
            np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(
            tmemprof.code_rows_np(_t(layout), num_rows, boundary, pages,
                                  row_words),
            jmemprof.code_rows_np(layout, num_rows, boundary, pages,
                                  row_words))


# ---------------------------------------------------------------------------
# The bank model
# ---------------------------------------------------------------------------


def test_bank_model_constants_equal_the_reference():
    assert dataclasses.asdict(tsim.Timing()) == \
        dataclasses.asdict(jsim.Timing())
    assert tsim.NUM_BANKS == jsim.NUM_BANKS
    for row in range(100):
        assert tsim.bank_of(row) == jsim.bank_of(row)


@pytest.mark.parametrize("bridge", [0, 1])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_bank_array_replay_equals_dram_sim(seed, bridge):
    """The same seeded lockstep accesses (up to 9 slices each, rows from a
    small set so hits, conflicts and tFAW stalls all occur) through both
    ``BankArray``s: every bank's counters and row state, the overlap and
    queue samples, the makespan and the derived rates agree."""
    rng = np.random.default_rng(seed)
    arrays = [m.BankArray(m.Timing(), bridge_cycles=bridge)
              for m in (jsim, tsim)]
    now = 0
    for _ in range(300):
        k = int(rng.integers(1, 10))
        slices = [(int(c), int(b), int(r)) for c, b, r in zip(
            rng.choice(9, k, replace=False), rng.integers(0, 8, k),
            rng.integers(0, 6, k))]
        done = [a.access(slices, now) for a in arrays]
        assert done[0] == done[1]
        now = done[0] if rng.random() < 0.3 else now + int(
            rng.integers(0, 12))
    ja, ta = arrays
    for c in range(9):
        for b in range(8):
            assert vars(ta.machine(c, b).counters) == \
                vars(ja.machine(c, b).counters)
            assert ta.machine(c, b).open_row == ja.machine(c, b).open_row
    assert vars(ta.totals()) == vars(ja.totals())
    assert (ta.blp_samples, ta.queue_depths, ta.sample_times,
            ta.finish_cycle) == (ja.blp_samples, ja.queue_depths,
                                 ja.sample_times, ja.finish_cycle)
    assert (ta.row_hit_rate, ta.achieved_blp, ta.blp_histogram(),
            ta.queue_depth_percentile(99)) == (
        ja.row_hit_rate, ja.achieved_blp, ja.blp_histogram(),
        ja.queue_depth_percentile(99))


def test_rank_timers_equal_the_reference():
    t = [m.RankTimers(m.Timing()) for m in (jsim, tsim)]
    for ready in (0, 1, 2, 3, 5, 8, 9, 30, 31, 31, 60):
        got = [x.earliest_act(ready) for x in t]
        assert got[0] == got[1]
        for x in t:
            x.commit_act(got[0][0])


# ---------------------------------------------------------------------------
# Replay and export
# ---------------------------------------------------------------------------


def _seeded_records() -> list:
    """Port records of every layout, two pools and streams, three steps."""
    rng = np.random.default_rng(7)
    tmemprof.enable()
    for step in range(3):
        for layout in LAYOUTS:
            b = 0 if layout == JLayout.BASELINE_ECC else 16
            n_pages = 32 + extra_page_count(layout, b, 64)
            for op in ("gather", "scatter"):
                tmemprof.record(op, rng.integers(0, n_pages, 24),
                                layout=_t(layout), num_rows=32, boundary=b,
                                row_words=64, pool=layout.value,
                                stream="main" if op == "gather" else "w")
        tmemprof.next_step()
    recs = tmemprof.records()
    tmemprof.disable()
    tmemprof.reset()
    return recs


def test_profile_of_the_same_records_equals_the_reference():
    recs = _seeded_records()
    got = tmemprof.profile(recs)
    want = jmemprof.profile(_as_jax(recs))
    assert got == want
    assert got["overall"]["accesses"] > 0 and got["streams"]
    timing = tsim.Timing(tRCD=20, bridge=2)
    assert tmemprof.profile(recs, timing) == jmemprof.profile(
        _as_jax(recs), jsim.Timing(tRCD=20, bridge=2))


def test_export_equals_the_reference():
    recs = _seeded_records()
    for obs, r in ((tobs, recs), (jobs, _as_jax(recs))):
        obs.metrics.enable()
        prof = obs.memprof.profile(r)
        obs.memprof.publish("suite", prof)
        obs.memprof.emit_metrics(prof, suite="suite")
    assert tobs.metrics.collect() == jobs.metrics.collect()
    blob_t = {"profiles": tobs.memprof.PROFILER.published}
    blob_j = {"profiles": jobs.memprof.PROFILER.published}
    assert tobs.memprof.counter_events(blob_t) == \
        jobs.memprof.counter_events(blob_j)
    assert tobs.dashboard.render_bank_heatmap(blob_t) == \
        jobs.dashboard.render_bank_heatmap(blob_j)
    assert tobs.memprof.collect() == jobs.memprof.collect()


def test_collect_replays_live_records():
    recs = _seeded_records()
    for mod in (tmemprof, jmemprof):
        mod.PROFILER.records = list(recs if mod is tmemprof
                                    else _as_jax(recs))
    assert tmemprof.collect() == jmemprof.collect()
    assert tmemprof.collect()["profiles"]["live"]["records"] == len(recs)


# ---------------------------------------------------------------------------
# The hooks
# ---------------------------------------------------------------------------


def _pool_pair(layout: JLayout, boundary: int, daec: int = 0):
    return (jmake_pool(32, layout, boundary=boundary, row_words=64,
                       daec_rows=daec),
            tmake_pool(32, _t(layout), boundary=boundary, row_words=64,
                       daec_rows=daec, device="cpu"))


def _verbs(pool, pkg: str):
    """Each verb of the pool surface once, with the same ids."""
    rng = np.random.default_rng(4)
    n = pool.num_pages
    ids = rng.choice(n, 10, replace=False)
    data = rng.integers(0, 2**32, (10, pool.page_words),
                        dtype=np.uint64).astype(np.uint32)
    data = jnp.asarray(data) if pkg == "jax" else \
        torch.from_numpy(data.view(np.int32))
    pool = pool.write(ids, data)
    pool.read(ids[:4])
    pool.read(ids[4:], status=True)
    pool.read_writeback(ids[:3])
    pool = pool.migrate(ids[:2], ids[8:])
    pool, _ = pool.move_boundary(0 if pool.boundary else 8)
    pool.memprof_record("gather", ids[:5], stream="x")


@pytest.mark.parametrize("layout,boundary,daec", [
    (JLayout.INTERWRAP, 16, 0), (JLayout.PARITY, 16, 0),
    (JLayout.BASELINE_ECC, 0, 8)])
def test_pool_verbs_record_as_the_reference_does(layout, boundary, daec):
    jpool, tpool = _pool_pair(layout, boundary, daec)
    for mod in (jmemprof, tmemprof):
        mod.enable()
    _verbs(jpool, "jax")
    _verbs(tpool, "torch")
    assert _recs(tmemprof) == _recs(jmemprof)
    assert len(_recs(tmemprof)) >= 7


def test_routed_records_at_one_bank_equal_the_reference():
    jpool = jshard.make_sharded_pool(32, JLayout.INTERWRAP, boundary=16,
                                     num_shards=1, row_words=64)
    tpool = tshard.make_sharded_pool(32, TLayout.INTERWRAP, boundary=16,
                                     num_shards=1, row_words=64,
                                     device="cpu")
    rng = np.random.default_rng(5)
    ids = rng.choice(tpool.num_pages, 12, replace=False)
    for mod in (jmemprof, tmemprof):
        mod.enable()
    for pool in (jpool, tpool):
        data = pool.read(ids)
        pool = pool.write(ids, data)
        pool.read(ids[:5], status=True)
        pool.read_writeback(ids[5:])
        pool.memprof_record("scatter", ids[:3], stream="decode")
    assert _recs(tmemprof) == _recs(jmemprof)
    streams = {r.stream for r in tmemprof.records()}
    assert streams == {"bank0", "decode/bank0"}


@pytest.mark.parametrize("layout", [JLayout.INTERWRAP, JLayout.PARITY,
                                    JLayout.BASELINE_ECC])
def test_routed_records_at_four_banks_follow_the_router(layout):
    """Each dispatch gives one record per bank it touches: the bank's local
    ids in batch order, against its own geometry (the records built from
    ``router.route_np``); migrations, repartitions and the stream verbs'
    bank reads add nothing of their own."""
    S, R = 4, 128
    b = 0 if layout == JLayout.BASELINE_ECC else 64
    pool = tshard.make_sharded_pool(R, _t(layout), boundary=b, num_shards=S,
                                    row_words=64, device="cpu")
    rng = np.random.default_rng(6)
    ids = rng.choice(pool.num_pages, 20, replace=False)
    tmemprof.enable()
    pool = pool.write(ids, torch.zeros((20, pool.page_words),
                                       dtype=torch.int32))
    pool.read(ids)
    pool.read(ids[:7], status=True)
    pool.migrate(ids[:2], ids[18:])
    if b:
        pool, _ = pool.move_boundary(32)
    aligned = np.stack([np.arange(3) * S + s for s in range(S)])
    pool.streams(aligned)
    want = []
    for op, batch, stream in (("scatter", ids, "main"),
                              ("gather", ids, "main"),
                              ("gather", ids[:7], "main"),
                              ("gather", aligned.reshape(-1), "streams")):
        shard, local = router.route_np(batch, R, S)
        prefix = "" if stream == "main" else f"{stream}/"
        for s in range(S):
            if (shard == s).any():
                want.append((0, op, local[shard == s].tolist(),
                             layout.value, R // S, b // S, 64, "pool",
                             f"{prefix}bank{s}"))
    got = _recs(tmemprof)
    # the repartition moves the boundary: the stream reads' geometry is
    # the new one
    if b:
        want = want[:-S] + [w[:5] + (32 // S,) + w[6:] for w in want[-S:]]
    assert got == want


def test_objcache_records_its_stream_once_a_batch():
    from repro.objcache import ObjCache as JCache
    from repro.vm import VirtualMemory as JVM
    from repro_torch.objcache import ObjCache as TCache
    from repro_torch.vm import VirtualMemory as TVM
    keys = np.arange(1, 7)
    vals = np.arange(6 * 128, dtype=np.uint32).reshape(6, 128)
    for mod, vm, cache_cls, layout in (
            (jmemprof, JVM(row_words=16), JCache, JLayout.INTERWRAP),
            (tmemprof, TVM(row_words=16, device="cpu"), TCache,
             TLayout.INTERWRAP)):
        vm.add_pool("dimm", 16, layout, boundary=8)
        cache = cache_cls(vm, "dimm", index_capacity=64, probe=8)
        mod.enable()
        assert cache.set_many(keys, vals).all()
        _, _, found = cache.get_many(keys)
        assert found.all()
    assert _recs(tmemprof) == _recs(jmemprof)
    assert {(r.op, r.stream) for r in tmemprof.records()} == {
        ("scatter", "objcache"), ("gather", "objcache")}


def test_engine_records_one_decode_gather_and_one_scatter_a_step():
    from repro_torch.configs.base import ModelConfig
    from repro_torch.serve import Engine, ServeRequest
    cfg = ModelConfig(name="serve-test", family="dense", num_layers=2,
                      d_model=64, num_heads=4, num_kv_heads=2, d_ff=128,
                      vocab_size=256, head_dim=16, dtype="float32")
    for metrics_on in (False, True):
        tobs.metrics.enable(metrics_on)
        eng = Engine(cfg, max_batch=2, max_len=24, num_rows=32,
                     row_words=64, secded_rows=8, device="cpu")
        for i in range(2):
            eng.submit(ServeRequest(f"s{i}", np.arange(1, 7), 6,
                                    tier="paid" if i % 2 else "batch"))
        eng.poll()                           # prefills + the first step
        tmemprof.enable()
        tmemprof.reset()
        eng.step()
        eng.step()
        recs = tmemprof.records()
        assert [(r.op, r.stream, r.step) for r in recs] == [
            ("gather", "decode", 1), ("scatter", "main", 1),
            ("gather", "decode", 2), ("scatter", "main", 2)]
        tmemprof.disable()
