"""The scrub → monitor → adapt loop on the port equals the reference.

The scrub sweep against the reference's (``use_kernel=False``) and the
scrub wrapper against the reference's Pallas ``scrub_rows`` (interpret
mode), on mixed InterWrap and PARITY pools with planted flips; the health
monitor's recommendations; and ``VMPolicy.step`` end to end — the
reference's policy scenarios run on twin VMs (the port on the CPU), with
the same boundary moves, transitions and storage.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest

from repro.core import monitor as jmon
from repro.core import pool as jp
from repro.core import scrubber as jscrub
from repro.core.layouts import Layout as JLayout
from repro.core.protection import Protection as JProt
from repro.kernels.scrub import kernel as jscrub_kernel
from repro.objcache import ObjCache as JCache
from repro.vm import MigrationEngine as JMig
from repro.vm import VirtualMemory as JVM
from repro.vm import policy as jpolicy
from repro_torch.core import monitor as tmon
from repro_torch.core import pool as tp
from repro_torch.core.layouts import Layout, parity_coords
from repro_torch.core.protection import Protection
from repro_torch.kernels import common
from repro_torch.kernels.scrub import ops as scrub_ops
from repro_torch.objcache import ObjCache
from repro_torch.vm import MigrationEngine, VirtualMemory
from repro_torch.vm import policy as tpolicy

ROWS, W = 32, 64


def _filled(layout: Layout, boundary: int, seed: int):
    """Twin pools written with the same random pages."""
    rng = np.random.default_rng(seed)
    j = jp.make_pool(ROWS, JLayout(layout.value), boundary=boundary,
                     row_words=W)
    data = rng.integers(0, 2**32, (j.num_pages, 8 * W), dtype=np.uint32)
    j = j.write(np.arange(j.num_pages), jnp.asarray(data))
    t = tp.make_pool(ROWS, layout, boundary=boundary, row_words=W,
                     device="cpu")
    t = t.write(np.arange(t.num_pages), common.to_words(data))
    return j, t


def _flip(j, t, row, lane, word, bits):
    arr = np.asarray(j.storage).copy()
    arr[row, lane, word] ^= np.uint32(bits)
    t.storage.copy_(common.to_words(arr))
    return dataclasses.replace(j, storage=jnp.asarray(arr)), t


def _stats(s) -> dict:
    return {f.name: getattr(s, f.name) for f in dataclasses.fields(s)}


@pytest.mark.parametrize("layout,boundary", [
    (Layout.INTERWRAP, 8), (Layout.INTERWRAP, 0), (Layout.PARITY, 8),
    (Layout.PARITY, 24), (Layout.PARITY, ROWS)])
def test_scrub_matches_reference(layout, boundary):
    j, t = _filled(layout, boundary, 40 + boundary)
    if boundary < ROWS:                 # SECDED: data, code, double, double
        j, t = _flip(j, t, boundary, 3, 5, 1 << 4)
        j, t = _flip(j, t, boundary + 1, 8, 2, 1 << 30)
        j, t = _flip(j, t, ROWS - 1, 0, 6, 0b11)
        j, t = _flip(j, t, ROWS - 2, 7, W - 1, 1 << 31)
    if layout == Layout.PARITY and boundary:
        j, t = _flip(j, t, 3, 2, 17, 1 << 8)      # data of CREAM page 3
        prow, off = parity_coords(ROWS, boundary, np.asarray([5]), W)
        j, t = _flip(j, t, int(prow[0]), 8, int(off[0]), 1)   # page 5's entry
    before = t.storage.clone()
    j2, js = jscrub.scrub(j, use_kernel=False)
    t2, ts = t.scrub()
    assert t.storage.equal(before)            # functional: input intact
    assert _stats(ts) == _stats(js)
    np.testing.assert_array_equal(common.to_u32(t2.storage),
                                  np.asarray(j2.storage))
    if boundary < ROWS:
        assert ts.corrected_data == 2 and ts.corrected_code == 1
        assert ts.detected_uncorrectable == 1
    if layout == Layout.PARITY and boundary:
        assert ts.parity_corrupt_lines == 2 and {3, 5} <= set(ts.corrupt_rows)
    # a second sweep finds only what a scrub cannot repair
    _, ts2 = t2.scrub(use_kernel=True)
    assert ts2.corrected == 0
    assert ts2.detected_uncorrectable == ts.detected_uncorrectable


def test_scrub_rows_matches_pallas():
    j, t = _filled(Layout.INTERWRAP, 0, 7)
    j, t = _flip(j, t, 2, 1, 9, 1 << 17)
    j, t = _flip(j, t, 5, 8, 0, 1 << 3)
    j, t = _flip(j, t, 9, 4, 4, 0b1001)
    want_rows, want_st = jscrub_kernel.scrub_rows(j.storage)
    got_rows, got_st = scrub_ops.scrub_rows(t.storage)
    np.testing.assert_array_equal(common.to_u32(got_rows),
                                  np.asarray(want_rows))
    np.testing.assert_array_equal(got_st.numpy(), np.asarray(want_st))
    assert sorted(np.unique(want_st).tolist()) == [0, 1, 2, 3]
    sto, st, bad = scrub_ops.scrub_secded(t.storage, 8)
    assert sto[:8].equal(t.storage[:8])
    assert sto[8:].equal(got_rows[8:]) and st.equal(got_st[8:])
    assert bad.nonzero()[:, 0].tolist() == [1]
    with pytest.raises(ValueError, match="expected"):
        scrub_ops.scrub_rows(t.storage[:, :8])


def test_scrub_of_a_daec_tier_is_not_ported_yet():
    """The DAEC tier is ported now: its sweep equals the reference's
    (census and storage), a superbeat's verdict counting on both beats."""
    rng = np.random.default_rng(5)
    j = jp.make_pool(16, JLayout.INTERWRAP, boundary=8, row_words=W,
                     daec_rows=4)
    t = tp.make_pool(16, Layout.INTERWRAP, boundary=8, row_words=W,
                     daec_rows=4, device="cpu")
    data = rng.integers(0, 2**32, (j.num_pages, 8 * W), dtype=np.uint32)
    j = j.write(np.arange(j.num_pages), jnp.asarray(data))
    t = t.write(np.arange(t.num_pages), common.to_words(data))
    j, t = _flip(j, t, 13, 2, 9, 0b11 << 6)       # DAEC: adjacent double
    j, t = _flip(j, t, 10, 4, 1, 0b11 << 6)       # SECDED: detected
    (js, jstats), (ts, tstats) = j.scrub(), t.scrub()
    np.testing.assert_array_equal(common.to_u32(ts.storage),
                                  np.asarray(js.storage))
    assert _stats(tstats) == _stats(jstats)
    assert (tstats.corrected_data, tstats.detected_uncorrectable) == (2, 1)
    assert tstats.corrupt_rows == (10,)


# ---------------------------------------------------------------------------
# The health monitor
# ---------------------------------------------------------------------------


def test_monitor_recommendations_match_reference():
    cfg = dict(window=2, upgrade_threshold=1e-6, downgrade_threshold=1e-9,
               downgrade_patience=2)
    jm, tm = jmon.ErrorMonitor(jmon.MonitorConfig(**cfg)), \
        tmon.ErrorMonitor(tmon.MonitorConfig(**cfg))
    feed = [dict(beats_checked=1000, corrected_data=0),
            dict(beats_checked=1000),
            dict(beats_checked=10**7, corrected_data=50),
            dict(beats_checked=10**7, corrected_code=1),
            dict(parity_lines_checked=64, parity_corrupt_lines=1),
            dict(beats_checked=10**9)]
    for i, kw in enumerate(feed):
        jm.record("p", jscrub.ScrubStats(**kw))
        tm.record("p", tmon.ScrubStats(**kw))
        if i == 3:
            jm.record_observation("p", 500, corrected=1, silent=1)
            tm.record_observation("p", 500, corrected=1, silent=1)
        assert tm.rate("p") == jm.rate("p")
        for cur in Protection:
            for floor, ceil in ((Protection.NONE, Protection.SECDED),
                                (Protection.PARITY, Protection.DAEC)):
                got = tm.recommend("p", cur, floor, ceil)
                want = jm.recommend("p", JProt(cur.value), JProt(floor.value),
                                    JProt(ceil.value))
                assert got.value == want.value
        if i == 4:
            jm.acknowledge_transition("p")
            tm.acknowledge_transition("p")
    assert tm.recommend("q", Protection.NONE) == Protection.NONE


# ---------------------------------------------------------------------------
# VMPolicy.step end to end
# ---------------------------------------------------------------------------


class TwinVM:
    def __init__(self, row_words=W):
        self.j = JVM(row_words=row_words)
        self.t = VirtualMemory(row_words=row_words, device="cpu")

    def add_pool(self, name, rows, layout, boundary=None):
        self.j.add_pool(name, rows, JLayout(layout.value), boundary=boundary)
        self.t.add_pool(name, rows, layout, boundary=boundary)

    def flip(self, name, row, lane, word, bits):
        self.j.pools[name], self.t.pools[name] = _flip(
            self.j.pools[name], self.t.pools[name], row, lane, word, bits)

    def check(self):
        for name in self.j.pools:
            np.testing.assert_array_equal(
                common.to_u32(self.t.pools[name].storage),
                np.asarray(self.j.pools[name].storage))
            assert self.t.pools[name].boundary == self.j.pools[name].boundary
            assert self.t.allocators[name].owner == \
                self.j.allocators[name].owner
        for name, space in self.j.tenants.items():
            assert {v: (p.pool, p.phys) for v, p in
                    self.t.tenants[name].entries.items()} == \
                {v: (p.pool, p.phys) for v, p in space.entries.items()}


class TwinPolicy:
    def __init__(self, vm: TwinVM, pool_policies=None, **cfg):
        jpp = {k: jpolicy.PoolPolicy(JProt(p.floor.value),
                                     JProt(p.ceiling.value))
               for k, p in (pool_policies or {}).items()}
        self.j = jpolicy.VMPolicy(vm.j, JMig(vm.j), jmon.MonitorConfig(**cfg),
                                  pool_policies=jpp)
        self.t = tpolicy.VMPolicy(vm.t, MigrationEngine(vm.t),
                                  tmon.MonitorConfig(**cfg),
                                  pool_policies=pool_policies)
        self.vm = vm

    def step(self):
        js, jperf = self.j.step()
        ts, tperf = self.t.step(use_kernel=True)
        assert {k: _stats(s) for k, s in ts.items()} == \
            {k: _stats(s) for k, s in js.items()}
        assert tperf == jperf
        assert [(n, a.value, b.value) for n, a, b in self.t.transitions] == \
            [(n, a.value, b.value) for n, a, b in self.j.transitions]
        self.vm.check()
        return tperf


def _values(keys, span):
    keys = np.asarray(keys, np.uint32)
    return keys[:, None] * np.arange(1, span + 1, dtype=np.uint32)


def test_policy_driven_upgrade_keeps_cache_intact():
    """The scenario of tests/test_objcache.py: an uncorrectable pattern in a
    SECDED row of a mixed pool trips the monitor, the pool upgrades to full
    SECDED, and the cache follows with every value found (the one the
    double flip hit reads as the reference reads it)."""
    vm = TwinVM(row_words=32)
    vm.add_pool("dimm", 16, Layout.INTERWRAP, boundary=8)
    jc = JCache(vm.j, "dimm", index_capacity=128, probe=8)
    tc = ObjCache(vm.t, "dimm", index_capacity=128, probe=8)
    keys = np.arange(1, 40)
    vals = _values(keys, vm.t.page_words)
    np.testing.assert_array_equal(tc.set_many(keys, vals),
                                  jc.set_many(keys, vals))
    kept = keys[tc.get_many(keys)[2]]
    jc.get_many(keys)
    policy = TwinPolicy(vm, window=1, upgrade_threshold=1e-9)
    vm.flip("dimm", 12, 1, 2, 0b11)
    perf = policy.step()
    assert len(perf) == 1 and vm.t.pools["dimm"].boundary == 0
    assert tc.refresh_translation() == jc.refresh_translation()
    got, lens, found = tc.get_many(kept)
    for w, g in zip(jc.get_many(kept), (got, lens, found), strict=True):
        np.testing.assert_array_equal(g, w)
    assert found.all()


def test_multitenant_monitor_driven_upgrade_and_quiet_downgrade():
    """The scenarios of tests/test_vm.py: a healthy epoch moves nothing; a
    double flip in an unmapped SECDED row upgrades the mixed pool with every
    page kept; a quiet all-SECDED pool downgrades to CREAM after its
    patience; a floor pins the spare pool."""
    rng = np.random.default_rng(3)
    vm = TwinVM()
    vm.add_pool("p0", 32, Layout.INTERWRAP, 16)
    vm.add_pool("spare", 16, Layout.INTERWRAP, 0)
    vm.add_pool("quiet", 16, Layout.PARITY, 0)
    for name, rel in (("secure", Protection.SECDED),
                      ("bulk", Protection.NONE)):
        vm.j.create_tenant(name, JProt(rel.value))
        vm.t.create_tenant(name, rel)
    spans = {}
    for name, n in (("secure", 6), ("bulk", 18)):
        vpns = vm.j.alloc(name, n, allow_host=False, pool="p0")
        assert vm.t.alloc(name, n, allow_host=False, pool="p0") == vpns
        data = rng.integers(0, 2**32, (n, 8 * W), dtype=np.uint32)
        vm.j.write(name, vpns, jnp.asarray(data))
        vm.t.write(name, vpns, data)
        spans[name] = (vpns, data)
    policy = TwinPolicy(vm, {"spare": tpolicy.PoolPolicy(
        floor=Protection.SECDED)}, window=2, upgrade_threshold=1e-9,
        downgrade_patience=2)
    assert policy.step() == []                    # healthy epoch
    vm.flip("p0", 30, 0, 0, 0b11)
    perf = policy.step()
    assert [p["pool"] for p in perf] == ["p0", "quiet"]
    assert vm.t.pools["p0"].boundary == 0 and perf[0]["migrated"] >= 2
    assert vm.t.pools["quiet"].boundary == 16     # downgraded to PARITY
    for name, (vpns, data) in spans.items():
        np.testing.assert_array_equal(common.to_u32(vm.t.read(name, vpns)),
                                      data)
    assert policy.step() == []
    assert vm.t.pools["spare"].boundary == 0      # pinned by its floor


def test_campaign_methods_raise_until_their_slice():
    """The tenant-SLO methods are ported now: the same calls on twin VMs
    give the reference's observed rates, escalations (NONE -> PARITY by the
    SLO, then SECDED -> DAEC through a carved tier), placements and data."""
    from repro.obs import slo as jslo
    from repro_torch.obs import slo as tslo
    jslo.TRACKER.reset()
    tslo.TRACKER.reset()
    twins = []
    for vm, mod, prot, lay in (
            (JVM(row_words=W), jpolicy, JProt, JLayout),
            (VirtualMemory(row_words=W, device="cpu"), tpolicy, Protection,
             Layout)):
        vm.add_pool("p", 32, lay.INTERWRAP, boundary=16)
        vm.create_tenant("t", segments={"s": prot.NONE})
        policy = mod.VMPolicy(vm)
        policy.set_tenant_slo("t", "s", mod.TenantSLO(
            max_error_rate=0.01, min_reads=50, ceiling=prot.DAEC))
        vpns = vm.alloc("t", 6, segment="s")
        vm.write("t", vpns, np.arange(6 * vm.page_words, dtype=np.uint32)
                 .reshape(6, -1))
        policy.observe_reads("t", "s", 40, detected=1)
        steps = [policy.observed_error_rate("t", "s"),
                 policy.auto_escalate()]              # below min_reads
        policy.observe_reads("t", "s", 40, silent=1)
        steps.append(policy.auto_escalate())         # NONE -> PARITY
        steps.append(policy.escalate_tenant("t", "s", prot.DAEC))
        steps.append(policy.ensure_daec_frames(3))
        pages = [(vm.translate("t", v).phys,
                  vm.effective_protection("t", v).value) for v in vpns]
        data = vm.read("t", vpns)
        twins.append((steps, pages, vm.pools["p"].daec_rows,
                      common.to_u32(data) if prot is Protection
                      else np.asarray(data)))
    (jsteps, jpages, jrows, jdata), (tsteps, tpages, trows, tdata) = twins
    assert tsteps[0] == jsteps[0] == 1 / 40
    assert tsteps[1] == jsteps[1] == []
    norm = lambda e: {k: getattr(v, "value", v)  # noqa: E731
                      for k, v in e.items()}
    assert [norm(e) for e in tsteps[2]] == [norm(e) for e in jsteps[2]]
    assert tsteps[2][0]["to"] == Protection.PARITY
    assert norm(tsteps[3]) == norm(jsteps[3])
    assert tsteps[4] == jsteps[4] >= 3
    assert tpages == jpages and trows == jrows > 0
    assert all(c == "daec" for _, c in tpages)
    np.testing.assert_array_equal(tdata, jdata)
    assert dataclasses.asdict(tslo.TRACKER.tenants["t/s"]) == \
        dataclasses.asdict(jslo.TRACKER.tenants["t/s"])
    assert tpolicy.pool_protection(
        tp.make_pool(16, Layout.PARITY, boundary=8, row_words=W,
                     device="cpu")) == Protection.PARITY
