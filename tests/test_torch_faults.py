"""CREAM-Campaign on the port equals the reference.

The same numpy inputs and seeds through ``repro`` and ``repro_torch`` (on
the CPU):

  * injection seed for seed — ``inject_flips``, ``apply_flips`` and
    ``FaultModel.step`` / ``step_pool`` with hard cells and with a cell
    drawn twice in one step: identical flips and storage;
  * the shadow oracle's verdicts for each error shape × reliability class
    (the cases of ``tests/test_fault_tolerance.py``): identical census
    and surfaced data;
  * the tenant-SLO escalation (NONE → PARITY → SECDED, and SECDED → DAEC
    through a carved tier): identical escalations, placements and data;
  * the DAEC campaign tick by tick, and a small serve campaign at the
    reference's ``faults-test`` config: identical census, escalations and
    first escalation step, and equal paid-tier tokens;
  * the three paths that must not bypass a wrapped pool — the engine's
    fused read and the migration engine's fused read and coded write —
    show every access to the shadow.

Every comparison is exact: the data plane is integer, and the census
counts flip positions, not float values.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ModelConfig as JConfig
from repro.core import injection as jinj
from repro.core import pool as jp
from repro.core.layouts import GROUP_ROWS
from repro.core.layouts import Layout as JLayout
from repro.core.protection import Protection as JProt
from repro.faults import FaultCampaign as JCampaign
from repro.faults import ShadowedPool as JShadow
from repro.obs import slo as jslo
from repro.serve import Engine as JEngine
from repro.serve import ServeRequest as JRequest
from repro.vm import MigrationEngine as JMig
from repro.vm import VirtualMemory as JVM
from repro.vm import policy as jpolicy
from repro_torch.configs.base import ModelConfig as TConfig
from repro_torch.core import injection as tinj
from repro_torch.core import pool as tp
from repro_torch.core.layouts import Layout
from repro_torch.core.protection import Protection, at_least
from repro_torch.faults import (MEMCACHED_FIT, FaultCampaign, ShadowedPool,
                                hours_for_expected_flips)
from repro_torch.kernels import common
from repro_torch.models import load_jax_params
from repro_torch.obs import slo as tslo
from repro_torch.serve import Engine, ServeRequest
from repro_torch.vm import MigrationEngine, VirtualMemory
from repro_torch.vm import policy as tpolicy

W = 64


def _u32(t: torch.Tensor) -> np.ndarray:
    return common.to_u32(t)


def _census(c: dict) -> dict:
    return {k: dataclasses.asdict(v) for k, v in c.items()}


def _esc(escalations: list[dict]) -> list[tuple]:
    return [(e["tenant"], e["segment"], e["from"].value, e["to"].value,
             e["moved"]) for e in escalations]


# ---------------------------------------------------------------------------
# Injection, seed for seed
# ---------------------------------------------------------------------------


def _raw(shape, seed):
    return np.random.default_rng(seed).integers(0, 2**32, shape,
                                                dtype=np.uint32)


def test_inject_and_apply_flips_match_reference():
    raw = _raw((16, 9, W), 0)
    js, jrec = jinj.inject_flips(jnp.asarray(raw), np.random.default_rng(3),
                                 500, row_range=(4, 12), lanes=(0, 8))
    ts, trec = tinj.inject_flips(common.to_words(raw),
                                 np.random.default_rng(3), 500,
                                 row_range=(4, 12), lanes=(0, 8))
    assert [dataclasses.astuple(r) for r in trec] == \
        [dataclasses.astuple(r) for r in jrec]
    np.testing.assert_array_equal(_u32(ts), np.asarray(js))
    # two bits of one word and one bit listed twice (it cancels)
    recs = [(2, 3, 5, 7), (2, 3, 5, 9), (7, 8, 1, 31), (7, 8, 1, 31),
            (0, 0, 0, 0)]
    want = jinj.apply_flips(jnp.asarray(raw),
                            [jinj.FlipRecord(*r) for r in recs])
    got = tinj.apply_flips(common.to_words(raw),
                           [tinj.FlipRecord(*r) for r in recs])
    np.testing.assert_array_equal(_u32(got), np.asarray(want))
    assert _u32(got)[7, 8, 1] == raw[7, 8, 1]


def _models(seed, shape, rate, n_hard, mix):
    kw = dict(soft_rate=rate, n_hard=n_hard, shape=shape)
    return (jinj.FaultModel.make(seed, mix=jinj.ErrorMix(**mix), **kw),
            tinj.FaultModel.make(seed, mix=tinj.ErrorMix(**mix), **kw))


def test_fault_model_steps_match_reference_with_duplicate_cells():
    """A tiny storage at a high rate: in its first step the soft draw puts
    two flips into one word and one cell twice (they cancel), then the
    hard cells are OR-ed on top — three steps, storage equal after each."""
    shape = (8, 9, 4)
    mix = dict(single=0.5, adjacent_double=0.3, random_double=0.2)
    jm, tm = _models(21, shape, 3e8, 3, mix)
    assert [dataclasses.astuple(c) for c in tm.hard_cells] == \
        [dataclasses.astuple(c) for c in jm.hard_cells]
    # the first step's draw, replayed from a twin generator
    probe = tinj.FaultModel.make(21, soft_rate=3e8, n_hard=3, shape=shape,
                                 mix=tm.mix)
    rows, lns, words, bits = probe._draw_soft(*shape, 8 * 9 * 4 * 4)
    cells = list(zip(rows, lns, words, bits))
    assert len(set(cells)) < len(cells), "no cell drawn twice"
    assert len(set(zip(rows, lns, words))) < len(set(cells))
    raw = _raw(shape, 1)
    js, ts = jnp.asarray(raw), common.to_words(raw)
    for _ in range(3):
        js, jn = jm.step(js)
        ts2, tn = tm.step(ts)
        assert not torch.equal(ts2, ts)              # the input stays valid
        ts = ts2
        assert tn == jn > 3
        np.testing.assert_array_equal(_u32(ts), np.asarray(js))
        arr = _u32(ts)
        for c in tm.hard_cells:                      # stuck-at-1 holds
            assert arr[c.row, c.lane, c.word] >> c.bit & 1


def test_step_pool_matches_reference_and_sharded_raises():
    jm, tm = _models(2, (16, 9, W), 0.0, 4, dict())
    j = jp.make_pool(16, JLayout.INTERWRAP, boundary=0, row_words=W)
    t = tp.make_pool(16, Layout.INTERWRAP, boundary=0, row_words=W,
                     device="cpu")
    j, jn = jm.step_pool(j)
    t, tn = tm.step_pool(t)
    assert tn == jn == 4
    np.testing.assert_array_equal(_u32(t.storage), np.asarray(j.storage))
    t, stats = t.scrub()
    assert stats.corrected > 0
    # the storage-level step is 3-D only, as the reference's; a sharded
    # pool's 4-D storage steps through step_pool (global row r at bank
    # r % S, local row r // S), which tests/test_torch_shard.py holds
    # against the reference on the global-row image
    with pytest.raises(ValueError, match="step_pool"):
        tm.step(torch.zeros((2, 8, 9, W), dtype=torch.int32))
    from repro_torch.shard import make_sharded_pool
    s = make_sharded_pool(16, Layout.INTERWRAP, 0, num_shards=2,
                          row_words=W, device="cpu")
    s.storage.copy_(common.to_words(np.asarray(j.storage))
                    .view(8, 2, 9, W).transpose(0, 1))
    jm2, tm2 = _models(2, (16, 9, W), 0.0, 4, dict())
    j, jn = jm2.step_pool(j)
    s, sn = tm2.step_pool(s)
    assert sn == jn == 4
    np.testing.assert_array_equal(
        _u32(s.storage.transpose(0, 1).reshape(16, 9, W)),
        np.asarray(j.storage))


# ---------------------------------------------------------------------------
# The shadow oracle's verdicts, error shape × class
# ---------------------------------------------------------------------------


class TwinShadow:
    """Reference and port shadowed pools written with the same pages."""

    def __init__(self, layout, boundary, daec_rows=0, seed=0):
        j = jp.make_pool(16, JLayout(layout.value), boundary=boundary,
                         daec_rows=daec_rows)
        t = tp.make_pool(16, layout, boundary=boundary, daec_rows=daec_rows,
                         device="cpu")
        self.j, self.t = JShadow(j), ShadowedPool(t)
        data = np.random.default_rng(seed).integers(
            0, 2**32, (self.j.num_pages, self.j.page_words), dtype=np.uint32)
        self.j.write(jnp.arange(self.j.num_pages), jnp.asarray(data))
        self.t.write(np.arange(self.t.num_pages), data)
        self.truth = data

    def flip(self, cells) -> None:
        for sh, inj in ((self.j, jinj), (self.t, tinj)):
            sh.inner = dataclasses.replace(sh.inner, storage=inj.apply_flips(
                sh.inner.storage, [inj.FlipRecord(*c) for c in cells]))

    def read_all(self) -> tuple[np.ndarray, dict]:
        self.j.census.clear()
        self.t.census.clear()
        want = np.asarray(self.j.read(jnp.arange(self.j.num_pages)))
        got = _u32(self.t.read(np.arange(self.t.num_pages)))
        np.testing.assert_array_equal(got, want)
        assert _census(self.t.census) == _census(self.j.census)
        return got, {k: dataclasses.astuple(v)[1:]
                     for k, v in self.t.census.items()}


# (name, layout, boundary, daec_rows, flips, class, (corrected, detected,
# silent) of that class, page, recovered exactly)
VERDICTS = [
    ("daec-single", Layout.INTERWRAP, 0, 8, [(12, 3, 5, 17)], "daec",
     (1, 0, 0), 12, True),
    ("daec-adjacent", Layout.INTERWRAP, 0, 8,
     [(10, 0, 10, 7), (10, 0, 10, 8)], "daec", (1, 0, 0), 10, True),
    ("daec-same-codeword", Layout.INTERWRAP, 0, 8,
     [(9, 2, 4, 5), (9, 2, 4, 7)], "daec", (0, 1, 0), 9, False),
    ("secded-adjacent", Layout.INTERWRAP, 0, 0,
     [(3, 0, 10, 7), (3, 0, 10, 8)], "secded", (0, 1, 0), 3, False),
    ("secded-random-double", Layout.INTERWRAP, 0, 0,
     [(5, 0, 3, 1), (5, 4, 9, 30)], "secded", (1, 0, 0), 5, True),
    ("parity-adjacent", Layout.PARITY, 16, 0,
     [(6, 2, 8, 7), (6, 2, 8, 8)], "parity", (0, 1, 0), 6, False),
    ("parity-same-congruence", Layout.PARITY, 16, 0,
     [(4, 3, 2, 5), (4, 3, 2, 13)], "parity", (0, 0, 1), 4, False),
    ("none-single", Layout.INTERWRAP, 16, 0, [(7, 0, 0, 0)], "none",
     (0, 0, 1), 7, False),
]


@pytest.mark.parametrize("case", VERDICTS, ids=[v[0] for v in VERDICTS])
def test_shadow_verdicts_match_reference(case):
    _, layout, boundary, daec_rows, flips, cls, want, page, exact = case
    tw = TwinShadow(layout, boundary, daec_rows)
    tw.flip(flips)
    data, census = tw.read_all()
    _, corrected, detected, silent = census[cls]
    assert (corrected, detected, silent) == want
    assert (data[page] == tw.truth[page]).all() == exact
    # the other classes of the pool saw only clean reads
    assert all(c[1:] == (0, 0, 0) for k, c in census.items() if k != cls)


def test_shadow_survives_repartition():
    vm = VirtualMemory(row_words=W, device="cpu")
    vm.add_pool("p", 32, Layout.INTERWRAP, boundary=16)
    sh = ShadowedPool(vm.pools["p"])
    vm.pools["p"] = sh
    vm.create_tenant("t", segments={"seg": Protection.NONE})
    vpns = vm.alloc("t", 3, segment="seg")
    payload = np.arange(3 * vm.page_words, dtype=np.uint32).reshape(3, -1)
    vm.write("t", vpns, payload)
    eng = MigrationEngine(vm)
    eng.repartition_with_migration("p", 32)
    assert vm.pools["p"] is sh
    np.testing.assert_array_equal(_u32(vm.read("t", vpns)), payload)
    eng.repartition_with_migration("p", 0)
    np.testing.assert_array_equal(_u32(vm.read("t", vpns)), payload)
    assert sh.num_pages == 32
    assert sh.census["secded"].silent == 0 and sh.census["secded"].reads


# ---------------------------------------------------------------------------
# The three fused paths a wrapped pool must not bypass
# ---------------------------------------------------------------------------


def _vm_with_tenant(n: int, seed: int = 0):
    vm = VirtualMemory(row_words=W, device="cpu")
    vm.add_pool("p", 32, Layout.INTERWRAP, boundary=16)
    vm.create_tenant("t", segments={"seg": Protection.NONE})
    vpns = vm.alloc("t", n, segment="seg")
    payload = np.random.default_rng(seed).integers(
        0, 2**32, (n, vm.page_words), dtype=np.uint32)
    vm.write("t", vpns, payload)
    campaign = FaultCampaign(vm, "p", hours_per_step=0.0)   # no faults
    return vm, vpns, payload, campaign


def test_engine_decode_reads_go_through_the_shadow():
    cfg = TConfig(**FAULTS_TEST)
    vm = VirtualMemory(row_words=W, device="cpu")
    vm.add_pool("kv", 64, Layout.INTERWRAP, boundary=16)
    eng = Engine(cfg, max_batch=2, max_len=32, vm=vm, pool="kv",
                 row_words=W, max_sessions=8)
    campaign = FaultCampaign(vm, "kv", hours_per_step=0.0)
    rng = np.random.default_rng(0)
    for i in range(3):
        eng.submit(ServeRequest(f"s{i}", rng.integers(0, 256, 10), 4))
    while eng.sched.has_work():
        eng.poll()
    gathered = eng.steps * 2 * eng.n_layers * eng.kv.max_blocks
    census = campaign.report().census
    assert eng.steps > 0
    assert sum(c.reads for c in census.values()) == gathered
    assert all(c.silent == c.detected == 0 for c in census.values())


def test_migration_reads_go_through_the_shadow():
    vm, vpns, payload, campaign = _vm_with_tenant(20)
    alloc = vm.allocators["p"]
    doomed = [p for p in vm.pools["p"].evict_prediction(8)
              if p in alloc.owner]
    assert doomed, "no mapped extra page to evict"
    info = MigrationEngine(vm).repartition_with_migration("p", 8)
    assert info["migrated"] == len(doomed)
    census = campaign.report().census
    assert census["none"].reads == len(doomed)     # the fused read: 0
    np.testing.assert_array_equal(_u32(vm.read("t", vpns)), payload)


def test_migration_coded_writes_update_the_shadow():
    """An escalation NONE -> SECDED relocates pages from a bare CREAM pool
    into the SECDED frames of a shadowed pool, with the codes of the
    migrate gather. The write must land in the shadow too: no false silent
    read afterwards."""
    vm = VirtualMemory(row_words=W, device="cpu")
    vm.add_pool("cream", 32, Layout.INTERWRAP, boundary=32)
    vm.add_pool("safe", 16, Layout.INTERWRAP, boundary=0)
    vm.create_tenant("t", segments={"seg": Protection.NONE})
    vpns = vm.alloc("t", 4, segment="seg")
    assert {vm.translate("t", v).pool for v in vpns} == {"cream"}
    payload = np.random.default_rng(1).integers(
        0, 2**32, (4, vm.page_words), dtype=np.uint32)
    vm.write("t", vpns, payload)
    campaign = FaultCampaign(vm, "safe", hours_per_step=0.0)
    policy = tpolicy.VMPolicy(vm)
    esc = policy.escalate_tenant("t", "seg", Protection.SECDED)
    assert esc["moved"] == 4 and policy.engine.stats.kernel_batches == 1
    assert {vm.translate("t", v).pool for v in vpns} == {"safe"}
    np.testing.assert_array_equal(_u32(vm.read("t", vpns)), payload)
    census = campaign.report().census
    assert census["secded"].reads == 4 and census["secded"].silent == 0


# ---------------------------------------------------------------------------
# Tenant-SLO escalation
# ---------------------------------------------------------------------------


class TwinVM:
    """A reference VM and a port VM driven with the same calls."""

    def __init__(self, rows: int, boundary: int):
        self.j = JVM(row_words=W)
        self.t = VirtualMemory(row_words=W, device="cpu")
        self.j.add_pool("p", rows, JLayout.INTERWRAP, boundary=boundary)
        self.t.add_pool("p", rows, Layout.INTERWRAP, boundary=boundary)

    def tenant(self, seg: str, prot: Protection) -> None:
        self.j.create_tenant("t", segments={seg: JProt(prot.value)})
        self.t.create_tenant("t", segments={seg: prot})

    def same(self) -> None:
        assert {v: (e.pool, e.phys, e.reliability.value)
                for v, e in self.t.tenants["t"].entries.items()} == \
            {v: (e.pool, e.phys, e.reliability.value)
             for v, e in self.j.tenants["t"].entries.items()}
        jpool, tpool = self.j.pools["p"], self.t.pools["p"]
        assert tpool.daec_rows == jpool.daec_rows
        np.testing.assert_array_equal(_u32(tpool.storage),
                                      np.asarray(jpool.storage))


def _slo(mod, prot, **kw):
    return mod.TenantSLO(ceiling=prot, **kw)


def test_auto_escalation_via_zero_loss_migration_matches_reference():
    vm = TwinVM(32, 16)
    vm.tenant("seg", Protection.NONE)
    jpol, tpol = jpolicy.VMPolicy(vm.j), tpolicy.VMPolicy(vm.t)
    jslo.TRACKER.reset()
    tslo.TRACKER.reset()
    jpol.set_tenant_slo("t", "seg", jpolicy.TenantSLO(max_error_rate=1e-2,
                                                      min_reads=10))
    tpol.set_tenant_slo("t", "seg", tpolicy.TenantSLO(max_error_rate=1e-2,
                                                      min_reads=10))
    jv, tv = vm.j.alloc("t", 4, segment="seg"), vm.t.alloc("t", 4,
                                                            segment="seg")
    assert jv == tv
    payload = np.arange(4 * vm.t.page_words, dtype=np.uint32).reshape(4, -1)
    vm.j.write("t", jv, jnp.asarray(payload))
    vm.t.write("t", tv, payload)
    targets = []
    for _ in range(3):
        jpol.observe_reads("t", "seg", reads=100, silent=5)
        tpol.observe_reads("t", "seg", reads=100, silent=5)
        assert tpol.observed_error_rate("t", "seg") == \
            jpol.observed_error_rate("t", "seg") == 0.05
        jd, td = jpol.auto_escalate(), tpol.auto_escalate()
        assert _esc(td) == _esc(jd)
        targets.append([e["to"] for e in td])
        vm.same()
        np.testing.assert_array_equal(_u32(vm.t.read("t", tv)), payload)
    assert targets == [[Protection.PARITY], [Protection.SECDED], []]
    assert tpol.observed_error_rate("t", "seg") == 0.0   # window reset
    assert vm.t.tenants["t"].segments["seg"] == Protection.SECDED
    assert dataclasses.asdict(tslo.TRACKER.tenants["t/seg"]) == \
        dataclasses.asdict(jslo.TRACKER.tenants["t/seg"])


def test_escalation_to_daec_carves_the_tier_in_place():
    """SECDED -> DAEC: ``ensure_daec_frames`` carves whole boundary steps
    at the top of the SECDED span (upgrading mapped frames there without
    a move) and the rest of the segment is relocated into it."""
    vm = TwinVM(32, 8)
    vm.tenant("seg", Protection.SECDED)
    jpol, tpol = jpolicy.VMPolicy(vm.j), tpolicy.VMPolicy(vm.t)
    jv, tv = vm.j.alloc("t", 10, segment="seg"), vm.t.alloc("t", 10,
                                                             segment="seg")
    payload = np.random.default_rng(4).integers(
        0, 2**32, (10, vm.t.page_words), dtype=np.uint32)
    vm.j.write("t", jv, jnp.asarray(payload))
    vm.t.write("t", tv, payload)
    jd = jpol.escalate_tenant("t", "seg", JProt.DAEC)
    td = tpol.escalate_tenant("t", "seg", Protection.DAEC)
    assert _esc([td]) == _esc([jd])
    assert vm.t.pools["p"].daec_rows % GROUP_ROWS == 0
    assert vm.t.pools["p"].daec_rows >= 10
    vm.same()
    assert all(vm.t.effective_protection("t", v) == Protection.DAEC
               for v in tv)
    np.testing.assert_array_equal(_u32(vm.t.read("t", tv)), payload)
    assert tpol.ensure_daec_frames(0) == jpol.ensure_daec_frames(0)


# ---------------------------------------------------------------------------
# The campaigns, tick by tick
# ---------------------------------------------------------------------------


def test_daec_campaign_matches_reference_tick_by_tick():
    """The reference's SECDED -> DAEC acceptance campaign on both packages:
    after every tick the census, escalations and storage are identical,
    and the run ends on DAEC with zero silent reads in every class."""
    vm = TwinVM(32, 0)
    vm.tenant("seg", Protection.SECDED)
    jpol, tpol = jpolicy.VMPolicy(vm.j), tpolicy.VMPolicy(vm.t)
    jslo.TRACKER.reset()
    tslo.TRACKER.reset()
    jpol.set_tenant_slo("t", "seg", jpolicy.TenantSLO(
        max_error_rate=1e-3, min_reads=32, ceiling=JProt.DAEC))
    tpol.set_tenant_slo("t", "seg", tpolicy.TenantSLO(
        max_error_rate=1e-3, min_reads=32, ceiling=Protection.DAEC))
    jv, tv = vm.j.alloc("t", 8, segment="seg"), vm.t.alloc("t", 8,
                                                            segment="seg")
    payload = np.random.default_rng(11).integers(
        0, 2**32, (8, vm.t.page_words), dtype=np.uint32)
    vm.j.write("t", jv, jnp.asarray(payload))
    vm.t.write("t", tv, payload)
    hours = hours_for_expected_flips(
        MEMCACHED_FIT, vm.t.pools["p"].storage.numel() * 4, 6.0)
    jc = JCampaign(vm.j, "p", policy=jpol, fit_per_mbit=MEMCACHED_FIT,
                   hours_per_step=hours,
                   mix=jinj.ErrorMix(single=0.0, adjacent_double=1.0),
                   seed=11)
    tc = FaultCampaign(vm.t, "p", policy=tpol, fit_per_mbit=MEMCACHED_FIT,
                       hours_per_step=hours,
                       mix=tinj.ErrorMix(single=0.0, adjacent_double=1.0),
                       seed=11)
    escalated_at = None
    for step in range(46):
        assert tc.inject() == jc.inject()
        np.testing.assert_array_equal(_u32(vm.t.read("t", tv)),
                                      np.asarray(vm.j.read("t", jv)))
        assert tc.observe() == jc.observe()
        if escalated_at is None:
            jd, td = jc.escalate(), tc.escalate()
            assert _esc(td) == _esc(jd)
            if td:
                escalated_at = step
        assert _census(tc.shadow.census) == _census(jc.shadow.census)
        vm.same()
        if escalated_at is not None and step >= escalated_at + 6:
            break
    assert escalated_at is not None
    assert tc.first_escalation_step == jc.first_escalation_step
    report = tc.report()
    tc.detach()
    jc.detach()
    assert _esc(report.escalations) == _esc(jc.report().escalations)
    assert report.escalations[0]["to"] == Protection.DAEC
    assert all(vm.t.effective_protection("t", v) == Protection.DAEC
               for v in tv)
    assert report.census["daec"].reads > 0
    assert report.census["daec"].detected == 0
    assert all(c.silent == 0 for c in report.census.values())
    assert report.rates() == jc.report().rates()


FAULTS_TEST = dict(name="faults-test", family="dense", num_layers=2,
                   d_model=64, num_heads=4, num_kv_heads=2, d_ff=128,
                   vocab_size=256, head_dim=16, dtype="float32")


@pytest.fixture(scope="module")
def serve_campaigns():
    """The reference's serve campaign (``tests/test_faults_campaign.py``
    ``campaign_run``) on both packages in lockstep, with one set of
    weights; per-tick census and escalations are compared as it runs."""
    jslo.TRACKER.reset()
    tslo.TRACKER.reset()
    out = {}
    for side in ("j", "t"):
        if side == "j":
            vm = JVM(row_words=W)
            vm.add_pool("kv", 64, JLayout.INTERWRAP, boundary=2 * GROUP_ROWS)
            eng = JEngine(JConfig(**FAULTS_TEST), max_batch=4, max_len=48,
                          vm=vm, pool="kv", mode="cream", row_words=W,
                          max_sessions=32)
            pol, slo_mod, prot, inj, camp, req = (
                jpolicy, jpolicy, JProt, jinj, JCampaign, JRequest)
            nbytes = int(np.asarray(vm.pools["kv"].storage).nbytes)
        else:
            vm = VirtualMemory(row_words=W, device="cpu")
            vm.add_pool("kv", 64, Layout.INTERWRAP, boundary=2 * GROUP_ROWS)
            eng = Engine(TConfig(**FAULTS_TEST), max_batch=4, max_len=48,
                         vm=vm, pool="kv", mode="cream", row_words=W,
                         max_sessions=32)
            load_jax_params(eng.model,
                            jax.tree.map(np.asarray, out["j"]["eng"].params))
            pol, slo_mod, prot, inj, camp, req = (
                tpolicy, tpolicy, Protection, tinj, FaultCampaign,
                ServeRequest)
            nbytes = vm.pools["kv"].storage.numel() * 4
        policy = pol.VMPolicy(vm)
        policy.set_tenant_slo("serve", "batch", slo_mod.TenantSLO(
            max_error_rate=1e-3, min_reads=64, ceiling=prot.SECDED))
        hours = hours_for_expected_flips(MEMCACHED_FIT, nbytes, 5.0)
        campaign = camp(vm, "kv", policy=policy, engine=eng,
                        fit_per_mbit=MEMCACHED_FIT, hours_per_step=hours,
                        mix=inj.SINGLES, n_hard=0, seed=5)
        rng = np.random.default_rng(5)
        prompts = {s: rng.integers(0, 256, size=12).astype(np.int32)
                   for s in range(4)}
        reqs = [req(f"s{s}", prompts[s], 6,
                    tier="paid" if s == 0 else "batch")
                for _ in range(6) for s in range(4)]
        for r in reqs:
            eng.submit(r)
        out[side] = dict(vm=vm, eng=eng, policy=policy, campaign=campaign,
                         reqs=reqs, done=[], ticks=[])
    j, t = out["j"], out["t"]
    while j["eng"].sched.has_work():
        assert t["eng"].sched.has_work()
        for side in (j, t):
            side["done"].extend(side["eng"].poll())
            side["campaign"].tick()
            if side["campaign"].steps % 3 == 0:
                side["policy"].scrub_all()
            side["ticks"].append((_census(side["campaign"].shadow.census),
                                  _esc(side["policy"].escalations)))
    assert not t["eng"].sched.has_work()
    for side in (j, t):
        side["campaign"].observe()
        side["report"] = side["campaign"].report()
        side["campaign"].detach()
    return out


def test_serve_campaign_census_and_escalations_match_reference(
        serve_campaigns):
    j, t = serve_campaigns["j"], serve_campaigns["t"]
    assert len(t["ticks"]) == len(j["ticks"])
    for k, (a, b) in enumerate(zip(t["ticks"], j["ticks"])):
        assert a == b, f"tick {k}"
    assert t["campaign"].injected == j["campaign"].injected > 0
    assert t["campaign"].first_escalation_step == \
        j["campaign"].first_escalation_step is not None
    assert _census(t["report"].census) == _census(j["report"].census)
    assert _esc(t["report"].escalations) == _esc(j["report"].escalations)
    assert {k: dataclasses.asdict(v)
            for k, v in tslo.TRACKER.classes.items()} == \
        {k: dataclasses.asdict(v) for k, v in jslo.TRACKER.classes.items()}


def test_serve_campaign_keeps_the_secded_contract(serve_campaigns):
    j, t = serve_campaigns["j"], serve_campaigns["t"]
    report, vm = t["report"], t["vm"]
    cen = report.census["secded"]
    assert cen.reads > 0 and cen.corrected > 0
    assert cen.silent == 0 and cen.detected == 0
    assert report.census["none"].silent > 0
    assert len(t["done"]) == len(t["reqs"]) == len(j["done"])
    first = report.escalations[0]
    assert (first["tenant"], first["segment"]) == ("serve", "batch")
    assert first["moved"] > 0
    target = vm.tenants["serve"].segments["batch"]
    for vpn, pte in vm.tenants["serve"].entries.items():
        if pte.segment == "batch" and pte.pool is not None:
            assert at_least(vm.effective_protection("serve", vpn), target)
    # the paid tier's tokens (batch KV may hold NaNs after silent flips)
    paid = [(a.generated, b.generated)
            for a, b in zip(t["reqs"], j["reqs"]) if a.tier == "paid"]
    assert paid and all(a == b for a, b in paid)
