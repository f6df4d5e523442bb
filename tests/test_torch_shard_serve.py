"""The VM stack, CREAM-Campaign and CREAM-Serve on a CREAM-Shard pool.

A sharded pool keeps the global page-id convention and, for the geometry
used here, a local pool's capacity and frame classes, so a port VM or
engine on a sharded pool makes the allocation decisions a reference VM or
engine makes on a local pool of the same global geometry. The reference's
own sharded pool fails under the installed JAX for more than one shard,
so that local reference is the oracle:

  * VM: alloc / write / read / free, swap round trips, the zero-loss
    repartition with migration and the scrub → adapt loop give the
    reference's page tables, contents and transaction infos;
  * the object cache and the ``SequenceCache`` run on a sharded pool with
    zero loss (the scenarios of ``tests/test_shard_vm.py``);
  * a fault campaign on an all-SECDED sharded pool sees the reference's
    flips (global row r is bank r % S, local row r // S), census and
    storage tick by tick;
  * the engine on a sharded pool decodes the reference engine's tokens
    with one router-fused read per step; ``schedule_migration`` moves the
    pages the reference engine moves, on local and sharded pools.

Every comparison is exact: tokens are greedy, the data plane is integer.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ModelConfig as JConfig
from repro.core import injection as jinj
from repro.core.layouts import Layout as JLayout
from repro.core.protection import Protection as JProt
from repro.faults import FaultCampaign as JCampaign
from repro.serve import Engine as JEngine
from repro.serve import ServeRequest as JRequest
from repro.vm import MigrationEngine as JMig
from repro.vm import VirtualMemory as JVM
from repro.vm import VMPolicy as JPolicy
from repro_torch.configs.base import ModelConfig as TConfig
from repro_torch.core import injection as tinj
from repro_torch.core.layouts import Layout
from repro_torch.core.protection import Protection
from repro_torch.core.scrubber import ScrubStats
from repro_torch.faults import (MEMCACHED_FIT, FaultCampaign,
                                hours_for_expected_flips)
from repro_torch.kernels import common
from repro_torch.kernels.mixed import ops as mixed_ops
from repro_torch.models import load_jax_params
from repro_torch.objcache.cache import ObjCache
from repro_torch.serve import Engine, SequenceCache, ServeRequest
from repro_torch.shard import ShardedPool
from repro_torch.vm import MigrationEngine, VirtualMemory, VMPolicy

W = 32


def _u32(t: torch.Tensor) -> np.ndarray:
    return common.to_u32(t)


def _census(c: dict) -> dict:
    return {k: dataclasses.asdict(v) for k, v in c.items()}


class TwinVM:
    """A reference VM on a local pool and a port VM on a sharded pool of
    the same global geometry, driven with the same calls."""

    def __init__(self, shards: int, rows: int, boundary: int):
        self.j = JVM(row_words=W)
        self.t = VirtualMemory(row_words=W, device="cpu")
        self.j.add_pool("main", rows, JLayout.INTERWRAP, boundary=boundary)
        pool = self.t.add_pool("main", rows, Layout.INTERWRAP,
                               boundary=boundary, shards=shards)
        assert isinstance(pool, ShardedPool)
        assert pool.num_pages == self.j.pools["main"].num_pages

    def tenant(self, prot: Protection, **segments) -> None:
        self.j.create_tenant("t", default_reliability=JProt(prot.value),
                             segments={k: JProt(v.value)
                                       for k, v in segments.items()})
        self.t.create_tenant("t", default_reliability=prot,
                             segments=segments)

    def alloc(self, n: int, **kw) -> list[int]:
        jv, tv = self.j.alloc("t", n, **kw), self.t.alloc("t", n, **kw)
        assert jv == tv
        return tv

    def write(self, vpns, data) -> None:
        self.j.write("t", vpns, jnp.asarray(data))
        self.t.write("t", vpns, data)

    def read(self, vpns) -> np.ndarray:
        got = _u32(self.t.read("t", vpns))
        np.testing.assert_array_equal(got,
                                      np.asarray(self.j.read("t", vpns)))
        return got

    def same(self) -> None:
        assert {v: (e.pool, e.phys, e.reliability.value)
                for v, e in self.t.tenants["t"].entries.items()} == \
            {v: (e.pool, e.phys, e.reliability.value)
             for v, e in self.j.tenants["t"].entries.items()}
        assert self.t.pools["main"].boundary == self.j.pools["main"].boundary
        assert vars(self.t.stats) == vars(self.j.stats)

    def image(self) -> np.ndarray:
        """The port's banks as global rows (row r = bank r % S, r // S)."""
        sto = _u32(self.t.pools["main"].storage)
        return sto.transpose(1, 0, 2, 3).reshape(-1, *sto.shape[2:])


def _blob(n: int, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, 2**32, (n, 8 * W),
                                                dtype=np.uint32)


# ---------------------------------------------------------------------------
# VM, policy, object cache and SequenceCache on a sharded pool
# ---------------------------------------------------------------------------


def test_vm_alloc_write_read_free_on_sharded_pool():
    vm = TwinVM(4, 128, 64)
    vm.tenant(Protection.NONE, paid=Protection.SECDED)
    vpns = vm.alloc(24) + vm.alloc(8, segment="paid")
    blob = _blob(32, 0)
    vm.write(vpns, blob)
    np.testing.assert_array_equal(vm.read(vpns), blob)
    vm.same()
    assert all(vm.t.tenants["t"].entries[v].pool == "main" for v in vpns)
    assert [vm.t.effective_protection("t", v) for v in vpns[-8:]] == \
        [Protection.SECDED] * 8
    vm.j.free("t", vpns)
    vm.t.free("t", vpns)
    assert vm.t.used_device_pages() == 0


def test_vm_swap_roundtrip_on_sharded_pool():
    vm = TwinVM(4, 128, 64)
    vm.tenant(Protection.NONE)
    vpns = vm.alloc(8)
    blob = _blob(8, 1)
    vm.write(vpns, blob)
    assert vm.t.swap_out("t", vpns) == vm.j.swap_out("t", vpns) == 8
    assert vm.t.residency("t", vpns) == "host"
    np.testing.assert_array_equal(vm.read(vpns), blob)
    assert vm.t.swap_in("t", vpns) == vm.j.swap_in("t", vpns) == 8
    assert vm.t.residency("t", vpns) == "device"
    np.testing.assert_array_equal(vm.read(vpns), blob)
    vm.same()


def test_repartition_with_migration_zero_loss_on_sharded_pool():
    vm = TwinVM(4, 128, 128)
    vm.tenant(Protection.NONE, paid=Protection.SECDED)
    state = vm.t.pools["main"]
    # map every page (incl. every extra), then upgrade protection fully:
    # every extra page is doomed and must be relocated, not dropped
    vpns = vm.alloc(state.num_pages)
    blob = _blob(len(vpns), 2)
    vm.write(vpns, blob)
    info = MigrationEngine(vm.t).repartition_with_migration("main", 0)
    assert info == JMig(vm.j).repartition_with_migration("main", 0)
    assert info["migrated"] == state.num_extra_pages
    np.testing.assert_array_equal(vm.read(vpns), blob)
    vm.same()
    # and back down, relocating what the weakened span may not hold
    vm.j.free("t", vpns[:64])
    vm.t.free("t", vpns[:64])
    paid = vm.alloc(16, segment="paid")
    vm.write(paid, blob[:16])
    info = MigrationEngine(vm.t).repartition_with_migration("main", 96)
    assert info == JMig(vm.j).repartition_with_migration("main", 96)
    np.testing.assert_array_equal(vm.read(paid), blob[:16])
    np.testing.assert_array_equal(vm.read(vpns[64:]), blob[64:])
    vm.same()
    # boundary steps must respect the lockstep granularity (S * 8 rows)
    with pytest.raises(ValueError, match="bad boundary"):
        MigrationEngine(vm.t).repartition_with_migration("main", 8)


def test_policy_scrub_adapt_and_daec_carving_on_sharded_pool():
    vm = VirtualMemory(row_words=W, device="cpu")
    vm.add_pool("main", 128, Layout.INTERWRAP, boundary=128, shards=4)
    vm.create_tenant("t")
    vpns = vm.alloc("t", 40)
    blob = _blob(40, 3)
    vm.write("t", vpns, blob)
    policy = VMPolicy(vm)
    stats = policy.scrub_all()
    assert stats["main"].error_rate == 0.0
    for _ in range(4):         # a hot census forces an upgrade
        policy.monitor.record("main", ScrubStats(beats_checked=1000,
                                                 corrected_data=50))
    infos = policy.adapt()
    assert infos and vm.pools["main"].boundary == 0
    np.testing.assert_array_equal(_u32(vm.read("t", vpns)), blob)
    # carving a DAEC tier moves in lockstep steps of S * 8 rows
    assert policy.ensure_daec_frames(5) >= 5
    assert vm.pools["main"].daec_rows == 32
    assert vm.pools["main"].daec_rows_local == 8
    np.testing.assert_array_equal(_u32(vm.read("t", vpns)), blob)
    policy.scrub_all()
    np.testing.assert_array_equal(_u32(vm.read("t", vpns)), blob)


def test_objcache_on_sharded_pool():
    vm = VirtualMemory(row_words=W, device="cpu")
    vm.add_pool("main", 128, Layout.INTERWRAP, boundary=128, shards=4)
    cache = ObjCache(vm, "main", index_capacity=256, max_value_words=48)
    rng = np.random.default_rng(3)
    keys = np.arange(40)
    vals = rng.integers(0, 2**32, (40, 48), dtype=np.uint32)
    assert cache.set_many(keys, vals).all()
    got, lens, found = cache.get_many(keys)
    assert found.all() and (lens == 48).all()
    np.testing.assert_array_equal(got, vals)
    assert cache.delete_many(keys[:10]).all()
    _, _, found = cache.get_many(keys[:10])
    assert not found.any()
    # a live upgrade: the cache's pages survive it
    MigrationEngine(vm).repartition_with_migration("main", 0)
    cache.refresh_translation()
    got, _, found = cache.get_many(keys[10:])
    assert found.all()
    np.testing.assert_array_equal(got, vals[10:])


def test_objcache_get_on_a_shadowed_pool_goes_through_the_oracle():
    """The fused probe + gather reads the storage directly; a wrapped pool
    (the campaign's shadow) must see the get's page reads instead."""
    vm = VirtualMemory(row_words=W, device="cpu")
    vm.add_pool("main", 32, Layout.INTERWRAP, boundary=16)
    cache = ObjCache(vm, "main", index_capacity=64, max_value_words=48)
    vals = np.random.default_rng(4).integers(0, 2**32, (12, 48),
                                             dtype=np.uint32)
    assert cache.set_many(np.arange(12), vals).all()
    campaign = FaultCampaign(vm, "main", hours_per_step=0.0)

    def reads() -> int:
        return sum(c.reads for c in campaign.shadow.census.values())

    before = reads()
    got, _, found = cache.get_many(np.arange(12))
    assert found.all()
    np.testing.assert_array_equal(got, vals)
    assert reads() - before == 12


def test_sequence_cache_on_sharded_pool():
    vm = VirtualMemory(row_words=W, device="cpu")
    vm.add_pool(SequenceCache.POOL, 64, Layout.INTERWRAP, shards=4)
    cache = SequenceCache(num_rows=64, vm=vm)
    rng = np.random.default_rng(4)
    blobs = {f"s{i}": torch.from_numpy(
        rng.integers(0, 256, 1000, dtype=np.uint8)) for i in range(6)}
    for sid, blob in blobs.items():
        cache.park(sid, blob)
    out = cache.resume_many(list(blobs))
    for sid, blob in blobs.items():
        assert torch.equal(out[sid], blob)
    assert cache.stats.device_hits == 6


# ---------------------------------------------------------------------------
# A fault campaign on a sharded pool
# ---------------------------------------------------------------------------


def test_campaign_on_sharded_pool_matches_reference_tick_by_tick():
    """All-SECDED rows hold page r in global row r on both pools, so the
    reference's draws over global rows hit the same pages."""
    vm = TwinVM(4, 64, 0)
    vm.tenant(Protection.SECDED)
    vpns = vm.alloc(24)
    vm.write(vpns, _blob(24, 5))
    hours = hours_for_expected_flips(
        MEMCACHED_FIT, vm.t.pools["main"].storage.numel() * 4, 3.0)
    kw = dict(fit_per_mbit=MEMCACHED_FIT, hours_per_step=hours, seed=7)
    jc = JCampaign(vm.j, "main", mix=jinj.FIELD_MIX, n_hard=2, **kw)
    tc = FaultCampaign(vm.t, "main", mix=tinj.FIELD_MIX, n_hard=2, **kw)
    assert tc.model.hard_cells == [tinj.FlipRecord(*dataclasses.astuple(c))
                                   for c in jc.model.hard_cells]
    assert tc.shadow._valid.size == jc.shadow._valid.size
    for step in range(8):
        assert tc.inject() == jc.inject()
        vm.read(vpns)
        assert tc.observe() == jc.observe()
        assert _census(tc.shadow.census) == _census(jc.shadow.census)
        np.testing.assert_array_equal(
            vm.image(), np.asarray(vm.j.pools["main"].inner.storage))
        if step % 3 == 2:
            jpol, tpol = JPolicy(vm.j), VMPolicy(vm.t)
            assert vars(tpol.scrub_all()["main"]) == \
                vars(jpol.scrub_all()["main"])
    assert tc.injected > 0
    assert tc.shadow.census["secded"].silent == 0


# ---------------------------------------------------------------------------
# CREAM-Serve on a sharded pool
# ---------------------------------------------------------------------------

SERVE_TEST = dict(name="serve-test", family="dense", num_layers=2,
                  d_model=64, num_heads=4, num_kv_heads=2, d_ff=128,
                  vocab_size=256, head_dim=16, dtype="float32")
ROW_WORDS = 2 * 2 * 16          # one KV token per row: 8 tokens a page


class ServeTwin:
    """A reference engine on a local pool and a port engine on a local or
    sharded pool of the same geometry, with the same weights and prompts.
    ``mig`` frames are claimed for a tenant of their own in both VMs, so
    migrations between them touch no page of a decode sequence."""

    def __init__(self, shards: int, secded_rows: int, mig: int = 0):
        jcfg, tcfg = JConfig(**SERVE_TEST), TConfig(**SERVE_TEST)
        rows = 32
        kw = dict(max_batch=4, max_len=32, seed=0)
        self.j = JEngine(jcfg, mode="cream", num_rows=rows,
                         row_words=ROW_WORDS, secded_rows=secded_rows, **kw)
        vm = VirtualMemory(row_words=ROW_WORDS, device="cpu")
        vm.add_pool("kv", rows, Layout.INTERWRAP,
                    boundary=rows - secded_rows, shards=shards)
        self.t = Engine(tcfg, vm=vm, pool="kv", **kw)
        load_jax_params(self.t.model, jax.tree.map(np.asarray, self.j.params))
        self.phys = []
        if mig:
            for vm_ in (self.j.vm, self.t.vm):
                vm_.create_tenant("mig")
                vm_.alloc("mig", mig, allow_host=False)
            ents = self.t.vm.tenants["mig"].entries
            self.phys = [ents[v].phys for v in sorted(ents)]
            assert self.phys == [e.phys for _, e in sorted(
                self.j.vm.tenants["mig"].entries.items())]
        rng = np.random.default_rng(1)
        prompts = [rng.integers(0, 256, size=12).astype(np.int32)
                   for _ in range(8)]
        self.jreqs = [JRequest(f"s{i}", p, 10) for i, p in enumerate(prompts)]
        self.treqs = [ServeRequest(f"s{i}", p, 10)
                      for i, p in enumerate(prompts)]
        for a, b in zip(self.jreqs, self.treqs):
            self.j.submit(a)
            self.t.submit(b)

    def check_tables(self) -> None:
        np.testing.assert_array_equal(self.t.kv._table, self.j.kv._table)
        assert self.t.vm.allocators["kv"].owner == \
            self.j.vm.allocators["kv"].owner

    def run(self, each_poll=None) -> list[list[int]]:
        k = 0
        while self.j.sched.has_work():
            self.j.poll()
            self.t.poll()
            k += 1
            self.check_tables()
            if each_poll is not None:
                each_poll(k)
        assert not self.t.sched.has_work()
        assert self.j.steps == self.t.steps
        assert self.j.sched.stats == self.t.sched.stats
        want = [r.generated for r in self.jreqs]
        assert [r.generated for r in self.treqs] == want
        return want


@pytest.fixture(scope="module")
def local_tokens() -> list[list[int]]:
    """The port engine on a local pool: the tokens every run must give."""
    return ServeTwin(1, 16).run()


@pytest.mark.parametrize("shards,secded_rows", [(2, 16), (4, 0)])
def test_engine_on_sharded_pool_matches_the_reference(shards, secded_rows,
                                                      local_tokens,
                                                      monkeypatch):
    twin = ServeTwin(shards, secded_rows)
    assert isinstance(twin.t.pool, ShardedPool)
    calls = {"routed": 0, "local": 0}
    routed, local = mixed_ops.read_correct_routed, mixed_ops.read_correct

    def count(name, fn):
        def wrapped(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return wrapped

    monkeypatch.setattr(mixed_ops, "read_correct_routed",
                        count("routed", routed))
    monkeypatch.setattr(mixed_ops, "read_correct", count("local", local))
    per_gather = []
    gather = twin.t._gather_pages

    def counted_gather(phys):
        before = dict(calls)
        out = gather(phys)
        per_gather.append((calls["routed"] - before["routed"],
                           calls["local"] - before["local"]))
        return out

    twin.t._gather_pages = counted_gather
    tokens = twin.run()
    if secded_rows == 16:
        assert tokens == local_tokens
    # each step's one gather is one router-fused read (preemption's page
    # reads inside a step go through pool.read, outside the gather)
    assert len(per_gather) == twin.t.steps
    assert set(per_gather) == {(1, 0)}


@pytest.mark.parametrize("shards", [1, 4])
def test_scheduled_migration_moves_what_the_reference_moves(shards,
                                                            local_tokens):
    twin = ServeTwin(shards, 0 if shards > 1 else 16, mig=8)
    src, dst = twin.phys[:4], twin.phys[5:] + twin.phys[4:5]
    if shards > 1:
        assert all(a % shards != b % shards for a, b in zip(src, dst))
    payload = np.random.default_rng(6).integers(
        0, 2**32, (4, twin.t.pool.page_words), dtype=np.uint32)
    twin.j.vm.pools["kv"] = twin.j.pool.write(src, jnp.asarray(payload))
    twin.t.vm.pools["kv"] = twin.t.pool.write(src, payload)

    def migrate_at_three(k):
        if k == 3:
            twin.j.schedule_migration(src, dst)
            twin.t.schedule_migration(src[:2], dst[:2])   # coalesced
            twin.t.schedule_migration(src[2:], dst[2:])
        if k == 4:
            assert twin.t._pending_migration is None
            np.testing.assert_array_equal(_u32(twin.t.pool.read(dst)),
                                          payload)
            np.testing.assert_array_equal(
                np.asarray(twin.j.pool.read(dst)), payload)

    tokens = twin.run(migrate_at_three)
    if shards == 1:
        assert tokens == local_tokens
    with pytest.raises(ValueError, match="match"):
        twin.t.schedule_migration([1, 2], [3])
