"""CREAM-VM on the port equals the reference: page tables, host swap, and the
zero-loss repartition transaction, with pool storage compared bit for bit.

Both VMs are driven with the same calls and numpy data; the port runs on
the CPU, where the migration gather/re-encode takes its plain version.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.layouts import Layout as JLayout
from repro.core.protection import Protection as JProt
from repro.vm.address_space import VirtualMemory as JVM
from repro.vm.migration import MigrationEngine as JMig
from repro_torch.core.layouts import Layout
from repro_torch.core.protection import Protection
from repro_torch.kernels import common
from repro_torch.vm.address_space import VirtualMemory
from repro_torch.vm.migration import MigrationEngine

W = 64


class TwinVM:
    def __init__(self):
        self.j = JVM(row_words=W)
        self.t = VirtualMemory(row_words=W, device="cpu")

    def add_pool(self, name, rows, layout, boundary=None):
        self.j.add_pool(name, rows, JLayout(layout.value), boundary=boundary)
        self.t.add_pool(name, rows, layout, boundary=boundary)

    def tenant(self, name, rel: Protection):
        self.j.create_tenant(name, JProt(rel.value))
        self.t.create_tenant(name, rel)

    def alloc(self, tenant, n, **kw):
        a = self.j.alloc(tenant, n, **kw)
        b = self.t.alloc(tenant, n, **kw)
        assert a == b
        return a

    def write(self, tenant, vpns, data):
        self.j.write(tenant, vpns, jnp.asarray(data))
        self.t.write(tenant, vpns, data)

    def read(self, tenant, vpns):
        a = np.asarray(self.j.read(tenant, vpns))
        np.testing.assert_array_equal(common.to_u32(self.t.read(tenant, vpns)),
                                      a)
        return a

    def check(self):
        assert set(self.j.pools) == set(self.t.pools)
        for name in self.j.pools:
            np.testing.assert_array_equal(
                common.to_u32(self.t.pools[name].storage),
                np.asarray(self.j.pools[name].storage))
            assert self.t.pools[name].boundary == self.j.pools[name].boundary
            assert self.t.allocators[name].owner == \
                self.j.allocators[name].owner
        for name, space in self.j.tenants.items():
            got = {v: (p.pool, p.phys, p.reliability.value, p.segment)
                   for v, p in self.t.tenants[name].entries.items()}
            want = {v: (p.pool, p.phys, p.reliability.value, p.segment)
                    for v, p in space.entries.items()}
            assert got == want
        assert self.t.swap.keys() == self.j.swap.keys()
        for slot, page in self.j.swap.items():
            np.testing.assert_array_equal(self.t.swap[slot], page)
        assert vars(self.t.stats) == vars(self.j.stats)


def _data(rng, n):
    return rng.integers(0, 2**32, (n, 8 * W), dtype=np.uint32)


def test_alloc_write_read_swap_bit_exact():
    rng = np.random.default_rng(0)
    vm = TwinVM()
    vm.add_pool("a", 16, Layout.INTERWRAP)
    vm.add_pool("b", 16, Layout.BASELINE_ECC)
    vm.tenant("t", Protection.NONE)
    vm.tenant("p", Protection.SECDED)
    vt = vm.alloc("t", 24)
    vp = vm.alloc("p", 10)
    vh = vm.alloc("t", 8)                      # overflows to the host tier
    dt, dp, dh = _data(rng, 24), _data(rng, 10), _data(rng, 8)
    vm.write("t", vt, dt)
    vm.write("p", vp, dp)
    vm.write("t", vh, dh)
    vm.check()
    np.testing.assert_array_equal(vm.read("t", vt + vh),
                                  np.concatenate([dt, dh]))
    np.testing.assert_array_equal(vm.read("p", vp), dp)
    assert vm.j.swap_out("t", vt[:5]) == vm.t.swap_out("t", vt[:5]) == 5
    vm.check()
    np.testing.assert_array_equal(vm.read("t", vt), dt)
    vm.j.free("t", vt[5:9])
    vm.t.free("t", vt[5:9])
    vm.alloc("p", 2)
    vm.check()
    assert vm.t.device_capacity_pages() == vm.j.device_capacity_pages()
    assert vm.t.utilisation() == vm.j.utilisation()


def test_repartition_upgrade_migrates_extras_bit_exact():
    """Mapped extra pages survive a protection upgrade: read out through
    the gather/re-encode path, landed in SECDED frames with the
    precomputed codes, overflow to host — same frames, same bits."""
    rng = np.random.default_rng(1)
    vm = TwinVM()
    vm.add_pool("kv", 32, Layout.INTERWRAP)
    vm.tenant("t", Protection.NONE)
    vpns = vm.alloc("t", vm.t.pools["kv"].num_pages)
    data = _data(rng, len(vpns))
    vm.write("t", vpns, data)
    freed = [v for v in vpns if vm.t.translate("t", v).phys in (27, 28)]
    vm.j.free("t", freed)
    vm.t.free("t", freed)
    info_j = JMig(vm.j).repartition_with_migration("kv", 8)
    mig = MigrationEngine(vm.t)
    info_t = mig.repartition_with_migration("kv", 8)
    assert info_t == info_j
    assert info_t["migrated"] == 3 and info_t["to_host"] == 1
    assert mig.stats.kernel_batches == 1
    vm.check()
    keep = [i for i, v in enumerate(vpns) if v not in freed]
    np.testing.assert_array_equal(vm.read("t", [vpns[i] for i in keep]),
                                  data[keep])


def test_repartition_downgrade_relocates_strict_tenants_bit_exact():
    rng = np.random.default_rng(2)
    vm = TwinVM()
    vm.add_pool("kv", 32, Layout.INTERWRAP, boundary=8)
    vm.tenant("strict", Protection.SECDED)
    vm.tenant("loose", Protection.NONE)
    vs = vm.alloc("strict", 12)
    vl = vm.alloc("loose", 6)
    ds, dl = _data(rng, 12), _data(rng, 6)
    vm.write("strict", vs, ds)
    vm.write("loose", vl, dl)
    info_j = JMig(vm.j).repartition_with_migration("kv", 16)
    info_t = MigrationEngine(vm.t).repartition_with_migration("kv", 16)
    assert info_t == info_j and info_t["migrated"] > 0
    vm.check()
    np.testing.assert_array_equal(vm.read("strict", vs), ds)
    np.testing.assert_array_equal(vm.read("loose", vl), dl)


def test_bad_boundary_and_sharded_pools_raise():
    vm = VirtualMemory(row_words=W, device="cpu")
    vm.add_pool("kv", 16, Layout.INTERWRAP)
    with pytest.raises(ValueError, match="bad boundary"):
        MigrationEngine(vm).repartition_with_migration("kv", 4)
    # sharded pools need rows and boundary in multiples of shards * 8
    with pytest.raises(ValueError, match="multiple"):
        vm.add_pool("s", 16, Layout.INTERWRAP, shards=4)
    from repro_torch.shard import ShardedPool
    assert isinstance(vm.add_pool("s", 16, Layout.INTERWRAP, shards=2),
                      ShardedPool)
    with pytest.raises(ValueError, match="expected"):
        vm.create_tenant("t")
        vm.write("t", vm.alloc("t", 1), torch.zeros((1, 3), dtype=torch.int32))
