"""The VM and the sharded pool at every row width the reference takes.

The second half of ``test_torch_widths.py`` (which holds the pools, PARITY,
the plain kernels and empty id vectors), in a file of its own so that the
two run side by side: at W in {4, 7, 12, 60}, none a multiple of 8, and
the four layouts that take such widths, the same numpy inputs through
both packages on the CPU give the same pages, page tables, swap contents,
statuses, scrub censuses and storage bits for

  * the VM: alloc, write, read, swap out and in, relocate, and a
    repartition with migration down and back up;
  * the sharded pool at S = 1 against the reference's own ShardedPool;
  * the sharded pool at S = 4 against four reference ``PoolState`` banks
    driven through ``router.route_np``.
"""
import jax.numpy as jnp
import numpy as np
import pytest

from repro import shard as jshard
from repro.core import pool as jpool
from repro.core.protection import Protection as JProt
from repro.vm.address_space import VirtualMemory as JVM
from repro.vm.migration import MigrationEngine as JMig
from repro_torch.core.layouts import Layout
from repro_torch.core.protection import Protection
from repro_torch.kernels import common
from repro_torch.shard import make_sharded_pool, router
from repro_torch.vm.address_space import VirtualMemory
from repro_torch.vm.migration import MigrationEngine
from test_torch_widths import (LAYOUTS, WIDTHS, R, _flip, _flip_cells, _jl,
                               _pages, _u32)


@pytest.mark.parametrize("layout", LAYOUTS, ids=lambda l: l.value)
@pytest.mark.parametrize("W", WIDTHS)
def test_vm_equals_the_reference(W, layout):
    """Alloc, write, read, swap out and in, relocate, and a repartition
    with migration down and back up, at width W: the same frames, page
    tables, swap contents, stats and storage bits."""
    rng = np.random.default_rng(W)
    j, t = JVM(row_words=W), VirtualMemory(row_words=W, device="cpu")
    for vm, lay, prot in ((j, _jl(layout), JProt), (t, layout, Protection)):
        vm.add_pool("kv", R, lay)
        vm.add_pool("ecc", 16, type(lay).BASELINE_ECC)
        vm.create_tenant("loose", prot.NONE)
        vm.create_tenant("strict", prot.SECDED)

    def both(fn):
        a, b = fn(j, JProt), fn(t, Protection)
        assert a == b
        return a

    def check():
        for name in j.pools:
            np.testing.assert_array_equal(_u32(t.pools[name].storage),
                                          np.asarray(j.pools[name].storage))
            assert t.pools[name].boundary == j.pools[name].boundary
        for name, space in j.tenants.items():
            assert {v: (p.pool, p.phys, p.reliability.value)
                    for v, p in t.tenants[name].entries.items()} == \
                {v: (p.pool, p.phys, p.reliability.value)
                 for v, p in space.entries.items()}
        assert t.swap.keys() == j.swap.keys()
        assert vars(t.stats) == vars(j.stats)

    def write(tenant, vpns, data):
        j.write(tenant, vpns, jnp.asarray(data))
        t.write(tenant, vpns, data)

    def read(tenant, vpns):
        want = np.asarray(j.read(tenant, vpns))
        np.testing.assert_array_equal(_u32(t.read(tenant, vpns)), want)
        return want

    vl = both(lambda vm, P: vm.alloc("loose", vm.pools["kv"].num_pages))
    vs = both(lambda vm, P: vm.alloc("strict", 10))
    dl, ds = _pages(rng, len(vl), W), _pages(rng, len(vs), W)
    write("loose", vl, dl)
    write("strict", vs, ds)
    check()
    np.testing.assert_array_equal(read("loose", vl), dl)
    np.testing.assert_array_equal(read("strict", vs), ds)
    assert both(lambda vm, P: vm.swap_out("loose", vl[:4])) == 4
    check()
    assert both(lambda vm, P: vm.swap_in("loose", vl[:2])) == 2
    np.testing.assert_array_equal(read("loose", vl), dl)
    jm, tm = JMig(j), MigrationEngine(t)
    assert tm.relocate("strict", vs[:3]) == jm.relocate("strict", vs[:3])
    check()
    if layout != Layout.BASELINE_ECC:
        freed = vl[-3:]
        j.free("loose", freed)
        t.free("loose", freed)
        for nb in (8, 16):
            assert tm.repartition_with_migration("kv", nb) == \
                jm.repartition_with_migration("kv", nb)
            check()
    live = [v for v in vl if v in t.tenants["loose"].entries]
    np.testing.assert_array_equal(read("loose", live),
                                  dl[[vl.index(v) for v in live]])
    np.testing.assert_array_equal(read("strict", vs), ds)


@pytest.mark.parametrize("layout", LAYOUTS, ids=lambda l: l.value)
@pytest.mark.parametrize("W", WIDTHS)
def test_one_bank_equals_the_reference_sharded_pool(W, layout):
    """At S = 1 the reference's own ShardedPool runs at width W."""
    rows, boundary = 32, 16
    j = jshard.make_sharded_pool(rows, _jl(layout), boundary, num_shards=1,
                                 row_words=W)
    t = make_sharded_pool(rows, layout, boundary, num_shards=1, row_words=W,
                          device="cpu")
    rng = np.random.default_rng(W)
    ids = rng.permutation(t.num_pages)
    assert t.num_pages == j.num_pages
    data = _pages(rng, ids.size, W)
    j, t = j.write(ids, jnp.asarray(data)), t.write(ids, common.to_words(data))

    def same():
        np.testing.assert_array_equal(_u32(t.storage), np.asarray(j.storage))
        jd, js = j.read(ids, status=True)
        td, ts = t.read(ids, status=True)
        np.testing.assert_array_equal(_u32(td), np.asarray(jd))
        np.testing.assert_array_equal(_u32(t.read(ids)), np.asarray(jd))
        np.testing.assert_array_equal(ts.numpy(), np.asarray(js))

    n = t.num_pages
    j = j.migrate([1, 2, n - 1], [5, n - 2, 3])
    t = t.migrate([1, 2, n - 1], [5, n - 2, 3])
    same()
    j, ji = j.move_boundary(8)
    t, ti = t.move_boundary(8)
    assert ti == ji
    ids = ids[ids < t.num_pages]
    j, t = j.set_daec_rows(8), t.set_daec_rows(8)
    j, js = j.scrub()
    t, ts = t.scrub()
    assert vars(ts) == vars(js)
    same()


@pytest.mark.parametrize("layout", LAYOUTS, ids=lambda l: l.value)
@pytest.mark.parametrize("W", WIDTHS)
def test_four_banks_equal_four_reference_banks(W, layout):
    """S = 4 against four reference PoolStates through ``route_np``:
    writes, routed and status reads with flips, a migration across banks,
    a repartition, a DAEC tier and a scrub."""
    S, rows, boundary = 4, 64, 32
    t = make_sharded_pool(rows, layout, boundary, num_shards=S, row_words=W,
                          device="cpu")
    j = [jpool.make_pool(rows // S, _jl(layout), t.boundary_local,
                         row_words=W) for _ in range(S)]
    rng = np.random.default_rng(W + 1)

    def route(ids):
        return router.route_np(np.asarray(ids, np.int64), rows, S)

    def check():
        for s in range(S):
            np.testing.assert_array_equal(_u32(t.storage[s]),
                                          np.asarray(j[s].storage))

    def read(ids):
        shard, local = route(ids)
        data = np.zeros((len(ids), 8 * W), np.uint32)
        status = np.zeros(len(ids), np.int32)
        for s in range(S):
            own = shard == s
            if own.any():
                d, st = j[s].read(local[own], status=True)
                data[own], status[own] = np.asarray(d), np.asarray(st)
        td, ts = t.read(ids, status=True)
        np.testing.assert_array_equal(_u32(t.read(ids)), data)
        np.testing.assert_array_equal(_u32(td), data)
        np.testing.assert_array_equal(ts.numpy(), status)
        return data, status

    def land(ids, data):
        shard, local = route(ids)
        for s in range(S):
            own = shard == s
            if own.any():
                j[s] = j[s].write(local[own], jnp.asarray(data[own]))

    n = t.num_pages
    ids = rng.permutation(n)
    data = _pages(rng, n, W)
    t = t.write(ids, common.to_words(data))
    land(ids, data)
    check()
    b_local = t.boundary_local
    cells = [(s, c) for s in range(S)
             for c in _flip_cells(rng, b_local, rows // S, W, 3)]
    sto = _u32(t.storage).copy()
    for s, c in cells:
        sto[s] = _flip(sto[s], [c])
    t.storage.copy_(common.to_words(sto))
    j = [jpool.PoolState(jnp.asarray(sto[s]), b.boundary, b.layout,
                         b.row_words, b.daec_rows) for s, b in enumerate(j)]
    _, status = read(ids)
    assert {1, 2, 3} <= set(status.tolist())
    src, dst = ids[:4], ids[4:8]
    moved, _ = read(src)
    t = t.migrate(src, dst)
    land(dst, moved)
    check()
    if layout != Layout.BASELINE_ECC:
        t, _ = t.move_boundary(0)
        j = [jpool.repartition(b, 0)[0] for b in j]
        check()
    t = t.set_daec_rows(S)
    j = [jpool.set_daec_rows(b, 1) for b in j]
    check()
    read(np.arange(t.num_pages))
    t, _ = t.scrub()
    j = [b.scrub()[0] for b in j]
    check()
