"""CREAM-Cache end to end: memcached on the real data plane.

The paper's Fig. 8 story, live: a key-value cache whose objects sit in
actual CREAM pool pages, a zipfian workload hammering it, and a mid-run
SECDED -> correction-free demotion whose freed frames the cache claims
online — watch the hit rate (and the modeled request latency) improve the
moment the boundary register moves. Authoritative items keep a SECDED
contract throughout and survive everything. Port of
``examples/objcache_memcached.py``; the page-fault model's constants and
trace come from :mod:`repro_torch.examples.cache_sim`.

Run: PYTHONPATH=src python -m repro_torch.examples.objcache_memcached [--device cpu]
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.layouts import Layout
from repro_torch.core.protection import Protection
from repro_torch.examples import cache_sim, parser
from repro_torch.kernels.common import resolve_device
from repro_torch.objcache import ObjCache
from repro_torch.vm import MigrationEngine, VirtualMemory

ROWS, ROW_WORDS = 48, 64
GET_BATCH, SET_BATCH = 32, 16


def values_for(keys, span):
    return np.asarray(keys, np.uint32)[:, None] * \
        np.arange(1, span + 1, dtype=np.uint32)


def replay(cache, trace, span):
    pending = np.zeros(0, np.int64)
    g0, h0 = cache.stats.gets, cache.stats.hits
    for i in range(0, len(trace) - len(trace) % GET_BATCH, GET_BATCH):
        ks = trace[i:i + GET_BATCH]
        _, _, found = cache.get_many(ks)
        pending = np.unique(np.concatenate([pending, ks[~found]]))
        while len(pending) >= SET_BATCH:
            batch, pending = pending[:SET_BATCH], pending[SET_BATCH:]
            cache.set_many(batch, values_for(batch, span))
    gets, hits = cache.stats.gets - g0, cache.stats.hits - h0
    miss = gets - hits
    model_us = (miss * cache_sim.FAULT_PENALTY_US
                + hits * cache_sim.HIT_COST_US) / max(gets, 1)
    return hits / max(gets, 1), model_us


def main(argv=None, device=None) -> None:
    args = parser(__doc__).parse_args(argv)
    device = resolve_device(device if device is not None else args.device)

    # 1) An all-SECDED DIMM under VM management, the cache as its tenant.
    vm = VirtualMemory(row_words=ROW_WORDS, device=device)
    vm.add_pool("dimm", ROWS, Layout.INTERWRAP, boundary=0)
    cache = ObjCache(vm, "dimm", index_capacity=4 * ROWS, probe=16)
    span = vm.page_words                 # full-page objects: pages = items

    # 2) A handful of authoritative items contract for SECDED protection.
    auth = np.arange(90_000, 90_004)
    cache.set_many(auth, values_for(auth, span),
                   reliability=Protection.SECDED)

    # 3) Zipfian traffic against the baseline capacity.
    trace = cache_sim.zipf_trace(np.random.default_rng(0), 4 * ROWS, 6000)
    hit0, us0 = replay(cache, trace[:3000], span)
    print(f"all-SECDED   : {vm.device_capacity_pages()} pages, "
          f"hit={hit0:.3f}, modeled {us0:8.1f} us/req")

    # 4) Live demotion: the boundary register frees the code lane mid-run.
    #    Cached values are untouched; the reclaimed frames join the free
    #    lists and the very next slab reservation claims them.
    MigrationEngine(vm).repartition_with_migration("dimm", ROWS)
    cache.refresh_translation()
    hit1, us1 = replay(cache, trace[3000:], span)
    print(f"correction-free: {vm.device_capacity_pages()} pages, "
          f"hit={hit1:.3f}, modeled {us1:8.1f} us/req")
    print(f"capacity +{vm.device_capacity_pages() - ROWS} pages -> "
          f"hit rate {hit0:.3f} -> {hit1:.3f}, "
          f"modeled latency x{us0 / max(us1, 1e-9):.2f} better")

    # 5) The authoritative items lived through it all, bit for bit.
    got, _, found = cache.get_many(auth)
    assert found.all()
    np.testing.assert_array_equal(got, values_for(auth, span))
    print("authoritative SECDED items intact after the boundary move")


if __name__ == "__main__":
    main()
