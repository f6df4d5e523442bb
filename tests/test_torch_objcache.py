"""CREAM-Cache on the port equals the reference: the hash index, the fused
probe + gather read, and whole ``ObjCache`` replays on the three
protection configurations with a demotion and an upgrade.

Both packages get the same numpy inputs; the port runs on the CPU, where
the hash wrapper takes its plain version, held here against the
reference's Pallas kernel in interpret mode.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import pool as jp
from repro.core import secded as jsec
from repro.core.layouts import Layout as JLayout
from repro.kernels.hash import kernel as jhash
from repro.objcache import ObjCache as JCache
from repro.objcache import hash_index as jhix
from repro.vm import MigrationEngine as JMig
from repro.vm import VirtualMemory as JVM
from repro_torch.core.layouts import Layout
from repro_torch.kernels import common
from repro_torch.kernels.hash import ops as hash_ops
from repro_torch.objcache import ObjCache
from repro_torch.objcache import hash_index as hix
from repro_torch.vm import MigrationEngine, VirtualMemory

ROWS, W = 16, 64


def _keys(a) -> torch.Tensor:
    return common.to_words(np.asarray(a, np.uint32))


# ---------------------------------------------------------------------------
# The hash index
# ---------------------------------------------------------------------------


def test_hash_u32_and_probe_window_over_edge_keys():
    edge = np.asarray([0, 1, hix.MAX_KEY, hix.TOMB, hix.EMPTY, 2**31 - 1,
                       2**31, 2**31 + 1, 0x9E3779B9, 123456789], np.uint32)
    want = np.asarray(jhix.hash_u32(jnp.asarray(edge)))
    np.testing.assert_array_equal(common.to_u32(hix.hash_u32(_keys(edge))),
                                  want)
    for capacity, probe in ((16, 4), (1000, 16), (2**20 + 7, 32)):
        np.testing.assert_array_equal(
            hix.probe_slots(_keys(edge), capacity, probe).numpy(),
            np.asarray(jhix.probe_slots(jnp.asarray(edge), capacity, probe)))
    assert (hix.EMPTY, hix.TOMB, hix.MAX_KEY) == \
        (jhix.EMPTY, jhix.TOMB, jhix.MAX_KEY)


def _colliders(capacity: int, home: int, count: int) -> list[int]:
    """Keys whose window starts at slot ``home``."""
    out, k = [], 0
    while len(out) < count:
        if int(np.asarray(jhix.hash_u32(jnp.asarray([k], jnp.uint32)))[0]) \
                % capacity == home:
            out.append(k)
        k += 1
    return out


class TwinIndex:
    def __init__(self, capacity, probe):
        self.j = jhix.make_index(capacity, probe)
        self.t = hix.make_index(capacity, probe, device="cpu")

    def check(self):
        for name in ("key", "page", "off", "length"):
            np.testing.assert_array_equal(
                common.to_u32(getattr(self.t, name)),
                np.asarray(getattr(self.j, name)).view(np.uint32))
        np.testing.assert_array_equal(self.t.live.numpy(),
                                      np.asarray(self.j.live))

    def insert(self, keys, rng):
        n = len(keys)
        pages, offs, lens = (rng.integers(0, 100, n).astype(np.int32)
                             for _ in range(3))
        self.j, js, jok = jhix.insert(self.j, jnp.asarray(keys, jnp.uint32),
                                      jnp.asarray(pages), jnp.asarray(offs),
                                      jnp.asarray(lens))
        before = self.t.key.clone()
        new, ts, tok = hix.insert(self.t, _keys(keys), torch.as_tensor(pages),
                                  torch.as_tensor(offs), torch.as_tensor(lens))
        assert self.t.key.equal(before)          # functional: input intact
        self.t = new
        np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
        np.testing.assert_array_equal(tok.numpy(), np.asarray(jok))
        self.check()
        return np.asarray(jok)

    def find(self, keys):
        js, jf = jhix.find(self.j, jnp.asarray(keys, jnp.uint32))
        ts, tf = hix.find(self.t, _keys(keys))
        np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
        np.testing.assert_array_equal(tf.numpy(), np.asarray(jf))
        want = jhix.lookup(self.j, jnp.asarray(keys, jnp.uint32))
        got = hix.lookup(self.t, _keys(keys))
        for w, g in zip(want, got, strict=True):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        return np.asarray(jf)

    def delete(self, keys):
        self.j, jf = jhix.delete(self.j, jnp.asarray(keys, jnp.uint32))
        self.t, tf = hix.delete(self.t, _keys(keys))
        np.testing.assert_array_equal(tf.numpy(), np.asarray(jf))
        self.check()

    def delete_slots(self, slots):
        self.j = jhix.delete_slots(self.j, jnp.asarray(slots, jnp.int32))
        self.t = hix.delete_slots(self.t, torch.as_tensor(slots))
        self.check()


def test_index_sequence_with_conflicts_full_windows_and_tombstones():
    rng = np.random.default_rng(3)
    capacity, probe = 16, 4
    tw = TwinIndex(capacity, probe)
    col = _colliders(capacity, 5, 6)
    # six keys with one home slot in one batch: in-batch conflicts, and
    # the last two find their window full
    ok = tw.insert(col, rng)
    assert ok.tolist() == [True] * 4 + [False] * 2
    tw.find(col + [99999])
    tw.delete(col[:2] + [424242])                 # tombstones mid-window
    assert tw.find(col[2:4]).all()                # displaced keys survive
    assert tw.insert(col[4:], rng).all()          # tombstones reused
    tw.insert(col[2:3] + [7, 8, 9], rng)          # an update and new keys
    tw.delete_slots(np.asarray([0, 3, 15]))
    keys = rng.choice(2**32 - 2, 40, replace=False).astype(np.uint32)
    tw.insert(keys[:20], rng)
    tw.insert(keys[20:], rng)                     # a nearly full table
    tw.find(np.concatenate([keys, col]))
    tw.delete(keys[::3])
    tw.find(keys)


# ---------------------------------------------------------------------------
# The fused probe + gather read
# ---------------------------------------------------------------------------


def _pool_words(layout: Layout, boundary: int, seed: int
                ) -> tuple[np.ndarray, int]:
    """A reference pool filled with random pages (codes maintained), then
    flips in three SECDED rows: a data bit, a code bit, a double."""
    rng = np.random.default_rng(seed)
    pool = jp.make_pool(ROWS, JLayout(layout.value), boundary=boundary,
                        row_words=W)
    pool = pool.write(np.arange(pool.num_pages), jnp.asarray(rng.integers(
        0, 2**32, (pool.num_pages, 8 * W), dtype=np.uint32)))
    sto = np.asarray(pool.storage).copy()
    if boundary <= ROWS - 3:
        sto[boundary, 5, 3] ^= np.uint32(1 << 7)
        sto[boundary + 1, 8, 2] ^= np.uint32(1 << 12)
        sto[boundary + 2, 0, 8] ^= np.uint32(0b101)
        data = sto[boundary:boundary + 3, :8].reshape(3, -1)
        st = np.asarray(jsec.decode_block(jnp.asarray(data),
                                          jnp.asarray(sto[boundary:boundary
                                                          + 3, 8]))[2])
        assert sorted(set(st.max(axis=1).tolist())) == [1, 2, 3]
    return sto, pool.num_pages


@pytest.mark.parametrize("boundary", [0, 8, ROWS])
@pytest.mark.parametrize("layout", list(Layout))
def test_lookup_read_matches_pallas(layout, boundary):
    sto, n_pages = _pool_words(layout, boundary, 20 + boundary)
    rng = np.random.default_rng(boundary)
    keys = rng.choice(10_000, 9, replace=False).astype(np.uint32)
    pages = np.unique(np.concatenate([
        [boundary, boundary + 1, boundary + 2, n_pages - 1],
        rng.permutation(n_pages)[:5]]))
    pages = pages[pages < n_pages][:9].astype(np.int32)
    index = jhix.make_index(32, 8)
    index, _, ok = jhix.insert(index, jnp.asarray(keys[:len(pages)]),
                               jnp.asarray(pages),
                               jnp.zeros(len(pages), jnp.int32),
                               jnp.full(len(pages), 8, jnp.int32))
    assert np.asarray(ok).all()
    queries = np.concatenate([keys[:len(pages)], [55555, 7]]).astype(
        np.uint32)
    want = jhash.lookup_read(jnp.asarray(sto), index.key, index.page,
                             jnp.asarray(queries), JLayout(layout.value),
                             ROWS, boundary, index.probe)
    got = hash_ops.lookup_read(
        common.to_words(sto), common.to_words(np.asarray(index.key)),
        torch.as_tensor(np.array(index.page)), _keys(queries), layout,
        ROWS, boundary, index.probe)
    np.testing.assert_array_equal(common.to_u32(got), np.asarray(want))


# ---------------------------------------------------------------------------
# Whole-cache replays: the three configurations, demotion, upgrade
# ---------------------------------------------------------------------------

#: (layout, boundary) — the three protection levels of bench_objcache.py
CONFIGS = {"baseline": (Layout.INTERWRAP, 0),
           "parity": (Layout.PARITY, None),
           "correction_free": (Layout.INTERWRAP, None)}
GET_BATCH, SET_BATCH = 16, 4


def values_for(keys, span):
    keys = np.asarray(keys, np.uint32)
    return keys[:, None] * np.arange(1, span + 1, dtype=np.uint32)


class TwinCache:
    def __init__(self, layout: Layout, boundary):
        self.jvm = JVM(row_words=W)
        self.jvm.add_pool("dimm", ROWS, JLayout(layout.value),
                          boundary=boundary)
        self.tvm = VirtualMemory(row_words=W, device="cpu")
        self.tvm.add_pool("dimm", ROWS, layout, boundary=boundary)
        self.j = JCache(self.jvm, "dimm", index_capacity=4 * ROWS, probe=16)
        self.t = ObjCache(self.tvm, "dimm", index_capacity=4 * ROWS,
                          probe=16)

    def check(self):
        np.testing.assert_array_equal(
            common.to_u32(self.tvm.pools["dimm"].storage),
            np.asarray(self.jvm.pools["dimm"].storage))
        for f in dataclasses.fields(self.j.stats):
            if not f.name.endswith("_s"):         # wall-clock seconds differ
                assert getattr(self.t.stats, f.name) == \
                    getattr(self.j.stats, f.name), f.name
        np.testing.assert_array_equal(self.t._live, self.j._live)
        assert self.t.capacity_report() == self.j.capacity_report()

    def get(self, keys):
        want = self.j.get_many(keys)
        got = self.t.get_many(keys)
        for w, g in zip(want, got, strict=True):
            np.testing.assert_array_equal(g, w)
        return got

    def set(self, keys, values, lens=None):
        want = self.j.set_many(keys, values, lens)
        got = self.t.set_many(keys, values, lens)
        np.testing.assert_array_equal(got, want)

    def delete(self, keys):
        np.testing.assert_array_equal(self.t.delete_many(keys),
                                      self.j.delete_many(keys))

    def repartition(self, boundary):
        want = JMig(self.jvm).repartition_with_migration("dimm", boundary)
        got = MigrationEngine(self.tvm).repartition_with_migration("dimm",
                                                                  boundary)
        assert got == want
        assert self.t.refresh_translation() == self.j.refresh_translation()
        self.check()
        return got


def _replay(tw: TwinCache, trace: np.ndarray, rng) -> None:
    """bench_objcache.replay on both caches: gets in fixed batches, misses
    refilled SET_BATCH at a time with full-page or sub-page values, every
    hit verified, a few deletes; both caches compared after each batch."""
    pending = np.zeros(0, np.int64)
    span = 8 * W
    for i in range(0, len(trace) - len(trace) % GET_BATCH, GET_BATCH):
        ks = trace[i:i + GET_BATCH]
        vals, lens, found = tw.get(ks)
        want = values_for(ks[found], span)
        for v, n, w in zip(vals[found], lens[found], want):
            np.testing.assert_array_equal(v[:n], w[:n])
        pending = np.unique(np.concatenate([pending, ks[~found]]))
        while len(pending) >= SET_BATCH:
            batch, pending = pending[:SET_BATCH], pending[SET_BATCH:]
            lens = rng.choice([span // 8, span // 2, span], SET_BATCH)
            tw.set(batch, values_for(batch, span), lens)
        if i % (4 * GET_BATCH) == 0:
            tw.delete(ks[:2])
        tw.check()


def _zipf(rng, n_pages, n, alpha=0.99):
    probs = np.arange(1, n_pages + 1, dtype=np.float64) ** (-alpha)
    probs /= probs.sum()
    return rng.permutation(n_pages)[rng.choice(n_pages, size=n, p=probs)]


@pytest.mark.parametrize("config", list(CONFIGS))
def test_cache_replay_demotion_and_upgrade_bit_exact(config):
    rng = np.random.default_rng(11)
    layout, boundary = CONFIGS[config]
    tw = TwinCache(layout, boundary)
    trace = _zipf(rng, 4 * ROWS, 256)
    _replay(tw, trace[:128], rng)
    tw.repartition(ROWS)                          # demotion (no-op if CREAM)
    _replay(tw, trace[128:], rng)
    live = np.flatnonzero(tw.t._live)
    info = tw.repartition(0)                      # upgrade: extras migrate
    if tw.t.capacity_report()["away_items"]:
        assert info["to_host"] > 0
    tw.get(np.unique(trace))
    assert len(live) and tw.t.stats.host_hits == tw.j.stats.host_hits
    _replay(tw, trace[:64], rng)


def test_upgrade_sends_values_to_the_host_tier_and_reads_them_back():
    """A full correction-free cache upgraded to SECDED parks the values of
    its evicted extra pages on the host and serves them as host hits."""
    tw = TwinCache(Layout.INTERWRAP, None)
    keys = np.arange(1, 3 * ROWS)
    tw.set(keys, values_for(keys, 8 * W))
    stored = keys[tw.t.get_many(keys)[2]]
    tw.j.get_many(keys)
    info = tw.repartition(0)
    assert info["to_host"] > 0
    vals, _, found = tw.get(stored)
    assert found.all() and tw.t.stats.host_hits > 0
    np.testing.assert_array_equal(vals, values_for(stored, 8 * W))
    tw.check()


def test_cache_rejects_bad_keys_and_values():
    vm = VirtualMemory(row_words=W, device="cpu")
    vm.add_pool("dimm", ROWS, Layout.INTERWRAP)
    cache = ObjCache(vm, "dimm", index_capacity=64, probe=8)
    with pytest.raises(ValueError, match="keys must be"):
        cache.get_many([hix.TOMB])
    with pytest.raises(ValueError, match="values must be"):
        cache.set_many([1], np.zeros((1, 8 * W + 1), np.uint32))
    with pytest.raises(ValueError, match="not under VM management"):
        ObjCache(vm, "nope")
