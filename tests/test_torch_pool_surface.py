"""The rest of the port's pool surface equals the reference bit for bit.

Capacity accounting (``raw_bytes``, ``effective_bytes``,
``capacity_gain``) over every layout and boundary; the write-back read on
SECDED, DAEC-tier and PARITY pools, each plain and behind a
``ShadowedPool``, with planted single and double flips (data, status and
storage after a first and a second read); the sharded write-back read
against the reference ``ShardedPool`` at S = 1 and against S reference
``PoolState`` banks driven through ``router.route_np`` at S = 4 (the
reference's own S > 1 path does not run under the installed JAX);
``streams``, ``read_page`` / ``write_page``, ``migrate_pages``, the VM's
``adopt_pool`` / ``capacity_report`` and the migration throughput.
Everything runs on the CPU from the same numpy inputs; every comparison
of words, statuses and reports is exact.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as jcore
import repro_torch.core as tcore
from repro import shard as jshard
from repro.core import pool as jp
from repro.core.layouts import Layout as JLayout
from repro.core.protection import Protection as JProt
from repro.faults import ShadowedPool as JShadow
from repro.vm.address_space import VirtualMemory as JVM
from repro.vm.migration import MigrationStats as JStats
from repro_torch.core import pool as tp
from repro_torch.core.layouts import Layout
from repro_torch.core.protection import Protection
from repro_torch.faults import ShadowedPool
from repro_torch.kernels import common
from repro_torch.shard import make_sharded_pool, router
from repro_torch.vm.address_space import VirtualMemory
from repro_torch.vm.migration import MigrationStats

ROWS, W = 32, 64


def _u32(t: torch.Tensor) -> np.ndarray:
    return common.to_u32(t)


def _jl(layout: Layout) -> JLayout:
    return JLayout(layout.value)


def test_core_exports_what_the_reference_exports():
    assert sorted(tcore.__all__) == sorted(jcore.__all__)


# ---------------------------------------------------------------------------
# Capacity accounting
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("boundary", [0, ROWS // 2, ROWS])
@pytest.mark.parametrize("layout", list(Layout), ids=lambda l: l.value)
def test_capacity_accounting_equals_the_reference(layout, boundary):
    j = jp.make_pool(ROWS, _jl(layout), boundary=boundary, row_words=W)
    t = tp.make_pool(ROWS, layout, boundary=boundary, row_words=W,
                     device="cpu")
    assert (t.boundary, t.num_pages, t.num_extra_pages) == \
        (j.boundary, j.num_pages, j.num_extra_pages)
    assert t.raw_bytes == j.raw_bytes == ROWS * 9 * W * 4
    assert t.effective_bytes == j.effective_bytes
    assert t.capacity_gain() == j.capacity_gain()
    sh = ShadowedPool(t)
    assert sh.capacity_gain() == JShadow(j).capacity_gain()


# ---------------------------------------------------------------------------
# The write-back read
# ---------------------------------------------------------------------------

# (name, layout, boundary, daec_rows, flips (row, lane, word, bit)):
# SECDED singles in data and code, a same-word double (uncorrectable), a
# page holding both a single and a double (worst status 3: not written
# back), DAEC singles, adjacent and same-codeword doubles, PARITY and
# unprotected CREAM flips
WRITEBACK = [
    ("secded", Layout.INTERWRAP, 0, 0,
     [(1, 2, 5, 7), (2, 0, 9, 30), (3, 8, 3, 4), (4, 6, 1, 3), (4, 6, 1, 9),
      (5, 1, 0, 0), (5, 7, 60, 2), (5, 7, 60, 3)]),
    ("mixed", Layout.INTERWRAP, 16, 0,
     [(17, 3, 11, 12), (18, 5, 2, 0), (18, 5, 2, 1), (19, 8, 40, 31),
      (3, 0, 0, 0)]),
    ("daec-tier", Layout.INTERWRAP, 8, 8,
     [(9, 2, 5, 7), (10, 4, 4, 1), (10, 4, 4, 2), (25, 3, 5, 17),
      (26, 0, 10, 7), (26, 0, 10, 8), (27, 2, 4, 5), (27, 2, 4, 7),
      (28, 8, 6, 6)]),
    ("parity", Layout.PARITY, 16, 0,
     [(20, 1, 7, 7), (21, 2, 2, 2), (21, 2, 2, 20), (22, 8, 0, 1),
      (2, 4, 8, 3), (6, 2, 8, 7), (6, 2, 8, 8)]),
    ("parity-daec", Layout.PARITY, 16, 8,
     [(17, 1, 7, 7), (25, 6, 33, 9), (26, 5, 4, 0), (26, 5, 4, 1),
      (1, 3, 3, 3)]),
]


class TwinPool:
    """A reference and a port pool (each optionally shadowed) holding the
    same seeded pages, then the same planted flips."""

    def __init__(self, layout, boundary, daec_rows, shadowed, seed=0):
        j = jp.make_pool(ROWS, _jl(layout), boundary=boundary,
                         row_words=W, daec_rows=daec_rows)
        t = tp.make_pool(ROWS, layout, boundary=boundary, row_words=W,
                         daec_rows=daec_rows, device="cpu")
        self.shadowed = shadowed
        self.j = JShadow(j) if shadowed else j
        self.t = ShadowedPool(t) if shadowed else t
        self.n = t.num_pages
        data = np.random.default_rng(seed).integers(
            0, 2**32, (self.n, t.page_words), dtype=np.uint32)
        ids = np.arange(self.n)
        self.j = self.j.write(ids, jnp.asarray(data))
        self.t = self.t.write(ids, common.to_words(data))
        self.truth = data
        self.same_storage()

    def _inner(self, pool):
        return pool.inner if self.shadowed else pool

    def flip(self, cells) -> None:
        sto = _u32(self._inner(self.t).storage).copy()
        for r, ln, w, b in cells:
            sto[r, ln, w] ^= np.uint32(1 << b)
        jin = dataclasses.replace(self._inner(self.j),
                                  storage=jnp.asarray(sto))
        tin = dataclasses.replace(self._inner(self.t),
                                  storage=common.to_words(sto))
        if self.shadowed:
            self.j.inner, self.t.inner = jin, tin
        else:
            self.j, self.t = jin, tin
        self.same_storage()

    def same_storage(self) -> None:
        np.testing.assert_array_equal(_u32(self._inner(self.t).storage),
                                      np.asarray(self._inner(self.j).storage))

    def read_writeback(self, ids) -> np.ndarray:
        before = _u32(self._inner(self.t).storage).copy()
        old = self._inner(self.t)
        jd, js, self.j = self.j.read_writeback(ids)
        td, ts, self.t = self.t.read_writeback(ids)
        np.testing.assert_array_equal(_u32(td), np.asarray(jd))
        np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
        assert ts.dtype == torch.int32
        self.same_storage()
        # not donating: the input state's storage is as it was
        np.testing.assert_array_equal(_u32(old.storage), before)
        if self.shadowed:
            assert {k: vars(v) for k, v in self.t.census.items()} == \
                {k: vars(v) for k, v in self.j.census.items()}
        return ts.numpy()


@pytest.mark.parametrize("shadowed", [False, True], ids=["plain", "shadowed"])
@pytest.mark.parametrize("case", WRITEBACK, ids=[c[0] for c in WRITEBACK])
def test_read_writeback_equals_the_reference(case, shadowed):
    _, layout, boundary, daec_rows, flips = case
    tw = TwinPool(layout, boundary, daec_rows, shadowed)
    tw.flip(flips)
    rng = np.random.default_rng(3)
    ids = rng.permutation(tw.n)
    ids = np.concatenate([ids, ids[:3]])          # duplicate ids too
    first = tw.read_writeback(ids)
    second = tw.read_writeback(ids)
    corrected = np.isin(first, (1, 2))
    assert corrected.any() and (first == 3).any()
    # everything the first read corrected now reads clean; the
    # uncorrectable pages kept their evidence
    assert (second[corrected] == 0).all()
    np.testing.assert_array_equal(second == 3, first == 3)


# ---------------------------------------------------------------------------
# The sharded write-back read
# ---------------------------------------------------------------------------

S_ROWS, S_W = 64, 16


def _sharded_storage(S, b_local, seed):
    """Random (S, R_local, 9, S_W) words; every bank's protected rows carry
    valid SECDED codes, then a single data-bit, a single code-bit and a
    same-word double flip in its first three protected rows."""
    from repro.core import secded as jsec
    rng = np.random.default_rng(seed)
    r_local = S_ROWS // S
    sto = rng.integers(0, 2**32, (S, r_local, 9, S_W), dtype=np.uint32)
    for s in range(S):
        data = sto[s, b_local:, :8].reshape(r_local - b_local, 8 * S_W)
        codes = np.array(jsec.encode_block(jnp.asarray(data)))
        data[0, 3] ^= np.uint32(1 << 5)
        codes[1, 1] ^= np.uint32(1 << 9)
        data[2, 6] ^= np.uint32((1 << 2) | (1 << 9))
        sto[s, b_local:, :8] = data.reshape(-1, 8, S_W)
        sto[s, b_local:, 8] = codes
    return sto


@pytest.mark.parametrize("layout", [Layout.INTERWRAP, Layout.PARITY],
                         ids=lambda l: l.value)
def test_one_bank_read_writeback_equals_the_reference_sharded_pool(layout):
    boundary = 16
    j = jshard.make_sharded_pool(S_ROWS, _jl(layout), boundary, num_shards=1,
                                 row_words=S_W)
    t = make_sharded_pool(S_ROWS, layout, boundary, num_shards=1,
                          row_words=S_W, device="cpu")
    rng = np.random.default_rng(1)
    data = rng.integers(0, 2**32, (t.num_pages, 8 * S_W), dtype=np.uint32)
    ids = rng.permutation(t.num_pages)
    j = j.write(ids, jnp.asarray(data))
    t = t.write(ids, common.to_words(data))
    sto = _u32(t.storage).copy()
    sto[0, 17, 2, 3] ^= np.uint32(1 << 4)              # single
    sto[0, 18, 8, 1] ^= np.uint32(1 << 7)              # code bit
    sto[0, 19, 5, 2] ^= np.uint32((1 << 1) | (1 << 8))  # double
    sto[0, 3, 1, 1] ^= np.uint32(1)                    # CREAM page
    j = dataclasses.replace(j, storage=jax.device_put(
        jnp.asarray(sto), j.storage.sharding))
    t = dataclasses.replace(t, storage=common.to_words(sto))
    for _ in range(2):
        jd, js, j = j.read_writeback(ids)
        td, ts, t = t.read_writeback(ids)
        np.testing.assert_array_equal(_u32(td), np.asarray(jd))
        np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
        np.testing.assert_array_equal(_u32(t.storage), np.asarray(j.storage))
    assert set(ts.numpy().tolist()) >= {0, 3}


@pytest.mark.parametrize("layout,daec_rows", [
    (Layout.INTERWRAP, 0), (Layout.PARITY, 0), (Layout.INTERWRAP, 16)],
    ids=["interwrap", "parity", "daec-tier"])
def test_four_bank_read_writeback_equals_reference_banks(layout, daec_rows):
    S, boundary = 4, 32
    b_local = boundary // S
    sto = _sharded_storage(S, b_local, seed=7)
    t = make_sharded_pool(S_ROWS, layout, boundary, num_shards=S,
                          row_words=S_W, daec_rows=daec_rows, device="cpu")
    t = dataclasses.replace(t, storage=common.to_words(sto))
    banks = [jp.PoolState(jnp.asarray(sto[s]), b_local, _jl(layout), S_W,
                          daec_rows // S) for s in range(S)]
    rng = np.random.default_rng(2)
    ids = rng.permutation(t.num_pages)
    shard, local = router.route_np(ids, S_ROWS, S)
    secded_rows = (local >= b_local) & (local < (S_ROWS - daec_rows) // S)
    counts = []
    for _ in range(2):
        data = np.zeros((ids.size, 8 * S_W), np.uint32)
        status = np.zeros(ids.size, np.int32)
        for s in range(S):
            own = shard == s
            d, st, banks[s] = jp.read_pages_any_writeback(banks[s],
                                                          local[own])
            data[own], status[own] = np.asarray(d), np.asarray(st)
        old = t
        td, ts, t = t.read_writeback(ids)
        np.testing.assert_array_equal(_u32(td), data)
        np.testing.assert_array_equal(ts.numpy(), status)
        for s in range(S):
            np.testing.assert_array_equal(_u32(t.storage[s]),
                                          np.asarray(banks[s].storage))
        assert old.storage.data_ptr() != t.storage.data_ptr()
        counts.append(np.bincount(status[secded_rows], minlength=4).tolist())
    # per bank: two corrected pages, then clean; one double, kept
    assert counts[0][1:] == [S, S, S] and counts[1][1:] == [0, 0, S]


# ---------------------------------------------------------------------------
# streams, single pages, migrate_pages
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shadowed", [False, True], ids=["plain", "shadowed"])
def test_streams_equal_the_reference(shadowed):
    tw = TwinPool(Layout.PARITY, 16, 0, shadowed)
    rng = np.random.default_rng(5)
    pages = rng.permutation(tw.n)[:12].reshape(3, 4)
    want = np.asarray(tw.j.streams(pages))
    got = tw.t.streams(pages)
    assert tuple(got.shape) == want.shape == (3, 4, 8 * W)
    np.testing.assert_array_equal(_u32(got), want)
    data = rng.integers(0, 2**32, (3, 4, 8 * W), dtype=np.uint32)
    valid = rng.random((3, 4)) < 0.7
    tw.j = tw.j.streams(pages, data, valid=valid)
    tw.t = tw.t.streams(torch.as_tensor(pages), common.to_words(data),
                        valid=torch.as_tensor(valid))
    tw.same_storage()
    np.testing.assert_array_equal(_u32(tw.t.streams(pages)),
                                  np.asarray(tw.j.streams(pages)))


@pytest.mark.parametrize("layout,boundary,daec_rows", [
    (Layout.INTERWRAP, 16, 8), (Layout.PARITY, 16, 0),
    (Layout.RANK_SUBSET, 8, 0)], ids=["interwrap-daec", "parity",
                                      "rank-subset"])
def test_read_and_write_page_equal_the_reference(layout, boundary,
                                                 daec_rows):
    tw = TwinPool(layout, boundary, daec_rows, shadowed=False, seed=4)
    tw.flip([(boundary + 1, 2, 3, 4), (boundary + 2, 0, 0, 1),
             (boundary + 2, 0, 0, 2), (1, 1, 1, 1)])
    rng = np.random.default_rng(6)
    for page in [0, 1, boundary, boundary + 1, boundary + 2, ROWS - 1,
                 tw.n - 1]:
        jd, js = jp.read_page(tw.j, page)
        td, ts = tp.read_page(tw.t, page)
        np.testing.assert_array_equal(_u32(td), np.asarray(jd))
        assert ts.shape == () and int(ts) == int(js)
        new = rng.integers(0, 2**32, 8 * W, dtype=np.uint32)
        old = tw.t
        before = _u32(old.storage).copy()
        tw.j = jp.write_page(tw.j, page, jnp.asarray(new))
        tw.t = tp.write_page(tw.t, page, common.to_words(new))
        tw.same_storage()
        np.testing.assert_array_equal(_u32(old.storage), before)
        np.testing.assert_array_equal(_u32(tp.read_page(tw.t, page)[0]), new)
    with pytest.raises(ValueError, match="words"):
        tp.write_page(tw.t, 0, np.zeros(8 * W - 1, np.uint32))


def test_migrate_pages_between_pools_equals_the_reference():
    src = TwinPool(Layout.INTERWRAP, 8, 0, shadowed=False, seed=8)
    src.flip([(9, 1, 2, 3)])
    dst = TwinPool(Layout.PARITY, 16, 0, shadowed=False, seed=9)
    s_ids, d_ids = [9, 0, src.n - 1, 12], [20, 1, dst.n - 1, 3]
    dst.j = jp.migrate_pages(src.j, s_ids, dst.j, d_ids)
    dst.t = tp.migrate_pages(src.t, s_ids, dst.t, d_ids)
    dst.same_storage()
    src.same_storage()


def test_batch_aliases_refuse_mixed_pools_as_the_reference():
    tw = TwinPool(Layout.INTERWRAP, 16, 0, shadowed=False)
    for fn in ("read_pages_batch", "read_pages_batch_status"):
        with pytest.raises(ValueError, match="single-mode"):
            getattr(tp, fn)(tw.t, [0])
        with pytest.raises(ValueError, match="single-mode"):
            getattr(jp, fn)(tw.j, [0])
    whole = TwinPool(Layout.INTERWRAP, ROWS, 0, shadowed=False)
    ids = np.asarray([3, ROWS + 1, 0])
    np.testing.assert_array_equal(
        _u32(tcore.read_pages_batch(whole.t, ids)),
        np.asarray(jcore.read_pages_batch(whole.j, jnp.asarray(ids))))
    data = np.arange(3 * 8 * W, dtype=np.uint32).reshape(3, -1)
    whole.j = jcore.write_pages_batch(whole.j, jnp.asarray(ids),
                                      jnp.asarray(data))
    whole.t = tcore.write_pages_batch(whole.t, ids, common.to_words(data))
    whole.same_storage()


# ---------------------------------------------------------------------------
# The VM's adopted pools and report, the migration throughput
# ---------------------------------------------------------------------------


def test_adopt_pool_and_capacity_report_equal_the_reference():
    jvm, tvm = JVM(row_words=W), VirtualMemory(row_words=W, device="cpu")
    jvm.add_pool("a", ROWS, JLayout.INTERWRAP, boundary=16)
    tvm.add_pool("a", ROWS, Layout.INTERWRAP, boundary=16)
    jvm.adopt_pool("b", jp.make_pool(ROWS, JLayout.PARITY, boundary=8,
                                     row_words=W, daec_rows=8))
    tvm.adopt_pool("b", tp.make_pool(ROWS, Layout.PARITY, boundary=8,
                                     row_words=W, daec_rows=8, device="cpu"))
    for vm, prot in ((jvm, JProt), (tvm, Protection)):
        vm.create_tenant("t")
        vm.alloc("t", 20, reliability=prot.SECDED)
        vm.alloc("t", 9, reliability=prot.PARITY, pool="b")
        vm.alloc("t", 200, reliability=prot.NONE)
    assert tvm.capacity_report() == jvm.capacity_report()
    assert tvm.capacity_report()["host_swap_pages"] > 0
    with pytest.raises(ValueError, match="row_words"):
        tvm.adopt_pool("c", tp.make_pool(8, row_words=2 * W, device="cpu"))


def _reporting(pool, device: torch.device):
    """``pool`` with its ``device`` reading ``device``: a stand-in for a
    pool made on the card."""
    cls = type("Reporting", (type(pool),),
               {"device": property(lambda self: device)})
    return cls(**{f.name: getattr(pool, f.name)
                  for f in dataclasses.fields(pool)})


@pytest.mark.parametrize("shards", [1, 4])
@pytest.mark.parametrize("index,adopted", [(0, True), (1, False)])
def test_adopt_pool_takes_a_pool_made_on_the_default_card(
        monkeypatch, shards, index, adopted):
    """A VM made on ``cuda`` (no index) adopts a pool whose tensors say
    ``cuda:0`` when 0 is the current card, and refuses one on ``cuda:1``."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    assert common.resolve_device("cuda") == torch.device("cuda", 0)
    assert common.resolve_device(None) == torch.device("cuda", 0)
    assert common.resolve_device("cuda:1") == torch.device("cuda", 1)
    vm = VirtualMemory(row_words=W, device="cuda")
    pool = (tp.make_pool(ROWS, Layout.INTERWRAP, boundary=16, row_words=W,
                         device="cpu") if shards == 1 else
            make_sharded_pool(2 * ROWS, Layout.INTERWRAP, 32, num_shards=shards,
                              row_words=W, device="cpu"))
    card = _reporting(pool, torch.device("cuda", index))
    if adopted:
        vm.adopt_pool("a", card)
        assert vm.capacity_report()["a"]["pages"] == pool.num_pages
    else:
        with pytest.raises(ValueError, match="lives on cuda:1"):
            vm.adopt_pool("a", card)


@pytest.mark.parametrize("moved,nbytes,seconds", [(0, 0, 0.0), (12, 98304,
                                                                0.25),
                                                  (3, 3 << 20, 1.5)])
def test_migration_throughput_equals_the_reference(moved, nbytes, seconds):
    kw = dict(pages_moved=moved, bytes_moved=nbytes, seconds=seconds)
    t, j = MigrationStats(**kw), JStats(**kw)
    assert t.throughput_pages_s == j.throughput_pages_s
    assert t.throughput_mb_s == j.throughput_mb_s
