"""CREAM-Shard on the port equals the reference, bank by bank.

The reference's own sharded pool needs a ``banks`` mesh whose programs
fail under the installed JAX for more than one shard, so the oracle for
``S > 1`` is what its router promises (``repro/shard/router.py``): ``S``
independent reference :class:`~repro.core.pool.PoolState` banks of
``R_local`` rows, driven through ``router.route_np``. At ``S = 1`` the
port is also held against the reference ``ShardedPool`` itself. Every
comparison of words, statuses, censuses and evicted ids is exact.

  * Router: ``route`` / ``unroute`` / ``plan_streams`` / ``owned_mask`` /
    ``check_geometry`` equal the reference's.
  * Routed read: bank s's rows of the port's assembled batch (the other
    rows zeroed) equal the reference's plain version and its Pallas kernel
    (interpret mode) on bank s, for every layout and S in {1, 2, 4, 8},
    with planted SECDED flips; the reference's per-bank outputs sum to the
    assembled batch.
  * Pool verbs: writes with duplicate ids, routed and status reads,
    migration across and within banks, repartition both ways,
    ``set_daec_rows``, injection and scrub, against the banks.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import shard as jshard
from repro.core import pool as jpool
from repro.core import scrubber as jscrub
from repro.core import secded as jsec
from repro.core.injection import FaultModel as JFault
from repro.core.layouts import Layout as JLayout
from repro.kernels.mixed import kernel as jmixed
from repro.kernels.mixed import ref as jmixed_ref
from repro.shard import router as jrouter
from repro_torch.core import pool as tpool
from repro_torch.core.injection import FaultModel
from repro_torch.core.layouts import Layout
from repro_torch.kernels import common
from repro_torch.kernels.mixed import ops as mixed_ops
from repro_torch.kernels.mixed import ref as mixed_ref
from repro_torch.shard import make_sharded_pool, router

LAYOUTS = list(Layout)
SHARDS = [1, 2, 4, 8]


def _u32(t: torch.Tensor) -> np.ndarray:
    return common.to_u32(t)


# ---------------------------------------------------------------------------
# Router
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("S", SHARDS)
def test_router_equals_the_reference(S):
    rows = 16 * S
    rng = np.random.default_rng(S)
    ids = rng.integers(0, rows + 2 * S, 37)
    js, jl = jrouter.route(jnp.asarray(ids), rows, S)
    ts, tl = router.route(torch.as_tensor(ids), rows, S)
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    for got, want in zip(router.route_np(ids, rows, S),
                         jrouter.route_np(ids, rows, S)):
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        router.unroute(ts, tl, rows, S).numpy(),
        np.asarray(jrouter.unroute(js, jl, rows, S)))
    np.testing.assert_array_equal(router.unroute(ts, tl, rows, S).numpy(),
                                  ids)
    for got, want in zip(router.plan_streams(ids, rows, S),
                         jrouter.plan_streams(ids, rows, S)):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(router.owned_mask(ts, S).numpy(),
                                  np.asarray(jrouter.owned_mask(js, S)))


@pytest.mark.parametrize("rows,boundary,S", [(64, 32, 4), (60, 0, 2),
                                             (64, 12, 2), (64, 80, 2),
                                             (16, 0, 0)])
def test_check_geometry_refuses_what_the_reference_refuses(rows, boundary, S):
    def outcome(fn):
        try:
            fn(rows, boundary, S)
            return None
        except ValueError as e:
            return str(e)
    assert outcome(router.check_geometry) == \
        outcome(jrouter.check_geometry)


# ---------------------------------------------------------------------------
# The routed read, bank by bank
# ---------------------------------------------------------------------------

ROWS, W = 128, 16


def _banks(layout, S, seed):
    """(S, R_local, 9, W) random words; each bank's SECDED rows carry
    valid codes with a single data-bit, a single code-bit and a same-beat
    double-bit flip planted in its first three."""
    rng = np.random.default_rng(seed)
    b_local = 0 if layout == Layout.BASELINE_ECC else ROWS // (2 * S)
    r_local = ROWS // S
    sto = rng.integers(0, 2**32, (S, r_local, 9, W), dtype=np.uint32)
    for s in range(S):
        data = sto[s, b_local:, :8].reshape(r_local - b_local, 8 * W)
        codes = np.array(jsec.encode_block(jnp.asarray(data)))
        data[0, 3] ^= np.uint32(1 << 5)
        codes[1, 1] ^= np.uint32(1 << 9)
        data[2, 6] ^= np.uint32((1 << 2) | (1 << 9))
        sto[s, b_local:, :8] = data.reshape(-1, 8, W)
        sto[s, b_local:, 8] = codes
    return sto, S * b_local


@pytest.mark.parametrize("S", SHARDS)
@pytest.mark.parametrize("layout", LAYOUTS, ids=lambda l: l.value)
def test_routed_read_equals_the_reference_per_bank(layout, S):
    sto, boundary = _banks(layout, S, seed=S + 7 * LAYOUTS.index(layout))
    b_local = boundary // S
    jl = JLayout(layout.value)
    n_pages = ROWS + S * jpool.make_pool(ROWS // S, jl, boundary=b_local,
                                         row_words=W).num_extra_pages
    rng = np.random.default_rng(S)
    # every bank's flipped SECDED rows, the last page, and a random sample
    flipped = [(b_local + i) * S + s for i in range(3) for s in range(S)
               if b_local + i < ROWS // S]
    ids = np.unique(np.concatenate([flipped, [n_pages - 1, 0],
                                    rng.permutation(n_pages)[:8]]))
    ids = rng.permutation(ids).astype(np.int32)
    words = common.to_words(sto)
    assembled = _u32(mixed_ops.read_correct_routed(
        words, torch.as_tensor(ids), layout, ROWS, boundary, S))
    shard, local = router.route_np(ids, ROWS, S)
    acc = np.zeros_like(assembled)
    for s in range(S):
        args = (jnp.asarray(sto[s]), jnp.asarray(ids), jl, ROWS, boundary, S,
                jnp.int32(s))
        want = np.asarray(jmixed_ref.read_correct_routed(*args))
        np.testing.assert_array_equal(
            np.asarray(jmixed.read_correct_routed(*args)), want)
        # bank s's share of the assembled batch is the reference's bank s
        own = shard == s
        np.testing.assert_array_equal(np.where(own[:, None], assembled, 0),
                                      want, err_msg=f"bank {s}")
        acc += want
        # ... and the local read of its owned ids
        np.testing.assert_array_equal(
            assembled[own], _u32(mixed_ref.read_correct(
                words[s], torch.as_tensor(local[own]), layout, ROWS // S,
                b_local)))
    np.testing.assert_array_equal(assembled, acc)


def test_routed_read_refuses_what_it_does_not_take():
    sto = torch.zeros((4, 8, 9, 16), dtype=torch.int32)
    ids = torch.arange(4)
    with pytest.raises(ValueError, match="storage"):
        mixed_ops.read_correct_routed(sto[0], ids, Layout.INTERWRAP, 32, 32, 4)
    with pytest.raises(ValueError, match="storage"):
        mixed_ops.read_correct_routed(sto, ids, Layout.INTERWRAP, 32, 32, 2)
    with pytest.raises(ValueError, match="banks"):
        mixed_ops.read_correct_routed(sto, ids, Layout.INTERWRAP, 32, 30, 4)
    with pytest.raises(ValueError, match="contiguous"):
        mixed_ops.read_correct_routed(sto, torch.arange(8)[::2],
                                      Layout.INTERWRAP, 32, 32, 4)


# ---------------------------------------------------------------------------
# The pool's verbs against S reference banks
# ---------------------------------------------------------------------------

VERB_W = 32


class Banks:
    """A port ShardedPool and S reference PoolState banks, same traffic."""

    def __init__(self, layout, S, rows, boundary, daec_rows=0):
        self.S, self.rows = S, rows
        self.t = make_sharded_pool(rows, layout, boundary, num_shards=S,
                                   row_words=VERB_W, daec_rows=daec_rows,
                                   device="cpu")
        self.j = [jpool.make_pool(rows // S, JLayout(layout.value),
                                  boundary=self.t.boundary_local,
                                  row_words=VERB_W,
                                  daec_rows=daec_rows // S)
                  for _ in range(S)]

    def route(self, ids):
        return router.route_np(ids, self.rows, self.S)

    def write(self, ids, data, valid=None):
        self.t = self.t.write(ids, common.to_words(data), valid=valid)
        # the oracle lands the last valid row of each page
        land = tpool._landing_rows(np.asarray(ids, np.int64), valid)
        shard, local = self.route(ids)
        for s in range(self.S):
            own = land & (shard == s)
            if own.any():
                self.j[s] = self.j[s].write(local[own],
                                            jnp.asarray(data[own]))

    def read(self, ids):
        shard, local = self.route(ids)
        data = np.zeros((len(ids), 8 * VERB_W), np.uint32)
        status = np.zeros(len(ids), np.int32)
        for s in range(self.S):
            own = shard == s
            if own.any():
                d, st = self.j[s].read(local[own], status=True)
                data[own], status[own] = np.asarray(d), np.asarray(st)
        got = self.t.read(ids)
        gd, gs = self.t.read(ids, status=True)
        np.testing.assert_array_equal(_u32(got), data)
        np.testing.assert_array_equal(_u32(gd), data)
        np.testing.assert_array_equal(gs.numpy(), status)
        return data, status

    def check(self):
        assert self.t.boundary_local == self.j[0].boundary
        assert self.t.daec_rows_local == self.j[0].daec_rows
        for s in range(self.S):
            np.testing.assert_array_equal(_u32(self.t.storage[s]),
                                          np.asarray(self.j[s].storage),
                                          err_msg=f"bank {s}")

    def migrate(self, src, dst):
        # the ring: every bank reads its own sources, then every page is
        # delivered to its destination's bank
        data, _ = self.read(src)
        self.t = self.t.migrate(src, dst)
        shard, local = self.route(dst)
        for s in range(self.S):
            own = shard == s
            if own.any():
                self.j[s] = self.j[s].write(local[own],
                                            jnp.asarray(data[own]))

    def repartition(self, nb):
        evicted = []
        for s in range(self.S):
            local = jpool.evicted_extra_pages(self.j[s], nb // self.S)
            evicted += router.unroute(np.full(len(local), s), local,
                                      self.rows, self.S).tolist()
        evicted.sort()
        assert self.t.evict_prediction(nb) == evicted
        old = self.t
        self.t, info = self.t.move_boundary(nb)
        assert info["evicted_extra_pages"] == evicted
        assert info["pages_reencoded"] == abs(nb - old.boundary)
        self.j = [jpool.repartition(b, nb // self.S)[0] for b in self.j]

    def set_daec_rows(self, n):
        self.t = self.t.set_daec_rows(n)
        self.j = [jpool.set_daec_rows(b, n // self.S) for b in self.j]

    def scrub(self):
        self.t, stats = self.t.scrub()
        merged, corrupt = {}, []
        for s in range(self.S):
            self.j[s], st = jscrub.scrub(self.j[s])
            for k, v in vars(st).items():
                if k != "corrupt_rows":
                    merged[k] = merged.get(k, 0) + v
            corrupt.extend(r * self.S + s for r in st.corrupt_rows)
        want = dict(merged, corrupt_rows=tuple(sorted(corrupt)))
        assert vars(stats) == want
        return stats


def _flip(banks: Banks, cells):
    """XOR (bank, row, lane, word, bit) cells into both sides' storage."""
    sto = _u32(banks.t.storage).copy()
    for s, r, ln, w, b in cells:
        sto[s, r, ln, w] ^= np.uint32(1 << b)
    banks.t.storage.copy_(common.to_words(sto))
    banks.j = [jpool.PoolState(jnp.asarray(sto[s]), b.boundary, b.layout,
                               b.row_words, b.daec_rows)
               for s, b in enumerate(banks.j)]


@pytest.mark.parametrize("S", [2, 4])
@pytest.mark.parametrize("layout", [Layout.INTERWRAP, Layout.PARITY,
                                    Layout.PACKED], ids=lambda l: l.value)
def test_sharded_pool_verbs_equal_the_reference_banks(layout, S):
    rows, boundary = 64, 32
    b = Banks(layout, S, rows, boundary)
    rng = np.random.default_rng(S)
    n = b.t.num_pages
    assert n == rows + S * b.j[0].num_extra_pages
    # writes with duplicate ids and a valid mask: the last valid row lands
    ids = np.concatenate([rng.permutation(n), rng.integers(0, n, 9)])
    data = rng.integers(0, 2**32, (ids.size, 8 * VERB_W), dtype=np.uint32)
    valid = rng.random(ids.size) < 0.9
    b.write(ids, data, valid)
    b.check()
    all_ids = rng.permutation(n)
    b.read(all_ids)
    # flips in SECDED rows of two banks: corrected on read, not persisted
    sec_row = b.t.boundary_local
    _flip(b, [(0, sec_row, 2, 5, 7), (S - 1, sec_row + 1, 8, 3, 1),
              (1, sec_row + 2, 4, 0, 3), (1, sec_row + 2, 4, 0, 4)])
    _, status = b.read(all_ids)
    assert sorted(set(status.tolist())) == [0, 1, 2, 3]
    b.check()
    # a cross-bank migration (and one page within its bank)
    src = np.asarray([3, 5, n - 1, sec_row * S, 0], np.int64)
    bank = dict(zip(range(n), router.route_np(np.arange(n), rows, S)[0]))
    dst = []
    for i, p in enumerate(src):        # four across banks, the last within
        dst.append(next(q for q in rng.permutation(n)
                        if q not in src and q not in dst
                        and (bank[q] != bank[p]) == (i < 4)))
    dst = np.asarray(dst, np.int64)
    b.migrate(src, dst)
    b.check()
    b.read(all_ids)
    # repartition down to all-SECDED and back up
    b.repartition(0)
    b.check()
    b.read(np.arange(rows))
    b.repartition(boundary)
    b.check()
    b.read(np.arange(b.t.num_pages))
    # carve a DAEC tier, read through it, scrub
    b.set_daec_rows(2 * S)
    b.check()
    b.read(np.arange(b.t.num_pages))
    stats = b.scrub()
    assert stats.beats_checked > 0
    b.check()


def test_sharded_pool_with_a_daec_tier_reads_through_the_local_engine():
    b = Banks(Layout.INTERWRAP, 4, 64, 32, daec_rows=8)
    rng = np.random.default_rng(5)
    ids = np.arange(b.t.num_pages)
    b.write(ids, rng.integers(0, 2**32, (ids.size, 8 * VERB_W),
                              dtype=np.uint32))
    common.LAUNCHES.clear()
    seen = []
    real = mixed_ops.read_correct_routed
    try:
        mixed_ops.read_correct_routed = lambda *a, **k: seen.append(a)
        b.read(ids)
    finally:
        mixed_ops.read_correct_routed = real
    assert not seen                    # the fused read corrects SECDED only
    b.check()


def test_sharded_pool_scrub_maps_parity_rows_to_global_rows():
    b = Banks(Layout.PARITY, 4, 64, 64)
    rng = np.random.default_rng(9)
    ids = np.arange(b.t.num_pages)
    b.write(ids, rng.integers(0, 2**32, (ids.size, 8 * VERB_W),
                              dtype=np.uint32))
    _flip(b, [(1, 2, 0, 0, 0), (3, 5, 1, 2, 3)])
    stats = b.scrub()
    assert stats.corrupt_rows == (2 * 4 + 1, 5 * 4 + 3)
    b.check()


def test_streams_read_and_write_bank_aligned_ids():
    b = Banks(Layout.INTERWRAP, 4, 64, 32)
    rng = np.random.default_rng(2)
    ids = rng.permutation(b.t.num_pages)[:22]
    spages, svalid, inv = router.plan_streams(ids, 64, 4)
    data = rng.integers(0, 2**32, (4, spages.shape[1], 8 * VERB_W),
                        dtype=np.uint32)
    b.t.streams(spages, common.to_words(data), valid=svalid)
    flat = data.reshape(-1, 8 * VERB_W)[inv]
    b.write(ids, flat)
    b.check()
    got = _u32(b.t.streams(spages)).reshape(-1, 8 * VERB_W)[inv]
    np.testing.assert_array_equal(got, flat)
    with pytest.raises(ValueError, match="bank"):
        b.t.streams(spages[::-1].copy())


@pytest.mark.parametrize("layout", [Layout.INTERWRAP, Layout.PARITY],
                         ids=lambda l: l.value)
def test_one_bank_equals_the_reference_sharded_pool(layout):
    """At S = 1 the reference's own ShardedPool runs: hold the port to it."""
    rows, boundary = 32, 16
    j = jshard.make_sharded_pool(rows, JLayout(layout.value), boundary,
                                 num_shards=1, row_words=VERB_W)
    t = make_sharded_pool(rows, layout, boundary, num_shards=1,
                          row_words=VERB_W, device="cpu")
    rng = np.random.default_rng(1)
    ids = rng.permutation(t.num_pages)
    assert t.num_pages == j.num_pages
    data = rng.integers(0, 2**32, (ids.size, 8 * VERB_W), dtype=np.uint32)
    j, t = j.write(ids, jnp.asarray(data)), t.write(ids, common.to_words(data))

    def same():
        np.testing.assert_array_equal(_u32(t.storage), np.asarray(j.storage))
        jd, js = j.read(ids, status=True)
        td, ts = t.read(ids, status=True)
        np.testing.assert_array_equal(_u32(td), np.asarray(jd))
        np.testing.assert_array_equal(_u32(t.read(ids)), np.asarray(jd))
        np.testing.assert_array_equal(ts.numpy(), np.asarray(js))

    same()
    n = t.num_pages
    j = j.migrate([1, 2, n - 1], [5, n - 2, 3])
    t = t.migrate([1, 2, n - 1], [5, n - 2, 3])
    same()
    j, ji = j.move_boundary(8)
    t, ti = t.move_boundary(8)
    assert ti == ji
    ids = ids[ids < t.num_pages]
    same()
    j, t = j.set_daec_rows(8), t.set_daec_rows(8)
    same()
    j, js = j.scrub()
    t, ts = t.scrub()
    assert vars(ts) == vars(js)
    same()


# ---------------------------------------------------------------------------
# Injection into a sharded pool
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("S", [2, 4])
def test_step_pool_on_banks_equals_the_reference_on_global_rows(S):
    rows, r_local = 64, 64 // S
    t = make_sharded_pool(rows, Layout.INTERWRAP, 0, num_shards=S,
                          row_words=VERB_W, device="cpu")
    rng = np.random.default_rng(S)
    sto = rng.integers(0, 2**32, tuple(t.storage.shape), dtype=np.uint32)
    t.storage.copy_(common.to_words(sto))
    # the global-row image: global row r is bank r % S, local row r // S
    image = sto.transpose(1, 0, 2, 3).reshape(rows, 9, VERB_W)
    shape = (rows, 9, VERB_W)
    jm = JFault.make(11, soft_rate=4e4, n_hard=3, shape=shape)
    tm = FaultModel.make(11, soft_rate=4e4, n_hard=3, shape=shape)
    for _ in range(2):
        image, jn = jm.step(jnp.asarray(image))
        image = np.asarray(image)
        t, tn = tm.step_pool(t)
        assert tn == jn > 3
        got = _u32(t.storage).transpose(1, 0, 2, 3).reshape(rows, 9, VERB_W)
        np.testing.assert_array_equal(got, image)
    assert t.storage.shape == (S, r_local, 9, VERB_W)
    with pytest.raises(ValueError, match="step_pool"):
        tm.step(t.storage)


# ---------------------------------------------------------------------------
# Dispatch of the routed read: the plain version only for CPU tensors
# ---------------------------------------------------------------------------


def _meta(*shape) -> torch.Tensor:
    return torch.empty(shape, dtype=torch.int32, device="meta")


def test_routed_read_on_non_cpu_tensors_never_falls_back():
    common.LAUNCHES.clear()
    mixed_ops.read_correct_routed(torch.zeros((2, 8, 9, 16),
                                              dtype=torch.int32),
                                  torch.arange(4), Layout.INTERWRAP, 16, 16, 2)
    assert sum(common.LAUNCHES.values()) == 0
    with pytest.raises(ValueError, match="CUDA device"):
        mixed_ops.read_correct_routed(_meta(4, 8, 9, 16), _meta(5),
                                      Layout.PARITY, 32, 16, 4)


@pytest.mark.parametrize("status", [False, True])
@pytest.mark.parametrize("layout", [Layout.PARITY, Layout.INTERWRAP],
                         ids=lambda l: l.value)
def test_routed_read_marshals_the_declared_c_arguments(layout, status,
                                                       monkeypatch):
    seen = []
    monkeypatch.setattr(common, "check_cuda_words", lambda *a, **k: None)
    monkeypatch.setattr(common, "launch",
                        lambda entry, *args: seen.append((entry, args)))
    mixed_ops.read_correct_routed(_meta(4, 8, 9, 16), _meta(5), layout, 32,
                                  16, 4, status=status)
    [(entry, args)] = seen
    assert entry == "mixed_read_correct_routed"
    assert len(args) + 1 == len(common.ENTRIES[entry])
    assert all(isinstance(t, torch.Tensor) for t in args[:3])
    # the status words (a zeroed (n,) int32 vector), or None without status
    if status:
        assert args[3].shape == (5,) and args[3].dtype == torch.int32
    else:
        assert args[3] is None
    # n, W, interwrap, global rows, S, local boundary, local ebase
    from repro_torch.core.layouts import extra_base_row
    assert args[4:] == (5, 16, int(layout == Layout.INTERWRAP), 32, 4, 4,
                        extra_base_row(layout, 4, 16))


def test_upload_to_the_card_is_pinned_and_non_blocking(monkeypatch):
    """Ids go to the card without blocking the host (a pageable copy
    waits for the stream's queued launches, which would serialise the
    engine's side-stream migration with the model step)."""
    seen = []

    class Pinned:
        def to(self, device, non_blocking=False):
            seen.append((str(device), non_blocking))
            return "on the card"

    monkeypatch.setattr(torch.Tensor, "pin_memory", lambda self: Pinned())
    assert common.upload(np.arange(3), "cuda") == "on the card"
    assert seen == [("cuda", True)]
    host = common.upload(np.arange(3, dtype=np.int32), "cpu")
    assert host.dtype == torch.int32 and host.tolist() == [0, 1, 2]


def _cache_ids(module):
    """An ObjCache: keyed sets and gets, then a translation refresh that
    rebuilds the slot->page table on the device."""
    from repro_torch.objcache import ObjCache
    from repro_torch.vm import VirtualMemory
    vm = VirtualMemory(row_words=16, device="cpu")
    vm.add_pool("dimm", 32, Layout.INTERWRAP)
    cache = ObjCache(vm, "dimm", index_capacity=64, probe=8)
    keys = np.arange(1, 9)
    cache.set_many(keys, np.tile(keys[:, None], (1, 8 * 16)).astype(
        np.uint32))
    vals, _, found = cache.get_many(keys)
    assert found.all() and (vals[:, 0] == keys).all()
    cache.refresh_translation()


def _shadow_ids(module):
    """A shadowed pool: a mirrored write, then a classified read."""
    from repro_torch.faults.shadow import ShadowedPool
    sh = ShadowedPool(tpool.make_pool(16, Layout.INTERWRAP, boundary=8,
                                      row_words=16, device="cpu"))
    data = np.arange(2 * 8 * 16, dtype=np.uint32).reshape(2, 8 * 16)
    sh.write(np.array([1, 3]), data)
    got = sh.read(np.array([1, 3]))
    np.testing.assert_array_equal(common.to_u32(got), data)


def _injection_ids(module):
    """The injection tick's stuck-at cells, then a targeted flip."""
    from repro_torch.core.injection import FlipRecord, apply_flips
    storage = torch.zeros((16, 9, 16), dtype=torch.int32)
    out, n = FaultModel.make(5, n_hard=2, shape=(16, 9, 16)).step(storage)
    assert n == 2 and bool(out.any())
    out = apply_flips(out, [FlipRecord(3, 1, 2, 7)])
    assert int(out[3, 1, 2]) & (1 << 7)


#: module whose uploads go to the device -> (driver, {function: distinct
#: upload lines in it})
ID_UPLOADS = {
    "repro_torch.objcache.cache": (_cache_ids, {
        "_device_keys": 1, "_dev": 1, "_set_unique": 1,
        "refresh_translation": 1}),
    "repro_torch.faults.shadow": (_shadow_ids, {"_classify": 2, "write": 2}),
    "repro_torch.core.injection": (_injection_ids, {"_land": 2}),
}


@pytest.mark.parametrize("module", list(ID_UPLOADS))
def test_cache_shadow_and_injection_ids_go_through_upload(module,
                                                          monkeypatch):
    """The object cache's keys, ids, values and slot->page table, the
    shadow's classify and mirrored write, and the injection tick's word
    indices and masks reach the device through ``common.upload`` (pinned
    and non-blocking on the card), not a pageable ``.to(device)`` copy:
    every call site in each function is seen."""
    import importlib
    import sys
    mod = importlib.import_module(module)
    sites = set()

    def counting(a, device):
        caller = sys._getframe(1)
        sites.add((caller.f_code.co_name, caller.f_lineno))
        return common.upload(a, device)

    monkeypatch.setattr(mod, "upload", counting)
    drive, want = ID_UPLOADS[module]
    drive(module)
    got = {fn: sum(1 for f, _ in sites if f == fn) for fn in want}
    assert got == want, sites


def test_to_u32_is_a_host_copy_of_a_cpu_tensor_too():
    """A snapshot of a pool's storage must not follow later in-place
    writes (shard_sequence in chip_smoke.py compares such snapshots)."""
    t = torch.zeros(4, dtype=torch.int32)
    snap = common.to_u32(t)
    t += 1
    assert not snap.any()
