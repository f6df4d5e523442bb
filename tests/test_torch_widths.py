"""Pools of every row width the reference takes, and empty id vectors.

The reference's ``make_pool`` takes any ``row_words``; so does the port,
on the CPU and (through the pool kernels' word-granular entries) on the
card. Held here on the CPU at W in {4, 7, 12, 60}, none a multiple of 8,
with the same numpy inputs through both packages:

  * pools of the four layouts that take such widths at boundaries 0, R/2
    and R, with and without a DAEC tier: storage, pages, statuses and
    repartition reports bit for bit (the VM and the sharded pools, with
    their scrubs, are in ``test_torch_widths_banks.py``);
  * each plain kernel version against the reference's ``ref.py``;
  * PARITY, whose parity bytes pack four to a word, refusing exactly the
    widths and calls the reference refuses, with its exception types.

Then empty id vectors: every sharded-pool read and migration returns the
reference's ``(0, page_words)`` results at S = 1 and S = 4, and every
kernel wrapper returns its empty results on any device before its device
checks, launching nothing. Last, with ``common.library`` stubbed, each
pool kernel's wrapper reaches its vector C entry at ``W % 8 == 0`` and
its ``_words`` entry otherwise, counted under one name.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import shard as jshard
from repro.core import pool as jpool
from repro.core import secded as jsec
from repro.core.layouts import Layout as JLayout
from repro.kernels.daec import ref as jdaec_ref
from repro.kernels.hash import ref as jhash_ref
from repro.kernels.interwrap import ref as jiw_ref
from repro.kernels.migrate import ref as jmigrate_ref
from repro.kernels.mixed import ref as jmixed_ref
from repro.kernels.scrub import ref as jscrub_ref
from repro.kernels.secded import ref as jsecded_ref
from repro_torch.core import pool as tpool
from repro_torch.core.layouts import Layout, extra_base_row, extra_page_count
from repro_torch.kernels import common
from repro_torch.kernels.daec import ops as daec_ops
from repro_torch.kernels.hash import ops as hash_ops
from repro_torch.kernels.interwrap import ops as interwrap_ops
from repro_torch.kernels.migrate import ops as migrate_ops
from repro_torch.kernels.mixed import ops as mixed_ops
from repro_torch.kernels.parity8 import ops as parity8_ops
from repro_torch.kernels.scrub import ops as scrub_ops
from repro_torch.kernels.secded import ops as secded_ops
from repro_torch.objcache import hash_index as hix
from repro_torch.shard import make_sharded_pool
from repro_torch.shard import pool as tshard

WIDTHS = [4, 7, 12, 60]
LAYOUTS = [Layout.INTERWRAP, Layout.PACKED, Layout.RANK_SUBSET,
           Layout.BASELINE_ECC]
R = 32
DAEC = 8


def _u32(t: torch.Tensor) -> np.ndarray:
    return common.to_u32(t)


def _jl(layout: Layout) -> JLayout:
    return JLayout(layout.value)


def _pages(rng, n: int, W: int) -> np.ndarray:
    return rng.integers(0, 2**32, (n, 8 * W), dtype=np.uint32)


def _outcome(fn):
    """``fn()``'s result, or the type of the exception it raised."""
    try:
        return fn()
    except Exception as e:           # noqa: BLE001 - the type is compared
        return type(e)


def _flip_cells(rng, lo: int, hi: int, W: int, n: int) -> list:
    """``n`` seeded (row, lane, word, bits) flips in rows [lo, hi): single
    data bits, a single code bit and one same-beat double."""
    cells = []
    for k in range(n):
        row = int(rng.integers(lo, hi))
        if k == n - 1:                                   # status 3
            word = 2 * int(rng.integers(0, 4 * W))
            cells.append((row, word // W, word % W, (1 << 2) | (1 << 9)))
        elif k == n - 2:                                 # status 2
            cells.append((row, 8, int(rng.integers(0, W)), 1 << 4))
        else:                                            # status 1
            cells.append((row, int(rng.integers(0, 8)),
                          int(rng.integers(0, W)),
                          1 << int(rng.integers(0, 32))))
    return cells


def _flip(sto: np.ndarray, cells) -> np.ndarray:
    sto = sto.copy()
    for row, lane, word, bits in cells:
        sto[row, lane, word] ^= np.uint32(bits)
    return sto


# ---------------------------------------------------------------------------
# Pools
# ---------------------------------------------------------------------------


class TwinPool:
    """A reference and a port pool, the same calls and numpy inputs."""

    def __init__(self, layout, boundary, W, daec_rows):
        self.W = W
        self.j = jpool.make_pool(R, _jl(layout), boundary, row_words=W,
                                 daec_rows=daec_rows)
        self.t = tpool.make_pool(R, layout, boundary, row_words=W,
                                 daec_rows=daec_rows, device="cpu")

    def check(self):
        np.testing.assert_array_equal(_u32(self.t.storage),
                                      np.asarray(self.j.storage))
        assert (self.t.boundary, self.t.daec_rows, self.t.num_pages) == \
            (self.j.boundary, self.j.daec_rows, self.j.num_pages)

    def write(self, ids, data):
        self.j = self.j.write(ids, jnp.asarray(data))
        self.t = self.t.write(ids, common.to_words(data))
        self.check()

    def read(self, ids):
        jd, js = self.j.read(ids, status=True)
        td, ts = self.t.read(ids, status=True)
        np.testing.assert_array_equal(_u32(td), np.asarray(jd))
        np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
        return np.asarray(js)

    def flip(self, cells):
        sto = _flip(np.asarray(self.j.storage), cells)
        self.j = jpool.PoolState(jnp.asarray(sto), self.j.boundary,
                                 self.j.layout, self.j.row_words,
                                 self.j.daec_rows)
        self.t.storage.copy_(common.to_words(sto))


@pytest.mark.parametrize("daec", [0, DAEC], ids=["no-tier", "daec-tier"])
@pytest.mark.parametrize("boundary", [0, R // 2, R])
@pytest.mark.parametrize("layout", LAYOUTS, ids=lambda l: l.value)
@pytest.mark.parametrize("W", WIDTHS)
def test_pool_equals_the_reference(W, layout, boundary, daec):
    """Write, flips, status and write-back reads, migration and a
    repartition, bit-exact against the reference at width W."""
    b = 0 if layout == Layout.BASELINE_ECC else boundary
    carve = daec > R - b          # no protected rows yet: both refuse it
    if carve:
        for make in (lambda: jpool.make_pool(R, _jl(layout), boundary,
                                             row_words=W, daec_rows=daec),
                     lambda: tpool.make_pool(R, layout, boundary,
                                             row_words=W, daec_rows=daec,
                                             device="cpu")):
            with pytest.raises(ValueError, match="daec_rows"):
                make()
    p = TwinPool(layout, boundary, W, 0 if carve else daec)
    rng = np.random.default_rng(1000 * W + boundary + daec)
    n = p.t.num_pages
    ids = rng.permutation(n)
    p.write(ids, _pages(rng, n, W))
    if carve:          # protect half the rows, then carve the tier there
        b = R // 2
        p.j, jinfo = p.j.move_boundary(b)
        p.t, tinfo = p.t.move_boundary(b)
        assert tinfo == jinfo
        p.j, p.t = p.j.set_daec_rows(daec), p.t.set_daec_rows(daec)
        p.check()
        ids = ids[ids < p.t.num_pages]
    if b < R:          # flips in the protected rows: every status shows
        p.flip(_flip_cells(rng, b, R, W, 6))
        st = p.read(ids)
        assert {1, 2} <= set(st.tolist())
        jd, js, p.j = p.j.read_writeback(ids)
        td, ts, p.t = p.t.read_writeback(ids)
        np.testing.assert_array_equal(_u32(td), np.asarray(jd))
        np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
        p.check()
    src, dst = ids[:3], ids[3:6]
    p.j = p.j.migrate(src, dst)
    p.t = p.t.migrate(src, dst)
    p.check()
    nb = 8                              # the CREAM region moves
    if layout != Layout.BASELINE_ECC and nb <= R - daec:
        assert p.t.evict_prediction(nb) == jpool.evicted_extra_pages(p.j, nb)
        p.j, jinfo = p.j.move_boundary(nb)
        p.t, tinfo = p.t.move_boundary(nb)
        assert tinfo == jinfo
        p.check()


@pytest.mark.parametrize("boundary", [0, R // 2, R])
@pytest.mark.parametrize("W", WIDTHS)
def test_parity_refuses_what_the_reference_refuses(W, boundary):
    """A PARITY pool packs a page's parity bytes four to a word: with a
    CREAM region, the reference's reads raise TypeError (ValueError where
    8W words hold no whole number of lines) and its writes ValueError
    unless W % 8 == 0; without one, it works at any W until a repartition
    gives it parity. The port raises the same type at the same call, and
    gives the same bits where the reference does."""
    rng = np.random.default_rng(W + boundary)
    n = tpool.make_pool(R, Layout.PARITY, boundary, row_words=W,
                        device="cpu").num_pages
    assert n == jpool.make_pool(R, JLayout.PARITY, boundary,
                                row_words=W).num_pages
    sec, cream = [R - 1], [0, n - 1]
    data = _pages(rng, 2, W)
    calls = {
        "read": lambda p: p.read(cream + sec, status=True),
        "read_secded": lambda p: p.read(sec, status=True),
        "write": lambda p: p.write(cream[:1] + sec, data),
        "write_secded": lambda p: p.write(sec, data[:1]),
        "scrub": lambda p: p.scrub(),
        "repartition": lambda p: p.move_boundary(8),
    }
    refused = []
    for name, call in calls.items():     # each on fresh pools
        want = _outcome(lambda: call(jpool.make_pool(
            R, JLayout.PARITY, boundary, row_words=W)))
        got = _outcome(lambda: call(tpool.make_pool(
            R, Layout.PARITY, boundary, row_words=W, device="cpu")))
        if isinstance(want, type):
            assert got is want, (name, got, want)
            refused.append(name)
            continue
        assert not isinstance(got, type), (name, got)
        words = lambda x: [np.asarray(v) for v in  # noqa: E731
                           (x if isinstance(x, tuple) else (x,))
                           if hasattr(v, "shape")]
        for g, w in zip(words(got), words(want), strict=True):
            np.testing.assert_array_equal(
                g.view(np.uint32) if g.dtype == np.int32 and
                w.dtype == np.uint32 else g, w, err_msg=name)
    if boundary:
        assert set(refused) == set(calls)
    else:                   # all SECDED until the repartition adds parity
        assert refused == ["repartition"]


# ---------------------------------------------------------------------------
# The plain kernel versions against the reference's ref.py
# ---------------------------------------------------------------------------


def _coded(rng, W: int, boundary: int) -> np.ndarray:
    """(R, 9, W) random words, rows [boundary, R) with SECDED codes and
    flips of every status planted."""
    sto = rng.integers(0, 2**32, (R, 9, W), dtype=np.uint32)
    data = sto[boundary:, :8].reshape(R - boundary, 8 * W)
    sto[boundary:, 8] = np.asarray(jsec.encode_block(jnp.asarray(data)))
    return _flip(sto, _flip_cells(rng, boundary, R, W, 8))


@pytest.mark.parametrize("W", WIDTHS)
def test_plain_kernels_equal_the_reference_refs(W):
    rng = np.random.default_rng(7 * W)
    half = R // 2
    sto = _coded(rng, W, half)
    js, ts = jnp.asarray(sto), common.to_words(sto)
    for layout in (Layout.INTERWRAP, Layout.PACKED):
        n = tpool.make_pool(R, layout, half, row_words=W,
                            device="cpu").num_pages
        ids = rng.permutation(n).astype(np.int32)
        want = np.asarray(jmixed_ref.read_correct(
            js, jnp.asarray(ids), _jl(layout), R, half))
        got, st = mixed_ops.read_correct(ts, torch.as_tensor(ids), layout, R,
                                         half, status=True)
        np.testing.assert_array_equal(_u32(got), want)
        assert set(st.tolist()) - {0}
        # routed over 4 banks: each bank's share is the reference's
        S = 4
        banks = rng.integers(0, 2**32, (S, R // S, 9, W), dtype=np.uint32)
        gids = rng.permutation(R + S * extra_page_count(
            layout, half // S, W)).astype(np.int32)
        tb = common.to_words(banks)
        total = np.zeros((gids.size, 8 * W), np.uint32)
        for s in range(S):
            share = np.asarray(jmixed_ref.read_correct_routed(
                jnp.asarray(banks[s]), jnp.asarray(gids), _jl(layout), R,
                half, S, s))
            got_s = mixed_ops.read_correct_routed_local(
                tb[s].contiguous(), torch.as_tensor(gids), layout, R, half,
                S, s)
            np.testing.assert_array_equal(_u32(got_s), share)
            total += share
        np.testing.assert_array_equal(_u32(mixed_ops.read_correct_routed(
            tb, torch.as_tensor(gids), layout, R, half, S)), total)
    # the InterWrap gather, scatter and migration gather / re-encode
    n = R + R // 8
    ids = rng.permutation(n).astype(np.int32)
    np.testing.assert_array_equal(
        _u32(interwrap_ops.gather(ts, torch.as_tensor(ids), R)),
        np.asarray(jiw_ref.gather(js, jnp.asarray(ids), R)))
    data = _pages(rng, n, W)
    np.testing.assert_array_equal(
        _u32(interwrap_ops.scatter(ts.clone(), torch.as_tensor(ids),
                                   common.to_words(data), R)),
        np.asarray(jiw_ref.scatter(js, jnp.asarray(ids), jnp.asarray(data),
                                   R)))
    for got, want in zip(
            migrate_ops.gather_encode(ts, torch.as_tensor(ids), R),
            jmigrate_ref.gather_encode(js, jnp.asarray(ids), R), strict=True):
        np.testing.assert_array_equal(_u32(got), np.asarray(want))
    # the scrub sweep, and the codecs on (N, 8W) pages
    got = scrub_ops.scrub_rows(ts[half:].contiguous())
    want = jscrub_ref.scrub_rows(js[half:])
    np.testing.assert_array_equal(_u32(got[0]), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    assert set(got[1].unique().tolist()) == {0, 1, 2, 3}
    pages = _pages(rng, 8, W)
    for ops, ref in ((secded_ops, jsecded_ref), (daec_ops, jdaec_ref)):
        codes = ops.encode(common.to_words(pages))
        np.testing.assert_array_equal(
            _u32(codes), np.asarray(ref.encode(jnp.asarray(pages))))
        bad = _flip(pages[:, None, :], [(3, 0, 5, 1 << 7)])[:, 0]
        got = ops.decode(common.to_words(bad), codes)
        want = ref.decode(jnp.asarray(bad), jnp.asarray(_u32(codes)))
        for g, w in zip(got, want, strict=True):
            np.testing.assert_array_equal(np.asarray(g).view(
                np.asarray(w).dtype), np.asarray(w))
    # the fused probe + gather of an index filled by the port's insert
    index = hix.make_index(64, 8, device="cpu")
    keys = torch.as_tensor(rng.choice(2**31, 40, replace=False),
                           dtype=torch.int32)
    index, _, ok = hix.insert(
        index, keys[:32], torch.as_tensor(rng.integers(0, R, 32),
                                          dtype=torch.int32),
        torch.zeros(32, dtype=torch.int32),
        torch.full((32,), 8 * W, dtype=torch.int32))
    assert bool(ok.any())
    q = keys[rng.permutation(40)].contiguous()
    np.testing.assert_array_equal(
        _u32(hash_ops.lookup_read(ts, index.key, index.page, q,
                                  Layout.PACKED, R, half, 8)),
        np.asarray(jhash_ref.lookup_read(
            js, jnp.asarray(_u32(index.key)), jnp.asarray(index.page.numpy()),
            jnp.asarray(_u32(q)), JLayout.PACKED, R, half, 8)))


# ---------------------------------------------------------------------------
# Empty id vectors
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("layout", [Layout.INTERWRAP, Layout.PARITY,
                                    Layout.PACKED], ids=lambda l: l.value)
@pytest.mark.parametrize("S", [1, 4])
def test_sharded_pool_takes_empty_id_vectors(S, layout):
    """read([]), read([], status=True), migrate([], []) and the module
    functions read_any / read_any_status / read_any_writeback give the
    reference's empty results (its ShardedPool at S = 1)."""
    W = 16
    j = jshard.make_sharded_pool(64, _jl(layout), 32, num_shards=1,
                                 row_words=W)
    t = make_sharded_pool(64, layout, 32, num_shards=S, row_words=W,
                          device="cpu")
    for daec in (0, 2 * S):
        pool = t.set_daec_rows(daec)
        jp = j.set_daec_rows(daec)

        def same(got, want):
            got = got if isinstance(got, tuple) else (got,)
            want = want if isinstance(want, tuple) else (want,)
            for g, w in zip(got, want):
                if not hasattr(w, "shape"):
                    continue
                assert tuple(g.shape) == tuple(w.shape)
                assert g.dtype == torch.int32

        same(pool.read([]), jp.read([]))
        same(pool.read([], status=True), jp.read([], status=True))
        same(pool.read(np.zeros(0, np.int64), status=True),
             jp.read([], status=True))
        same(tshard.read_any(pool, []), jshard.read_any(jp, []))
        same(tshard.read_any_status(pool, []),
             jshard.read_any_status(jp, []))
        same(tshard.read_any_writeback(pool, [])[:2],
             jshard.read_any_writeback(jp, [])[:2])
        before = pool.storage.clone()
        moved = pool.migrate([], [])
        assert torch.equal(moved.storage, before)
        assert torch.equal(pool.migrate([], [], donate=False).storage, before)


def _meta(*shape, dtype=torch.int32) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


W0 = 7
#: every kernel wrapper of kernels/*/ops.py at n = 0: (call on a device,
#: the shapes it returns)
EMPTY = {
    "mixed_read_correct": (
        lambda d: mixed_ops.read_correct(d(R, 9, W0), d(0), Layout.PACKED, R,
                                         16, status=True),
        [(0, 8 * W0), (0,)]),
    "mixed_read_correct_routed": (
        lambda d: mixed_ops.read_correct_routed(
            d(4, R // 4, 9, W0), d(0), Layout.INTERWRAP, R, 16, 4,
            status=True), [(0, 8 * W0), (0,)]),
    "mixed_read_correct_routed_local": (
        lambda d: mixed_ops.read_correct_routed_local(
            d(R // 4, 9, W0), d(0), Layout.INTERWRAP, R, 16, 4, 1,
            status=True), [(0, 8 * W0), (0,)]),
    "migrate_gather_encode": (
        lambda d: migrate_ops.gather_encode(d(R, 9, W0), d(0), R),
        [(0, 8 * W0), (0, W0)]),
    "scrub_rows": (lambda d: scrub_ops.scrub_rows(d(0, 9, W0)),
                   [(0, 9, W0), (0, 4 * W0)]),
    "hash_lookup_read": (
        lambda d: hash_ops.lookup_read(d(R, 9, W0), d(64), d(64), d(0),
                                       Layout.PACKED, R, 16, 8),
        [(0, 8 * W0)]),
    "interwrap_gather": (
        lambda d: interwrap_ops.gather(d(R, 9, W0), d(0), R), [(0, 8 * W0)]),
    "interwrap_scatter": (
        lambda d: interwrap_ops.scatter(d(R, 9, W0), d(0), d(0, 8 * W0), R),
        [(R, 9, W0)]),
    "parity8_encode": (lambda d: parity8_ops.encode(d(0, 64)), [(0, 1)]),
    "parity8_check": (lambda d: parity8_ops.check(d(0, 64), d(0, 1)),
                      [(0, 4)]),
    "parity8_write": (
        lambda d: parity8_ops.write(d(R, 9, 8), d(0), d(0, 64), 16),
        [(R, 9, 8)]),
    "secded_encode": (lambda d: secded_ops.encode(d(0, 8 * W0)), [(0, W0)]),
    "secded_decode": (
        lambda d: secded_ops.decode(d(0, 8 * W0), d(0, W0)),
        [(0, 8 * W0), (0, W0), (0, 4 * W0)]),
    "daec_encode": (lambda d: daec_ops.encode(d(0, 8 * W0)), [(0, W0)]),
    "daec_decode": (
        lambda d: daec_ops.decode(d(0, 8 * W0), d(0, W0)),
        [(0, 8 * W0), (0, W0), (0, 4 * W0)]),
}


def _cpu(*shape) -> torch.Tensor:
    return torch.zeros(shape, dtype=torch.int32)


@pytest.mark.parametrize("name", list(EMPTY))
def test_every_wrapper_returns_empty_results_at_n_0(name):
    """n = 0 is decided once, before the dispatch: the CPU and any other
    device get the same empty int32 results, with no device check (meta
    tensors pass none) and no launch."""
    call, shapes = EMPTY[name]
    common.LAUNCHES.clear()
    for dev in (_cpu, _meta):
        got = call(dev)
        got = got if isinstance(got, tuple) else (got,)
        assert [tuple(g.shape) for g in got] == shapes
        assert all(g.dtype == torch.int32 for g in got)
        assert {g.device.type for g in got} == \
            {"cpu" if dev is _cpu else "meta"}
    assert not common.LAUNCHES
    # the reference's plain codecs give the same shapes
    if name in ("secded_encode", "secded_decode", "daec_encode",
                "daec_decode"):
        ref = {"secded": jsecded_ref, "daec": jdaec_ref}[name.split("_")[0]]
        z = jnp.zeros((0, 8 * W0), jnp.uint32)
        want = ref.encode(z) if name.endswith("encode") else \
            ref.decode(z, jnp.zeros((0, W0), jnp.uint32))
        want = want if isinstance(want, tuple) else (want,)
        assert [tuple(w.shape) for w in want] == shapes


# ---------------------------------------------------------------------------
# The CUDA entries a wrapper reaches, with the library stubbed
# ---------------------------------------------------------------------------


class _Library:
    """Stands in for the built library: records each C call, returns 0."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        return lambda *args: self.calls.append((name, args)) or 0


@pytest.fixture
def stub_library(monkeypatch):
    lib = _Library()
    # the device check only: meta tensors keep their offsets, so the rule
    # on dtype, layout and alignment runs as on the card
    monkeypatch.setattr(common, "check_cuda_words",
                        lambda name, *t, W=None: common.check_words(
                            name, *t, W=W))
    monkeypatch.setattr(common, "library", lambda: lib)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda: type("S", (), {"cuda_stream": 7})())
    monkeypatch.setattr(common, "LAUNCHES", common.collections.Counter())
    return lib


#: each pool kernel's wrapper at width W on meta tensors (5 pages)
POOL_CALLS = {
    "mixed_read_correct": lambda W: mixed_ops.read_correct(
        _meta(R, 9, W), _meta(5), Layout.PACKED, R, 16, status=True),
    "mixed_read_correct_routed": lambda W: mixed_ops.read_correct_routed(
        _meta(4, R // 4, 9, W), _meta(5), Layout.INTERWRAP, R, 16, 4),
    "mixed_read_correct_routed_local":
        lambda W: mixed_ops.read_correct_routed_local(
            _meta(R // 4, 9, W), _meta(5), Layout.INTERWRAP, R, 16, 4, 2),
    "migrate_gather_encode": lambda W: migrate_ops.gather_encode(
        _meta(R, 9, W), _meta(5), R),
    "hash_lookup_read": lambda W: hash_ops.lookup_read(
        _meta(R, 9, W), _meta(64), _meta(64), _meta(5), Layout.PACKED, R, 16,
        8),
    "scrub_rows": lambda W: scrub_ops.scrub_rows(_meta(5, 9, W)),
    "interwrap_gather": lambda W: interwrap_ops.gather(_meta(R, 9, W),
                                                       _meta(5), R),
    "interwrap_scatter": lambda W: interwrap_ops.scatter(
        _meta(R, 9, W), _meta(5), _meta(5, 8 * W), R),
}


@pytest.mark.parametrize("W", [4, 7, 12, 16, 60, 64, 2048])
@pytest.mark.parametrize("name", list(POOL_CALLS))
def test_width_picks_the_c_entry_and_counts_one_launch(name, W,
                                                       stub_library):
    """W % 8 == 0 reaches the vector entry, any other W its ``_words``
    entry with the same arguments; the real ``common.launch`` counts one
    launch under the kernel's name either way. The parity8 wrappers keep
    the reference's PARITY rule."""
    assert set(POOL_CALLS) == set(common.WORD_ENTRIES)
    POOL_CALLS[name](W)
    [(entry, args)] = stub_library.calls
    assert entry == (name if W % 8 == 0 else name + "_words")
    assert common.ENTRIES[entry] == common.ENTRIES[name]
    assert len(args) == len(common.ENTRIES[entry])
    assert args[-1] == 7                                 # the stream
    assert common.LAUNCHES == {name: 1}
    if name == "mixed_read_correct":   # n, W, interwrap, rows, b, ebase
        assert args[4:-1] == (5, W, 0, R, 16,
                              extra_base_row(Layout.PACKED, 16, W))
    if name == "scrub_rows":
        assert args[3:-1] == (5 * W, W)


def _row_view(*shape) -> torch.Tensor:
    """A meta view of ``shape`` that starts one pool row (9W words) into
    its buffer."""
    row = 9 * shape[-1]
    return _meta(row + int(np.prod(shape)))[row:].view(shape)


#: each pool kernel's wrapper on storage one row into its buffer (5 pages)
VIEW_CALLS = {
    "mixed_read_correct": lambda W: mixed_ops.read_correct(
        _row_view(R, 9, W), _meta(5), Layout.PACKED, R, 16, status=True),
    "mixed_read_correct_routed": lambda W: mixed_ops.read_correct_routed(
        _row_view(4, R // 4, 9, W), _meta(5), Layout.INTERWRAP, R, 16, 4),
    "mixed_read_correct_routed_local":
        lambda W: mixed_ops.read_correct_routed_local(
            _row_view(4, R // 4, 9, W)[1], _meta(5), Layout.INTERWRAP, R,
            16, 4, 1),
    "migrate_gather_encode": lambda W: migrate_ops.gather_encode(
        _row_view(R, 9, W), _meta(5), R),
    "hash_lookup_read": lambda W: hash_ops.lookup_read(
        _row_view(R, 9, W), _meta(64), _meta(64), _meta(5), Layout.PACKED,
        R, 16, 8),
    "scrub_rows": lambda W: scrub_ops.scrub_rows(_row_view(5, 9, W)),
    "interwrap_gather": lambda W: interwrap_ops.gather(
        _row_view(R, 9, W), _meta(5), R),
    "interwrap_scatter": lambda W: interwrap_ops.scatter(
        _row_view(R, 9, W), _meta(5), _meta(5, 8 * W), R),
}


@pytest.mark.parametrize("W", [7, 8, 12, 60])
@pytest.mark.parametrize("name", list(VIEW_CALLS))
def test_a_view_at_any_row_offset_reaches_its_entry(name, W,
                                                    stub_library):
    """A row is 36W bytes, so a view of a pool's rows from any row starts
    on a 16-byte boundary when W % 4 == 0, and at W = 7 one row in does
    not. The word entry (W % 8 != 0) takes it, since it reads its
    operands word by word; the vector entry always gets an aligned one."""
    assert set(VIEW_CALLS) == set(common.WORD_ENTRIES)
    VIEW_CALLS[name](W)
    assert [c[0] for c in stub_library.calls] == \
        [name if W % 8 == 0 else name + "_words"]


def test_the_vector_rule_still_refuses_a_misaligned_operand(stub_library):
    """16-byte alignment is waived for the word entries' inputs only: a
    vector entry, a kernel that gives no W, and the routed local read's
    ``out`` (both its entries store vectors there) refuse a misaligned
    operand."""
    odd = _meta(1 + 32 * 9 * 8)[1:].view(32, 9, 8)
    assert odd.data_ptr() % 16
    for W in (None, 8, 16):
        with pytest.raises(ValueError, match="16-byte aligned"):
            common.check_words("scrub_rows", odd, W=W)
    common.check_words("scrub_rows", odd, W=7)
    with pytest.raises(ValueError, match="16-byte aligned"):
        mixed_ops.read_correct_routed_local(
            _meta(R // 4, 9, 7), _meta(5), Layout.INTERWRAP, R, 16, 4, 1,
            out=_meta(1 + 5 * 56)[1:])
    assert not stub_library.calls


def test_row_offset_views_pass_the_word_rule():
    """The operand rule, with no stub, on CPU views at W = 7. A pool's own
    views start at multiples of 8 rows (rows, boundaries and a sharded
    pool's banks are multiples of 8 rows), so they are 16-byte aligned
    at any W. The rows ``scrub_secded`` sweeps from a start the caller
    picks need not be: the rule that asked 16-byte alignment of every
    operand refused them; the word entry's rule takes them."""
    W = 7
    sharded = make_sharded_pool(128, Layout.PACKED, 32, num_shards=4,
                                row_words=W, device="cpu")
    for s in range(4):
        bank = sharded.bank(s).storage
        assert bank.data_ptr() % 16 == 0
        assert bank[sharded.boundary_local:].data_ptr() % 16 == 0
    storage = tpool.make_pool(64, Layout.PACKED, 32, row_words=W,
                              device="cpu").storage
    for start in (1, 2, 3, 5, 33):
        view = storage[start:]
        assert view.data_ptr() % 16
        with pytest.raises(ValueError, match="16-byte aligned"):
            common.check_words("scrub_rows", view)
        common.check_words("scrub_rows", view, W=W)


def test_parity8_keeps_the_reference_width_rule(stub_library):
    """A PARITY write and the parity codec refuse what the reference's
    refuse, on any device, before a launch."""
    with pytest.raises(ValueError, match="W % 8"):
        parity8_ops.write(_meta(R, 9, 12), _meta(5), _meta(5, 96), 16)
    with pytest.raises(ValueError, match="D % 64"):
        parity8_ops.encode(_meta(4, 96))
    with pytest.raises(TypeError, match="incompatible shapes"):
        parity8_ops.check(_meta(4, 96), _meta(4, 1))
    with pytest.raises(ValueError, match="D % 16"):
        parity8_ops.check(_meta(4, 56), _meta(4, 0))
    with pytest.raises(TypeError, match="incompatible shapes"):
        parity8_ops.check(torch.zeros((2, 96), dtype=torch.int32),
                          torch.zeros((2, 1), dtype=torch.int32))
    assert not stub_library.calls
    parity8_ops.write(_meta(R, 9, 8), _meta(5), _meta(5, 64), 16)
    assert [c[0] for c in stub_library.calls] == ["parity8_write"]


@pytest.mark.parametrize("name", list(POOL_CALLS))
def test_no_launch_for_an_empty_batch(name, stub_library):
    """At n = 0 no wrapper reaches the library."""
    call, _ = EMPTY[name]
    call(_meta)
    assert not stub_library.calls and not common.LAUNCHES
