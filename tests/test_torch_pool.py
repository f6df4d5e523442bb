"""The port's pool geometry and data plane equal the reference bit for bit.

``page_coords`` and the capacity accounting over every layout x boundary,
then a scripted sequence of pool operations — writes, SECDED reads with
planted flips, masked writes, ``migrate``, ``repartition`` down and up —
run on a ``repro.core.pool`` pool and a ``repro_torch.core.pool`` pool
(on the CPU) from the same numpy inputs, with the storage compared after
every step.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import layouts as jl
from repro.core import pool as jp
from repro.core.protection import ladder as jladder
from repro_torch.core import layouts as tl
from repro_torch.core import pool as tp
from repro_torch.core.protection import ladder as tladder
from repro_torch.kernels import common

ROWS, W = 32, 64
_jax_page_coords = jax.jit(jl.page_coords, static_argnums=(0, 1, 2, 4))


def _jl(layout: tl.Layout) -> jl.Layout:
    return jl.Layout(layout.value)


def _np(t: torch.Tensor) -> np.ndarray:
    return t.numpy()


@pytest.mark.parametrize("layout", list(tl.Layout))
def test_page_coords_every_boundary(layout):
    for boundary in range(0, ROWS + 1, 8):
        n = ROWS + tl.extra_page_count(layout, boundary, W)
        ids = np.arange(n)
        want = _jax_page_coords(_jl(layout), ROWS, boundary,
                                jnp.asarray(ids, jnp.int32), W)
        got = tl.page_coords(layout, ROWS, boundary, torch.as_tensor(ids), W)
        for w, g in zip(want, got, strict=True):
            np.testing.assert_array_equal(_np(g), np.asarray(w))
            assert g.dtype == torch.int64


@pytest.mark.parametrize("layout", list(tl.Layout))
def test_capacity_accounting_matches(layout):
    for rows in (8, 32, 64, 200):
        for boundary in range(0, rows + 1, 8):
            args = (layout, boundary, W)
            jargs = (_jl(layout), boundary, W)
            assert tl.extra_page_count(*args) == jl.extra_page_count(*jargs)
            assert tl.total_pages(*args) == jl.total_pages(*jargs)
            assert tl.extra_base_row(*args) == jl.extra_base_row(*jargs)
    assert tl.CAPACITY_GAIN[layout] == jl.CAPACITY_GAIN[_jl(layout)]


def test_wrap_tables_region_and_parity_coords_match():
    np.testing.assert_array_equal(tl.WRAP_LANES, jl.WRAP_LANES)
    np.testing.assert_array_equal(tl.WRAP_ROWS, jl.WRAP_ROWS)
    ids = np.arange(ROWS + 4)
    for boundary in (0, 8, 24, 32):
        np.testing.assert_array_equal(
            _np(tl.page_region(ROWS, boundary, torch.as_tensor(ids))),
            np.asarray(jl.page_region(ROWS, boundary, jnp.asarray(ids))))
        for w, g in zip(jl.parity_coords(ROWS, boundary, jnp.asarray(ids), W),
                        tl.parity_coords(ROWS, boundary, torch.as_tensor(ids),
                                         W)):
            np.testing.assert_array_equal(_np(g), np.asarray(w))
    assert [p.value for p in tladder()] == [p.value for p in jladder()]


def test_pick_block():
    assert [common.pick_block(n, 32) for n in (1, 7, 32, 48, 100)] == \
        [1, 7, 32, 24, 25]


# ---------------------------------------------------------------------------
# The scripted sequence: both pools, same inputs, storage equal after each op
# ---------------------------------------------------------------------------


class Twin:
    """A reference pool and a port pool driven in lockstep."""

    def __init__(self, layout: tl.Layout, boundary: int):
        self.j = jp.make_pool(ROWS, _jl(layout), boundary=boundary,
                              row_words=W)
        self.t = tp.make_pool(ROWS, layout, boundary=boundary, row_words=W,
                              device="cpu")

    def check(self):
        assert self.t.boundary == self.j.boundary
        assert self.t.num_pages == self.j.num_pages
        np.testing.assert_array_equal(common.to_u32(self.t.storage),
                                      np.asarray(self.j.storage))

    def write(self, pages, data, valid=None):
        self.j = self.j.write(pages, jnp.asarray(data), valid=valid)
        self.t = self.t.write(pages, common.to_words(data), valid=valid)
        self.check()

    def read(self, pages):
        jd, js = self.j.read(pages, status=True)
        td, ts = self.t.read(pages, status=True)
        np.testing.assert_array_equal(common.to_u32(td), np.asarray(jd))
        np.testing.assert_array_equal(_np(ts), np.asarray(js))
        return np.asarray(js)

    def flip(self, row, lane, word, bits):
        arr = np.asarray(self.j.storage).copy()
        arr[row, lane, word] ^= np.uint32(bits)
        self.j = dataclasses.replace(self.j, storage=jnp.asarray(arr))
        self.t.storage.copy_(common.to_words(arr))
        self.check()

    def migrate(self, src, dst):
        self.j = self.j.migrate(src, dst)
        self.t = self.t.migrate(src, dst)
        self.check()

    def repartition(self, boundary):
        self.j, jinfo = jp.repartition(self.j, boundary)
        self.t, tinfo = tp.repartition(self.t, boundary)
        assert tinfo == jinfo
        self.check()


def _pages(rng, n):
    return rng.integers(0, 2**32, (n, 8 * W), dtype=np.uint32)


@pytest.mark.parametrize("layout", [tl.Layout.INTERWRAP, tl.Layout.PACKED,
                                    tl.Layout.RANK_SUBSET])
def test_scripted_sequence_storage_bit_exact(layout):
    rng = np.random.default_rng(7)
    tw = Twin(layout, boundary=16)
    everything = list(range(tw.t.num_pages))
    tw.write(everything, _pages(rng, len(everything)))
    # SECDED reads with planted flips: data bit, code bit, same-beat double
    tw.flip(20, 3, 10, 1 << 5)
    tw.flip(21, 8, 4, 1 << 17)
    tw.flip(22, 0, 6, (1 << 2) | (1 << 9))
    st = tw.read([0, 20, 21, 22, 23, ROWS, ROWS + 1, 5])
    assert sorted(set(st.tolist())) == [0, 1, 2, 3]
    # masked write over a mixed id vector
    ids = [3, 18, ROWS + 1, 25]
    tw.write(ids, _pages(rng, 4), valid=np.asarray([True, False, True, True]))
    # in-pool migration (decode-corrected read + code-maintaining write)
    tw.migrate([20, ROWS, 2], [24, 9, ROWS + 1])
    # repartition down (protect more rows) and back up (reclaim code lanes)
    tw.repartition(8)
    tw.read(list(range(tw.t.num_pages)))
    tw.repartition(0)
    tw.read(list(range(tw.t.num_pages)))
    tw.repartition(24)
    tw.read(list(range(tw.t.num_pages)))
    tw.write([1, ROWS + 2, 30], _pages(rng, 3))
    tw.repartition(ROWS)
    tw.read(list(range(tw.t.num_pages)))


@pytest.mark.parametrize("layout", [tl.Layout.BASELINE_ECC, tl.Layout.PARITY])
def test_all_secded_pools_bit_exact(layout):
    """BASELINE_ECC, and PARITY with the whole pool SECDED (no side channel)."""
    rng = np.random.default_rng(8)
    tw = Twin(layout, boundary=0)
    tw.write(list(range(ROWS)), _pages(rng, ROWS))
    tw.flip(4, 2, 0, 1 << 31)
    tw.read(list(range(ROWS)))
    tw.migrate([4, 5], [6, 7])


def test_evict_prediction_matches():
    j = jp.make_pool(ROWS, jl.Layout.INTERWRAP, row_words=W)
    t = tp.make_pool(ROWS, tl.Layout.INTERWRAP, row_words=W, device="cpu")
    for nb in range(0, ROWS + 1, 8):
        assert t.evict_prediction(nb) == j.evict_prediction(nb)


def test_duplicate_ids_land_the_last_valid_row_with_its_codes():
    """Of several rows for one page the last valid one lands, data and
    SECDED codes alike (the serve step writes its scratch page once per
    unbound slot and layer)."""
    rng = np.random.default_rng(9)
    t = tp.make_pool(ROWS, tl.Layout.INTERWRAP, boundary=16, row_words=W,
                     device="cpu")
    ids = [20, 3, 20, ROWS, 3, 20]
    data = _pages(rng, len(ids))
    valid = torch.as_tensor([True, True, True, True, True, False])
    t = t.write(ids, common.to_words(data), valid=valid)
    got, status = t.read([20, 3, ROWS], status=True)
    np.testing.assert_array_equal(common.to_u32(got), data[[2, 4, 3]])
    assert int(status.max()) == 0


def test_out_of_range_ids_raise():
    t = tp.make_pool(ROWS, tl.Layout.INTERWRAP, row_words=W, device="cpu")
    with pytest.raises(ValueError, match="out of range"):
        t.read([t.num_pages])
    with pytest.raises(ValueError, match="out of range"):
        t.write([-1], torch.zeros((1, 8 * W), dtype=torch.int32))


def test_migrate_without_donation_keeps_input():
    t = tp.make_pool(ROWS, tl.Layout.INTERWRAP, row_words=W, device="cpu")
    t = t.write([0], torch.ones((1, 8 * W), dtype=torch.int32))
    before = t.storage.clone()
    moved = t.migrate([0], [1], donate=False)
    assert torch.equal(t.storage, before)
    assert torch.equal(moved.read([1]), t.read([0]))


def test_parity_pool_capacity_repartition_and_daec_tier_match_reference():
    """A PARITY pool offers the reference's pages and moves its boundary;
    ``make_pool(daec_rows=...)`` and ``set_daec_rows`` on a PARITY pool
    give the reference's storage after a write of every page, and the
    boundary cannot move into the tier (the PARITY side channel is held
    against the reference in ``tests/test_torch_parity.py``, the DAEC tier
    in ``tests/test_torch_daec.py``)."""
    pool = tp.make_pool(ROWS, tl.Layout.PARITY, boundary=16, row_words=W,
                        device="cpu")
    assert pool.num_pages == ROWS + tl.extra_page_count(tl.Layout.PARITY, 16,
                                                         W)
    assert pool.move_boundary(8)[0].boundary == 8
    j = jp.make_pool(ROWS, jl.Layout.PARITY, boundary=16, row_words=W,
                     daec_rows=8)
    t = tp.make_pool(ROWS, tl.Layout.PARITY, boundary=16, row_words=W,
                     daec_rows=8, device="cpu")
    assert (t.daec_rows, t.daec_start) == (j.daec_rows, j.daec_start) \
        == (8, 24)
    data = np.random.default_rng(3).integers(0, 2**32, (t.num_pages, 8 * W),
                                             dtype=np.uint32)
    j = j.write(jnp.arange(j.num_pages), jnp.asarray(data))
    t = t.write(np.arange(t.num_pages), common.to_words(data))
    for n in (16, 0):
        j, t = j.set_daec_rows(n), t.set_daec_rows(n)
        assert t.daec_rows == n
        np.testing.assert_array_equal(_np(t.storage).view(np.uint32),
                                      np.asarray(j.storage))
    np.testing.assert_array_equal(common.to_u32(t.read(np.arange(
        t.num_pages))), data)
    with pytest.raises(ValueError, match="overlap the DAEC tier"):
        t.set_daec_rows(16).move_boundary(24)
