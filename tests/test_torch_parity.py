"""The port's parity8 codec and the PARITY pool's side channel equal the
reference bit for bit.

The plain codec against ``repro.core.parity8`` and the parity8 wrappers
against the reference's Pallas kernels (interpret mode), with planted
flips; then a scripted PARITY-pool sequence — writes, reads with planted
parity flips (status 3), masked and duplicate writes, ``migrate``, and
``repartition`` down and up with the surviving extra pages re-homed — run
on a ``repro.core.pool`` pool and a ``repro_torch.core.pool`` pool (on the
CPU) from the same numpy inputs, with the storage compared after every
step, at every boundary. Last, the pool's one-pass write
(``parity8_ops.write``) against the reference's ``write_pages_any``, that a
pool write goes through it once, and that it refuses strided operands.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import parity8 as jparity
from repro.core import pool as jp
from repro.core.layouts import Layout as JLayout
from repro.kernels.parity8 import kernel as jkernel
from repro_torch.core import parity8 as tparity
from repro_torch.core import pool as tp
from repro_torch.core.layouts import Layout, page_coords, parity_coords
from repro_torch.kernels import common
from repro_torch.kernels.parity8 import ops as parity8_ops

ROWS, W = 32, 64


def _flipped(rng, data: np.ndarray, n: int) -> np.ndarray:
    """``data`` with ``n`` random single-bit flips."""
    out = data.copy()
    flat = out.reshape(-1)
    idx = rng.choice(flat.size, n, replace=False)
    flat[idx] ^= np.uint32(1) << rng.integers(0, 32, n).astype(np.uint32)
    return out


def test_codec_matches_reference_with_flips():
    rng = np.random.default_rng(0)
    data = rng.integers(0, 2**32, (6, 4, 128), dtype=np.uint32)
    parity = np.asarray(jparity.encode_lines(jnp.asarray(data)))
    np.testing.assert_array_equal(
        common.to_u32(tparity.encode_lines(common.to_words(data))), parity)
    packed = np.asarray(jparity.encode_lines_packed(jnp.asarray(data)))
    np.testing.assert_array_equal(
        common.to_u32(tparity.encode_lines_packed(common.to_words(data))),
        packed)
    bad = _flipped(rng, data, 9)
    want = np.asarray(jparity.check_lines(jnp.asarray(bad),
                                          jnp.asarray(parity)))
    got = tparity.check_lines(common.to_words(bad), common.to_words(parity))
    np.testing.assert_array_equal(got.numpy(), want)
    assert 0 < want.sum() <= 9
    want = np.asarray(jparity.check_lines_packed(jnp.asarray(bad),
                                                 jnp.asarray(packed)))
    got = tparity.check_lines_packed(common.to_words(bad),
                                     common.to_words(packed))
    np.testing.assert_array_equal(got.numpy(), want)
    with pytest.raises(ValueError, match="multiple of 16"):
        tparity.encode_lines(common.to_words(data[..., :8]))


def test_ops_match_the_pallas_kernels():
    """Encode, then check with flips in the data and in the parity words,
    so both statuses occur."""
    rng = np.random.default_rng(1)
    data = rng.integers(0, 2**32, (12, 8 * W), dtype=np.uint32)
    want = np.asarray(jkernel.encode(jnp.asarray(data)))
    got = parity8_ops.encode(common.to_words(data))
    np.testing.assert_array_equal(common.to_u32(got), want)
    bad = _flipped(rng, data, 5)
    bad_parity = _flipped(rng, want, 3)
    want_st = np.asarray(jkernel.check(jnp.asarray(bad),
                                       jnp.asarray(bad_parity)))
    got_st = parity8_ops.check(common.to_words(bad),
                               common.to_words(bad_parity))
    np.testing.assert_array_equal(got_st.numpy(), want_st)
    assert sorted(np.unique(want_st).tolist()) == [0, 1]
    with pytest.raises(ValueError, match="D % 64"):
        parity8_ops.encode(common.to_words(data[:, :32]))
    with pytest.raises(ValueError, match="parity must be"):
        parity8_ops.check(common.to_words(data), common.to_words(want[:, :1]))


# ---------------------------------------------------------------------------
# The scripted PARITY-pool sequence
# ---------------------------------------------------------------------------


class Twin:
    """A reference PARITY pool and a port PARITY pool in lockstep."""

    def __init__(self, boundary: int):
        self.j = jp.make_pool(ROWS, JLayout.PARITY, boundary=boundary,
                              row_words=W)
        self.t = tp.make_pool(ROWS, Layout.PARITY, boundary=boundary,
                              row_words=W, device="cpu")

    def check(self):
        assert self.t.boundary == self.j.boundary
        assert self.t.num_pages == self.j.num_pages
        np.testing.assert_array_equal(common.to_u32(self.t.storage),
                                      np.asarray(self.j.storage))

    def write(self, pages, data, valid=None, lands=None):
        """``lands`` (optional) is the batch rows the reference gets: the
        port lands only the last valid row of duplicate ids, the reference
        leaves duplicates unspecified."""
        sel = np.arange(len(pages)) if lands is None else np.asarray(lands)
        jvalid = None if valid is None else np.asarray(valid)[sel]
        self.j = self.j.write(np.asarray(pages)[sel], jnp.asarray(data[sel]),
                              valid=jvalid)
        self.t = self.t.write(pages, common.to_words(data), valid=valid)
        self.check()

    def read(self, pages):
        jd, js = self.j.read(pages, status=True)
        td, ts = self.t.read(pages, status=True)
        np.testing.assert_array_equal(common.to_u32(td), np.asarray(jd))
        np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
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
        before = self.t.storage.clone()
        new, tinfo = tp.repartition(self.t, boundary)
        assert tinfo == jinfo
        assert self.t.storage.equal(before)      # functional: input intact
        self.t = new
        self.check()


def _pages(rng, n):
    return rng.integers(0, 2**32, (n, 8 * W), dtype=np.uint32)


@pytest.mark.parametrize("boundary", [0, 8, 16, 24, 32])
def test_scripted_parity_sequence_storage_bit_exact(boundary):
    rng = np.random.default_rng(100 + boundary)
    tw = Twin(boundary)
    everything = list(range(tw.t.num_pages))
    tw.write(everything, _pages(rng, len(everything)))
    flipped = []
    if boundary:
        tw.flip(1, 3, 10, 1 << 5)                  # data bit, CREAM page 1
        prow, off = parity_coords(ROWS, boundary, np.asarray([2]), W)
        tw.flip(int(prow[0]), 8, int(off[0]) + 1, 1 << 20)   # page 2's parity
        flipped += [1, 2]
    if tw.t.num_extra_pages:
        extra = ROWS + tw.t.num_extra_pages - 1
        rows, lanes, _ = page_coords(Layout.PARITY, ROWS, boundary,
                                     np.asarray([extra]), W)
        tw.flip(int(rows[0, 4]), int(lanes[0, 4]), 7, 1 << 30)  # last extra
        flipped.append(extra)
    if boundary < ROWS:                            # SECDED: statuses 1, 2, 3
        tw.flip(boundary, 2, 3, 1 << 1)
        tw.flip(ROWS - 1, 8, 0, 1 << 9)
        tw.flip(ROWS - 2, 0, 6, (1 << 2) | (1 << 9))
    st = tw.read(everything)
    if boundary < ROWS:
        assert sorted(set(st[boundary:ROWS].tolist())) == [0, 1, 2, 3]
    for page in flipped:
        assert st[page] == 3, page
    # masked write over a mixed id vector, then duplicates: last valid lands
    ids = [0, ROWS - 1, 5, tw.t.num_pages - 1]
    tw.write(ids, _pages(rng, 4), valid=[True, False, True, True])
    dup = [3, 17, 3, tw.t.num_pages - 1, 17, 3]
    tw.write(dup, _pages(rng, 6), valid=[True] * 5 + [False],
             lands=[2, 3, 4])
    tw.read(everything)
    # in-pool migration: decode/parity-checked read + coded write
    tw.migrate([4, ROWS - 3, tw.t.num_pages - 1], [6, 9, ROWS - 4])
    # repartition down (protect more rows) and back up (reclaim code lanes)
    for nb in (max(boundary - 8, 0), ROWS, 16, boundary):
        tw.repartition(nb)
        tw.read(list(range(tw.t.num_pages)))
        tw.write([1, tw.t.num_pages - 1], _pages(rng, 2))


def test_write_leaves_secded_pages_out_of_the_parity_tables():
    """A write of SECDED pages alone launches no parity encode and leaves
    the tables as they were; a CREAM page's write updates only its entry."""
    rng = np.random.default_rng(5)
    t = tp.make_pool(ROWS, Layout.PARITY, boundary=16, row_words=W,
                     device="cpu")
    t = t.write(list(range(t.num_pages)), common.to_words(
        _pages(rng, t.num_pages)))
    tables = t.storage[:4, 8, :].clone()
    t = t.write([20, 30], common.to_words(_pages(rng, 2)))
    assert t.storage[:4, 8, :].equal(tables)
    t = t.write([9], common.to_words(_pages(rng, 1)))
    prow, off = parity_coords(ROWS, 16, np.asarray([9]), W)
    changed = (t.storage[:4, 8, :] != tables).nonzero().tolist()
    assert changed and all(r == int(prow[0]) and
                           int(off[0]) <= c < int(off[0]) + W // 8
                           for r, c in changed)


# ---------------------------------------------------------------------------
# The PARITY pool's one-pass write (parity8_ops.write)
# ---------------------------------------------------------------------------


def _filled(boundary: int):
    """A reference and a port PARITY pool holding the same random pages."""
    rng = np.random.default_rng(200 + boundary)
    tw = Twin(boundary)
    everything = list(range(tw.t.num_pages))
    tw.write(everything, _pages(rng, len(everything)))
    return tw, rng


@pytest.mark.parametrize("boundary", [8, 16, 24, 32])
def test_write_plain_version_matches_reference_write_pages_any(boundary):
    """``parity8_ops.write`` on CPU tensors (its plain version) lands the
    pages and their packed parity exactly as the reference's
    ``write_pages_any`` does, for ids mixing CREAM, SECDED and extra pages,
    then for a masked batch with duplicates after ``_landing_rows``. The
    SECDED pages' code words are the caller's: the write leaves them as
    they were, and everything else is bit-exact."""
    tw, rng = _filled(boundary)
    n_pages = tw.t.num_pages
    ids = np.concatenate([np.arange(0, boundary, 3),          # CREAM
                          np.arange(boundary, ROWS, 2),       # SECDED
                          np.arange(ROWS, n_pages)])          # extra
    ids = rng.permutation(ids)
    dup = np.concatenate([ids[:5], ids[:3], [ids[0]]])
    valid = np.ones(dup.size, bool)
    valid[[1, -1]] = False                 # a masked row and a masked dup
    for batch, mask in ((ids, None), (dup, valid)):
        data = _pages(rng, batch.size)
        land = tp._landing_rows(batch, mask)
        before = tw.t.storage.clone()
        want = np.asarray(jp.write_pages_any(
            tw.j, jnp.asarray(batch), jnp.asarray(data),
            valid=jnp.asarray(land)).storage)
        got = parity8_ops.write(
            tw.t.storage, torch.as_tensor(batch[land]),
            common.to_words(data[land]), boundary)
        assert got is tw.t.storage                 # in place
        got = common.to_u32(got)
        sec = np.unique(batch[land][(batch[land] >= boundary)
                                    & (batch[land] < ROWS)])
        np.testing.assert_array_equal(got[sec, 8],
                                      common.to_u32(before)[sec, 8])
        got[sec, 8] = want[sec, 8]
        np.testing.assert_array_equal(got, want)
        tw.j = dataclasses.replace(tw.j, storage=jnp.asarray(want))
        tw.t.storage.copy_(common.to_words(want))


def test_pool_write_is_one_parity8_write_and_no_standalone_encode(
        monkeypatch):
    """A PARITY-pool write of CREAM, SECDED and extra ids makes exactly one
    ``parity8_ops.write`` call (one launch on the card) and never calls the
    standalone encode; SECDED ids take their codec's encode once."""
    calls = []
    for name in ("write", "encode"):
        fn = getattr(parity8_ops, name)
        monkeypatch.setattr(
            parity8_ops, name,
            lambda *a, _n=name, _f=fn, **k: calls.append(_n) or _f(*a, **k))
    sec_calls = []
    enc = tp.secded_ops.encode
    monkeypatch.setattr(tp.secded_ops, "encode",
                        lambda d: sec_calls.append(d.shape[0]) or enc(d))
    rng = np.random.default_rng(7)
    t = tp.make_pool(ROWS, Layout.PARITY, boundary=16, row_words=W,
                     device="cpu")
    ids = [0, 20, ROWS, 9, 31]
    t.write(ids, common.to_words(_pages(rng, len(ids))))
    assert calls == ["write"]
    assert sec_calls == [2]


def test_write_refuses_a_strided_storage_view():
    """The kernel takes a contiguous ``(R, 9, W)`` storage (a bank of a
    sharded pool is a contiguous view of its tensor); a strided view is
    refused on the CPU as it would be on the card."""
    wide = torch.zeros((ROWS, 9, W + 8), dtype=torch.int32)
    with pytest.raises(ValueError, match="contiguous"):
        parity8_ops.write(wide[..., :W], torch.arange(2),
                          torch.zeros((2, 8 * W), dtype=torch.int32), 16)
    with pytest.raises(ValueError, match="contiguous"):
        parity8_ops.write(torch.zeros((ROWS, 9, W), dtype=torch.int32),
                          torch.arange(4)[::2],
                          torch.zeros((2, 8 * W), dtype=torch.int32), 16)
