"""The port's SEC-DAEC tier equals the reference bit for bit.

  * The codec: ``H_COLUMNS`` rebuilt and equal; every single bit (128 data,
    16 code) and every adjacent pair of one superbeat, plus seeded
    same-codeword doubles, through ``repro_torch.core.daec``, the daec
    kernels' plain version (``repro_torch.kernels.daec.ops`` on the CPU),
    ``repro.core.daec`` and the reference's Pallas kernels in interpret
    mode: data, codes and status identical.
  * The pool: a DAEC tier's reads, writes, ``set_daec_rows`` in both
    directions and the scrub census, on twin pools with planted flips:
    storage, data, status and census identical.

Every comparison is exact: the data plane is integer.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import daec as jd
from repro.core import pool as jp
from repro.core.layouts import Layout as JLayout
from repro.kernels.daec import kernel as jk
from repro_torch.core import daec as td
from repro_torch.core import pool as tp
from repro_torch.core.layouts import Layout
from repro_torch.kernels import common
from repro_torch.kernels.daec import ops as daec_ops

W = 64


def test_h_columns_match_the_reference():
    np.testing.assert_array_equal(td.H_COLUMNS.numpy(),
                                  np.asarray(jd.H_COLUMNS))
    assert td.H_COLUMNS.shape == (td.NUM_DATA_BITS + td.NUM_CODE_BITS,)


def _flip_patterns(rng) -> list[tuple[list[int], list[int]]]:
    """(data bits, code bits) flipped in superbeat 0 of one row each:
    every single bit, every adjacent pair of data bits and of code-field
    bits, and 64 seeded same-codeword doubles (bits b, b+2)."""
    pats = [([b], []) for b in range(128)] + [([], [q]) for q in range(16)]
    pats += [([b, b + 1], []) for b in range(127)]
    pats += [([], [q, q + 1]) for q in range(15)]
    pats += [([int(b), int(b) + 2], []) for b in rng.integers(0, 126, 64)]
    return [([], [])] + pats


def _planted_block(seed: int):
    """(N, 8) words (two superbeats a row) and their DAEC codes, with one
    flip pattern per row in superbeat 0 -> (data, codes, patterns)."""
    rng = np.random.default_rng(seed)
    pats = _flip_patterns(rng)
    data = rng.integers(0, 2**32, (len(pats), 8), dtype=np.uint32)
    codes = np.array(jd.encode_block(jnp.asarray(data)))
    for r, (dbits, cbits) in enumerate(pats):
        for b in dbits:
            data[r, b // 32] ^= np.uint32(1 << (b % 32))
        for q in cbits:
            codes[r, 0] ^= np.uint32(1 << q)
    return data, codes, pats


def test_encode_matches_reference_codec_and_kernel():
    data = np.random.default_rng(0).integers(0, 2**32, (48, 8 * W),
                                             dtype=np.uint32)
    want = np.asarray(jd.encode_block(jnp.asarray(data)))
    np.testing.assert_array_equal(np.asarray(jk.encode(jnp.asarray(data))),
                                  want)
    for got in (td.encode_block(common.to_words(data)),
                daec_ops.encode(common.to_words(data))):
        np.testing.assert_array_equal(common.to_u32(got), want)


def test_decode_every_single_and_adjacent_pair_matches_reference():
    data, codes, pats = _planted_block(1)
    ref = [np.asarray(x) for x in jd.decode_block(jnp.asarray(data),
                                                  jnp.asarray(codes))]
    kern = [np.asarray(x) for x in jk.decode(jnp.asarray(data),
                                             jnp.asarray(codes))]
    for a, b in zip(kern, ref):
        np.testing.assert_array_equal(a, b)
    for got in (td.decode_block(common.to_words(data),
                                common.to_words(codes)),
                daec_ops.decode(common.to_words(data),
                                common.to_words(codes))):
        np.testing.assert_array_equal(common.to_u32(got[0]), ref[0])
        np.testing.assert_array_equal(common.to_u32(got[1]), ref[1])
        np.testing.assert_array_equal(got[2].numpy(), ref[2])
    # the code's promise, row by row: singles and adjacent pairs corrected
    # (data 1 / code 2 on both beats of the superbeat), same-codeword
    # doubles detected (3), and superbeat 1 of every row clean
    status = ref[2]
    for r, (dbits, cbits) in enumerate(pats):
        if not dbits and not cbits:
            want = 0
        elif len(dbits + cbits) == 2 and abs(sum(dbits + cbits)
                                             - 2 * min(dbits + cbits)) == 2:
            want = 3
        else:
            want = 1 if dbits else 2
        assert status[r].tolist() == [want, want, 0, 0], (r, dbits, cbits)
        if want != 3:
            clean = np.asarray(jd.encode_block(jnp.asarray(ref[0][r:r + 1])))
            np.testing.assert_array_equal(ref[1][r:r + 1], clean)


def test_wrappers_check_shapes_and_contiguity():
    data = torch.zeros((4, 64), dtype=torch.int32)
    with pytest.raises(ValueError, match="D % 8"):
        daec_ops.encode(torch.zeros((4, 12), dtype=torch.int32))
    with pytest.raises(ValueError, match="codes must be"):
        daec_ops.decode(data, torch.zeros((4, 4), dtype=torch.int32))
    with pytest.raises(ValueError, match="contiguous"):
        daec_ops.encode(torch.zeros((64, 4), dtype=torch.int32).t())
    assert daec_ops.encode(data).shape == (4, 8)
    assert [t.shape for t in daec_ops.decode(data, daec_ops.encode(data))] \
        == [(4, 64), (4, 8), (4, 32)]


# ---------------------------------------------------------------------------
# The DAEC tier of the pool
# ---------------------------------------------------------------------------


class TwinPools:
    """A reference pool and a port pool (on the CPU) with one DAEC tier,
    written with the same random pages."""

    def __init__(self, rows=32, boundary=8, daec_rows=16,
                 layout=Layout.INTERWRAP, seed=0):
        self.rng = np.random.default_rng(seed)
        self.j = jp.make_pool(rows, JLayout(layout.value), boundary=boundary,
                              row_words=W, daec_rows=daec_rows)
        self.t = tp.make_pool(rows, layout, boundary=boundary, row_words=W,
                              daec_rows=daec_rows, device="cpu")
        assert self.t.num_pages == self.j.num_pages
        data = self.rng.integers(0, 2**32, (self.j.num_pages, 8 * W),
                                 dtype=np.uint32)
        self.write(np.arange(self.j.num_pages), data)

    def write(self, pages, data) -> None:
        self.j = self.j.write(jnp.asarray(pages), jnp.asarray(data))
        self.t = self.t.write(pages, common.to_words(data))
        self.same()

    def same(self) -> None:
        assert self.t.daec_rows == self.j.daec_rows
        np.testing.assert_array_equal(common.to_u32(self.t.storage),
                                      np.asarray(self.j.storage))

    def flip(self, cells) -> None:
        arr = np.asarray(self.j.storage).copy()
        for row, lane, word, bits in cells:
            arr[row, lane, word] ^= np.uint32(bits)
        self.j = dataclasses.replace(self.j, storage=jnp.asarray(arr))
        self.t = dataclasses.replace(self.t, storage=common.to_words(arr))

    def read_all(self):
        pages = np.arange(self.j.num_pages)
        jd_, js = self.j.read(jnp.asarray(pages), status=True)
        td_, ts = self.t.read(pages, status=True)
        np.testing.assert_array_equal(common.to_u32(td_), np.asarray(jd_))
        np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
        return np.asarray(js)


# planted in rows of the DAEC tier [16, 32) and the SECDED span [8, 16):
# single data bit, adjacent double, same-codeword double (bits b, b+2),
# a code-lane bit, and a split pair across two superbeats
FLIPS = [(20, 0, 5, 1 << 9), (22, 3, 17, 0b11 << 14), (25, 6, 40, 0b101),
         (27, 8, 3, 1 << 30), (30, 1, 2, 1 << 31), (30, 1, 6, 1),
         (10, 2, 11, 1 << 4), (12, 5, 7, 0b11 << 20)]


def test_daec_tier_reads_and_writes_match_reference():
    tw = TwinPools()
    assert tw.t.daec_start == 16
    tw.flip(FLIPS)
    status = tw.read_all()
    # DAEC: corrected singles and adjacent pairs, a detected same-codeword
    # double; SECDED: a corrected single, a detected adjacent double
    assert status[[20, 22, 25, 27, 30, 10, 12]].tolist() == [1, 1, 3, 2, 1,
                                                            1, 3]
    rng = np.random.default_rng(7)
    pages = np.asarray([3, 17, 9, 31, 24, 17, 32])   # mixed, one duplicate
    tw.write(pages, rng.integers(0, 2**32, (len(pages), 8 * W),
                                 dtype=np.uint32))
    tw.read_all()


@pytest.mark.parametrize("sizes", [(16, 24), (16, 8), (16, 0), (0, 16)],
                         ids=["grow", "shrink", "drop", "carve"])
def test_set_daec_rows_both_directions_match_reference(sizes):
    start, end = sizes
    tw = TwinPools(daec_rows=start)
    tw.flip([(r, 1 + r % 7, 3 * r % W, 1 << (r % 31)) for r in range(8, 32)])
    before = tw.t.storage.clone()
    tw.j = tw.j.set_daec_rows(end)
    t2 = tw.t.set_daec_rows(end)
    assert torch.equal(tw.t.storage, before)      # the input stays valid
    tw.t = t2
    tw.same()
    # the re-tiered rows were decoded (corrected) on the way: now clean;
    # the others still report their planted single
    status = tw.read_all()[8:32]
    moved = np.zeros(24, bool)
    moved[24 - max(start, end):24 - min(start, end)] = True
    assert (status[moved] == 0).all() and (status[~moved] == 1).all()
    with pytest.raises(ValueError, match="must fit"):
        tw.t.set_daec_rows(32)


def test_daec_scrub_census_matches_reference():
    tw = TwinPools()
    tw.flip(FLIPS)
    js, jstats = tw.j.scrub()
    ts, tstats = tw.t.scrub()
    np.testing.assert_array_equal(common.to_u32(ts.storage),
                                  np.asarray(js.storage))
    assert dataclasses.asdict(tstats) == dataclasses.asdict(jstats)
    # a DAEC superbeat's verdict counts on both of its beats
    assert tstats.corrected_data == 2 + 2 + 2 * 2 + 1
    assert tstats.corrected_code == 2
    assert tstats.detected_uncorrectable == 2 + 1
    assert sorted(tstats.corrupt_rows) == [12, 25]
    assert tstats.beats_checked == (32 - 8) * 4 * W
