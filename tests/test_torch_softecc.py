"""SoftECC (the Virtualized-ECC baseline) and the layouts' access accounting
equal the reference.

The functional pool: the same numpy pages written to a reference
``SoftECCState`` and to the port's, single data-bit, code-bit and
double-bit flips planted at the same cells, then every page read and the
pool scrubbed: storage, reads, statuses and scrub stats bit-exact at every
step. The accounting: ``plan_line_access``, ``count_device_ops``,
``parallelism_groups``, ``place_page``, ``interwrap_slices`` and
``plan_line_ops`` (with a ``CodeCache`` whose hit sequence is compared)
equal the reference for every layout over sampled pages, reads and writes.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import layouts as jlay
from repro.core import softecc as jsoft
from repro_torch.core import layouts as tlay
from repro_torch.core import softecc as tsoft
from repro_torch.kernels import common

W = 32


def _pair(rows: int, seed: int):
    rng = np.random.default_rng(seed)
    j = jsoft.make_softecc(rows, W)
    t = tsoft.make_softecc(rows, W, device="cpu")
    data = rng.integers(0, 2**32, (j.num_pages, j.page_words),
                        dtype=np.uint32)
    for p in range(j.num_pages):
        j = jsoft.write_page(j, p, jnp.asarray(data[p]))
    t = tsoft.write_pages(t, np.arange(t.num_pages), data)
    return j, t, rng


def _same_storage(j, t) -> None:
    np.testing.assert_array_equal(common.to_u32(t.storage),
                                  np.asarray(j.storage))


def _flip(j, t, cells):
    arr = np.asarray(j.storage).copy()
    for row, lane, word, bit in cells:
        arr[row, lane, word] ^= np.uint32(1 << bit)
    j = jsoft.SoftECCState(jnp.asarray(arr), W)
    t = tsoft.SoftECCState(common.to_words(arr), W)
    return j, t


def test_geometry_and_refusals_equal_the_reference():
    j, t = jsoft.make_softecc(27, W), tsoft.make_softecc(27, W, device="cpu")
    for name in ("num_rows", "num_pages", "num_code_rows", "page_words"):
        assert getattr(t, name) == getattr(j, name), name
    for p in range(t.num_pages):
        assert tsoft._locate(t, p) == jsoft._locate(j, p)
    with pytest.raises(ValueError):
        tsoft.make_softecc(20, W, device="cpu")
    with pytest.raises(ValueError):
        tsoft.write_page(t, 0, np.zeros(7, np.uint32))


@pytest.mark.parametrize("rows", [9, 36])
def test_write_flip_read_scrub_sequence_is_bit_exact(rows):
    j, t, rng = _pair(rows, seed=rows)
    _same_storage(j, t)
    n = j.num_pages
    # a data-bit single, a code-bit single (in a code row), a double in one
    # beat, and two singles in two beats of one page
    cells = [(1, 3, 5, 17), (8, 2, 1, 30), (0, 0, 4, 2), (0, 0, 4, 9)]
    if rows > 9:
        cells += [(12, 1, 0, 0), (12, 6, 9, 31)]
    j, t = _flip(j, t, cells)
    for p in range(n):
        jd, js = jsoft.read_page(j, p)
        td, ts = tsoft.read_page(t, p)
        np.testing.assert_array_equal(common.to_u32(td), np.asarray(jd))
        assert int(ts) == int(js), p
        np.testing.assert_array_equal(
            common.to_u32(tsoft._code_slice(t, p)),
            np.asarray(jsoft._code_slice(j, p)))
    td, ts = tsoft.read_pages(t, rng.permutation(n))
    j2, jstats = jsoft.scrub(j)
    t2, tstats = tsoft.scrub(t)
    assert tstats == jstats
    assert tstats["uncorrectable_pages"] == 1
    _same_storage(j2, t2)
    _same_storage(j, t)           # scrub leaves its input as it was
    # a second scrub finds only the uncorrectable page
    assert tsoft.scrub(t2)[1] == jsoft.scrub(j2)[1]


def test_code_cache_hits_and_line_ops_equal_the_reference():
    rng = np.random.default_rng(3)
    jc, tc = jsoft.CodeCache(16), tsoft.CodeCache(16)
    seq_j, seq_t = [], []
    for _ in range(600):
        page, line = int(rng.integers(0, 64)), int(rng.integers(0, 128))
        write = bool(rng.integers(0, 2))
        seq_j.append(jsoft.plan_line_ops(page, line, write, jc))
        seq_t.append(tsoft.plan_line_ops(page, line, write, tc))
    assert seq_t == seq_j
    assert (tc.hits, tc.misses) == (jc.hits, jc.misses)
    assert list(tc._lru) == list(jc._lru)
    for cap in (0, -1):
        a, b = jsoft.CodeCache(cap), tsoft.CodeCache(cap)
        assert [b.access((1, 2)) for _ in range(3)] == \
            [a.access((1, 2)) for _ in range(3)]
        assert (b.hits, b.misses) == (a.hits, a.misses)
    assert tsoft.plan_line_ops(5, 7, True, None) == \
        jsoft.plan_line_ops(5, 7, True, None)


def _acc(a) -> tuple:
    return (a.slices, a.write, a.rmw, a.rows, a.lanes, a.num_device_ops())


@pytest.mark.parametrize("layout", list(tlay.Layout), ids=lambda l: l.value)
def test_access_plans_equal_the_reference(layout):
    jl = jlay.Layout(layout.value)
    rng = np.random.default_rng(len(layout.value))
    assert tlay.parallelism_groups(layout) == jlay.parallelism_groups(jl)
    for rows in (64, 200):
        total = tlay.total_pages(layout, rows)
        pages = np.unique(np.concatenate([
            [0, rows - 1, rows, total - 1],
            rng.integers(0, total, 24)]))
        for p in pages[pages < total]:
            p = int(p)
            for write in (False, True):
                assert [_acc(a) for a in tlay.plan_line_access(
                    layout, rows, p, write)] == [
                        _acc(a) for a in jlay.plan_line_access(
                            jl, rows, p, write)], (rows, p, write)
                assert tlay.count_device_ops(layout, rows, p, write) == \
                    jlay.count_device_ops(jl, rows, p, write)
            tp, jp = tlay.place_page(layout, rows, p), \
                jlay.place_page(jl, rows, p)
            assert (tp.kind, tp.row0, tp.slices) == \
                (jp.kind, jp.row0, jp.slices)
        for bad in (-1, total):
            with pytest.raises(ValueError):
                tlay.plan_line_access(layout, rows, bad, False)
            with pytest.raises(ValueError):
                tlay.place_page(layout, rows, bad)


def test_interwrap_slices_and_parity_rows_equal_the_reference():
    for s in range(9):
        assert tlay.interwrap_slices(s) == jlay.interwrap_slices(s)
    for bad in (-1, 9):
        with pytest.raises(ValueError):
            tlay.interwrap_slices(bad)
    for rows in (64, 96):
        n_extra = tlay.extra_page_count(tlay.Layout.PARITY, rows)
        for p in range(rows + n_extra):
            assert tlay._parity_row_of_page(tlay.Layout.PARITY, rows, p,
                                            256) == \
                jlay._parity_row_of_page(jlay.Layout.PARITY, rows, p, 256)
        for e in range(n_extra):
            assert tlay._parity_extra_data_row0(rows, n_extra, e, 256) == \
                jlay._parity_extra_data_row0(rows, n_extra, e, 256)


def test_softecc_pool_on_a_cuda_tensor_never_falls_back():
    """A pool whose storage is not on the CPU goes to the kernels (here a
    meta tensor stands in for the card): the SECDED wrapper refuses it."""
    t = tsoft.SoftECCState(torch.zeros((9, 8, W), dtype=torch.int32,
                                       device="meta"), W)
    with pytest.raises((ValueError, RuntimeError, NotImplementedError)):
        tsoft.read_page(t, 0)
