"""The port's InterWrap page gather / scatter equal the reference bit for bit.

  * ``kernels/interwrap/ref.py`` against the reference's Pallas kernel (in
    interpret mode on the CPU) and its jnp oracle, on every page id of the
    pool, extras included;
  * whole-pool InterWrap ``read_pages_batch(_status)`` /
    ``write_pages_batch`` against ``repro.core.pool`` on the same numpy
    inputs;
  * the dispatch rule: a whole-pool InterWrap pool moves its pages through
    :mod:`repro_torch.kernels.interwrap.ops` and nothing else, while
    SECDED, PARITY and mixed pools keep their routes;
  * the scatter contract: a write whose batch names a page twice hands the
    op distinct ids, and the last valid row lands, as in the reference.

The CUDA kernels themselves run on the card (``chip_smoke.py``).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import layouts as jl
from repro.core import pool as jp
from repro.kernels.interwrap import kernel as jkernel
from repro.kernels.interwrap import ref as jref
from repro_torch.core import layouts as tl
from repro_torch.core import pool as tp
from repro_torch.kernels import common
from repro_torch.kernels.interwrap import ops
from repro_torch.kernels.interwrap import ref

RNG = np.random.default_rng(14)


def _words(shape) -> np.ndarray:
    return RNG.integers(0, 2**32, size=shape, dtype=np.uint32)


@pytest.mark.parametrize("W", [8, 64])
@pytest.mark.parametrize("rows", [8, 16, 64])
def test_ref_equals_the_reference_kernel_and_oracle(rows, W):
    storage = _words((rows, 9, W))
    ids = RNG.permutation(rows + rows // 8).astype(np.int32)   # every page
    t_sto = common.to_words(storage)
    got = ops.gather(t_sto, torch.as_tensor(ids), rows)
    for want in (jkernel.gather(jnp.asarray(storage), jnp.asarray(ids), rows),
                 jref.gather(jnp.asarray(storage), jnp.asarray(ids), rows)):
        np.testing.assert_array_equal(common.to_u32(got), np.asarray(want))
    data = _words((ids.size, 8 * W))
    t_out = ops.scatter(t_sto.clone(), torch.as_tensor(ids),
                        common.to_words(data), rows)
    for want in (jkernel.scatter(jnp.asarray(storage), jnp.asarray(ids),
                                 jnp.asarray(data), rows),
                 jref.scatter(jnp.asarray(storage), jnp.asarray(ids),
                              jnp.asarray(data), rows)):
        np.testing.assert_array_equal(common.to_u32(t_out), np.asarray(want))


def test_wrap_coords_equal_the_reference_and_page_coords():
    rows = 64
    ids = np.arange(rows + rows // 8)
    want = jref.wrap_coords(jnp.asarray(ids, jnp.int32), rows)
    got = ref.wrap_coords(torch.as_tensor(ids), rows)
    for w, g in zip(want, got, strict=True):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    # whole-pool InterWrap: the kernels' translation is page_coords'
    rows_pc, lanes_pc, _ = tl.page_coords(tl.Layout.INTERWRAP, rows, rows,
                                          torch.as_tensor(ids), 64)
    assert torch.equal(rows_pc, got[0]) and torch.equal(lanes_pc, got[1])


def test_ops_check_shapes_and_contiguity():
    sto = torch.zeros((16, 9, 8), dtype=torch.int32)
    pages = torch.arange(4)
    with pytest.raises(ValueError, match="storage"):
        ops.gather(sto[:8], pages, 16)
    with pytest.raises(ValueError, match="data must be"):
        ops.scatter(sto, pages, torch.zeros((3, 64), dtype=torch.int32), 16)
    with pytest.raises(ValueError, match="contiguous"):
        ops.gather(sto.transpose(0, 2).contiguous().transpose(0, 2), pages,
                   16)


ROWS, W = 32, 64


def _pair():
    j = jp.make_pool(ROWS, jl.Layout.INTERWRAP, boundary=None, row_words=W)
    t = tp.make_pool(ROWS, tl.Layout.INTERWRAP, boundary=None, row_words=W,
                     device="cpu")
    return j, t


def _same_storage(j, t) -> None:
    np.testing.assert_array_equal(common.to_u32(t.storage),
                                  np.asarray(j.storage))


def test_whole_interwrap_batch_access_equals_the_reference():
    j, t = _pair()
    n_pages = j.num_pages
    assert t.num_pages == n_pages == ROWS + ROWS // 8
    for step in range(4):
        ids = RNG.choice(n_pages, size=12, replace=False)
        data = _words((ids.size, 8 * W))
        j = jp.write_pages_batch(j, jnp.asarray(ids, jnp.int32),
                                 jnp.asarray(data))
        t = tp.write_pages_batch(t, ids, common.to_words(data))
        _same_storage(j, t)
        probe = RNG.choice(n_pages, size=16, replace=False)
        np.testing.assert_array_equal(
            common.to_u32(tp.read_pages_batch(t, probe)),
            np.asarray(jp.read_pages_batch(j, jnp.asarray(probe, jnp.int32))))
        tdata, tstatus = tp.read_pages_batch_status(t, probe)
        jdata, jstatus = jp.read_pages_batch_status(
            j, jnp.asarray(probe, jnp.int32))
        np.testing.assert_array_equal(common.to_u32(tdata), np.asarray(jdata))
        np.testing.assert_array_equal(tstatus.numpy(), np.asarray(jstatus))
        assert int(tstatus.abs().sum()) == 0


def test_batch_access_refuses_mixed_pools_as_the_reference_does():
    for boundary in (8, 16):
        j = jp.make_pool(ROWS, jl.Layout.INTERWRAP, boundary=boundary,
                         row_words=W)
        t = tp.make_pool(ROWS, tl.Layout.INTERWRAP, boundary=boundary,
                         row_words=W, device="cpu")
        for fn, pool in ((jp.read_pages_batch, j), (tp.read_pages_batch, t)):
            with pytest.raises(ValueError, match="single-mode"):
                fn(pool, [0])
    # an all-SECDED pool is single-mode too, and decodes on load
    j = jp.make_pool(ROWS, jl.Layout.INTERWRAP, boundary=0, row_words=W)
    t = tp.make_pool(ROWS, tl.Layout.INTERWRAP, boundary=0, row_words=W,
                     device="cpu")
    data = _words((3, 8 * W))
    j = jp.write_pages_batch(j, jnp.asarray([1, 5, 9], jnp.int32),
                             jnp.asarray(data))
    t = tp.write_pages_batch(t, [1, 5, 9], common.to_words(data))
    _same_storage(j, t)


class _Spy:
    """Records the ids each InterWrap op was handed, then runs it."""

    def __init__(self, monkeypatch):
        self.gathers: list[np.ndarray] = []
        self.scatters: list[np.ndarray] = []
        gather, scatter = ops.gather, ops.scatter

        def spy_gather(storage, pages, num_rows):
            self.gathers.append(pages.numpy().copy())
            return gather(storage, pages, num_rows)

        def spy_scatter(storage, pages, data, num_rows):
            self.scatters.append(pages.numpy().copy())
            return scatter(storage, pages, data, num_rows)
        monkeypatch.setattr(ops, "gather", spy_gather)
        monkeypatch.setattr(ops, "scatter", spy_scatter)


@pytest.mark.parametrize("layout,boundary,routed", [
    (tl.Layout.INTERWRAP, None, True),
    (tl.Layout.INTERWRAP, 0, False),            # all SECDED
    (tl.Layout.INTERWRAP, 16, False),           # mixed
    (tl.Layout.PARITY, 16, False),
    (tl.Layout.PARITY, ROWS, False),
    (tl.Layout.PACKED, ROWS, False),
], ids=["interwrap-whole", "secded", "interwrap-mixed", "parity-mixed",
        "parity-whole", "packed-whole"])
def test_only_whole_interwrap_pools_route_through_the_ops(
        layout, boundary, routed, monkeypatch):
    spy = _Spy(monkeypatch)
    pool = tp.make_pool(ROWS, layout, boundary=boundary, row_words=W,
                        device="cpu")
    ids = np.arange(pool.num_pages)[::3]
    data = _words((ids.size, 8 * W))
    pool = pool.write(ids, common.to_words(data))
    got = pool.read(ids)
    np.testing.assert_array_equal(common.to_u32(got), data)
    if routed:
        assert len(spy.gathers) == 1 and len(spy.scatters) == 1
        np.testing.assert_array_equal(spy.scatters[0], ids)
        np.testing.assert_array_equal(spy.gathers[0], ids)
    else:
        assert not spy.gathers and not spy.scatters


def test_duplicate_ids_reach_the_scatter_once_and_the_last_valid_row_lands(
        monkeypatch):
    spy = _Spy(monkeypatch)
    j, t = _pair()
    ids = np.asarray([20, 3, 20, ROWS, 3, 20, ROWS + 1], np.int32)
    data = _words((ids.size, 8 * W))
    valid = np.asarray([True, True, True, True, True, False, True])
    j = jp.write_pages_any(j, jnp.asarray(ids), jnp.asarray(data),
                           valid=jnp.asarray(valid))
    t = t.write(ids, common.to_words(data), valid=torch.as_tensor(valid))
    assert len(spy.scatters) == 1
    handed = spy.scatters[0]
    assert len(set(handed.tolist())) == handed.size == 4
    _same_storage(j, t)
    np.testing.assert_array_equal(common.to_u32(t.read([20, 3, ROWS])),
                                  data[[2, 4, 3]])
