"""The deprecated access shims of the port's pools warn and forward as the
reference's do.

Each of ``read_any``, ``read_any_status``, ``write_any``, ``read_pages``,
``read_pages_status`` and ``write_pages`` on a ``PoolState``, a
``ShadowedPool`` and a ``ShardedPool`` (1 and 4 banks) warns once with
the reference's ``DeprecationWarning`` text and returns what ``read`` /
``write`` return; at one bank (the reference's sharded pool runs there)
and on the local and shadowed pools the results equal the reference's
shims on the same numpy inputs, bit for bit. ``write_any`` leaves the
pool it was called on as it was (the reference's is functional there).
"""
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import pool as jpool
from repro.core.layouts import Layout as JLayout
from repro.faults.shadow import ShadowedPool as JShadow
from repro.shard import make_sharded_pool as jmake_sharded
from repro_torch.core import pool as tpool
from repro_torch.core.layouts import Layout
from repro_torch.faults import ShadowedPool
from repro_torch.kernels import common
from repro_torch.shard import make_sharded_pool

ROWS, BOUNDARY, W = 64, 32, 16
SHIMS = ("read_pages", "read_any", "read_pages_status", "read_any_status",
         "write_pages", "write_any")
NEW = {"read_pages": "read(pages)", "read_any": "read(pages)",
       "read_pages_status": "read(pages, status=True)",
       "read_any_status": "read(pages, status=True)",
       "write_pages": "write(pages, data)", "write_any": "write(pages, data)"}


def _payload(n_pages: int, page_words: int) -> np.ndarray:
    return np.arange(n_pages * page_words, dtype=np.uint32).reshape(
        n_pages, -1)


def _port(kind: str):
    if kind == "local":
        p = tpool.make_pool(ROWS, Layout.INTERWRAP, boundary=BOUNDARY,
                            row_words=W, device="cpu")
    elif kind == "shadowed":
        p = ShadowedPool(tpool.make_pool(ROWS, Layout.INTERWRAP,
                                         boundary=BOUNDARY, row_words=W,
                                         device="cpu"))
    else:
        p = make_sharded_pool(ROWS, Layout.INTERWRAP, boundary=BOUNDARY,
                              row_words=W, num_shards=int(kind[-1]),
                              device="cpu")
    return p.write(np.arange(p.num_pages), _payload(p.num_pages,
                                                     p.page_words))


def _ref(kind: str):
    if kind == "local":
        p = jpool.make_pool(ROWS, JLayout.INTERWRAP, boundary=BOUNDARY,
                            row_words=W)
    elif kind == "shadowed":
        p = JShadow(jpool.make_pool(ROWS, JLayout.INTERWRAP,
                                    boundary=BOUNDARY, row_words=W))
    else:
        p = jmake_sharded(ROWS, JLayout.INTERWRAP, boundary=BOUNDARY,
                          row_words=W, num_shards=1)
    return p.write(np.arange(p.num_pages),
                   jnp.asarray(_payload(p.num_pages, p.page_words)))


def _np(x):
    if isinstance(x, tuple):
        return tuple(_np(t) for t in x)
    return common.to_u32(x) if isinstance(x, torch.Tensor) \
        else np.asarray(x).view(np.uint32)


def _call_once(pool, name, *args):
    """Call shim ``name``; exactly one DeprecationWarning, the reference's
    text."""
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        out = getattr(pool, name)(*args)
    dep = [w for w in caught if issubclass(w.category, DeprecationWarning)]
    assert len(dep) == 1, [str(w.message) for w in dep]
    assert str(dep[0].message) == (
        f"PoolLike.{name} is deprecated; use the unified access API: "
        f"pool.{NEW[name]}")
    return out


@pytest.mark.parametrize("kind", ["local", "shadowed", "sharded1",
                                  "sharded4"])
@pytest.mark.parametrize("name", SHIMS)
def test_shim_warns_once_and_forwards(kind, name):
    pool = _port(kind)
    ids = np.array([0, 5, pool.num_pages - 1, 17])
    if name.startswith("read"):
        want = pool.read(ids, status=name.endswith("status"))
        got = _call_once(pool, name, ids)
        for g, w in zip(_np(got) if isinstance(got, tuple) else [_np(got)],
                        _np(want) if isinstance(want, tuple)
                        else [_np(want)]):
            np.testing.assert_array_equal(g, w)
        return
    blob = torch.full((ids.size, pool.page_words), 7, dtype=torch.int32)
    before = _np(pool.read(np.arange(pool.num_pages)))
    new = _call_once(pool, name, ids, blob)
    np.testing.assert_array_equal(_np(new.read(ids)), _np(blob))
    if name == "write_any" and kind != "shadowed":
        # functional, as the reference's: the old pool is unchanged
        np.testing.assert_array_equal(
            _np(pool.read(np.arange(pool.num_pages))), before)


@pytest.mark.parametrize("kind", ["local", "shadowed", "sharded1"])
def test_shims_equal_the_reference_shims(kind):
    port, ref = _port(kind), _ref(kind)
    ids = np.array([3, 0, port.num_pages - 1, 9])
    for name in ("read_pages", "read_any", "read_pages_status",
                 "read_any_status"):
        got = _call_once(port, name, ids)
        with pytest.warns(DeprecationWarning):
            want = getattr(ref, name)(jnp.asarray(ids))
        got = _np(got) if isinstance(got, tuple) else (_np(got),)
        want = _np(want) if isinstance(want, tuple) else (_np(want),)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.astype(np.int64),
                                          w.astype(np.int64))
    blob = _payload(ids.size, port.page_words) ^ np.uint32(0xA5A5A5A5)
    for name in ("write_pages", "write_any"):
        port = _call_once(port, name, ids, torch.from_numpy(
            blob.view(np.int32)))
        with pytest.warns(DeprecationWarning):
            ref = getattr(ref, name)(jnp.asarray(ids), jnp.asarray(blob))
        store = port.inner.storage if kind == "shadowed" else port.storage
        rstore = ref.inner.storage if kind == "shadowed" else ref.storage
        np.testing.assert_array_equal(
            common.to_u32(store).reshape(-1),
            np.asarray(rstore).reshape(-1))
