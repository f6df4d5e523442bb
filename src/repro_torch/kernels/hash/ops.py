"""Fused probe + gather read: the dispatching wrapper.

A CPU pool takes the plain version (:mod:`.ref`); a CUDA pool launches the
kernel in ``csrc/hash.cu`` (its vector or word-granular entry, by W) or
raises. There is no fallback.
"""
from __future__ import annotations

from typing import TYPE_CHECKING

import torch

from repro_torch.core.layouts import (DATA_LANES, LANES, Layout,
                                      extra_base_row)
from repro_torch.kernels import common
from repro_torch.kernels.hash import ref

if TYPE_CHECKING:      # core/ and objcache/ import the kernels
    from repro_torch.core.pool import PoolState
    from repro_torch.objcache.hash_index import HashIndex


def lookup_read(storage: torch.Tensor, slot_keys: torch.Tensor,
                slot_pages: torch.Tensor, queries: torch.Tensor,
                layout: Layout, num_rows: int, boundary: int,
                probe: int,
                *, use_kernel: bool | None = None) -> torch.Tensor:
    """(R, 9, W) pool, (C,) slot keys and pages, (n,) int32 key bits ->
    (n, 8W) page data of each key's slot (page 0 for an absent key),
    SECDED pages corrected."""
    if storage.dim() != 3 or storage.shape[1] != LANES \
            or storage.shape[0] != num_rows:
        raise ValueError(f"expected ({num_rows}, 9, W) storage, got "
                         f"{tuple(storage.shape)}")
    capacity = slot_keys.shape[0]
    if slot_keys.dim() != 1 or slot_pages.shape != (capacity,) \
            or queries.dim() != 1:
        raise ValueError("slot keys/pages must be (C,) and queries (n,)")
    if not 1 <= probe <= capacity:
        raise ValueError(f"bad probe window {probe} for capacity {capacity}")
    operands = (storage, slot_keys, slot_pages, queries)
    common.check_contiguous("hash_lookup_read", *operands)
    W, n = storage.shape[2], queries.shape[0]
    if n == 0:
        return common.empty_words(storage, 0, DATA_LANES * W)
    if all(t.device.type == "cpu" for t in operands):
        return ref.lookup_read(storage, slot_keys, slot_pages, queries,
                               layout, num_rows, boundary, probe)
    common.check_cuda_words("hash_lookup_read", *operands, W=W)
    out = common.empty_words(storage, n, DATA_LANES * W)
    common.launch_for_width("hash_lookup_read", W, storage, slot_keys,
                            slot_pages, queries, out, n, W, capacity, probe,
                            int(layout == Layout.INTERWRAP), num_rows,
                            boundary, extra_base_row(layout, boundary, W))
    return out


def lookup_pool(state: PoolState, index: HashIndex,
                queries: torch.Tensor, *,
                use_kernel: bool | None = None) -> torch.Tensor:
    """:func:`lookup_read` of a :class:`~repro_torch.core.pool.PoolState`
    and a :class:`~repro_torch.objcache.hash_index.HashIndex`."""
    return lookup_read(state.storage, index.key, index.page, queries,
                       state.layout, state.num_rows, state.boundary,
                       index.probe)
