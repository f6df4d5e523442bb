"""Fused probe + gather read: the dispatching wrapper.

A CPU pool takes the plain version (:mod:`.ref`); a CUDA pool launches the
kernel in ``csrc/hash.cu`` or raises. There is no fallback.
"""
from __future__ import annotations

import torch

from repro_torch.core.layouts import (DATA_LANES, LANES, Layout,
                                      extra_base_row)
from repro_torch.kernels import common
from repro_torch.kernels.hash import ref


def lookup_read(storage: torch.Tensor, slot_keys: torch.Tensor,
                slot_pages: torch.Tensor, queries: torch.Tensor,
                layout: Layout, num_rows: int, boundary: int,
                probe: int) -> torch.Tensor:
    """(R, 9, W) pool, (C,) slot keys and pages, (n,) int32 key bits ->
    (n, 8W) page data of each key's slot (page 0 for an absent key),
    SECDED pages corrected."""
    if storage.dim() != 3 or storage.shape[1] != LANES \
            or storage.shape[0] != num_rows or storage.shape[2] % 8:
        raise ValueError(f"expected ({num_rows}, 9, W) storage with W % 8 "
                         f"== 0, got {tuple(storage.shape)}")
    capacity = slot_keys.shape[0]
    if slot_keys.dim() != 1 or slot_pages.shape != (capacity,) \
            or queries.dim() != 1:
        raise ValueError("slot keys/pages must be (C,) and queries (n,)")
    if not 1 <= probe <= capacity:
        raise ValueError(f"bad probe window {probe} for capacity {capacity}")
    operands = (storage, slot_keys, slot_pages, queries)
    common.check_contiguous("hash_lookup_read", *operands)
    if all(t.device.type == "cpu" for t in operands):
        return ref.lookup_read(storage, slot_keys, slot_pages, queries,
                               layout, num_rows, boundary, probe)
    common.check_cuda_words("hash_lookup_read", *operands)
    W = storage.shape[2]
    n = queries.shape[0]
    out = torch.empty((n, DATA_LANES * W), dtype=torch.int32,
                      device=storage.device)
    if n:
        common.launch("hash_lookup_read", storage, slot_keys, slot_pages,
                      queries, out, n, W, capacity, probe,
                      int(layout == Layout.INTERWRAP), num_rows, boundary,
                      extra_base_row(layout, boundary, W))
    return out
