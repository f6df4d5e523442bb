"""Plain PyTorch versions of the fused mixed-pool reads.

:func:`read_correct` is exactly the data path of
:func:`repro_torch.core.pool.read_pages_any`: one
:func:`~repro_torch.core.layouts.page_coords` gather, then the SECDED
correction of the pages in the protected region. Parity is detection-only
and never alters data, so the fused read's contract is data-only.
:func:`read_correct_routed` is its sharded form: the shard router, then
:func:`read_correct` on each bank's local geometry.
"""
from __future__ import annotations

import torch

from repro_torch.core import secded
from repro_torch.core.layouts import (CODE_LANE, REGION_SECDED, Layout,
                                      page_coords)


def read_correct(storage: torch.Tensor, pages: torch.Tensor, layout: Layout,
                 num_rows: int, boundary: int) -> torch.Tensor:
    """(R, 9, W) pool, (n,) page ids -> (n, 8W) decode-corrected page data."""
    pages = pages.long()
    n = pages.shape[0]
    rows, lanes, region = page_coords(layout, num_rows, boundary, pages,
                                      storage.shape[2])
    data = storage[rows, lanes, :].reshape(n, -1)
    if boundary < num_rows:
        crow = torch.clamp(pages, boundary, num_rows - 1)
        fixed, _, _ = secded.decode_block(data, storage[crow, CODE_LANE, :])
        data = torch.where((region == REGION_SECDED)[:, None], fixed, data)
    return data


def read_correct_routed(storage: torch.Tensor, pages: torch.Tensor,
                        layout: Layout, num_rows: int, boundary: int,
                        num_shards: int) -> torch.Tensor:
    """(S, R_local, 9, W) banks, (n,) global page ids -> (n, 8W) data.

    Two passes: the router's global id -> (bank, local id), then
    :func:`read_correct` of each bank's owned local ids against the bank's
    local geometry (``num_rows`` / ``boundary`` are global); every row
    comes from its own bank, the sum of the reference's per-bank outputs.
    """
    from repro_torch.shard import router      # shard/ sits above kernels/
    shard, local = router.route(pages, num_rows, num_shards)
    rows_local, b_local = num_rows // num_shards, boundary // num_shards
    out = None
    for s in range(num_shards):
        owned = shard == s
        data = read_correct(storage[s], torch.where(owned, local, 0), layout,
                            rows_local, b_local)
        out = torch.where(owned[:, None], data,
                          0 if out is None else out)
    return out
