"""Plain PyTorch versions of the fused mixed-pool reads.

:func:`read_correct` is exactly the data path of
:func:`repro_torch.core.pool.read_pages_any`: one
:func:`~repro_torch.core.layouts.page_coords` gather, then the SECDED
correction of the pages in the protected region. Parity is detection-only
and never alters data, so the fused read's contract is data-only.
:func:`read_correct_routed` is its sharded form: the shard router, then
:func:`read_correct` on each bank's local geometry;
:func:`read_correct_routed_local` is one bank's share of it, the other
banks' rows zero.
"""
from __future__ import annotations

import torch

from repro_torch.core import secded
from repro_torch.core.layouts import (CODE_LANE, REGION_SECDED, Layout,
                                      page_coords)


def read_correct(storage: torch.Tensor, pages: torch.Tensor, layout: Layout,
                 num_rows: int, boundary: int, status: bool = False):
    """(R, 9, W) pool, (n,) page ids -> (n, 8W) decode-corrected page data,
    or with ``status=True`` ``(data, status (n,) int32)``: each page's
    worst beat status, 0 outside the SECDED region — the status of
    ``read_pages_any_status`` on every layout but PARITY, whose parity
    check this read does not run."""
    pages = pages.long()
    n = pages.shape[0]
    rows, lanes, region = page_coords(layout, num_rows, boundary, pages,
                                      storage.shape[2])
    data = storage[rows, lanes, :].reshape(n, -1)
    if boundary >= num_rows:
        return (data, torch.zeros((n,), dtype=torch.int32,
                                  device=storage.device)) if status else data
    crow = torch.clamp(pages, boundary, num_rows - 1)
    fixed, _, beats = secded.decode_block(data, storage[crow, CODE_LANE, :])
    is_sec = region == REGION_SECDED
    data = torch.where(is_sec[:, None], fixed, data)
    if not status:
        return data
    return data, torch.where(is_sec, beats.amax(dim=-1), 0).to(torch.int32)


def read_correct_routed(storage: torch.Tensor, pages: torch.Tensor,
                        layout: Layout, num_rows: int, boundary: int,
                        num_shards: int, status: bool = False):
    """(S, R_local, 9, W) banks, (n,) global page ids -> (n, 8W) data, or
    with ``status=True`` ``(data, status (n,) int32)``.

    Two passes: the router's global id -> (bank, local id), then
    :func:`read_correct` of each bank's owned local ids against the bank's
    local geometry (``num_rows`` / ``boundary`` are global); every row
    and status comes from its own bank, the sum of the reference's
    per-bank outputs.
    """
    from repro_torch.shard import router      # shard/ sits above kernels/
    shard, local = router.route(pages, num_rows, num_shards)
    rows_local, b_local = num_rows // num_shards, boundary // num_shards
    out = st = None
    for s in range(num_shards):
        owned = shard == s
        data, beats = read_correct(storage[s], torch.where(owned, local, 0),
                                   layout, rows_local, b_local, status=True)
        out = torch.where(owned[:, None], data, 0 if out is None else out)
        st = torch.where(owned, beats, 0 if st is None else st)
    return (out, st.to(torch.int32)) if status else out


def read_correct_routed_local(bank: torch.Tensor, pages: torch.Tensor,
                              layout: Layout, num_rows: int, boundary: int,
                              num_shards: int, shard_id: int,
                              status: bool = False):
    """Bank ``shard_id``'s ``(R_local, 9, W)`` storage, ``(n,)`` global
    page ids -> ``(n, 8W)`` data, or with ``status=True`` ``(data, status
    (n,) int32)``: :func:`read_correct` of the bank's owned local ids on
    its local geometry, every other bank's row and status zero (the
    reference's ``read_correct_routed`` of one shard)."""
    from repro_torch.shard import router      # shard/ sits above kernels/
    shard, local = router.route(pages, num_rows, num_shards)
    owned = shard == shard_id
    data, beats = read_correct(bank, torch.where(owned, local, 0), layout,
                               num_rows // num_shards,
                               boundary // num_shards, status=True)
    data = torch.where(owned[:, None], data, 0)
    if not status:
        return data
    return data, torch.where(owned, beats, 0).to(torch.int32)
