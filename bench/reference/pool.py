"""The CREAM pool's page layout, read and write, written plainly.

A pool is ``(R, 9, W)`` int32 words: R rows of 9 lanes (8 data lanes and
the code lane), W words a lane. Rows ``[boundary, R)`` are SECDED rows: a
page there is its row's 8 data lanes, and the code lane holds their check
bytes. Below the boundary the layout is InterWrap (the paper's §4.1.3): in
each group of 8 rows the 72 (row, lane) slices are numbered ``l = 9 * row
+ lane`` and page slot ``s`` of the group owns slices ``8s .. 8s + 7``;
slots 0-7 are the group's 8 regular pages and slot 8 is its extra page,
whose id is ``R + group``. Page data is the slices' words in that order.
"""
from __future__ import annotations

import torch

from reference import secded

LANES, DATA_LANES, CODE_LANE, GROUP = 9, 8, 8, 8


def coords(pages: torch.Tensor, num_rows: int, boundary: int):
    """Page ids (n,) -> (rows (n, 8), lanes (n, 8), is_secded (n,))."""
    pages = pages.long()
    k = torch.arange(DATA_LANES, device=pages.device)
    extra = pages >= num_rows
    is_sec = (pages >= boundary) & ~extra
    group = torch.where(extra, pages - num_rows, pages // GROUP)
    slot = torch.where(extra, GROUP, pages % GROUP)
    linear = DATA_LANES * slot[:, None] + k[None, :]
    rows = torch.where(is_sec[:, None], pages[:, None],
                       GROUP * group[:, None] + linear // LANES)
    lanes = torch.where(is_sec[:, None], k[None, :], linear % LANES)
    return rows, lanes, is_sec


def read(storage: torch.Tensor, pages: torch.Tensor, num_rows: int,
         boundary: int) -> torch.Tensor:
    """(n, 8W) page data, SECDED pages corrected against their codes."""
    w = storage.shape[2]
    rows, lanes, is_sec = coords(pages, num_rows, boundary)
    data = storage[rows, lanes].reshape(len(pages), DATA_LANES * w)
    if is_sec.any():
        sec = torch.nonzero(is_sec).squeeze(1)
        fixed, _ = secded.decode_block(
            data[sec], storage[pages[sec].long(), CODE_LANE])
        data[sec] = fixed
    return data


def write(storage: torch.Tensor, pages: torch.Tensor, data: torch.Tensor,
          num_rows: int, boundary: int) -> None:
    """Write pages in place, codes of SECDED pages with them. Of repeated
    ids the last one lands."""
    pages = pages.long()
    n = len(pages)
    last = torch.ones(n, dtype=torch.bool, device=pages.device)
    order = torch.argsort(pages, stable=True)
    sp = pages[order]
    last[order[:-1]] = sp[:-1] != sp[1:]
    pages, data = pages[last], data[last]
    w = storage.shape[2]
    rows, lanes, is_sec = coords(pages, num_rows, boundary)
    storage[rows, lanes] = data.reshape(len(pages), DATA_LANES, w)
    if is_sec.any():
        sec = torch.nonzero(is_sec).squeeze(1)
        storage[pages[sec], CODE_LANE] = secded.encode_block(data[sec])
