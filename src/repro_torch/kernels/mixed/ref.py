"""Plain PyTorch version of the fused mixed-pool read.

Exactly the data path of :func:`repro_torch.core.pool.read_pages_any`:
one :func:`~repro_torch.core.layouts.page_coords` gather, then the SECDED
correction of the pages in the protected region. Parity is detection-only
and never alters data, so the fused read's contract is data-only.
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
