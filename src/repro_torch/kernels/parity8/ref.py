"""Plain PyTorch version of the parity8 kernels — the codec delegates to
:mod:`repro_torch.core.parity8` (as ``repro/kernels/parity8/ref.py`` does);
the PARITY pool's write is the chain of eager ops the kernel fuses."""
from __future__ import annotations

import torch

from repro_torch.core import parity8 as _p
from repro_torch.core.layouts import (CODE_LANE, DATA_LANES, REGION_SECDED,
                                      Layout, page_coords, parity_coords)


def encode(data: torch.Tensor) -> torch.Tensor:
    """(N, D) words, D % 64 == 0 -> (N, D//64) packed parity bytes."""
    return _p.encode_lines_packed(data)


def check(data: torch.Tensor, parity: torch.Tensor) -> torch.Tensor:
    """(N, D), (N, D//64) -> per-line status (N, D//16)."""
    return _p.check_lines_packed(data, parity)


def write(storage: torch.Tensor, pages: torch.Tensor, data: torch.Tensor,
          boundary: int) -> torch.Tensor:
    """Land ``(n, 8W)`` pages in a PARITY pool's storage in place: the
    :func:`page_coords` scatter of every page's slices, then the packed
    parity of the CREAM and extra pages scattered into their table slots
    (SECDED pages have none). Returns ``storage``."""
    num_rows, _, W = storage.shape
    rows, lanes, region = page_coords(Layout.PARITY, num_rows, boundary,
                                      pages, W)
    storage[rows, lanes, :] = data.reshape(-1, DATA_LANES, W)
    keep = region != REGION_SECDED
    prow, off = parity_coords(num_rows, boundary, pages[keep], W)
    idx = off[:, None] + torch.arange(W // 8, device=pages.device)
    storage[prow[:, None], CODE_LANE, idx] = encode(data[keep])
    return storage
