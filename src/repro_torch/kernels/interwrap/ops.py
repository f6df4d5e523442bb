"""InterWrap page gather / scatter: the dispatching wrappers.

A CPU pool takes the plain version (:mod:`.ref`); a CUDA pool launches the
kernels in ``csrc/interwrap.cu`` or raises. There is no fallback.
"""
from __future__ import annotations

import torch

from repro_torch.core.layouts import DATA_LANES, LANES
from repro_torch.kernels import common
from repro_torch.kernels.interwrap import ref


def _check(name: str, storage: torch.Tensor, pages: torch.Tensor,
           num_rows: int) -> None:
    if storage.dim() != 3 or storage.shape[1] != LANES \
            or storage.shape[0] != num_rows or storage.shape[2] % 8:
        raise ValueError(f"{name}: expected ({num_rows}, 9, W) storage with "
                         f"W % 8 == 0, got {tuple(storage.shape)}")
    if pages.dim() != 1:
        raise ValueError(f"{name}: pages must be a 1-D id vector")


def gather(storage: torch.Tensor, pages: torch.Tensor,
           num_rows: int) -> torch.Tensor:
    """(R, 9, W) pool, (n,) page ids -> (n, 8W) page data.

    Page ids must lie in ``[0, R + R/8)`` (the pool validates them on the
    host); the kernel clamps rows into the pool all the same.
    """
    _check("interwrap_gather", storage, pages, num_rows)
    common.check_contiguous("interwrap_gather", storage, pages)
    if storage.device.type == "cpu" and pages.device.type == "cpu":
        return ref.gather(storage, pages, num_rows)
    pages = pages.to(torch.int32)
    common.check_cuda_words("interwrap_gather", storage, pages)
    n, W = pages.shape[0], storage.shape[2]
    out = torch.empty((n, DATA_LANES * W), dtype=torch.int32,
                      device=storage.device)
    if n:
        common.launch("interwrap_gather", storage, pages, out, n, W, num_rows)
    return out


def scatter(storage: torch.Tensor, pages: torch.Tensor, data: torch.Tensor,
            num_rows: int) -> torch.Tensor:
    """Write (n, 8W) pages into the (R, 9, W) pool in place; returns it.

    Contract: the ids in ``pages`` are distinct. Two slices landing on one
    cell would race on the card (the plain version keeps an unspecified
    one), and checking on the device would cost a sync per write; the pool
    lands only the last valid row of each page before it calls this.
    """
    _check("interwrap_scatter", storage, pages, num_rows)
    n, W = pages.shape[0], storage.shape[2]
    if data.shape != (n, DATA_LANES * W):
        raise ValueError(f"interwrap_scatter: data must be "
                         f"{(n, DATA_LANES * W)}, got {tuple(data.shape)}")
    common.check_contiguous("interwrap_scatter", storage, pages, data)
    if storage.device.type == "cpu" and pages.device.type == "cpu" \
            and data.device.type == "cpu":
        return ref.scatter(storage, pages, data, num_rows)
    pages = pages.to(torch.int32)
    common.check_cuda_words("interwrap_scatter", storage, pages, data)
    if n:
        common.launch("interwrap_scatter", storage, pages, data, n, W,
                      num_rows)
    return storage
