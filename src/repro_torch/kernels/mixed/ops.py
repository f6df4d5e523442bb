"""Fused mixed-pool reads: the dispatching wrappers.

A CPU pool takes the plain version (:mod:`.ref`); a CUDA pool launches
the kernel in ``csrc/mixed.cu`` or raises. There is no fallback.
"""
from __future__ import annotations

import torch

from repro_torch.core.layouts import (DATA_LANES, LANES, Layout,
                                      extra_base_row)
from repro_torch.kernels import common
from repro_torch.kernels.mixed import ref


def read_correct(storage: torch.Tensor, pages: torch.Tensor, layout: Layout,
                 num_rows: int, boundary: int) -> torch.Tensor:
    """(R, 9, W) pool, (n,) page ids -> (n, 8W) corrected page data.

    Page ids must be in range (the pool validates them on the host); the
    kernel clamps rows into the pool all the same, so a stray id can never
    read outside the storage.
    """
    if storage.dim() != 3 or storage.shape[1] != LANES \
            or storage.shape[0] != num_rows or storage.shape[2] % 8:
        raise ValueError(f"expected ({num_rows}, 9, W) storage with W % 8 "
                         f"== 0, got {tuple(storage.shape)}")
    if pages.dim() != 1:
        raise ValueError("pages must be a 1-D id vector")
    common.check_contiguous("mixed_read_correct", storage, pages)
    if storage.device.type == "cpu" and pages.device.type == "cpu":
        return ref.read_correct(storage, pages, layout, num_rows, boundary)
    W = storage.shape[2]
    pages = pages.to(torch.int32)
    common.check_cuda_words("mixed_read_correct", storage, pages)
    n = pages.shape[0]
    out = torch.empty((n, DATA_LANES * W), dtype=torch.int32,
                      device=storage.device)
    if n:
        common.launch("mixed_read_correct", storage, pages, out, n, W,
                      int(layout == Layout.INTERWRAP), num_rows, boundary,
                      extra_base_row(layout, boundary, W))
    return out


def read_correct_routed(storage: torch.Tensor, pages: torch.Tensor,
                        layout: Layout, num_rows: int, boundary: int,
                        num_shards: int) -> torch.Tensor:
    """Router-fused read of global page ids from ``(S, R_local, 9, W)``
    banks -> ``(n, 8W)`` corrected page data, each page from its own bank,
    in one launch.

    ``num_rows`` / ``boundary`` are the global geometry (``S * R_local``,
    ``S * b_local``). Page ids must be in range (the pool validates them
    on the host); the kernel clamps banks and rows all the same.
    """
    S = num_shards
    if storage.dim() != 4 or storage.shape[0] != S \
            or storage.shape[2] != LANES or S * storage.shape[1] != num_rows \
            or storage.shape[3] % 8:
        raise ValueError(f"expected ({S}, {num_rows // max(S, 1)}, 9, W) "
                         f"storage with W % 8 == 0, got "
                         f"{tuple(storage.shape)}")
    if boundary % S:
        raise ValueError(f"boundary {boundary} must split over {S} banks")
    if pages.dim() != 1:
        raise ValueError("pages must be a 1-D id vector")
    common.check_contiguous("mixed_read_correct_routed", storage, pages)
    if storage.device.type == "cpu" and pages.device.type == "cpu":
        return ref.read_correct_routed(storage, pages, layout, num_rows,
                                       boundary, S)
    W = storage.shape[3]
    pages = pages.to(torch.int32)
    common.check_cuda_words("mixed_read_correct_routed", storage, pages)
    n = pages.shape[0]
    out = torch.empty((n, DATA_LANES * W), dtype=torch.int32,
                      device=storage.device)
    if n:
        b_local = boundary // S
        common.launch("mixed_read_correct_routed", storage, pages, out, n, W,
                      int(layout == Layout.INTERWRAP), num_rows, S, b_local,
                      extra_base_row(layout, b_local, W))
    return out
