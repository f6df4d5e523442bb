"""parity8 encode / check and the PARITY pool's write: the dispatching
wrappers.

A CPU tensor takes the plain version (:mod:`.ref`); a CUDA tensor launches
the kernel in ``csrc/parity8.cu`` or raises. There is no fallback.

Widths: these keep the reference's PARITY rule on both devices. Parity
bytes pack four to a word, so a block must hold a multiple of 4 lines (D
% 64 == 0, a pool's W % 8 == 0). The reference's encode and pool write
refuse other blocks with a ``ValueError``; its check of a block of whole
lines (D % 16 == 0) fails on the shapes of its XOR with a ``TypeError``,
and so does :func:`check` here.
"""
from __future__ import annotations

import torch

from repro_torch.core.layouts import (DATA_LANES, LANES, Layout,
                                      extra_base_row, parity_table_rows)
from repro_torch.kernels import common
from repro_torch.kernels.parity8 import ref


def _check(data: torch.Tensor) -> tuple[int, int]:
    if data.dim() != 2 or data.shape[1] % 64:
        raise ValueError(f"expected (N, D) words with D % 64 == 0, got "
                         f"{tuple(data.shape)}")
    return data.shape[0], data.shape[1]


def encode(data: torch.Tensor,
           *, use_kernel: bool | None = None) -> torch.Tensor:
    """(N, D) int32 words -> (N, D//64) packed parity bytes."""
    n, d = _check(data)
    common.check_contiguous("parity8_encode", data)
    if n == 0:
        return common.empty_words(data, 0, d // 64)
    if data.device.type == "cpu":
        return ref.encode(data)
    common.check_cuda_words("parity8_encode", data)
    parity = common.empty_words(data, n, d // 64)
    common.launch("parity8_encode", data, parity, n * d // 4)
    return parity


def check(data: torch.Tensor, parity: torch.Tensor,
          *, use_kernel: bool | None = None) -> torch.Tensor:
    """(N, D), (N, D//64) -> per-line status (N, D//16) int32: 0 ok,
    1 corrupt."""
    if data.dim() != 2 or data.shape[1] % 16:
        raise ValueError(f"expected (N, D) words with D % 16 == 0, got "
                         f"{tuple(data.shape)}")
    n, d = data.shape
    if parity.shape != (n, d // 64):
        raise ValueError(f"parity must be {(n, d // 64)}, got "
                         f"{tuple(parity.shape)}")
    if d % 64:
        raise TypeError(f"incompatible shapes: {d // 16} line parities "
                        f"against {4 * (d // 64)} packed ones")
    common.check_contiguous("parity8_check", data, parity)
    if n == 0:
        return common.empty_words(data, 0, d // 16)
    if data.device.type == "cpu" and parity.device.type == "cpu":
        return ref.check(data, parity)
    common.check_cuda_words("parity8_check", data, parity)
    status = common.empty_words(data, n, d // 16)
    common.launch("parity8_check", data, parity, status, n * d // 4)
    return status


def write(storage: torch.Tensor, pages: torch.Tensor, data: torch.Tensor,
          boundary: int,
          *, use_kernel: bool | None = None) -> torch.Tensor:
    """Land ``(n, 8W)`` pages in a PARITY pool's ``(R, 9, W)`` storage in
    place, with the packed parity of its CREAM and extra pages; returns
    ``storage``. On the card this is one launch: each page is read once,
    its eight slices stored at their rows and lanes and, unless it is a
    SECDED page, its parity folded from the same registers into its slot
    of the code-lane tables. SECDED pages' codes are the caller's. The
    kernel reads the ids as int64, as the pool uploads them.

    Contract: the ids are distinct and in range. Two pages landing on one
    cell would race on the card, and the kernel does not clamp; the pool
    checks ids on the host and lands one row per page first
    (:func:`repro_torch.core.pool._landing_rows`).
    """
    if storage.dim() != 3 or storage.shape[1] != LANES \
            or storage.shape[2] % 8:
        raise ValueError(f"parity8_write: expected (R, 9, W) storage with "
                         f"W % 8 == 0, got {tuple(storage.shape)}")
    if pages.dim() != 1:
        raise ValueError("parity8_write: pages must be a 1-D id vector")
    (num_rows, _, W), n = storage.shape, pages.shape[0]
    if data.shape != (n, DATA_LANES * W):
        raise ValueError(f"parity8_write: data must be "
                         f"{(n, DATA_LANES * W)}, got {tuple(data.shape)}")
    common.check_contiguous("parity8_write", storage, pages, data)
    if n == 0:
        return storage
    if storage.device.type == "cpu" and pages.device.type == "cpu" \
            and data.device.type == "cpu":
        return ref.write(storage, pages, data, boundary)
    common.check_cuda_words("parity8_write", storage, data)
    if pages.device != storage.device:
        raise ValueError("parity8_write: operands must share one CUDA device")
    pages = pages.to(torch.int64)
    common.launch("parity8_write", storage, pages, data, n, W, num_rows,
                  boundary, extra_base_row(Layout.PARITY, boundary, W),
                  parity_table_rows(boundary, 0, W))
    return storage
