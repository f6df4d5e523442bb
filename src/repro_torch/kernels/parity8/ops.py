"""parity8 encode / check: the dispatching wrappers.

A CPU tensor takes the plain version (:mod:`.ref`); a CUDA tensor launches
the kernel in ``csrc/parity8.cu`` or raises. There is no fallback.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import common
from repro_torch.kernels.parity8 import ref


def _check(data: torch.Tensor) -> tuple[int, int]:
    if data.dim() != 2 or data.shape[1] % 64:
        raise ValueError(f"expected (N, D) words with D % 64 == 0, got "
                         f"{tuple(data.shape)}")
    return data.shape[0], data.shape[1]


def encode(data: torch.Tensor) -> torch.Tensor:
    """(N, D) int32 words -> (N, D//64) packed parity bytes."""
    n, d = _check(data)
    common.check_contiguous("parity8_encode", data)
    if data.device.type == "cpu":
        return ref.encode(data)
    common.check_cuda_words("parity8_encode", data)
    parity = torch.empty((n, d // 64), dtype=torch.int32, device=data.device)
    if n:
        common.launch("parity8_encode", data, parity, n * d // 4)
    return parity


def check(data: torch.Tensor, parity: torch.Tensor) -> torch.Tensor:
    """(N, D), (N, D//64) -> per-line status (N, D//16) int32: 0 ok,
    1 corrupt."""
    n, d = _check(data)
    if parity.shape != (n, d // 64):
        raise ValueError(f"parity must be {(n, d // 64)}, got "
                         f"{tuple(parity.shape)}")
    common.check_contiguous("parity8_check", data, parity)
    if data.device.type == "cpu" and parity.device.type == "cpu":
        return ref.check(data, parity)
    common.check_cuda_words("parity8_check", data, parity)
    status = torch.empty((n, d // 16), dtype=torch.int32, device=data.device)
    if n:
        common.launch("parity8_check", data, parity, status, n * d // 4)
    return status
