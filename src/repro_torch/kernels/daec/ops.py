"""SEC-DAEC encode / decode: the dispatching wrappers.

A CPU tensor takes the plain version (:mod:`.ref`); a CUDA tensor launches
the kernel in ``csrc/daec.cu`` or raises. There is no fallback.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import common
from repro_torch.kernels.daec import ref


def _check(data: torch.Tensor) -> tuple[int, int]:
    if data.dim() != 2 or data.shape[1] % 8:
        raise ValueError(f"expected (N, D) words with D % 8 == 0, got "
                         f"{tuple(data.shape)}")
    return data.shape[0], data.shape[1]


def encode(data: torch.Tensor) -> torch.Tensor:
    """(N, D) int32 words -> (N, D//8) packed DAEC code fields."""
    n, d = _check(data)
    common.check_contiguous("daec_encode", data)
    if data.device.type == "cpu":
        return ref.encode(data)
    common.check_cuda_words("daec_encode", data)
    codes = torch.empty((n, d // 8), dtype=torch.int32, device=data.device)
    if n:
        common.launch("daec_encode", data, codes, n * d // 8)
    return codes


def decode(data: torch.Tensor, codes: torch.Tensor
           ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(N, D), (N, D//8) -> (corrected data, corrected codes, per-beat
    status (N, D//2) int32; each superbeat's status on both its beats)."""
    n, d = _check(data)
    if codes.shape != (n, d // 8):
        raise ValueError(f"codes must be {(n, d // 8)}, got "
                         f"{tuple(codes.shape)}")
    common.check_contiguous("daec_decode", data, codes)
    if data.device.type == "cpu" and codes.device.type == "cpu":
        return ref.decode(data, codes)
    common.check_cuda_words("daec_decode", data, codes)
    out = torch.empty_like(data)
    out_codes = torch.empty_like(codes)
    status = torch.empty((n, d // 2), dtype=torch.int32, device=data.device)
    if n:
        common.launch("daec_decode", data, codes, out, out_codes, status,
                      n * d // 8)
    return out, out_codes, status
