"""Plain PyTorch version of the DAEC kernels — delegates to
:mod:`repro_torch.core.daec` (as ``repro/kernels/daec/ref.py`` does)."""
from __future__ import annotations

import torch

from repro_torch.core import daec as _d


def encode(data: torch.Tensor) -> torch.Tensor:
    """(N, D) words, D % 8 == 0 -> (N, D//8) packed DAEC code fields."""
    return _d.encode_block(data)


def decode(data: torch.Tensor, codes: torch.Tensor
           ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(N, D), (N, D//8) -> (corrected data, corrected codes, status
    (N, D//2))."""
    return _d.decode_block(data, codes)
