"""Plain PyTorch version of the SECDED kernels — delegates to
:mod:`repro_torch.core.secded` (as ``repro/kernels/secded/ref.py`` does)."""
from __future__ import annotations

import torch

from repro_torch.core import secded as _s


def encode(data: torch.Tensor) -> torch.Tensor:
    """(N, D) words, D % 8 == 0 -> (N, D//8) packed codes."""
    return _s.encode_block(data)


def decode(data: torch.Tensor, codes: torch.Tensor
           ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(N, D), (N, D//8) -> (corrected data, corrected codes, status (N, D//2))."""
    return _s.decode_block(data, codes)
