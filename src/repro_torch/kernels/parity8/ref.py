"""Plain PyTorch version of the parity8 kernels — delegates to
:mod:`repro_torch.core.parity8` (as ``repro/kernels/parity8/ref.py`` does)."""
from __future__ import annotations

import torch

from repro_torch.core import parity8 as _p


def encode(data: torch.Tensor) -> torch.Tensor:
    """(N, D) words, D % 64 == 0 -> (N, D//64) packed parity bytes."""
    return _p.encode_lines_packed(data)


def check(data: torch.Tensor, parity: torch.Tensor) -> torch.Tensor:
    """(N, D), (N, D//64) -> per-line status (N, D//16)."""
    return _p.check_lines_packed(data, parity)
