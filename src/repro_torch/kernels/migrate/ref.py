"""Plain PyTorch version of the fused migration gather/re-encode."""
from __future__ import annotations

import torch

from repro_torch.core import secded
from repro_torch.kernels.interwrap import ref as interwrap_ref


def gather_encode(storage: torch.Tensor, pages: torch.Tensor, num_rows: int
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """(R, 9, W), (n,) -> (data (n, 8W), packed SECDED codes (n, W))."""
    data = interwrap_ref.gather(storage, pages, num_rows)
    return data, secded.encode_block(data)
