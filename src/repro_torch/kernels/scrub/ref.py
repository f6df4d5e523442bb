"""Plain PyTorch version of the fused scrub sweep."""
from __future__ import annotations

import torch

from repro_torch.core import secded
from repro_torch.core.layouts import CODE_LANE, DATA_LANES


def scrub_rows(storage: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Decode+correct SECDED rows: (R, 9, W) -> (storage', status (R, 4W))."""
    R, _, W = storage.shape
    data = storage[:, :DATA_LANES, :].reshape(R, DATA_LANES * W)
    codes = storage[:, CODE_LANE, :]
    data2, codes2, status = secded.decode_block(data, codes)
    out = torch.cat([data2.reshape(R, DATA_LANES, W), codes2[:, None, :]],
                    dim=1)
    return out, status
