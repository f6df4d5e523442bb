"""Plain PyTorch version of the InterWrap page gather / scatter."""
from __future__ import annotations

import torch

from repro_torch.core.layouts import GROUP_ROWS, WRAP_LANES, WRAP_ROWS


def wrap_coords(pages: torch.Tensor, num_rows: int
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """(n,) page ids -> (rows (n, 8), lanes (n, 8)) under the InterWrap
    bridge translation ℓ = 8·slot + k (extras take slot 8 of their group)."""
    pages = pages.long()
    dev = pages.device
    is_extra = pages >= num_rows
    e = pages - num_rows
    group = torch.where(is_extra, e, pages // GROUP_ROWS)
    slot = torch.where(is_extra, GROUP_ROWS, pages % GROUP_ROWS)
    lanes = torch.as_tensor(WRAP_LANES, device=dev).long()[slot]
    rows = GROUP_ROWS * group[:, None] \
        + torch.as_tensor(WRAP_ROWS, device=dev).long()[slot]
    return rows, lanes


def gather(storage: torch.Tensor, pages: torch.Tensor,
           num_rows: int) -> torch.Tensor:
    """(R, 9, W), (n,) -> (n, 8W): read n wrap-striped pages."""
    rows, lanes = wrap_coords(pages, num_rows)
    return storage[rows, lanes, :].reshape(pages.shape[0], -1)


def scatter(storage: torch.Tensor, pages: torch.Tensor, data: torch.Tensor,
            num_rows: int) -> torch.Tensor:
    """Write n wrap-striped pages (n, 8W) into ``storage`` in place."""
    rows, lanes = wrap_coords(pages, num_rows)
    storage[rows, lanes, :] = data.reshape(pages.shape[0], 8, -1)
    return storage
