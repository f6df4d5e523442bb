"""Migration gather/re-encode: the dispatching wrapper.

A CPU pool takes the plain version (:mod:`.ref`); a CUDA pool launches
the kernel in ``csrc/migrate.cu`` or raises. There is no fallback.
"""
from __future__ import annotations

import torch

from repro_torch.core.layouts import DATA_LANES, LANES
from repro_torch.kernels import common
from repro_torch.kernels.migrate import ref


def gather_encode(storage: torch.Tensor, pages: torch.Tensor, num_rows: int,
                  *, use_kernel: bool | None = None
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """(R, 9, W) InterWrap pool, (n,) page ids -> (data (n, 8W), codes (n, W)).

    ``codes`` is the packed SECDED plane of each page's future conventional
    row (what ``secded.encode_block`` gives over ``data``).
    """
    if storage.dim() != 3 or storage.shape[1] != LANES \
            or storage.shape[0] != num_rows or storage.shape[2] % 8:
        raise ValueError(f"expected ({num_rows}, 9, W) storage with W % 8 "
                         f"== 0, got {tuple(storage.shape)}")
    if pages.dim() != 1:
        raise ValueError("pages must be a 1-D id vector")
    common.check_contiguous("migrate_gather_encode", storage, pages)
    if storage.device.type == "cpu" and pages.device.type == "cpu":
        return ref.gather_encode(storage, pages, num_rows)
    W = storage.shape[2]
    pages = pages.to(torch.int32)
    common.check_cuda_words("migrate_gather_encode", storage, pages)
    n = pages.shape[0]
    data = torch.empty((n, DATA_LANES * W), dtype=torch.int32,
                       device=storage.device)
    codes = torch.empty((n, W), dtype=torch.int32, device=storage.device)
    if n:
        common.launch("migrate_gather_encode", storage, pages, data, codes,
                      n, W, num_rows)
    return data, codes
