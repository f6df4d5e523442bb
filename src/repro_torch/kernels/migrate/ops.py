"""Migration gather/re-encode: the dispatching wrapper.

A CPU pool takes the plain version (:mod:`.ref`); a CUDA pool launches
the kernel in ``csrc/migrate.cu`` (its vector or word-granular entry, by
W) or raises. There is no fallback.
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
            or storage.shape[0] != num_rows:
        raise ValueError(f"expected ({num_rows}, 9, W) storage, got "
                         f"{tuple(storage.shape)}")
    if pages.dim() != 1:
        raise ValueError("pages must be a 1-D id vector")
    common.check_contiguous("migrate_gather_encode", storage, pages)
    W, n = storage.shape[2], pages.shape[0]
    if n == 0:
        return (common.empty_words(storage, 0, DATA_LANES * W),
                common.empty_words(storage, 0, W))
    if storage.device.type == "cpu" and pages.device.type == "cpu":
        return ref.gather_encode(storage, pages, num_rows)
    pages = pages.to(torch.int32)
    common.check_cuda_words("migrate_gather_encode", storage, pages,
                            W=W)
    data = common.empty_words(storage, n, DATA_LANES * W)
    codes = common.empty_words(storage, n, W)
    common.launch_for_width("migrate_gather_encode", W, storage, pages, data,
                            codes, n, W, num_rows)
    return data, codes
