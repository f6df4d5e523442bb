"""Fused scrub sweep: the dispatching wrapper, plus the pool adapter.

A CPU pool takes the plain version (:mod:`.ref`); a CUDA pool launches the
kernel in ``csrc/scrub.cu`` (its vector or word-granular entry, by W) or
raises. There is no fallback.
"""
from __future__ import annotations

import torch

from repro_torch.core.layouts import DATA_LANES, LANES
from repro_torch.core.secded import DETECTED_UNCORRECTABLE
from repro_torch.kernels import common
from repro_torch.kernels.scrub import ref


def scrub_rows(storage: torch.Tensor,
               *, use_kernel: bool | None = None
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """(R, 9, W) SECDED rows -> (corrected rows, per-beat status (R, 4W))."""
    if storage.dim() != 3 or storage.shape[1] != LANES:
        raise ValueError(f"expected (R, 9, W) rows, got "
                         f"{tuple(storage.shape)}")
    common.check_contiguous("scrub_rows", storage)
    R, _, W = storage.shape
    if R == 0:
        return (torch.empty_like(storage),
                common.empty_words(storage, 0, DATA_LANES * W // 2))
    if storage.device.type == "cpu":
        return ref.scrub_rows(storage)
    common.check_cuda_words("scrub_rows", storage, W=W)
    out = torch.empty_like(storage)
    status = common.empty_words(storage, R, DATA_LANES * W // 2)
    common.launch_for_width("scrub_rows", W, storage, out, status, R * W, W)
    return out, status


def scrub_secded(storage: torch.Tensor, start: int, stop: int | None = None,
                 *, use_kernel: bool | None = None
                 ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Scrub rows ``[start, stop)`` of a pool buffer (``stop`` defaults to
    R) -> ``(storage', status, row_bad)``. Functional, as the reference:
    ``storage`` itself is left as it was."""
    if stop is None:
        stop = storage.shape[0]
    fixed, status = scrub_rows(storage[start:stop])
    storage = torch.cat([storage[:start], fixed, storage[stop:]])
    row_bad = status.amax(dim=-1) == DETECTED_UNCORRECTABLE
    return storage, status, row_bad
