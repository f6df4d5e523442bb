"""Plain PyTorch version of the fused probe + gather read.

Resolve each query key against the index's slot arrays with the bounded
linear probe of :mod:`repro_torch.objcache.hash_index` (the single source
of the probe sequence), then the decode-corrected mixed-pool gather of the
matched pages — exactly :func:`repro_torch.kernels.mixed.ref.read_correct`
over the resolved page vector. Absent keys resolve to page 0.
"""
from __future__ import annotations

import torch

from repro_torch.core.layouts import Layout
from repro_torch.kernels.mixed import ref as mixed_ref
from repro_torch.objcache import hash_index as hix


def resolve_pages(slot_keys: torch.Tensor, slot_pages: torch.Tensor,
                  queries: torch.Tensor, probe: int) -> torch.Tensor:
    """(C,) keys, (C,) pages, (n,) queries -> (n,) matched pages (0 if
    absent)."""
    slot, found = hix.find(hix.HashIndex(slot_keys, slot_pages, None, None,
                                         probe), queries)
    cs = torch.clamp(slot, max=slot_keys.shape[0] - 1)
    return torch.where(found, slot_pages[cs], 0)


def lookup_read(storage: torch.Tensor, slot_keys: torch.Tensor,
                slot_pages: torch.Tensor, queries: torch.Tensor,
                layout: Layout, num_rows: int, boundary: int,
                probe: int) -> torch.Tensor:
    """(R, 9, W) pool + index arrays + (n,) keys -> (n, 8W) page data."""
    pages = resolve_pages(slot_keys, slot_pages, queries, probe)
    return mixed_ref.read_correct(storage, pages, layout, num_rows, boundary)
