"""CREAM core on PyTorch — layouts, protection ladder, the SECDED codec and
the pool with its boundary register (port of :mod:`repro.core`)."""
from repro_torch.core.layouts import Layout, page_coords
from repro_torch.core.pool import (PoolState, evicted_extra_pages, make_pool,
                                   read_pages_any, read_pages_any_status,
                                   repartition, write_pages_any)
from repro_torch.core.protection import Protection

__all__ = [
    "Layout", "page_coords", "PoolState", "make_pool", "read_pages_any",
    "read_pages_any_status", "write_pages_any", "evicted_extra_pages",
    "repartition", "Protection",
]
