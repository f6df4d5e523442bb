"""CREAM core on PyTorch — layouts, protection ladder and region
descriptors, the SECDED codec, the pool with its boundary register, the
scrubber and the region manager (port of :mod:`repro.core`)."""
from repro_torch.core.layouts import Layout, page_coords
from repro_torch.core.pool import (PoolState, evicted_extra_pages, make_pool,
                                   migrate_pages, read_page, read_pages_any,
                                   read_pages_any_status, read_pages_batch,
                                   repartition, write_page, write_pages_any,
                                   write_pages_batch)
from repro_torch.core.protection import Protection, RegionSpec
from repro_torch.core.regions import Region, RegionManager
from repro_torch.core.scrubber import ScrubStats, scrub

__all__ = [
    "Layout", "page_coords", "PoolState", "make_pool", "read_page",
    "write_page", "read_pages_batch", "write_pages_batch", "read_pages_any",
    "read_pages_any_status", "write_pages_any", "migrate_pages",
    "evicted_extra_pages", "repartition", "Protection",
    "RegionSpec", "Region", "RegionManager", "ScrubStats", "scrub",
]
