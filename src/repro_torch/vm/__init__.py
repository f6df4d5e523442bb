"""CREAM-VM on PyTorch — tenants, frames, host swap, zero-loss
repartition over CREAM pools, and the scrub → monitor → adapt policy
(port of :mod:`repro.vm`)."""
from repro_torch.vm.address_space import (PTE, AddressSpace, FrameAllocator,
                                          VirtualMemory, VMStats, frame_class)
from repro_torch.vm.migration import MigrationEngine, MigrationStats
from repro_torch.vm.policy import PoolPolicy, VMPolicy

__all__ = [
    "PTE", "AddressSpace", "FrameAllocator", "VirtualMemory", "VMStats",
    "frame_class", "MigrationEngine", "MigrationStats", "PoolPolicy",
    "VMPolicy",
]
