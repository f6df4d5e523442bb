"""CREAM-VM on PyTorch — tenants, frames, host swap and zero-loss
repartition over CREAM pools (port of :mod:`repro.vm`)."""
from repro_torch.vm.address_space import (PTE, AddressSpace, FrameAllocator,
                                          VirtualMemory, VMStats, frame_class)
from repro_torch.vm.migration import MigrationEngine, MigrationStats

__all__ = [
    "PTE", "AddressSpace", "FrameAllocator", "VirtualMemory", "VMStats",
    "frame_class", "MigrationEngine", "MigrationStats",
]
