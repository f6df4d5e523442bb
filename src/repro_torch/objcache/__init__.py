"""CREAM-Cache on PyTorch — a key-value object cache on the CREAM data
plane (port of :mod:`repro.objcache`): values in pool pages allocated
through the VM, a device-side hash index, and one fused probe + gather
kernel per batched get."""
from repro_torch.objcache.cache import ObjCache, ObjCacheStats
from repro_torch.objcache.hash_index import HashIndex, make_index
from repro_torch.objcache.slab import SlabAllocator

__all__ = ["ObjCache", "ObjCacheStats", "HashIndex", "make_index",
           "SlabAllocator"]
