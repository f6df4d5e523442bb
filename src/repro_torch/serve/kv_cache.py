"""CREAM-VM-backed sequence-state cache: the paper's capacity story, served.

Port of ``repro/serve/kv_cache.py``. Paper anchor: §6.1's memcached
experiment (Fig. 8) with the SSD replaced by host memory, and Fig. 1's
loss-tolerant cache quadrant (KV pages run protection-free by policy).

Serving keeps more sequences than fit in one decode batch; a parked
sequence's decode state lives in the tier order

    device CREAM pool  ->  host memory  ("page fault": host <-> device copy)

and the pool's protection mode sets the device tier's capacity: an
all-InterWrap pool (``mode="cream"``) holds 12.5 % more pages than an
all-SECDED one (``mode="secded"``) of the same rows, so more sequences stay
on the device and fewer resumes cross the host. A ``cream`` pool is a
whole-pool InterWrap pool, whose pages move through the InterWrap gather
and scatter kernels (:mod:`repro_torch.kernels.interwrap`).

Storage goes through :class:`~repro_torch.vm.address_space.VirtualMemory`:
the cache is a tenant with an LRU policy, so a protection upgrade of the
pool migrates parked sequences instead of dropping them.

Blobs are ``uint8`` tensors on the pool's device, so a device hit never
crosses the host; a host hit pays the host -> device copy inside the VM's
read, and its wall time is charged to the host tier.
"""
from __future__ import annotations

import math
import time
from collections import OrderedDict
from dataclasses import dataclass

import torch

from repro_torch.core.layouts import Layout
from repro_torch.core.pool import PoolState
from repro_torch.core.protection import Protection
from repro_torch.vm.address_space import VirtualMemory


@dataclass
class CacheStats:
    device_hits: int = 0
    host_hits: int = 0          # page faults: state had been demoted to host
    misses: int = 0             # unknown sequence (needs prefill)
    evictions: int = 0
    device_fetch_s: float = 0.0
    host_fetch_s: float = 0.0

    @property
    def fault_rate(self) -> float:
        total = self.device_hits + self.host_hits
        return self.host_hits / total if total else 0.0


@dataclass
class _Entry:
    vpns: list[int]
    nbytes: int


def _as_bytes(blob: torch.Tensor, device: torch.device) -> torch.Tensor:
    """A uint8 blob -> a flat uint8 tensor on ``device``."""
    if blob.dtype != torch.uint8:
        raise TypeError(f"blob must be uint8, got {blob.dtype}")
    return blob.reshape(-1).to(device)


def _sync(device: torch.device) -> None:
    """Wait for the device, so a host clock spans the work (CUDA only)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class SequenceCache:
    """LRU cache of per-sequence state blobs, allocated through the VM."""

    POOL = "kv"

    def __init__(self, num_rows: int, mode: str = "cream",
                 row_words: int = 256, vm: VirtualMemory | None = None,
                 tenant: str = "kv", device=None):
        """mode: ``"cream"`` (InterWrap, +12.5 % pages) | ``"secded"``
        (baseline ECC).

        Pass an existing ``vm`` (with a pool named ``"kv"``) to share pools
        with other tenants; otherwise a private one-pool VM is built on
        ``device`` (``cuda`` unless asked otherwise).
        """
        if mode not in ("cream", "secded"):
            raise ValueError(mode)
        if vm is None:
            vm = VirtualMemory(row_words=row_words, device=device)
            vm.add_pool(self.POOL, num_rows, Layout.INTERWRAP,
                        boundary=None if mode == "cream" else 0)
        self.vm = vm
        self.tenant = tenant
        reliability = Protection.NONE if mode == "cream" \
            else Protection.SECDED
        vm.create_tenant(tenant, default_reliability=reliability)
        self.mode = mode
        self.lru: OrderedDict[str, _Entry] = OrderedDict()
        self.stats = CacheStats()

    @property
    def pool(self) -> PoolState:
        return self.vm.pools[self.POOL]

    @property
    def device_capacity_pages(self) -> int:
        return self.vm.device_capacity_pages()

    @property
    def device_utilisation(self) -> float:
        return self.vm.utilisation()

    def pages_needed(self, nbytes: int) -> int:
        return math.ceil(nbytes / self.vm.page_bytes)

    # -- write ---------------------------------------------------------------
    def park(self, seq_id: str, blob: torch.Tensor) -> None:
        """Store a sequence's state (uint8 blob). Evicts LRU to host if full."""
        if seq_id in self.lru:
            self.vm.free(self.tenant, self.lru.pop(seq_id).vpns)
        blob = _as_bytes(blob, self.vm.device)
        nbytes = blob.numel()
        n = self.pages_needed(nbytes)
        # zero=False: every allocated page is overwritten just below
        vpns = self.vm.alloc(self.tenant, n, allow_host=False, zero=False)
        while vpns is None and self._evict_one():
            vpns = self.vm.alloc(self.tenant, n, allow_host=False, zero=False)
        if vpns is None:             # device full of pinned pages -> host
            vpns = self.vm.alloc(self.tenant, n, allow_host=True, zero=False)
        words = torch.zeros(n * self.vm.page_bytes, dtype=torch.uint8,
                            device=self.vm.device)
        words[:nbytes] = blob
        self.vm.write(self.tenant, vpns, words.view(torch.int32).reshape(n, -1))
        self.lru[seq_id] = _Entry(vpns, nbytes)
        self.lru.move_to_end(seq_id)

    # -- read ----------------------------------------------------------------
    def resume_many(self, seq_ids) -> dict[str, torch.Tensor | None]:
        """Batched :meth:`resume`: one VM read for every known sequence
        (one pool read per backing pool) instead of one per sequence."""
        seq_ids = list(seq_ids)
        out: dict[str, torch.Tensor | None] = {}
        known: list[tuple[str, _Entry, bool]] = []
        all_vpns: list[int] = []
        for sid in seq_ids:
            entry = self.lru.get(sid)
            if entry is None:
                self.stats.misses += 1
                out[sid] = None
                continue
            self.lru.move_to_end(sid)
            on_host = self.vm.residency(self.tenant, entry.vpns) != "device"
            known.append((sid, entry, on_host))
            all_vpns.extend(entry.vpns)
        if not known:
            return out
        t0 = time.perf_counter()
        pages = self.vm.read(self.tenant, all_vpns).view(torch.uint8)
        off = 0
        any_host = False
        for sid, entry, on_host in known:
            n = len(entry.vpns)
            out[sid] = pages[off:off + n].reshape(-1)[:entry.nbytes].clone()
            off += n
            any_host |= on_host
            if on_host:
                self.stats.host_hits += 1
            else:
                self.stats.device_hits += 1
        _sync(self.vm.device)
        fetch_s = time.perf_counter() - t0
        # charge the batch's wall time to the slower tier it touched
        if any_host:
            self.stats.host_fetch_s += fetch_s
        else:
            self.stats.device_fetch_s += fetch_s
        return out

    def resume(self, seq_id: str) -> torch.Tensor | None:
        """Fetch a sequence's state; None if unknown (caller must prefill)."""
        entry = self.lru.get(seq_id)
        if entry is None:
            self.stats.misses += 1
            return None
        self.lru.move_to_end(seq_id)
        t0 = time.perf_counter()
        on_host = self.vm.residency(self.tenant, entry.vpns) != "device"
        data = self.vm.read(self.tenant, entry.vpns)
        blob = data.view(torch.uint8).reshape(-1)[:entry.nbytes].clone()
        _sync(self.vm.device)
        if on_host:
            self.stats.host_hits += 1
            self.stats.host_fetch_s += time.perf_counter() - t0
        else:
            self.stats.device_hits += 1
            self.stats.device_fetch_s += time.perf_counter() - t0
        return blob

    # -- internals -----------------------------------------------------------
    def _evict_one(self) -> bool:
        """Demote the LRU device-resident entry to the host tier."""
        for e in self.lru.values():          # oldest first
            if self.vm.residency(self.tenant, e.vpns) != "host":
                self.vm.swap_out(self.tenant, e.vpns)
                self.stats.evictions += 1
                return True
        return False


# ---------------------------------------------------------------------------
# State trees <-> blobs
# ---------------------------------------------------------------------------


def _flatten(tree, leaves: list):
    """Leaves in the reference's order (dict keys sorted) -> the tree's
    key structure, None at each leaf."""
    if isinstance(tree, dict):
        return tuple((k, _flatten(tree[k], leaves)) for k in sorted(tree))
    leaves.append(tree)
    return None


def _unflatten(treedef, leaves):
    if treedef is None:
        return next(leaves)
    return {k: _unflatten(c, leaves) for k, c in treedef}


def pack_tree(tree) -> tuple[torch.Tensor, tuple]:
    """A tree of tensors (nested dicts, as the decode states are) ->
    (uint8 blob on the leaves' device, spec) for :class:`SequenceCache`
    storage. The bytes are the reference's ``pack_tree`` bytes for the same
    tree."""
    leaves: list[torch.Tensor] = []
    treedef = _flatten(tree, leaves)
    spec = [(tuple(t.shape), t.dtype) for t in leaves]
    if not leaves:
        return torch.zeros(0, dtype=torch.uint8), (treedef, spec)
    dev = leaves[0].device
    blob = torch.cat([t.detach().to(dev).contiguous().reshape(-1)
                      .view(torch.uint8) for t in leaves])
    return blob, (treedef, spec)


def unpack_tree(blob: torch.Tensor, spec) -> object:
    """Inverse of :func:`pack_tree`: fresh tensors on the blob's device."""
    treedef, shapes = spec
    leaves = []
    off = 0
    for shape, dtype in shapes:
        n = math.prod(shape) * torch.empty(0, dtype=dtype).element_size()
        leaves.append(blob[off:off + n].clone().view(dtype).reshape(shape))
        off += n
    return _unflatten(treedef, iter(leaves))
