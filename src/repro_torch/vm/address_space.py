"""Address spaces, page tables, and the mode-aware frame allocator.

Port of ``repro/vm/address_space.py``. A pool is a local
:class:`~repro_torch.core.pool.PoolState` or, with ``add_pool(...,
shards=S)``, a CREAM-Shard :class:`~repro_torch.shard.pool.ShardedPool`
of ``S`` rank-subset banks (with ``mesh=``, one a rank of a banks mesh);
everything above the pool sees the same global page ids either way.

  * **frame** — one physical pool page ``(pool_name, phys)`` (regular pages
    ``[0, R)``, extra pages ``[R, R + extra)``);
  * **storage class** — the protection a frame provides today, from its
    pool's boundary register and SEC-DAEC tier: DAEC for rows
    ``[R - daec_rows, R)``, SECDED for the rest of ``[boundary, R)``, the
    CREAM layout's protection elsewhere;
  * **reliability class** — what a tenant requested for a segment; a frame
    may serve it iff its storage class is at least as strong;
  * **host swap tier** — overflow residency in host memory
    (``PTE.pool is None``); reads from it are the page faults.

All data-plane traffic goes through :meth:`VirtualMemory.read` /
:meth:`VirtualMemory.write`, one pool ``read`` / ``write`` per pool.
Page-table walks stay on the host.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.core.layouts import DEFAULT_ROW_WORDS, Layout
from repro_torch.core.pool import PoolLike, make_pool
from repro_torch.core.protection import _ORDER, Protection
from repro_torch.kernels.common import resolve_device, to_u32
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import tracing as obs_tracing


def cream_protection(layout: Layout) -> Protection:
    """Protection a CREAM-region frame provides under ``layout``."""
    if layout == Layout.BASELINE_ECC:
        return Protection.SECDED
    return Protection.PARITY if layout == Layout.PARITY else Protection.NONE


def frame_class(state: PoolLike, phys: int) -> Protection:
    """Storage class of frame ``phys`` under the pool's current boundary."""
    if state.boundary <= phys < state.num_rows:
        if phys >= state.num_rows - state.daec_rows:
            return Protection.DAEC
        return Protection.SECDED
    return cream_protection(state.layout)


def frame_classes(state: PoolLike, phys: np.ndarray) -> np.ndarray:
    """:func:`frame_class` of a vector of frames -> their class names."""
    return np.where(
        (phys >= state.boundary) & (phys < state.num_rows),
        np.where(phys >= state.num_rows - state.daec_rows,
                 Protection.DAEC.value, Protection.SECDED.value),
        cream_protection(state.layout).value)


@dataclass
class PTE:
    """Page-table entry: where one virtual page lives right now."""
    pool: str | None            # None -> host swap tier
    phys: int                   # physical page id, or host swap slot
    reliability: Protection     # requested class (the contract)
    segment: str = "default"


class AddressSpace:
    """Per-tenant page table + segment reliability defaults."""

    def __init__(self, tenant: str,
                 default_reliability: Protection = Protection.NONE):
        self.tenant = tenant
        self.entries: dict[int, PTE] = {}
        self.segments: dict[str, Protection] = {
            "default": default_reliability}
        self._next_vpn = 0

    def add_segment(self, name: str, reliability: Protection) -> None:
        self.segments[name] = reliability

    def new_vpn(self) -> int:
        vpn = self._next_vpn
        self._next_vpn += 1
        return vpn

    @property
    def num_pages(self) -> int:
        return len(self.entries)


class FrameAllocator:
    """Free lists over one pool's frames, keyed by storage class.

    Free lists are insertion-ordered dicts (page-id order after a rebuild)
    with a frame -> class side map; ``owner`` maps a mapped frame to its
    ``(tenant, vpn)``, the reverse translation migration walks.
    """

    def __init__(self, state: PoolLike):
        self.free: dict[Protection, dict[int, None]] = {}
        self.owner: dict[int, tuple[str, int]] = {}
        self._class: dict[int, Protection] = {}
        self.rebuild(state)

    def rebuild(self, state: PoolLike) -> None:
        """Recompute free lists after a boundary move; refuse if a mapped
        frame no longer exists (that would silently lose data)."""
        lost = [p for p in self.owner if p >= state.num_pages]
        if lost:
            raise RuntimeError(
                f"frames {lost} are mapped but no longer exist; "
                "relocate them before repartitioning")
        self.free = {p: {} for p in _ORDER}
        self._class = {}
        for phys in range(state.num_pages):
            if phys not in self.owner:
                cls = frame_class(state, phys)
                self.free[cls][phys] = None
                self._class[phys] = cls

    def peek(self, reliability: Protection, count: int,
             exclude: set[int] | None = None) -> list[int]:
        """Up to ``count`` free frames of class >= ``reliability`` (no pop):
        exact class first, then stronger."""
        exclude = exclude or set()
        picks: list[int] = []
        for cls in _ORDER[_ORDER.index(reliability):]:
            for phys in self.free[cls]:
                if phys in exclude:
                    continue
                picks.append(phys)
                if len(picks) == count:
                    return picks
        return picks

    def claim(self, phys: int, tenant: str, vpn: int) -> None:
        cls = self._class.get(phys)
        if cls is None:
            raise KeyError(f"frame {phys} is not free")
        del self.free[cls][phys]
        del self._class[phys]
        self.owner[phys] = (tenant, vpn)

    def release(self, state: PoolLike, phys: int) -> None:
        del self.owner[phys]
        cls = frame_class(state, phys)
        self.free[cls][phys] = None
        self._class[phys] = cls

    @property
    def used(self) -> int:
        return len(self.owner)


@dataclass
class VMStats:
    """Data-plane traffic census (host reads are the page faults)."""
    device_reads: int = 0
    host_reads: int = 0
    device_writes: int = 0
    host_writes: int = 0

    @property
    def fault_rate(self) -> float:
        total = self.device_reads + self.host_reads
        return self.host_reads / total if total else 0.0


class VirtualMemory:
    """Multi-tenant virtual memory over a set of CREAM pools + host swap.

    Pools live on ``device`` (``cuda`` unless asked otherwise); page
    contents cross the API as ``(n, page_words)`` int32 tensors.
    """

    def __init__(self, row_words: int = DEFAULT_ROW_WORDS, device=None):
        self.row_words = row_words
        self.device = resolve_device(device)
        self.pools: dict[str, PoolLike] = {}
        self.allocators: dict[str, FrameAllocator] = {}
        self.tenants: dict[str, AddressSpace] = {}
        self.swap: dict[int, np.ndarray] = {}
        self._next_slot = 0
        self.stats = VMStats()

    # -- setup ---------------------------------------------------------------
    def add_pool(self, name: str, num_rows: int,
                 layout: Layout = Layout.INTERWRAP,
                 boundary: int | None = None, shards: int = 1,
                 mesh=None, daec_rows: int = 0) -> PoolLike:
        """Create a pool under VM management: a local pool, or with
        ``shards > 1`` or a ``mesh`` a
        :class:`~repro_torch.shard.pool.ShardedPool` of that many banks
        (CREAM-Shard), all on this VM's device or, over a 1-D ``banks``
        ``mesh`` of ``shards`` ranks, one a rank (every rank runs the same
        VM). ``daec_rows`` carves that many top rows of the protected
        region into the SEC-DAEC tier."""
        if name in self.pools:
            raise ValueError(f"pool {name!r} exists")
        if shards > 1 or mesh is not None:
            from repro_torch.shard.pool import make_sharded_pool
            state = make_sharded_pool(num_rows, layout, boundary,
                                      num_shards=shards,
                                      row_words=self.row_words, mesh=mesh,
                                      daec_rows=daec_rows,
                                      device=self.device)
        else:
            state = make_pool(num_rows, layout, boundary=boundary,
                              row_words=self.row_words, daec_rows=daec_rows,
                              device=self.device)
        self.pools[name] = state
        self.allocators[name] = FrameAllocator(state)
        obs_metrics.record_pool_capacity(name, state)
        return state

    def adopt_pool(self, name: str, state: PoolLike) -> None:
        """Bring an existing pool (local or sharded) under VM management,
        every frame free. It must live on this VM's device."""
        if state.row_words != self.row_words:
            raise ValueError("row_words mismatch")
        if resolve_device(state.device) != self.device:
            raise ValueError(f"pool lives on {state.device}, the VM on "
                             f"{self.device}")
        self.pools[name] = state
        self.allocators[name] = FrameAllocator(state)
        obs_metrics.record_pool_capacity(name, state)

    def create_tenant(self, name: str,
                      default_reliability: Protection = Protection.NONE,
                      segments: dict[str, Protection] | None = None
                      ) -> AddressSpace:
        if name in self.tenants:
            raise ValueError(f"tenant {name!r} exists")
        space = AddressSpace(name, default_reliability)
        for seg, rel in (segments or {}).items():
            space.add_segment(seg, rel)
        self.tenants[name] = space
        return space

    # -- geometry ------------------------------------------------------------
    @property
    def page_words(self) -> int:
        return 8 * self.row_words

    @property
    def page_bytes(self) -> int:
        return 4 * self.page_words

    def device_capacity_pages(self, pool: str | None = None) -> int:
        names = [pool] if pool else list(self.pools)
        return sum(self.pools[n].num_pages for n in names)

    def used_device_pages(self, pool: str | None = None) -> int:
        names = [pool] if pool else list(self.pools)
        return sum(self.allocators[n].used for n in names)

    def utilisation(self, pool: str | None = None) -> float:
        cap = self.device_capacity_pages(pool)
        return self.used_device_pages(pool) / cap if cap else 0.0

    def capacity_report(self) -> dict[str, dict]:
        """Per pool: geometry, pages, used and free frames by class, and
        the capacity gain; plus the host tier's page count."""
        out = {}
        for name, state in self.pools.items():
            alloc = self.allocators[name]
            out[name] = {
                "layout": state.layout.value,
                "rows": state.num_rows,
                "boundary": state.boundary,
                "daec_rows": state.daec_rows,
                "pages": state.num_pages,
                "extra_pages": state.num_extra_pages,
                "used": alloc.used,
                "free": {p.value: len(lst) for p, lst in alloc.free.items()},
                "gain": state.capacity_gain(),
            }
        out["host_swap_pages"] = len(self.swap)
        return out

    # -- translation ---------------------------------------------------------
    def translate(self, tenant: str, vpn: int) -> PTE:
        return self.tenants[tenant].entries[vpn]

    def effective_protection(self, tenant: str, vpn: int
                             ) -> Protection | None:
        """Storage class actually backing a page (None = host tier)."""
        pte = self.translate(tenant, vpn)
        if pte.pool is None:
            return None
        return frame_class(self.pools[pte.pool], pte.phys)

    def residency(self, tenant: str, vpns) -> str:
        """``"device"``, ``"host"`` or ``"mixed"``: where ``vpns`` live."""
        tiers = {"host" if self.translate(tenant, v).pool is None
                 else "device" for v in vpns}
        return tiers.pop() if len(tiers) == 1 else "mixed"

    # -- allocation ----------------------------------------------------------
    def alloc(self, tenant: str, n: int, segment: str = "default",
              reliability: Protection | None = None,
              allow_host: bool = True, zero: bool = True,
              pool: str | None = None) -> list[int] | None:
        """Allocate ``n`` virtual pages; returns their vpns.

        Frames come from any pool (or only ``pool``) with storage class >=
        the segment's reliability class; overflow lands in the host swap
        tier unless ``allow_host=False``, in which case the allocation fits
        on device or returns None untouched. ``zero=False`` skips zeroing
        the claimed device frames (callers that overwrite before reading).
        """
        space = self.tenants[tenant]
        rel = reliability if reliability is not None \
            else space.segments[segment]
        picks: list[tuple[str, int]] = []
        candidates = [(pool, self.allocators[pool])] if pool is not None \
            else list(self.allocators.items())
        for pool_name, alloc in candidates:
            for phys in alloc.peek(rel, n - len(picks)):
                picks.append((pool_name, phys))
            if len(picks) == n:
                break
        if len(picks) < n and not allow_host:
            return None
        vpns = []
        for i in range(n):
            vpn = space.new_vpn()
            if i < len(picks):
                pool_name, phys = picks[i]
                self.allocators[pool_name].claim(phys, tenant, vpn)
                space.entries[vpn] = PTE(pool_name, phys, rel, segment)
            else:
                slot = self._new_slot()
                self.swap[slot] = np.zeros(self.page_words, np.uint32)
                space.entries[vpn] = PTE(None, slot, rel, segment)
            vpns.append(vpn)
        if zero:
            by_pool: dict[str, list[int]] = {}
            for pool_name, phys in picks:
                by_pool.setdefault(pool_name, []).append(phys)
            for pool_name, phys_list in by_pool.items():
                self.pools[pool_name] = self.pools[pool_name].write(
                    phys_list,
                    torch.zeros((len(phys_list), self.page_words),
                                dtype=torch.int32, device=self.device))
        return vpns

    def free(self, tenant: str, vpns) -> None:
        space = self.tenants[tenant]
        for vpn in vpns:
            pte = space.entries.pop(vpn)
            if pte.pool is None:
                self.swap.pop(pte.phys, None)
            else:
                self.allocators[pte.pool].release(self.pools[pte.pool],
                                                  pte.phys)

    def _new_slot(self) -> int:
        slot = self._next_slot
        self._next_slot += 1
        return slot

    # -- data plane ----------------------------------------------------------
    def write(self, tenant: str, vpns, data) -> None:
        """Write ``(n, page_words)`` words (int32 tensor or uint32 numpy)
        through the page tables."""
        vpns = list(vpns)
        if isinstance(data, np.ndarray):
            data = torch.from_numpy(
                np.ascontiguousarray(data, np.uint32).view(np.int32))
        data = data.to(self.device, torch.int32).reshape(len(vpns), -1)
        if data.shape[1] != self.page_words:
            raise ValueError(f"expected (n, {self.page_words}) words")
        space = self.tenants[tenant]
        by_pool: dict[str, list[tuple[int, int]]] = {}
        host_view = None          # one device-to-host copy for all host pages
        for i, vpn in enumerate(vpns):
            pte = space.entries[vpn]
            if pte.pool is None:
                if host_view is None:
                    host_view = to_u32(data)
                self.swap[pte.phys] = host_view[i].copy()
                self.stats.host_writes += 1
            else:
                by_pool.setdefault(pte.pool, []).append((i, pte.phys))
        for pool_name, items in by_pool.items():
            idx = torch.as_tensor([i for i, _ in items], device=self.device)
            with obs_tracing.span("vm.write", pool=pool_name,
                                  pages=len(items)):
                self.pools[pool_name] = self.pools[pool_name].write(
                    [p for _, p in items], data[idx])
            self.stats.device_writes += len(items)
        if obs_metrics.enabled():
            device_n = sum(len(items) for items in by_pool.values())
            c = obs_metrics.counter(
                obs_metrics.NAME_VM_WRITES,
                "pages written through the VM data plane", labels=("tier",))
            if device_n:
                c.labels(tier="device").inc(device_n)
            if len(vpns) - device_n:
                c.labels(tier="host").inc(len(vpns) - device_n)

    def read(self, tenant: str, vpns) -> torch.Tensor:
        """Read ``(n, page_words)`` int32 through the page tables: host
        pages from the swap tier (counted as faults), device pages as one
        decode-corrected batch read per pool."""
        vpns = list(vpns)
        n = len(vpns)
        space = self.tenants[tenant]
        out = torch.zeros((n, self.page_words), dtype=torch.int32,
                          device=self.device)
        by_pool: dict[str, list[tuple[int, int]]] = {}
        host_items: list[tuple[int, int]] = []
        for i, vpn in enumerate(vpns):
            pte = space.entries[vpn]
            if pte.pool is None:
                host_items.append((i, pte.phys))
                self.stats.host_reads += 1
            else:
                by_pool.setdefault(pte.pool, []).append((i, pte.phys))
        if host_items:
            # the "page fault": host -> device transfer charged here
            blob = np.stack([self.swap[slot] for _, slot in host_items])
            out[torch.as_tensor([i for i, _ in host_items],
                                device=self.device)] = torch.from_numpy(
                blob.view(np.int32)).to(self.device)
        for pool_name, items in by_pool.items():
            idx = torch.as_tensor([i for i, _ in items], device=self.device)
            with obs_tracing.span("vm.read", pool=pool_name,
                                  pages=len(items)):
                out[idx] = self.pools[pool_name].read([p for _, p in items])
            self.stats.device_reads += len(items)
        if obs_metrics.enabled():
            device_n = sum(len(items) for items in by_pool.values())
            c = obs_metrics.counter(
                obs_metrics.NAME_VM_READS,
                "pages read through the VM data plane (host = faults)",
                labels=("tier",))
            if device_n:
                c.labels(tier="device").inc(device_n)
            if host_items:
                c.labels(tier="host").inc(len(host_items))
        return out

    # -- swap tier -----------------------------------------------------------
    def swap_out(self, tenant: str, vpns) -> int:
        """Demote device-resident pages to the host tier; returns count."""
        space = self.tenants[tenant]
        device = [v for v in vpns if space.entries[v].pool is not None]
        if not device:
            return 0
        data = to_u32(self.read(tenant, device))
        self.stats.device_reads -= len(device)   # internal move, not traffic
        for j, vpn in enumerate(device):
            pte = space.entries[vpn]
            self.allocators[pte.pool].release(self.pools[pte.pool], pte.phys)
            slot = self._new_slot()
            self.swap[slot] = data[j].copy()
            space.entries[vpn] = PTE(None, slot, pte.reliability, pte.segment)
        return len(device)

    def swap_in(self, tenant: str, vpns) -> int:
        """Promote host-resident pages back to device frames (best effort:
        a page stays on the host when no frame of its class is free);
        returns how many moved."""
        space = self.tenants[tenant]
        promoted = 0
        for vpn in vpns:
            pte = space.entries[vpn]
            if pte.pool is not None:
                continue
            home = None
            for pool_name, alloc in self.allocators.items():
                picks = alloc.peek(pte.reliability, 1)
                if picks:
                    home = (pool_name, picks[0])
                    break
            if home is None:
                continue
            pool_name, phys = home
            self.allocators[pool_name].claim(phys, tenant, vpn)
            blob = self.swap.pop(pte.phys)
            self.pools[pool_name] = self.pools[pool_name].write(
                [phys], torch.from_numpy(blob.view(np.int32))[None, :])
            space.entries[vpn] = PTE(pool_name, phys, pte.reliability,
                                     pte.segment)
            promoted += 1
        return promoted
