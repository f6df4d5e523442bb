"""CREAM-Cache: the capacity-adaptive key-value object cache.

Port of ``repro/objcache/cache.py`` (local pools). Values live in CREAM
pool pages allocated through the VM; the device-side hash index
(:mod:`repro_torch.objcache.hash_index`) resolves keys straight to physical
pages, so a batched get is one fused probe + mixed-pool gather
(:mod:`repro_torch.kernels.hash`) plus the per-value slice. A batched set
is one read-modify-write: one pool ``read`` of the touched pages, one chunk
scatter, one code-maintaining pool ``write``, and one index insert. No
per-key Python loops on either path; host-side work is numpy bookkeeping.

Per-item reliability classes: each ``set_many`` batch carries a
:class:`~repro_torch.core.protection.Protection` class, and its chunks come
from a slab whose VM pages were allocated under that class's segment —
over-protection allowed, under-protection never.

Capacity adapts live in both directions: after a demotion (boundary grows)
the freed frames are claimed by the next slab reservation; after an upgrade
(boundary shrinks) :meth:`ObjCache.refresh_translation` rebuilds the
slot->page translation, and values parked off the home pool stay readable
through a batched VM-read patch. Replacement is a 2Q approximation on
numpy recency/queue arrays.

On a CREAM-Shard pool (or a wrapped one, such as the fault campaign's
shadow) the probe stays a global index lookup and the resolved pages take
the pool's own ``read`` — on a sharded pool one router-fused mixed read
(:mod:`repro_torch.kernels.mixed`).

Telemetry as the reference's: ``objcache.set`` / ``objcache.get`` spans,
``cream_objcache_ops_total`` by outcome, and one CREAM-Lens record per
batch on stream ``objcache`` (the pool verbs inside run with the
profiler suspended, as the reference's jitted batch records once).
"""
from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.core.pool import PoolLike, PoolState
from repro_torch.core.protection import _ORDER, Protection
from repro_torch.kernels.common import to_u32, upload
from repro_torch.kernels.hash import ops as hash_ops
from repro_torch.objcache import hash_index as hix
from repro_torch.objcache.hash_index import HashIndex
from repro_torch.objcache.slab import SlabAllocator
from repro_torch.obs import memprof as obs_memprof
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import tracing as obs_tracing
from repro_torch.vm.address_space import VirtualMemory


def _get_batch(state, index: HashIndex, queries: torch.Tensor,
               max_len: int
               ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                          torch.Tensor]:
    """Fused batched get: probe + gather + per-value slice.

    A bare local pool takes the fused probe + gather kernel; any other
    pool (sharded, or wrapped so that its ``read`` must see every page)
    resolves the pages with the index lookup and reads them with its own
    ``read``. Returns ``(values (n, max_len) int32, lens (n,), slot (n,),
    found (n,))`` with not-found and beyond-length words zeroed.
    """
    page, off, length, slot, found = hix.lookup(index, queries)
    if isinstance(state, PoolState):
        data = hash_ops.lookup_read(
            state.storage, index.key, index.page, queries, state.layout,
            state.num_rows, state.boundary, index.probe)
    else:
        data = state.read(page)
    span = torch.arange(max_len, device=queries.device)
    idx = torch.clamp(off[:, None] + span, max=data.shape[1] - 1)
    vals = data.gather(1, idx.long())
    mask = (span[None, :] < length[:, None]) & found[:, None]
    return torch.where(mask, vals, 0), length, slot, found


def _write_values(state, upages: np.ndarray, inv: torch.Tensor,
                  offs: torch.Tensor, lens: torch.Tensor,
                  values: torch.Tensor):
    """Batched chunk write: read-modify-write of the touched pages.

    ``upages`` are unique page ids, ``inv[i]`` the row of value ``i``'s page
    within them; distinct values sharing a page land in disjoint chunk
    spans of the same image. The pool's write maintains the codes (SECDED
    or parity) and, like every VM write, updates the storage in place.
    """
    imgs = state.read(upages)
    u, w = imgs.shape
    span = torch.arange(values.shape[1], device=imgs.device)
    col = offs[:, None] + span
    col = torch.where(span[None, :] < lens[:, None], col, w)  # -> spare col
    padded = torch.cat([imgs, imgs.new_zeros((u, 1))], dim=1)
    padded[inv[:, None].expand_as(col), col] = values
    return state.write(upages, padded[:, :w])


@dataclass
class ObjCacheStats:
    gets: int = 0
    hits: int = 0
    misses: int = 0
    host_hits: int = 0          # values served off the home pool (faults)
    sets: int = 0
    updates: int = 0
    evictions: int = 0
    rejected: int = 0           # values that could not be admitted
    get_s: float = 0.0
    set_s: float = 0.0

    @property
    def hit_rate(self) -> float:
        return self.hits / self.gets if self.gets else 0.0

    @property
    def us_per_get(self) -> float:
        return self.get_s * 1e6 / self.gets if self.gets else 0.0

    @property
    def us_per_op(self) -> float:
        ops = self.gets + self.sets + self.rejected
        return (self.get_s + self.set_s) * 1e6 / ops if ops else 0.0


class ObjCache:
    """Key-value cache over one home pool of a :class:`VirtualMemory`.

    The index lives on the VM's device. ``use_kernel`` is kept for the
    reference's signature and ignored: the fused get dispatches by the
    pool's device (the kernel on the card, its plain version on the CPU).
    """

    def __init__(self, vm: VirtualMemory, pool: str,
                 tenant: str = "objcache", index_capacity: int = 1024,
                 probe: int = 16, max_value_words: int | None = None,
                 chunk_words: tuple[int, ...] | None = None,
                 use_kernel: bool | None = None):
        if pool not in vm.pools:
            raise ValueError(f"pool {pool!r} not under VM management")
        self.vm = vm
        self.pool_name = pool
        self.tenant = tenant
        vm.create_tenant(tenant, default_reliability=Protection.NONE,
                         segments={p.value: p for p in _ORDER})
        self.index = hix.make_index(index_capacity, probe, device=vm.device)
        self.max_value_words = int(max_value_words or vm.page_words)
        if self.max_value_words > vm.page_words:
            raise ValueError("values larger than one page are not supported")
        self.use_kernel = use_kernel
        self._chunk_words = chunk_words
        self.slabs: dict[Protection, SlabAllocator] = {}
        self.stats = ObjCacheStats()
        c = index_capacity
        # per-slot policy/translation mirrors (host-side, numpy-vectorised)
        self._vpn = np.full(c, -1, np.int64)
        self._off = np.zeros(c, np.int32)
        self._len = np.zeros(c, np.int32)
        self._cls = np.zeros(c, np.int32)
        self._relidx = np.zeros(c, np.int8)
        self._queue = np.zeros(c, np.int8)       # 0 probation, 1 main
        self._last = np.zeros(c, np.int64)
        self._live = np.zeros(c, bool)
        self._clock = 0
        # per-vpn translation mirrors (vpn -> home-pool phys page, or away)
        self._phys = np.full(64, -1, np.int64)
        self._away = np.zeros(64, bool)          # host swap or another pool

    # -- plumbing ------------------------------------------------------------
    @property
    def pool(self) -> PoolLike:
        return self.vm.pools[self.pool_name]

    @property
    def live_items(self) -> int:
        return int(self._live.sum())

    def capacity_report(self) -> dict:
        state = self.pool
        return {
            "pool_pages": state.num_pages,
            "boundary": state.boundary,
            "pages_claimed": sum(s.pages_claimed for s in self.slabs.values()),
            "live_items": self.live_items,
            "away_items": int(self._away[
                self._vpn[self._live]].sum()) if self._live.any() else 0,
        }

    def _slab(self, reliability: Protection) -> SlabAllocator:
        slab = self.slabs.get(reliability)
        if slab is None:
            slab = SlabAllocator(self.vm, self.tenant, reliability.value,
                                 reliability, self.pool_name,
                                 chunk_words=self._chunk_words)
            self.slabs[reliability] = slab
        return slab

    def _grow_vpn_mirrors(self, vmax: int) -> None:
        if vmax < len(self._phys):
            return
        new = max(vmax + 1, 2 * len(self._phys))
        phys = np.full(new, -1, np.int64)
        away = np.zeros(new, bool)
        phys[:len(self._phys)] = self._phys
        away[:len(self._away)] = self._away
        self._phys, self._away = phys, away

    def _note_vpns(self, vpns: np.ndarray) -> None:
        """Record home-pool phys ids for newly seen vpns (control plane)."""
        if not len(vpns):
            return
        self._grow_vpn_mirrors(int(vpns.max()))
        unknown = np.unique(vpns[(self._phys[vpns] < 0) & ~self._away[vpns]])
        space = self.vm.tenants[self.tenant]
        for v in unknown:                # new pages only, never keys
            pte = space.entries[int(v)]
            if pte.pool == self.pool_name:
                self._phys[v] = pte.phys
            else:
                self._away[v] = True

    @staticmethod
    def _check_keys(keys) -> np.ndarray:
        keys = np.asarray(keys, np.int64).reshape(-1)
        if keys.size and (int(keys.min()) < 0
                          or int(keys.max()) > hix.MAX_KEY):
            raise ValueError(f"keys must be in [0, {hix.MAX_KEY}]")
        return keys

    def _device_keys(self, keys: np.ndarray) -> torch.Tensor:
        """Checked int64 keys -> int32 key bits on the VM's device."""
        return upload(keys.astype(np.uint32).view(np.int32), self.vm.device)

    def _dev(self, a: np.ndarray) -> torch.Tensor:
        return upload(a, self.vm.device)

    # -- policy --------------------------------------------------------------
    def _drop_slots(self, slots: np.ndarray, evicted: bool) -> None:
        slots = np.asarray(slots)
        live = slots[self._live[slots]]
        if not len(live):
            return
        for ridx in np.unique(self._relidx[live]):
            sel = live[self._relidx[live] == ridx]
            self._slab(_ORDER[int(ridx)]).release(
                self._vpn[sel], self._off[sel], self._cls[sel])
        self.index = hix.delete_slots(self.index, self._dev(live))
        self._live[live] = False
        if evicted:
            self.stats.evictions += len(live)

    def _evict(self, count: int, reliability: Protection | None) -> bool:
        """Drop up to ``count`` victims: probation-oldest first, then main."""
        mask = self._live if reliability is None else \
            self._live & (self._relidx == _ORDER.index(reliability))
        cand = np.flatnonzero(mask)
        if not len(cand):
            return False
        order = np.lexsort((self._last[cand], self._queue[cand]))
        self._drop_slots(cand[order[:count]], evicted=True)
        return True

    # -- set -----------------------------------------------------------------
    def set_many(self, keys, values, lens=None,
                 reliability: Protection = Protection.NONE) -> np.ndarray:
        """Store a batch -> (n,) bool "admitted" mask (aligned to input).

        ``values`` is ``(n, span)`` uint32 with ``span <= max_value_words``;
        ``lens`` (words, default: full span) sets each value's true length.
        Duplicate keys within a batch resolve to the last occurrence.
        Existing keys are overwritten. A batch carries one reliability class.
        """
        t0 = time.perf_counter()
        keys = self._check_keys(keys)
        n = len(keys)
        values = np.asarray(values, np.uint32)
        if values.shape[0] != n or values.ndim != 2 \
                or values.shape[1] > self.max_value_words:
            raise ValueError(
                f"values must be (n, <= {self.max_value_words}) words")
        lens = np.full(n, values.shape[1], np.int32) if lens is None \
            else np.asarray(lens, np.int32)
        if lens.size and (int(lens.min()) < 1
                          or int(lens.max()) > values.shape[1]):
            raise ValueError("lens must be in [1, values.shape[1]]")
        # keep the LAST occurrence of each duplicated key
        _, ridx = np.unique(keys[::-1], return_index=True)
        take = np.sort(n - 1 - ridx)
        before = (self.stats.sets, self.stats.rejected, self.stats.evictions)
        with obs_tracing.span("objcache.set", n=n, cls=reliability.value):
            ok_u = self._set_unique(keys[take], values[take], lens[take],
                                    reliability)
        order = np.argsort(keys[take], kind="stable")
        stored = ok_u[order][np.searchsorted(keys[take][order], keys)]
        self.stats.set_s += time.perf_counter() - t0
        if obs_metrics.enabled():
            c = obs_metrics.counter(
                obs_metrics.NAME_OBJCACHE_OPS,
                "object-cache operations by outcome", labels=("op",))
            for op, delta in zip(
                    ("set", "rejected", "evicted"),
                    (self.stats.sets - before[0],
                     self.stats.rejected - before[1],
                     self.stats.evictions - before[2])):
                if delta:
                    c.labels(op=op).inc(delta)
        return stored

    def _insert(self, q: torch.Tensor, pages: torch.Tensor,
                offs: torch.Tensor, lens: torch.Tensor
                ) -> tuple[np.ndarray, np.ndarray]:
        self.index, slots, ok = hix.insert(self.index, q, pages, offs, lens)
        return slots.cpu().numpy(), ok.cpu().numpy()

    def _set_unique(self, keys: np.ndarray, values: np.ndarray,
                    lens: np.ndarray, reliability: Protection) -> np.ndarray:
        n = len(keys)
        if n == 0:
            return np.zeros(0, bool)
        # 1) overwrite semantics: retire existing versions first
        slot, found = (t.cpu().numpy() for t in hix.find(
            self.index, self._device_keys(keys)))
        if found.any():
            self._drop_slots(slot[found], evicted=False)
            self.stats.updates += int(found.sum())
        # 2) reserve chunks; under pressure, evict this class's LRU and
        #    retry, degrading to partial admission when nothing evictable
        #    is left (a batch larger than the whole cache stores what fits)
        slab = self._slab(reliability)
        vpn = np.zeros(n, np.int64)
        off = np.zeros(n, np.int32)
        cls = np.zeros(n, np.int32)
        admitted = np.zeros(n, bool)
        while True:
            rem = np.flatnonzero(~admitted)
            v, o, c, taken = slab.reserve(lens[rem], partial=True)
            if taken.any():
                sel = rem[taken]
                vpn[sel], off[sel], cls[sel] = v[taken], o[taken], c[taken]
                admitted[sel] = True
            if admitted.all():
                break
            if not self._evict(int((~admitted).sum()), reliability):
                break
        if not admitted.any():
            self.stats.rejected += n
            return admitted
        sub = np.flatnonzero(admitted)
        self._note_vpns(vpn[sub])
        pages = np.where(admitted, self._phys[vpn], 0)
        # 3) data plane: one RMW gather + chunk scatter + coded write-back
        upages, inv = np.unique(pages[sub], return_inverse=True)
        off_d = self._dev(off[sub])
        lens_d = self._dev(lens[sub])
        self.pool.memprof_record("scatter", upages, stream="objcache")
        with obs_memprof.suspended():
            self.vm.pools[self.pool_name] = _write_values(
                self.pool, upages, self._dev(inv.reshape(-1)), off_d,
                lens_d, upload(np.asarray(values[sub], np.uint32)
                               .view(np.int32), self.vm.device))
        self.vm.stats.device_writes += len(upages)
        # 4) index insert; a full probe window evicts-and-retries (rare)
        qsub = self._device_keys(keys[sub])
        pages_d = self._dev(pages[sub].astype(np.int32))
        slots, ok = self._insert(qsub, pages_d, off_d, lens_d)
        for _ in range(3):
            if ok.all():
                break
            if not self._evict(int((~ok).sum()) * 4, None):
                break
            slots, ok = self._insert(qsub, pages_d, off_d, lens_d)
        # 5) mirrors for the admitted, chunk release for the rejected
        s = slots[ok]
        self._vpn[s] = vpn[sub][ok]
        self._off[s] = off[sub][ok]
        self._len[s] = lens[sub][ok]
        self._cls[s] = cls[sub][ok]
        self._relidx[s] = _ORDER.index(reliability)
        self._queue[s] = 0
        self._clock += 1
        self._last[s] = self._clock
        self._live[s] = True
        if not ok.all():
            bad = sub[~ok]
            slab.release(vpn[bad], off[bad], cls[bad])
        stored = np.zeros(n, bool)
        stored[sub[ok]] = True
        self.stats.rejected += n - int(stored.sum())
        self.stats.sets += int(stored.sum())
        return stored

    # -- get -----------------------------------------------------------------
    def get_many(self, keys) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Batched lookup -> ``(values (n, max_value_words) uint32, lens,
        found)``.

        One fused probe + gather serves every device-resident value; values
        migrated off the home pool (protection upgrade overflow) are patched
        in through one batched VM read — the cache's page faults.
        """
        t0 = time.perf_counter()
        keys = self._check_keys(keys)
        n = len(keys)
        if n == 0:
            return (np.zeros((0, self.max_value_words), np.uint32),
                    np.zeros(0, np.int32), np.zeros(0, bool))
        with obs_tracing.span("objcache.get", n=n), obs_memprof.suspended():
            vals_d, lens_d, slot_d, found_d = _get_batch(
                self.pool, self.index, self._device_keys(keys),
                self.max_value_words)
        vals = to_u32(vals_d)                  # a fresh, writable copy
        lens, slot, found = (t.cpu().numpy()
                             for t in (lens_d, slot_d, found_d))
        hs = slot[found]
        if len(hs):
            if obs_memprof.enabled():   # the fused probe + gather, whole
                self.pool.memprof_record("gather", self._phys[self._vpn[hs]],
                                         stream="objcache")
            # 2Q: a re-referenced item promotes probation -> main
            self._clock += 1
            self._last[hs] = self._clock
            self._queue[hs] = 1
            # patch values whose pages migrated off the home pool
            away = self._away[self._vpn[hs]]
            if away.any():
                rows = np.flatnonzero(found)[away]
                data = to_u32(self.vm.read(
                    self.tenant, self._vpn[slot[rows]].tolist()))
                offs = self._off[slot[rows]]
                span = self.max_value_words
                col = np.minimum(offs[:, None] + np.arange(span),
                                 data.shape[1] - 1)
                got = np.take_along_axis(data, col, axis=1)
                mask = np.arange(span)[None, :] < self._len[slot[rows],
                                                            None]
                vals[rows] = np.where(mask, got, 0)
                self.stats.host_hits += len(rows)
        self.stats.gets += n
        self.stats.hits += int(found.sum())
        self.stats.misses += n - int(found.sum())
        self.stats.get_s += time.perf_counter() - t0
        if obs_metrics.enabled():
            c = obs_metrics.counter(
                obs_metrics.NAME_OBJCACHE_OPS,
                "object-cache operations by outcome", labels=("op",))
            c.labels(op="get").inc(n)
            if found.any():
                c.labels(op="hit").inc(int(found.sum()))
            if n - int(found.sum()):
                c.labels(op="miss").inc(n - int(found.sum()))
        return vals, lens.astype(np.int32), found

    # -- delete --------------------------------------------------------------
    def delete_many(self, keys) -> np.ndarray:
        """Batched delete -> (n,) bool "was present"."""
        keys = self._check_keys(keys)
        if not len(keys):
            return np.zeros(0, bool)
        slot, found = (t.cpu().numpy() for t in hix.find(
            self.index, self._device_keys(keys)))
        self._drop_slots(slot[found], evicted=False)
        return found

    # -- the migration bridge ------------------------------------------------
    def refresh_translation(self) -> dict:
        """Rebuild the slot->page translation from the VM page tables.

        Call after any repartition or migration touching the cache's
        frames: surviving frames keep serving from the fused device path,
        frames that moved to the host tier (or another pool) flip to the
        batched VM-read patch path, and their free chunks are quarantined
        so new values never land out of device reach. No cached value is
        lost.
        """
        space = self.vm.tenants[self.tenant]
        away_vpns = []
        if space.entries:
            self._grow_vpn_mirrors(max(space.entries))
        for vpn, pte in space.entries.items():   # pages, never keys
            if pte.pool == self.pool_name:
                self._phys[vpn] = pte.phys
                self._away[vpn] = False
            else:
                self._phys[vpn] = -1
                self._away[vpn] = True
                away_vpns.append(vpn)
        for slab in self.slabs.values():
            slab.drop_vpns(away_vpns)
        pages = np.zeros(self.index.capacity, np.int32)
        lv = np.flatnonzero(self._live)
        if len(lv):
            ph = self._phys[self._vpn[lv]]
            pages[lv] = np.where(ph >= 0, ph, 0).astype(np.int32)
        self.index = hix.replace_pages(self.index,
                                       upload(pages, self.index.key.device))
        return {"away_pages": len(away_vpns),
                "device_pages": int((self._phys >= 0).sum())}
