"""Paged-KV block tables on the CREAM data plane (paper §3.1 + §6.1/Fig. 8).

Port of ``repro/serve/paged_kv.py``: host-side block tables, unchanged
apart from torch dtypes.

Paper anchor: Fig. 1's "caches tolerate loss" quadrant and the §6.1
memcached/WebSearch capacity experiments, applied to the KV cache of a
serving engine. The KV cache is the serving tier's page cache: every
(sequence, layer, block) of KV lives in ONE CREAM pool page, so the
boundary register's +12.5 % (InterWrap) capacity gain is extra *sequences
kept device-resident* — the paper's fewer-page-faults story with decode
states instead of memcached values.

vLLM-style paged attention, mapped onto the repo's data plane:

  * a **block** holds ``block_tokens`` tokens of one attention layer's K and
    V, packed ``(2, block_tokens, Hkv, D)`` float32 and bit-cast to the
    pool's uint32 page words (tail-padded to ``page_words``);
  * the **block table** maps ``(seq row, layer, block index) -> vpn`` into a
    VM tenant; a cached vpn→physical-page mirror (refreshed after any
    repartition / migration, like :meth:`repro.objcache.ObjCache
    .refresh_translation`) turns a whole decode batch's tables into one
    int32 page-id array — the index map of the mixed-pool gather
    (:mod:`repro_torch.kernels.mixed`), so a decode step's KV reads are ONE
    batched ``read_pages`` and its write-back ONE batched ``write_pages``
    on the :class:`repro_torch.core.pool.PoolState`;
  * **reliability tiers** (HRM-style, Luo et al.): each sequence's pages are
    allocated under a tenant segment — ``paid`` → SECDED frames, ``batch``
    → NONE/PARITY frames. A repartition that grows the CREAM region frees
    weak-class frames that admit more batch sequences *without* evicting
    paid ones (the live capacity bridge);
  * **preempt-to-host**: a sequence's pages swap to the VM's host tier
    (:meth:`preempt`) and return bit-exact (:meth:`restore`) — restore
    re-lands pages in this pool via fresh frames, and the host reads are
    the page faults :class:`repro_torch.vm.address_space.VMStats` counts.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.core.protection import _ORDER, Protection
from repro_torch.vm.address_space import VirtualMemory, frame_class

#: Default request tiers: who may land on which storage class. Over-
#: protection is allowed (a batch page may sit on a SECDED frame when the
#: pool is all-SECDED), under-protection never is.
DEFAULT_TIERS = {"paid": Protection.SECDED, "batch": Protection.NONE}


@dataclass
class _Row:
    """One sequence's block-table row."""
    tier: str
    blocks: int = 0          # allocated blocks per layer


class PagedKV:
    """(seq row, layer, block) -> CREAM page-id block tables over a VM pool.

    ``token_words`` is the uint32 words one token of one layer's K+V packs
    to (``2 * Hkv * D`` for float32). All pages come from the single pool
    ``pool`` of ``vm`` (callers share the VM with other tenants freely; the
    serve data plane stays pinned so a decode step is one gather on one
    pool). ``max_tokens`` bounds a sequence's KV; the block table reserves
    ``ceil(max_tokens / block_tokens)`` block slots per (row, layer).
    """

    def __init__(self, vm: VirtualMemory, pool: str, n_layers: int,
                 token_words: int, max_seqs: int, max_tokens: int,
                 tenant: str = "serve",
                 tiers: dict[str, Protection] | None = None):
        self.vm = vm
        self.pool_name = pool
        self.tenant = tenant
        self.n_layers = n_layers
        self.token_words = token_words
        self.block_tokens = vm.page_words // token_words
        if self.block_tokens < 1:
            raise ValueError(
                f"page ({vm.page_words} words) smaller than one KV token "
                f"({token_words} words); raise row_words")
        self.kv_words = self.block_tokens * token_words
        self.max_seqs = max_seqs
        self.max_blocks = math.ceil(max_tokens / self.block_tokens)
        self.tiers = dict(tiers or DEFAULT_TIERS)
        vm.create_tenant(tenant, default_reliability=Protection.NONE,
                         segments=self.tiers)
        # block tables: vpn per (row, layer, block); -1 = unallocated
        self._table = np.full((max_seqs, n_layers, self.max_blocks), -1,
                              np.int64)
        self._rows: dict[int, _Row] = {}
        self._free_rows = list(range(max_seqs - 1, -1, -1))
        # vpn -> home-pool physical page (-1 = host / foreign pool)
        self._phys = np.full(64, -1, np.int32)
        # one always-device scratch page: unbound decode slots read it and
        # park their (ignored) write-back there, so the per-step gather and
        # scatter keep a fixed shape with no host-side branching
        scratch = vm.alloc(tenant, 1, reliability=Protection.NONE,
                           allow_host=False, zero=True, pool=pool)
        if scratch is None:
            raise ValueError(f"pool {pool!r} has no free frame for scratch")
        self._scratch_vpn = scratch[0]
        self._sync(scratch)

    # -- geometry / accounting ----------------------------------------------
    @property
    def page_words(self) -> int:
        return self.vm.page_words

    @property
    def scratch_phys(self) -> int:
        return int(self._phys[self._scratch_vpn])

    def blocks_for(self, n_tokens: int) -> int:
        return math.ceil(n_tokens / self.block_tokens)

    def frames_needed(self, row: int, n_tokens: int) -> int:
        """Device frames :meth:`ensure` would claim for ``n_tokens``."""
        need = self.blocks_for(n_tokens) - self._rows[row].blocks
        return max(need, 0) * self.n_layers

    def mapped_pages(self, row: int) -> int:
        """Pages the row currently maps (device- or host-resident)."""
        return self._rows[row].blocks * self.n_layers

    def row_frames_of_class(self, row: int,
                            reliability: Protection) -> int:
        """Device-resident pages of the row on frames of storage class
        >= ``reliability`` — what preempting the row would free for an
        allocation of that class. Lets the scheduler skip victims whose
        eviction cannot help (e.g. a batch session on NONE frames when a
        paid request needs SECDED)."""
        pool = self.vm.pools[self.pool_name]
        i = _ORDER.index(reliability)
        vpns = self._table[row][self._table[row] >= 0]
        return sum(1 for v in vpns
                   if self._phys[int(v)] >= 0
                   and _ORDER.index(frame_class(
                       pool, int(self._phys[int(v)]))) >= i)

    def free_frames(self, reliability: Protection) -> int:
        """Free home-pool frames with storage class >= ``reliability``."""
        alloc = self.vm.allocators[self.pool_name]
        i = _ORDER.index(reliability)
        return sum(len(alloc.free[cls]) for cls in _ORDER[i:])

    def used_pages(self) -> int:
        """Pages mapped by every row, plus the scratch page."""
        return int((self._table >= 0).sum()) + 1

    # -- row lifecycle -------------------------------------------------------
    def open(self, tier: str) -> int:
        """Claim a block-table row for a new sequence; no pages yet."""
        if tier not in self.tiers:
            raise KeyError(f"unknown tier {tier!r}")
        if not self._free_rows:
            raise RuntimeError(f"all {self.max_seqs} sequence rows in use")
        row = self._free_rows.pop()
        self._rows[row] = _Row(tier)
        return row

    def close(self, row: int) -> None:
        """Release a row and every page it maps."""
        vpns = self._table[row][self._table[row] >= 0]
        if len(vpns):
            self.vm.free(self.tenant, [int(v) for v in vpns])
        self._table[row] = -1
        del self._rows[row]
        self._free_rows.append(row)

    def ensure(self, row: int, n_tokens: int) -> bool:
        """Grow the row's block table to hold ``n_tokens``; False = pool
        full (no device frames of the row's class — caller preempts or
        defers; nothing is allocated on failure)."""
        r = self._rows[row]
        nb = self.blocks_for(n_tokens)
        if nb > self.max_blocks:
            raise ValueError(f"{n_tokens} tokens > {self.max_blocks} blocks")
        need = nb - r.blocks
        if need <= 0:
            return True
        vpns = self.vm.alloc(self.tenant, need * self.n_layers,
                             segment=r.tier, allow_host=False, zero=False,
                             pool=self.pool_name)
        if vpns is None:
            return False
        got = np.asarray(vpns, np.int64).reshape(self.n_layers, need)
        self._table[row, :, r.blocks:nb] = got
        r.blocks = nb
        self._sync(vpns)
        return True

    # -- residency -----------------------------------------------------------
    def resident(self, row: int) -> bool:
        """True iff every mapped page is home-pool device-resident."""
        vpns = self._table[row][self._table[row] >= 0]
        return bool((self._phys[vpns] >= 0).all()) if len(vpns) else True

    def host_pages(self, row: int) -> int:
        vpns = self._table[row][self._table[row] >= 0]
        return int((self._phys[vpns] < 0).sum()) if len(vpns) else 0

    def preempt(self, row: int) -> int:
        """Swap the row's device pages to the VM host tier (KV preserved
        bit-exact); returns pages moved."""
        from repro_torch.obs import metrics, tracing
        tier = self._rows[row].tier
        vpns = [int(v) for v in self._table[row][self._table[row] >= 0]
                if self._phys[v] >= 0 or self.vm.translate(
                    self.tenant, int(v)).pool is not None]
        with tracing.span("migrate.preempt_to_host", row=row, tier=tier,
                          pages=len(vpns)):
            moved = self.vm.swap_out(self.tenant, vpns) if vpns else 0
        self._sync(vpns)
        if metrics.enabled():
            metrics.counter(
                metrics.NAME_PREEMPTIONS,
                "sequences preempted to the host swap tier",
                labels=("tier",)).labels(tier=tier).inc()
        return moved

    def restore(self, row: int) -> bool:
        """Bring a preempted row's pages back into the home pool.

        Re-lands every off-home page in a fresh home-pool frame through the
        VM data plane — the host reads are the page faults the capacity
        mode controls — then retires the old mappings. False = not enough
        free frames (nothing changes; caller makes room and retries).
        """
        from repro_torch.obs import metrics, tracing
        r = self._rows[row]
        vpns = self._table[row]
        off = np.argwhere((vpns >= 0) & (self._phys[np.clip(vpns, 0, None)]
                                         < 0))
        if not len(off):
            return True
        old = [int(vpns[tuple(ix)]) for ix in off]
        new = self.vm.alloc(self.tenant, len(old), segment=r.tier,
                            allow_host=False, zero=False,
                            pool=self.pool_name)
        if new is None:
            return False
        with tracing.span("migrate.restore_from_host", row=row, tier=r.tier,
                          pages=len(old)):
            data = self.vm.read(self.tenant, old)       # the page fault(s)
            self.vm.write(self.tenant, new, data)
        self.vm.free(self.tenant, old)
        for ix, nv in zip(off, new):
            self._table[row][tuple(ix)] = nv
        self._sync(new)
        if metrics.enabled():
            metrics.counter(
                metrics.NAME_RESTORES,
                "preempted sequences restored to device frames",
                labels=("tier",)).labels(tier=r.tier).inc()
        return True

    def refresh(self) -> dict:
        """Rebuild the vpn→phys mirror from the VM page tables.

        Call after any repartition / migration touching the pool (the
        objcache's ``refresh_translation`` idiom): pages that moved to the
        host tier or a foreign pool flip to non-resident, and the scheduler
        preempts the sequences that own them before the next decode gather.
        """
        space = self.vm.tenants[self.tenant]
        if space.entries:
            self._grow(max(space.entries))
        away = device = 0
        for vpn, pte in space.entries.items():
            if pte.pool == self.pool_name:
                self._phys[vpn] = pte.phys
                device += 1
            else:
                self._phys[vpn] = -1
                away += 1
        return {"device_pages": device, "away_pages": away}

    # -- the decode-step index maps ------------------------------------------
    def gather_phys(self, rows: np.ndarray) -> np.ndarray:
        """Block tables of a decode batch as one page-id array.

        ``rows`` is ``(B,)`` int (-1 = unbound slot). Returns ``(B,
        n_layers, max_blocks)`` int32 physical page ids — the index map of
        the step's single mixed-pool gather. Unbound slots and unallocated
        block slots point at the scratch page (their data is masked by
        ``cache_len`` downstream); every mapped block of a bound row must
        be home-device-resident (the scheduler's invariant).
        """
        rows = np.asarray(rows)
        safe = np.clip(rows, 0, None)
        vpns = self._table[safe]                       # (B, L, maxB)
        vpns = np.where(rows[:, None, None] >= 0, vpns, -1)
        phys = np.where(vpns >= 0, self._phys[np.clip(vpns, 0, None)], -1)
        if (np.where(vpns >= 0, phys, 0) < 0).any():
            bad = sorted({int(r) for r in
                          rows[(np.where(vpns >= 0, phys, 0) < 0)
                               .any(axis=(1, 2))]})
            raise RuntimeError(
                f"rows {bad} have non-resident pages in the decode batch; "
                "preempt or restore them first")
        return np.where(phys >= 0, phys,
                        self.scratch_phys).astype(np.int32)

    def current_block_phys(self, rows: np.ndarray,
                           lens: np.ndarray) -> np.ndarray:
        """Physical page of each slot's *current* block (the one token
        ``lens`` lands in) — the index map of the step's single scatter.
        Returns ``(B, n_layers)`` int32; unbound slots write the scratch
        page."""
        rows = np.asarray(rows)
        lens = np.asarray(lens)
        safe = np.clip(rows, 0, None)
        blk = np.clip(lens // self.block_tokens, 0, self.max_blocks - 1)
        vpns = np.take_along_axis(self._table[safe],
                                  blk[:, None, None], axis=2)[:, :, 0]
        vpns = np.where(rows[:, None] >= 0, vpns, -1)
        phys = np.where(vpns >= 0, self._phys[np.clip(vpns, 0, None)], -1)
        return np.where(phys >= 0, phys,
                        self.scratch_phys).astype(np.int32)

    # -- internals -----------------------------------------------------------
    def _grow(self, vmax: int) -> None:
        if vmax < len(self._phys):
            return
        n = max(vmax + 1, 2 * len(self._phys))
        grown = np.full(n, -1, np.int32)
        grown[:len(self._phys)] = self._phys
        self._phys = grown

    def _sync(self, vpns) -> None:
        """Refresh the mirror for specific vpns from the page tables."""
        if not len(vpns):
            return
        self._grow(max(int(v) for v in vpns))
        space = self.vm.tenants[self.tenant]
        for v in vpns:
            pte = space.entries[int(v)]
            self._phys[int(v)] = pte.phys \
                if pte.pool == self.pool_name else -1


def token_words_for(num_kv_heads: int, head_dim: int,
                    dtype: torch.dtype = torch.float32) -> int:
    """32-bit words one token of one layer's K+V occupies in a pool page."""
    if dtype.itemsize != 4:
        raise ValueError(
            f"paged KV packs 4-byte elements into 32-bit pool words; "
            f"got {dtype} (cast the cache to float32)")
    return 2 * num_kv_heads * head_dim
