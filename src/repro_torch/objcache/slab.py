"""Slab/extent allocator: variable-size values onto VM pages.

Port of ``repro/objcache/slab.py`` over the port's
:class:`~repro_torch.vm.address_space.VirtualMemory`: the control plane is
numpy and host-only, line for line the reference's.

One allocator instance manages the chunks of a single reliability class:
its pages are allocated from the VM under that class's segment (so the
frames' storage class honours the contract), each page is cut into
fixed-size chunks of one size class, and a value occupies the smallest
chunk that fits it. The control plane is vectorised numpy — free lists are
LIFO arrays popped/pushed a batch at a time, never one chunk per Python
iteration — and growing is on-demand: when a reservation outruns the free
chunks, pages are claimed from the VM (``allow_host=False``; capacity the
VM cannot provide surfaces as a failed reservation the cache answers with
eviction). That on-demand growth *is* the live-capacity bridge: a protection
demotion frees weaker-class frames, the very next reservation claims them,
and the cache's effective capacity (and hit rate) rises online.

Pages whose frames migrate to the host swap tier (a protection upgrade
shrank the pool) are quarantined via :meth:`SlabAllocator.drop_vpns`: their
free chunks leave the lists so new values never land somewhere the batched
device get path cannot reach. Fully-free pages are not returned to the VM
(slab pages are sticky, as in memcached); ``drop_vpns`` is the one exception.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.protection import Protection
from repro_torch.vm.address_space import VirtualMemory


def default_chunk_words(page_words: int) -> tuple[int, ...]:
    """Size classes: powers of two from an eighth of a page up to a page."""
    return (page_words // 8, page_words // 4, page_words // 2, page_words)


class SlabAllocator:
    """Chunked value storage of one reliability class over VM pages."""

    def __init__(self, vm: VirtualMemory, tenant: str, segment: str,
                 reliability: Protection, pool: str,
                 chunk_words: tuple[int, ...] | None = None):
        self.vm = vm
        self.tenant = tenant
        self.segment = segment
        self.reliability = reliability
        self.pool = pool
        pw = vm.page_words
        self.chunk_words = tuple(chunk_words or default_chunk_words(pw))
        if any(pw % c for c in self.chunk_words):
            raise ValueError(f"chunk sizes {self.chunk_words} must divide "
                             f"the page ({pw} words)")
        ncls = len(self.chunk_words)
        self._free_vpn = [np.zeros(0, np.int64) for _ in range(ncls)]
        self._free_off = [np.zeros(0, np.int32) for _ in range(ncls)]
        self.vpns: set[int] = set()          # every page this slab owns
        self.pages_claimed = 0

    # -- geometry ------------------------------------------------------------
    def size_class(self, lens: np.ndarray) -> np.ndarray:
        """(n,) value lengths (words) -> (n,) smallest fitting class index."""
        lens = np.asarray(lens)
        if lens.size and int(lens.max()) > self.chunk_words[-1]:
            raise ValueError(
                f"value of {int(lens.max())} words exceeds the largest "
                f"chunk ({self.chunk_words[-1]} words)")
        if lens.size and int(lens.min()) < 1:
            raise ValueError("values must be at least one word long")
        return np.searchsorted(np.asarray(self.chunk_words), lens,
                               side="left").astype(np.int32)

    def free_chunks(self, cls: int) -> int:
        return len(self._free_vpn[cls])

    # -- grow ----------------------------------------------------------------
    def _grow(self, cls: int, n_chunks: int) -> int:
        """Claim VM pages and cut them into class-``cls`` chunks; returns the
        number of chunks actually added (the VM may be short on frames)."""
        chunk = self.chunk_words[cls]
        per_page = self.vm.page_words // chunk
        want_pages = -(-n_chunks // per_page)
        avail = len(self.vm.allocators[self.pool].peek(self.reliability,
                                                       want_pages))
        pages = min(want_pages, avail)
        if pages == 0:
            return 0
        # zero=False: chunks are always fully written before first read
        vpns = self.vm.alloc(self.tenant, pages, segment=self.segment,
                             allow_host=False, zero=False, pool=self.pool)
        if vpns is None:
            return 0
        self.vpns.update(vpns)
        self.pages_claimed += pages
        offs = np.arange(per_page, dtype=np.int32) * chunk
        self._free_vpn[cls] = np.concatenate(
            [self._free_vpn[cls], np.repeat(np.asarray(vpns, np.int64),
                                            per_page)])
        self._free_off[cls] = np.concatenate(
            [self._free_off[cls], np.tile(offs, pages)])
        return pages * per_page

    # -- reserve / release ---------------------------------------------------
    def reserve(self, lens: np.ndarray, partial: bool = False
                ) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
        """Reserve one chunk per value -> ``(vpn, off, cls, taken)``.

        Grows from the VM on shortfall. With ``partial=False`` the
        reservation is atomic: when the VM cannot provide enough frames,
        nothing is taken (``taken`` all False) — the caller evicts and
        retries. With ``partial=True`` whatever fits is taken, earliest
        values first within each size class.
        """
        cls = self.size_class(lens)
        n = len(cls)
        counts = np.bincount(cls, minlength=len(self.chunk_words))
        short_somewhere = False
        for c, need in enumerate(counts):
            short = int(need) - self.free_chunks(c)
            if short > 0:
                self._grow(c, short)
            if self.free_chunks(c) < int(need):
                short_somewhere = True
        vpn = np.zeros(n, np.int64)
        off = np.zeros(n, np.int32)
        taken = np.zeros(n, bool)
        if short_somewhere and not partial:
            return vpn, off, cls, taken
        for c in range(len(self.chunk_words)):     # ~4 classes, not n keys
            idxs = np.flatnonzero(cls == c)
            k = min(len(idxs), self.free_chunks(c))
            if not k:
                continue
            sel = idxs[:k]
            vpn[sel] = self._free_vpn[c][-k:]
            off[sel] = self._free_off[c][-k:]
            self._free_vpn[c] = self._free_vpn[c][:-k]
            self._free_off[c] = self._free_off[c][:-k]
            taken[sel] = True
        return vpn, off, cls, taken

    def release(self, vpn: np.ndarray, off: np.ndarray, cls: np.ndarray
                ) -> None:
        """Return chunks to their free lists (batched push)."""
        vpn, off, cls = (np.asarray(vpn, np.int64), np.asarray(off, np.int32),
                        np.asarray(cls))
        for c in range(len(self.chunk_words)):
            sel = cls == c
            if not sel.any():
                continue
            keep = np.isin(vpn[sel], np.fromiter(self.vpns, np.int64,
                                                 len(self.vpns)))
            self._free_vpn[c] = np.concatenate([self._free_vpn[c],
                                                vpn[sel][keep]])
            self._free_off[c] = np.concatenate([self._free_off[c],
                                                off[sel][keep]])

    def drop_vpns(self, vpns) -> None:
        """Quarantine pages (e.g. migrated to host swap): purge their free
        chunks and forget them, so no new value lands out of device reach."""
        gone = set(int(v) for v in vpns) & self.vpns
        if not gone:
            return
        self.vpns -= gone
        garr = np.fromiter(gone, np.int64, len(gone))
        for c in range(len(self.chunk_words)):
            keep = ~np.isin(self._free_vpn[c], garr)
            self._free_vpn[c] = self._free_vpn[c][keep]
            self._free_off[c] = self._free_off[c][keep]
