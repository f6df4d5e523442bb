"""Vectorised open-addressing hash index over device tensors.

Port of ``repro/objcache/hash_index.py``. The index maps a uint32 key to
the physical pool page (plus word offset and length) holding its value, so
the batched get resolves keys straight against pool storage. The probe
sequence below is the single definition the fused probe kernel
(``csrc/hash.cu``) must match slot for slot.

Collision policy is bounded linear probing: a key lives in the first
matching slot of its ``probe``-long window; lookups scan the whole window
and inserts claim the first EMPTY/TOMB slot by a first-writer-wins scatter
— ``probe`` rounds of tensor work, never a per-key host loop.

Keys are uint32 bit patterns in ``int32`` tensors, so the sentinels EMPTY
and TOMB read as -1 and -2. The hash and every unsigned comparison run in
int64 on the low 32 bits (:func:`_u32`); nothing relies on int32 overflow.
Functional like the reference: each update returns a new index and leaves
the input's tensors as they were.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import torch

from repro_torch.kernels.common import resolve_device, s32

#: Slot-state sentinels in the key array. User keys must be < TOMB.
EMPTY = 0xFFFFFFFF
TOMB = 0xFFFFFFFE
MAX_KEY = TOMB - 1

#: Knuth's multiplicative constant (2^32 / golden ratio), in 16-bit halves
#: so the int64 products below stay under 2^49.
_KNUTH = 2654435761
_KNUTH_LO, _KNUTH_HI = _KNUTH & 0xFFFF, _KNUTH >> 16


def _u32(x: torch.Tensor) -> torch.Tensor:
    """int32 bit patterns -> their uint32 values as int64."""
    return x.long() & 0xFFFFFFFF


def _hash64(keys: torch.Tensor) -> torch.Tensor:
    """:func:`hash_u32` as uint32 values in int64."""
    k = _u32(keys)
    k = (k * _KNUTH_LO + (((k * _KNUTH_HI) & 0xFFFF) << 16)) & 0xFFFFFFFF
    return k ^ (k >> 16)


def hash_u32(keys: torch.Tensor) -> torch.Tensor:
    """Multiplicative hash with an xor-shift finaliser (uint32 -> uint32,
    as int32 bit patterns)."""
    h = _hash64(keys)
    return torch.where(h >= 1 << 31, h - (1 << 32), h).to(torch.int32)


def probe_slots(queries: torch.Tensor, capacity: int,
                probe: int) -> torch.Tensor:
    """(n,) keys -> (n, probe) int64 candidate slots (linear window, mod C)."""
    h = _hash64(queries) % capacity
    r = torch.arange(probe, dtype=torch.int64, device=queries.device)
    return (h[:, None] + r[None, :]) % capacity


@dataclass
class HashIndex:
    """Index state: (C,) int32 tensors plus the static probe window."""
    key: torch.Tensor        # stored key bits, or EMPTY / TOMB
    page: torch.Tensor       # physical pool page of the value
    off: torch.Tensor        # word offset within the page
    length: torch.Tensor     # value length in words
    probe: int

    @property
    def capacity(self) -> int:
        return self.key.shape[0]

    @property
    def live(self) -> torch.Tensor:
        return _u32(self.key) < TOMB


def make_index(capacity: int, probe: int = 16, device=None) -> HashIndex:
    """Create an empty index on ``device`` (``cuda`` unless asked
    otherwise). ``probe`` bounds the displacement of any key."""
    if probe < 1 or probe > capacity:
        raise ValueError(f"bad probe window {probe} for capacity {capacity}")
    device = resolve_device(device)
    zeros = lambda: torch.zeros((capacity,), dtype=torch.int32,  # noqa: E731
                                device=device)
    return HashIndex(key=torch.full((capacity,), s32(EMPTY),
                                    dtype=torch.int32, device=device),
                     page=zeros(), off=zeros(), length=zeros(), probe=probe)


def find(index: HashIndex, queries: torch.Tensor
         ) -> tuple[torch.Tensor, torch.Tensor]:
    """Batched probe: (n,) int32 keys -> (slot (n,) int64, found (n,) bool).

    ``slot[i] == capacity`` when absent. One gather over the whole window
    per key; the first match wins (argmax takes the first maximum).
    """
    c = index.capacity
    cand = probe_slots(queries, c, index.probe)
    hit = index.key[cand] == queries[:, None]
    first = torch.argmax(hit.to(torch.int8), dim=1)
    found = hit.any(dim=1)
    slot = cand.gather(1, first[:, None])[:, 0]
    return torch.where(found, slot, c), found


def lookup(index: HashIndex, queries: torch.Tensor
           ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor,
                      torch.Tensor]:
    """Resolve keys -> ``(page, off, length, slot, found)``, all (n,).

    Values for absent keys are zeroed (page 0 / off 0 / length 0) — callers
    mask on ``found``.
    """
    slot, found = find(index, queries)
    cs = torch.clamp(slot, max=index.capacity - 1)
    page = torch.where(found, index.page[cs], 0)
    off = torch.where(found, index.off[cs], 0)
    length = torch.where(found, index.length[cs], 0)
    return page, off, length, slot, found


def _spare(t: torch.Tensor) -> torch.Tensor:
    """A copy of ``t`` with one spare slot at index C: scatters route the
    entries the reference drops (``mode="drop"``) there."""
    return torch.cat([t, t.new_zeros(1)])


def insert(index: HashIndex, queries: torch.Tensor, pages: torch.Tensor,
           offs: torch.Tensor, lens: torch.Tensor
           ) -> tuple[HashIndex, torch.Tensor, torch.Tensor]:
    """Batched insert/update -> ``(index', slot (n,), ok (n,))``.

    Present keys update their slot in place; absent keys claim the first
    EMPTY/TOMB slot of their window over ``probe`` first-writer-wins rounds
    (in-batch conflicts on a slot resolve to the lowest batch position —
    callers must deduplicate keys within a batch). ``ok[i]`` is False when
    key ``i``'s whole window is occupied by other live keys.
    """
    c, p = index.capacity, index.probe
    n = queries.shape[0]
    dev = queries.device
    batch = torch.arange(n, dtype=torch.int64, device=dev)
    slot, found = find(index, queries)
    placed = found
    slots = torch.where(found, slot, c)
    key = _spare(index.key)
    cand_all = probe_slots(queries, c, p)
    for r in range(p):
        cand = cand_all[:, r]
        state = key[cand]
        want = ~placed & ((state == s32(EMPTY)) | (state == s32(TOMB)))
        # first-writer-wins: the lowest batch index claims a contested slot
        claim = torch.full((c + 1,), n, dtype=torch.int64, device=dev)
        claim.scatter_reduce_(0, torch.where(want, cand, c), batch, "amin")
        win = want & (claim[cand] == batch)
        key[torch.where(win, cand, c)] = queries
        slots = torch.where(win, cand, slots)
        placed = placed | win
    tgt = torch.where(placed, slots, c)
    fields = {}
    for name, vals in (("page", pages), ("off", offs), ("length", lens)):
        t = _spare(getattr(index, name))
        t[tgt] = vals.to(torch.int32)
        fields[name] = t[:c]
    new = dataclasses.replace(index, key=key[:c], **fields)
    return new, slots, placed


def delete(index: HashIndex, queries: torch.Tensor
           ) -> tuple[HashIndex, torch.Tensor]:
    """Batched delete -> ``(index', found (n,))``. Slots become tombstones."""
    slot, found = find(index, queries)
    return delete_slots(index, slot), found


def delete_slots(index: HashIndex, slots: torch.Tensor) -> HashIndex:
    """Tombstone slot ids (the eviction path — no probe needed); ids
    outside ``[0, C)`` are dropped."""
    c = index.capacity
    slots = slots.long()
    key = _spare(index.key)
    key[torch.where((slots >= 0) & (slots < c), slots, c)] = s32(TOMB)
    return dataclasses.replace(index, key=key[:c])


def replace_pages(index: HashIndex, pages: torch.Tensor) -> HashIndex:
    """Swap in a rebuilt slot->page translation (post-migration refresh)."""
    return dataclasses.replace(
        index, page=pages.to(index.key.device, torch.int32))
