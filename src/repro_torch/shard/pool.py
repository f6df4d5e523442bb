"""CREAM-Shard — the CREAM pool split into rank-subset banks.

Port of ``repro/shard/pool.py``. The paper's second headline claim is that
CREAM increases bank-level parallelism: rank subsetting (§4.1.2) splits a
DIMM into independently addressable subsets (Figs. 9–11). A
:class:`ShardedPool` stripes the global page-id space round-robin over
``S`` banks (:mod:`repro_torch.shard.router`); every bank is an
identically-shaped CREAM mini-pool ``(R_local, 9, W)`` with its own
boundary register, all moved in lockstep.

The reference places the banks on ``S`` devices of a ``banks`` mesh. Here
all ``S`` banks live in one contiguous ``(S, R_local, 9, W)`` int32 tensor
on one card — rank subsets of one DIMM — and ``storage[s]`` is bank ``s``
as a contiguous view, so every local verb and kernel of
:mod:`repro_torch.core.pool` runs on it unchanged and in place.

  * :meth:`ShardedPool.read` of page ids is one launch of the router-fused
    mixed read (:func:`repro_torch.kernels.mixed.ops.read_correct_routed`);
    status reads, and every read of a pool with a SEC-DAEC tier (the fused
    read corrects with SECDED only), go through the local engine bank by
    bank and are assembled in batch order.
  * :meth:`ShardedPool.write` lands the last valid row of each page
    (:func:`repro_torch.core.pool._landing_rows` on the global batch),
    routes, and writes each bank's pages in place.
  * :func:`migrate_pages` is the reference's ``ppermute`` ring on one
    card: read every source page (routed), then write each into its
    destination's bank — the ring also reads every source before it lands
    anything, so the storage is the ring's.
  * :func:`repartition` and :func:`set_daec_rows` move every bank's
    boundary or DAEC tier in lockstep; :func:`scrub` sweeps bank by bank
    and reports corrupt rows as global rows (``local * S + bank``).

Writes and migrations update the storage in place (the reference donates
it); :func:`repartition`, :func:`set_daec_rows`, :func:`scrub` and
``migrate(donate=False)`` work on copies and leave the input valid.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.core import pool as pool_lib
from repro_torch.core.layouts import (GROUP_ROWS, LANES, Layout,
                                      extra_page_count)
from repro_torch.core.pool import PoolState
from repro_torch.kernels.common import resolve_device, upload
from repro_torch.kernels.mixed import ops as mixed_ops
from repro_torch.shard import router


@dataclass
class ShardedPool:
    """``storage`` (S, R_local, 9, W) int32 plus the per-bank geometry.

    Page ids follow the global convention of a local pool; ``daec_rows``
    global DAEC rows are the top ``daec_rows_local`` rows of every bank.
    """
    storage: torch.Tensor
    boundary_local: int
    layout: Layout
    row_words: int
    daec_rows_local: int = 0

    # -- geometry (global page ids, the same as PoolState's) ----------------
    @property
    def device(self) -> torch.device:
        return self.storage.device

    @property
    def num_shards(self) -> int:
        return self.storage.shape[0]

    @property
    def rows_local(self) -> int:
        return self.storage.shape[1]

    @property
    def num_rows(self) -> int:
        return self.num_shards * self.rows_local

    @property
    def boundary(self) -> int:
        return self.num_shards * self.boundary_local

    @property
    def boundary_step(self) -> int:
        """Boundaries move in lockstep across banks: S * GROUP_ROWS rows."""
        return self.num_shards * GROUP_ROWS

    @property
    def daec_rows(self) -> int:
        return self.num_shards * self.daec_rows_local

    @property
    def daec_start(self) -> int:
        """First global DAEC-tier page id (== num_rows without a tier)."""
        return self.num_rows - self.daec_rows

    @property
    def extra_pages_local(self) -> int:
        return extra_page_count(self.layout, self.boundary_local,
                                self.row_words)

    @property
    def num_extra_pages(self) -> int:
        return self.num_shards * self.extra_pages_local

    @property
    def num_pages(self) -> int:
        return self.num_rows + self.num_extra_pages

    @property
    def page_words(self) -> int:
        return 8 * self.row_words

    @property
    def page_bytes(self) -> int:
        return 4 * self.page_words

    @property
    def raw_bytes(self) -> int:
        return self.storage.numel() * 4

    @property
    def effective_bytes(self) -> int:
        return self.num_pages * self.page_bytes

    def capacity_gain(self) -> float:
        return self.num_extra_pages / self.num_rows

    @property
    def has_parity(self) -> bool:
        return self.layout == Layout.PARITY and self.boundary > 0

    def bank(self, s: int) -> PoolState:
        """Bank ``s`` as a local pool over a view of the storage: its
        writes land in this pool's storage."""
        return PoolState(self.storage[s], self.boundary_local, self.layout,
                         self.row_words, self.daec_rows_local)

    # -- the data plane ------------------------------------------------------
    def read(self, pages, *, status=False):
        """Batch read of global page ids -> ``(n, page_words)`` int32, or
        ``(data, status (n,) int32)`` with ``status=True``."""
        ids = pool_lib._host_ids(self, pages)
        if status or self.daec_rows_local:
            data, st = _read_status(self, ids)
            return (data, st) if status else data
        return mixed_ops.read_correct_routed(
            self.storage, upload(ids, self.device), self.layout,
            self.num_rows, self.boundary, self.num_shards)

    def write(self, pages, data, *, valid=None) -> "ShardedPool":
        """Code-maintaining batch write, in place; returns this pool.
        ``valid`` (optional ``(n,)`` bool) drops masked rows; of duplicate
        ids the last valid row lands."""
        ids = pool_lib._host_ids(self, pages)
        if not ids.size:
            return self
        words = pool_lib._as_words(self, data, ids.size)
        land = pool_lib._landing_rows(ids, valid)
        shard, local = router.route_np(ids, self.num_rows, self.num_shards)
        for s in range(self.num_shards):
            sel = np.flatnonzero(land & (shard == s))
            if sel.size:
                pool_lib._write_in_place(
                    self.bank(s), local[sel],
                    words[upload(sel, self.device)])
        return self

    def migrate(self, src_pages, dst_pages, *,
                donate: bool = True) -> "ShardedPool":
        """Relocate pages ``src -> dst`` across banks (see
        :func:`migrate_pages`)."""
        return migrate_pages(self, src_pages, dst_pages, donate=donate)

    def streams(self, pages, data=None, *, valid=None):
        """Bank-aligned ``(S, n)`` access: reads ``(S, n, page_words)``
        with ``data=None``, else writes and returns the pool (see
        :func:`read_streams`, :func:`write_streams`)."""
        if data is None:
            return read_streams(self, pages)
        return write_streams(self, pages, data, valid=valid)

    # -- control plane -------------------------------------------------------
    def evict_prediction(self, new_boundary: int) -> list[int]:
        return evicted_extra_pages(self, new_boundary)

    def move_boundary(self, new_boundary: int) -> tuple["ShardedPool", dict]:
        return repartition(self, new_boundary)

    def set_daec_rows(self, daec_rows: int) -> "ShardedPool":
        return set_daec_rows(self, daec_rows)

    def scrub(self, use_kernel: bool = False):
        """Sweep + repair every bank -> ``(new_pool, ScrubStats)``; leaves
        this pool valid. ``use_kernel`` is ignored, as for local pools."""
        return scrub(self)


def make_sharded_pool(num_rows: int, layout: Layout = Layout.INTERWRAP,
                      boundary: int | None = None, *, num_shards: int,
                      row_words: int = 64, daec_rows: int = 0,
                      device=None) -> ShardedPool:
    """A zeroed pool of ``num_rows`` global rows in ``num_shards`` banks,
    on ``device`` (``cuda`` unless asked otherwise).

    ``boundary`` (global, default: the whole pool CREAM) and ``num_rows``
    must be multiples of ``num_shards * GROUP_ROWS``; ``daec_rows`` global
    rows, a multiple of ``num_shards``, carve the SEC-DAEC tier.
    """
    boundary = num_rows if boundary is None else boundary
    if layout == Layout.BASELINE_ECC:
        boundary = 0
    router.check_geometry(num_rows, boundary, num_shards)
    if daec_rows % num_shards:
        raise ValueError(
            f"daec_rows ({daec_rows}) must shard evenly over {num_shards}")
    if not 0 <= daec_rows <= num_rows - boundary:
        raise ValueError(
            f"daec_rows ({daec_rows}) must fit the protected region "
            f"[{boundary}, {num_rows})")
    if row_words % 8:
        raise ValueError("row_words must be a multiple of 8")
    storage = torch.zeros((num_shards, num_rows // num_shards, LANES,
                           row_words), dtype=torch.int32,
                          device=resolve_device(device))
    return ShardedPool(storage, boundary // num_shards, layout, row_words,
                       daec_rows // num_shards)


def _read_status(pool: ShardedPool, ids: np.ndarray
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """Bank-by-bank read with status through the local engine (DAEC and
    PARITY aware), assembled in batch order."""
    n = ids.size
    data = torch.empty((n, pool.page_words), dtype=torch.int32,
                       device=pool.device)
    status = torch.empty((n,), dtype=torch.int32, device=pool.device)
    shard, local = router.route_np(ids, pool.num_rows, pool.num_shards)
    for s in range(pool.num_shards):
        sel = np.flatnonzero(shard == s)
        if sel.size:
            idx = upload(sel, pool.device)
            data[idx], status[idx] = pool_lib.read_pages_any_status(
                pool.bank(s), local[sel])
    return data, status


# ---------------------------------------------------------------------------
# Bank-aligned streams
# ---------------------------------------------------------------------------


def _stream_ids(pool: ShardedPool, pages) -> np.ndarray:
    """``(S, n)`` global ids whose row ``s`` lies in bank ``s`` -> their
    local ids, validated on the host."""
    p = np.asarray(pages.cpu() if isinstance(pages, torch.Tensor) else pages,
                   np.int64)
    if p.ndim != 2 or p.shape[0] != pool.num_shards:
        raise ValueError(f"streams must be ({pool.num_shards}, n) ids, got "
                         f"{p.shape}")
    pool_lib._host_ids(pool, p)
    shard, local = router.route_np(p, pool.num_rows, pool.num_shards)
    if (shard.reshape(p.shape) != np.arange(p.shape[0])[:, None]).any():
        raise ValueError("stream s must hold pages of bank s only")
    return local.reshape(p.shape)


def read_streams(pool: ShardedPool, pages) -> torch.Tensor:
    """Serve ``S`` request streams, one per bank: ``pages`` is ``(S, n)``
    global ids, stream ``s`` touching bank ``s`` only (plan them with
    :func:`repro_torch.shard.router.plan_streams`). Each bank reads only
    its own ``n`` pages. Returns ``(S, n, page_words)``."""
    local = _stream_ids(pool, pages)
    return torch.stack([pool.bank(s).read(local[s])
                        for s in range(pool.num_shards)])


def write_streams(pool: ShardedPool, pages, data, valid=None
                  ) -> ShardedPool:
    """Per-bank write of ``S`` aligned streams (see :func:`read_streams`):
    ``data`` ``(S, n, page_words)``, ``valid`` optional ``(S, n)`` bool."""
    local = _stream_ids(pool, pages)
    for s in range(pool.num_shards):
        pool.bank(s).write(local[s], data[s],
                           valid=None if valid is None else valid[s])
    return pool


# ---------------------------------------------------------------------------
# Migration, repartitioning, DAEC tier, scrub
# ---------------------------------------------------------------------------


def migrate_pages(pool: ShardedPool, src_pages, dst_pages,
                  donate: bool = True) -> ShardedPool:
    """Live in-pool migration ``src -> dst`` across bank boundaries.

    Every source page is read decode-corrected (one routed read), then
    each lands in its destination's bank with a code-maintaining write.
    ``donate=False`` works on a copy and keeps ``pool`` valid.
    """
    data = pool.read(src_pages)
    target = pool if donate else dataclasses.replace(
        pool, storage=pool.storage.clone())
    return target.write(dst_pages, data)


def evicted_extra_pages(pool: ShardedPool, new_boundary: int) -> list[int]:
    """Global extra-page ids a move to ``new_boundary`` would evict: the
    trailing range, since extras stripe round-robin."""
    if new_boundary >= pool.boundary:
        return []
    x_new = extra_page_count(pool.layout, new_boundary // pool.num_shards,
                             pool.row_words)
    return list(range(pool.num_rows + pool.num_shards * x_new,
                      pool.num_rows + pool.num_extra_pages))


def repartition(pool: ShardedPool, new_boundary: int
                ) -> tuple[ShardedPool, dict]:
    """Move every bank's CREAM/SECDED boundary in lockstep; the semantics
    of :func:`repro_torch.core.pool.repartition` per bank. Works on a copy.
    """
    router.check_geometry(pool.num_rows, new_boundary, pool.num_shards)
    old = pool.boundary
    info = {"old_boundary": old, "new_boundary": new_boundary,
            "evicted_extra_pages": [], "pages_reencoded": 0}
    if new_boundary == old:
        return pool, info
    info["evicted_extra_pages"] = evicted_extra_pages(pool, new_boundary)
    info["pages_reencoded"] = abs(new_boundary - old)
    nb_local = new_boundary // pool.num_shards
    banks = [pool_lib.repartition(pool.bank(s), nb_local)[0].storage
             for s in range(pool.num_shards)]
    return dataclasses.replace(pool, storage=torch.stack(banks),
                               boundary_local=nb_local), info


def set_daec_rows(pool: ShardedPool, daec_rows: int) -> ShardedPool:
    """Resize the SEC-DAEC tier (``daec_rows`` global, a multiple of S):
    every bank re-encodes its own top span. Works on a copy."""
    S = pool.num_shards
    if daec_rows % S:
        raise ValueError(
            f"daec_rows ({daec_rows}) must shard evenly over {S}")
    if not 0 <= daec_rows <= pool.num_rows - pool.boundary:
        raise ValueError(
            f"daec_rows ({daec_rows}) must fit the protected region "
            f"[{pool.boundary}, {pool.num_rows})")
    n_local = daec_rows // S
    if n_local == pool.daec_rows_local:
        return pool
    banks = [pool_lib.set_daec_rows(pool.bank(s), n_local).storage
             for s in range(S)]
    return dataclasses.replace(pool, storage=torch.stack(banks),
                               daec_rows_local=n_local)


def scrub(pool: ShardedPool):
    """Sweep every bank -> ``(new_pool, ScrubStats)``: the censuses
    summed, corrupt rows mapped back to global rows (``local * S + bank``)
    and sorted. Works on a copy."""
    from repro_torch.core.scrubber import ScrubStats
    from repro_torch.core.scrubber import scrub as _scrub
    S = pool.num_shards
    banks, merged, corrupt = [], {}, []
    for s in range(S):
        new_bank, stats = _scrub(pool.bank(s))
        banks.append(new_bank.storage)
        for f in dataclasses.fields(ScrubStats):
            if f.name != "corrupt_rows":
                merged[f.name] = merged.get(f.name, 0) + getattr(stats,
                                                                 f.name)
        corrupt.extend(r * S + s for r in stats.corrupt_rows)
    return (dataclasses.replace(pool, storage=torch.stack(banks)),
            ScrubStats(corrupt_rows=tuple(sorted(corrupt)), **merged))
