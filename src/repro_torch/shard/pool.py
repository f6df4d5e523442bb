"""CREAM-Shard — the CREAM pool split into rank-subset banks.

Port of ``repro/shard/pool.py``. The paper's second headline claim is that
CREAM increases bank-level parallelism: rank subsetting (§4.1.2) splits a
DIMM into independently addressable subsets (Figs. 9–11). A
:class:`ShardedPool` stripes the global page-id space round-robin over
``S`` banks (:mod:`repro_torch.shard.router`); every bank is an
identically-shaped CREAM mini-pool ``(R_local, 9, W)`` with its own
boundary register, all moved in lockstep. The banks live in one of two
places:

**On a banks mesh** (``make_sharded_pool(..., mesh=make_banks_mesh(S))``),
as the reference places them: rank ``s`` of an ``S``-rank process group
(NCCL on the cards, gloo on the CPU) holds bank ``s`` as its local
``storage`` of shape ``(1, R_local, 9, W)``, and every rank calls every
verb with the same arguments, in the same order:

  * :meth:`ShardedPool.read`, with ``status=True`` too: every rank routes
    the ids on the host, reads the pages it owns with one launch of the
    shard-local router-fused read (other banks' rows and statuses zero),
    and one int32 SUM all-reduce assembles the batch on every rank, as the
    reference's ``psum``. A DAEC tier, or a PARITY status read, reads its
    owned ids through the local engine, masked, then the same all-reduce.
  * :meth:`ShardedPool.write` masks by ownership and needs no collective;
    ``read_writeback`` persists each rank's owned corrections.
  * :func:`read_streams` / :func:`write_streams`: rank ``s`` serves stream
    ``s``, and the read returns its ``(1, n, page_words)`` block of the
    banks-sharded ``(S, n, page_words)`` result.
  * :func:`migrate_pages` is the reference's ring: each rank reads its
    owned sources (the other rows zero), then ``S - 1`` steps pass the
    batch to rank ``s + 1`` (``batch_isend_irecv``), each rank landing the
    pages addressed to it at every step.
  * :func:`repartition` and :func:`set_daec_rows` run on the local bank,
    in lockstep on every rank; :func:`scrub` sweeps the local bank, sums
    the censuses with one all-reduce and all-gathers the corrupt rows as
    global rows (``local * S + bank``).

**On one card** (``mesh=None``): all ``S`` banks live in one contiguous
``(S, R_local, 9, W)`` int32 tensor — rank subsets of one DIMM — and
``storage[s]`` is bank ``s`` as a contiguous view, so every local verb and
kernel of :mod:`repro_torch.core.pool` runs on it unchanged and in place.

  * :meth:`ShardedPool.read` of page ids is one launch of the router-fused
    mixed read over all banks
    (:func:`repro_torch.kernels.mixed.ops.read_correct_routed`), with
    ``status=True`` too, whose status comes out of the same launch.
    Every read of a pool with a SEC-DAEC tier (the fused read corrects
    with SECDED only), and the status reads of a PARITY pool (whose status
    is the parity check, which the fused read does not run), go through
    the local engine bank by bank and are assembled in batch order.
  * :meth:`ShardedPool.read_writeback` runs the local write-back read
    bank by bank on views of a copy of the storage;
  * :meth:`ShardedPool.write` lands the last valid row of each page
    (:func:`repro_torch.core.pool._landing_rows` on the global batch),
    routes, and writes each bank's pages in place.
  * :func:`migrate_pages` is the ring on one card: read every source page
    (routed), then write each into its destination's bank — the ring also
    reads every source before it lands anything, so the storage is the
    ring's.
  * :func:`repartition` and :func:`set_daec_rows` move every bank's
    boundary or DAEC tier in lockstep; :func:`scrub` sweeps bank by bank
    and reports corrupt rows as global rows (``local * S + bank``).

Either way, of duplicate ids in a write the last valid row lands. Writes
and migrations update the storage in place (the reference donates it);
:func:`repartition`, :func:`set_daec_rows`, :func:`scrub` and
``migrate(donate=False)`` and ``read_writeback`` work on copies and
leave the input valid.

Telemetry keeps the reference's names: each routed read / write counts
one ``cream_shard_dispatch_total`` under its op and runs in a
``shard.fused.dispatch`` span; a migration counts its pages in
``cream_shard_ring_pages_total`` under a ``shard.migrate.ring`` span (on
one card a gather and a scatter); CREAM-Lens gets one record per bank of
each dispatch, against the bank's own geometry, on stream ``bank<s>`` —
on a mesh each rank records its own bank, and the union over the ranks
is the one-card pool's records.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core import pool as pool_lib
from repro_torch.core.layouts import (GROUP_ROWS, LANES, Layout,
                                      extra_page_count)
from repro_torch.core.pool import PoolState
from repro_torch.kernels.common import resolve_device, upload
from repro_torch.kernels.mixed import ops as mixed_ops
from repro_torch.obs import memprof as obs_memprof
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import tracing as obs_tracing
from repro_torch.shard import router


def _note_dispatch(op: str) -> None:
    """Count one routed host-side dispatch through the shard data plane."""
    if not obs_metrics.enabled():
        return
    obs_metrics.counter(
        obs_metrics.NAME_SHARD_DISPATCH,
        "routed dispatches through the sharded data plane",
        labels=("op",)).labels(op=op).inc()


def _memprof_routed(pool: "ShardedPool", op: str, pages,
                    stream: str = "main") -> None:
    """Feed one routed dispatch to CREAM-Lens, split per bank: each bank's
    local ids against its own geometry (``rows_local`` rows,
    ``boundary_local``), stream ``bank<s>`` (``<stream>/bank<s>`` off the
    main stream), so the replay models ``S`` independent bank arrays."""
    if not obs_memprof.enabled():
        return
    ids = pool_lib._host_ids(pool, pages)
    shard, local = router.route_np(ids, pool.num_rows, pool.num_shards)
    prefix = "" if stream == "main" else f"{stream}/"
    for s in _served(pool):
        loc = local[shard == s]
        if loc.size:
            obs_memprof.record(
                op, loc, layout=pool.layout, num_rows=pool.rows_local,
                boundary=pool.boundary_local, row_words=pool.row_words,
                stream=f"{prefix}bank{s}")


@dataclass
class ShardedPool:
    """``storage`` (S, R_local, 9, W) int32 plus the per-bank geometry; on
    a banks ``mesh`` this rank's bank alone, ``(1, R_local, 9, W)``.

    Page ids follow the global convention of a local pool; ``daec_rows``
    global DAEC rows are the top ``daec_rows_local`` rows of every bank.
    """
    storage: torch.Tensor
    boundary_local: int
    layout: Layout
    row_words: int
    daec_rows_local: int = 0
    #: the 1-D ``banks`` mesh the banks lie on, one a rank
    #: (:func:`repro_torch.launch.mesh.make_banks_mesh`); None: one card
    mesh: Any = None

    # -- geometry (global page ids, the same as PoolState's) ----------------
    @property
    def device(self) -> torch.device:
        return self.storage.device

    @property
    def num_shards(self) -> int:
        if self.mesh is not None:
            return self.mesh.devices.numel()
        return self.storage.shape[0]

    @property
    def bank_id(self) -> int | None:
        """The bank this rank holds on a mesh (its rank in the mesh); None
        on one card."""
        if self.mesh is None:
            return None
        return self.mesh.device_mesh.get_local_rank()

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
        banks = 1 if self.mesh is None else self.num_shards
        return self.storage.numel() * 4 * banks

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
        writes land in this pool's storage. On a mesh only this rank's
        own bank is here."""
        if self.mesh is not None:
            if s != self.bank_id:
                raise ValueError(f"bank {s} lies on rank {s} of the banks "
                                 f"mesh; this rank holds bank "
                                 f"{self.bank_id}")
            s = 0
        return PoolState(self.storage[s], self.boundary_local, self.layout,
                         self.row_words, self.daec_rows_local)

    # -- the data plane ------------------------------------------------------
    def read(self, pages, *, status=False):
        """Batch read of global page ids -> ``(n, page_words)`` int32, or
        ``(data, status (n,) int32)`` with ``status=True``."""
        ids = pool_lib._host_ids(self, pages)
        op = "read_status" if status else "read"
        _note_dispatch(op)
        _memprof_routed(self, "gather", ids)
        with obs_tracing.span("shard.fused.dispatch", op=op,
                              pages=int(ids.size), shards=self.num_shards):
            return _read(self, ids, status)

    @property
    def fused_status(self) -> bool:
        """Whether a status read is the fused read's status output: no
        DAEC tier (the fused read corrects with SECDED only) and a layout
        other than PARITY (whose status is the parity check)."""
        return not self.daec_rows_local and self.layout != Layout.PARITY

    def write(self, pages, data, *, valid=None) -> "ShardedPool":
        """Code-maintaining batch write, in place; returns this pool.
        ``valid`` (optional ``(n,)`` bool) drops masked rows; of duplicate
        ids the last valid row lands."""
        ids = pool_lib._host_ids(self, pages)
        _note_dispatch("write")
        _memprof_routed(self, "scatter", ids)
        with obs_tracing.span("shard.fused.dispatch", op="write",
                              pages=int(ids.size), shards=self.num_shards):
            return _write(self, ids, data, valid)

    def read_writeback(self, pages):
        """Write-back read of global page ids (see
        :meth:`repro_torch.core.pool.PoolState.read_writeback`): each bank
        persists the corrections of the pages it owns -> ``(data, status,
        new_pool)``. Works on a copy: this pool stays valid."""
        ids = pool_lib._host_ids(self, pages)
        _note_dispatch("read_writeback")
        _memprof_routed(self, "gather", ids)
        copy = dataclasses.replace(self, storage=self.storage.clone())
        data, status = _read_status(copy, ids, pool_lib._writeback_in_place)
        return data, status, copy

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

    def memprof_record(self, op: str, pages, stream: str = "main") -> None:
        """Feed one dispatch to CREAM-Lens, routed per bank."""
        _memprof_routed(self, op, pages, stream)

    # -- deprecated access surface (thin shims over the unified API) --------

    def read_any(self, pages) -> torch.Tensor:
        pool_lib._warn_deprecated("read_any", "read(pages)")
        return _read(self, pool_lib._host_ids(self, pages))

    def read_any_status(self, pages) -> tuple[torch.Tensor, torch.Tensor]:
        pool_lib._warn_deprecated("read_any_status",
                                  "read(pages, status=True)")
        return _read(self, pool_lib._host_ids(self, pages), status=True)

    def write_any(self, pages, data) -> "ShardedPool":
        pool_lib._warn_deprecated("write_any", "write(pages, data)")
        copy = dataclasses.replace(self, storage=self.storage.clone())
        return _write(copy, pool_lib._host_ids(self, pages), data)

    def read_pages(self, pages) -> torch.Tensor:
        pool_lib._warn_deprecated("read_pages", "read(pages)")
        return self.read(pages)

    def read_pages_status(self, pages) -> tuple[torch.Tensor, torch.Tensor]:
        pool_lib._warn_deprecated("read_pages_status",
                                  "read(pages, status=True)")
        return self.read(pages, status=True)

    def write_pages(self, pages, data) -> "ShardedPool":
        pool_lib._warn_deprecated("write_pages", "write(pages, data)")
        return self.write(pages, data)

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


def _served(pool: "ShardedPool"):
    """The banks this process reads and writes: every bank on one card,
    its own on a mesh."""
    return range(pool.num_shards) if pool.mesh is None else (pool.bank_id,)


def _all_reduce(pool: "ShardedPool", t: torch.Tensor) -> None:
    """In-place SUM of ``t`` over the banks mesh: each rank's share of a
    batch, the other banks' rows zero, becomes the assembled batch."""
    if t.numel():
        dist.all_reduce(t, op=dist.ReduceOp.SUM,
                        group=pool.mesh.device_mesh.get_group())


def _read(pool: "ShardedPool", ids: np.ndarray, status: bool = False,
          reduce: bool = True):
    """:meth:`ShardedPool.read` of validated ids, without its telemetry:
    one router-fused mixed read (with its status output for a status
    read), or for a DAEC tier, or a status read of a PARITY pool, the
    bank-by-bank status read. On a mesh the read is shard-local (other
    banks' rows zero) and, with ``reduce``, one all-reduce assembles it."""
    if pool.daec_rows_local or (status and not pool.fused_status):
        data, st = _read_status(pool, ids, reduce=reduce)
        return (data, st) if status else data
    if pool.mesh is None:
        return mixed_ops.read_correct_routed(
            pool.storage, upload(ids, pool.device), pool.layout,
            pool.num_rows, pool.boundary, pool.num_shards, status=status)
    buf = torch.empty(ids.size * (pool.page_words + int(status)),
                      dtype=torch.int32, device=pool.device)
    got = mixed_ops.read_correct_routed_local(
        pool.storage[0], upload(ids, pool.device), pool.layout,
        pool.num_rows, pool.boundary, pool.num_shards, pool.bank_id,
        status=status, out=buf)
    if reduce:
        _all_reduce(pool, buf)
    return got


def _write(pool: "ShardedPool", ids: np.ndarray, data, valid=None
           ) -> "ShardedPool":
    """:meth:`ShardedPool.write` of validated ids, without its telemetry:
    each bank writes the last valid row of each of its pages in place (on
    a mesh, this rank's bank: no collective)."""
    if not ids.size:
        return pool
    words = pool_lib._as_words(pool, data, ids.size)
    land = pool_lib._landing_rows(ids, valid)
    shard, local = router.route_np(ids, pool.num_rows, pool.num_shards)
    for s in _served(pool):
        sel = np.flatnonzero(land & (shard == s))
        if sel.size:
            pool_lib._write_in_place(pool.bank(s), local[sel],
                                     words[upload(sel, pool.device)])
    return pool


def make_sharded_pool(num_rows: int, layout: Layout = Layout.INTERWRAP,
                      boundary: int | None = None, *, num_shards: int,
                      row_words: int = 64, mesh=None, daec_rows: int = 0,
                      device=None) -> ShardedPool:
    """A zeroed pool of ``num_rows`` global rows in ``num_shards`` banks,
    on ``device`` (``cuda`` unless asked otherwise).

    ``boundary`` (global, default: the whole pool CREAM) and ``num_rows``
    must be multiples of ``num_shards * GROUP_ROWS``; ``daec_rows`` global
    rows, a multiple of ``num_shards``, carve the SEC-DAEC tier. With a
    1-D ``banks`` ``mesh`` of ``num_shards`` ranks each rank holds its own
    bank on ``device`` (this rank's card; ``cpu`` under gloo), and every
    rank makes the pool with the same arguments.
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
    device = resolve_device(device)
    banks = num_shards
    if mesh is not None:
        if tuple(mesh.axis_names) != ("banks",) \
                or mesh.devices.numel() != num_shards:
            raise ValueError(
                f"mesh must be a 1-D 'banks' mesh of {num_shards} devices")
        if mesh.device_mesh.device_type != device.type:
            raise ValueError(f"a {mesh.device_mesh.device_type} mesh holds "
                             f"no bank on {device}")
        banks = 1
    storage = torch.zeros((banks, num_rows // num_shards, LANES, row_words),
                          dtype=torch.int32, device=device)
    return ShardedPool(storage, boundary // num_shards, layout, row_words,
                       daec_rows // num_shards, mesh)


def _read_status(pool: ShardedPool, ids: np.ndarray,
                 read=pool_lib._read_any_status, reduce: bool = True
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """Bank-by-bank read with status through the local engine (DAEC and
    PARITY aware), assembled in batch order. ``read(bank, local_ids)``
    reads one bank: the status read, or the write-back read that repairs
    the bank's view of the storage in place. On a mesh this rank reads
    its owned ids into zeroed rows and, with ``reduce``, one all-reduce
    of data and status assembles the batch."""
    n, pw = ids.size, pool.page_words
    if pool.mesh is None:
        data = torch.empty((n, pw), dtype=torch.int32, device=pool.device)
        status = torch.empty((n,), dtype=torch.int32, device=pool.device)
    else:
        buf = torch.zeros(n * (pw + 1), dtype=torch.int32,
                          device=pool.device)
        data, status = buf[:n * pw].view(n, pw), buf[n * pw:]
    shard, local = router.route_np(ids, pool.num_rows, pool.num_shards)
    for s in _served(pool):
        sel = np.flatnonzero(shard == s)
        if sel.size:
            idx = upload(sel, pool.device)
            data[idx], status[idx] = read(pool.bank(s), local[sel])
    if pool.mesh is not None and reduce:
        _all_reduce(pool, buf)
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
    its own ``n`` pages. Returns ``(S, n, page_words)``; on a mesh, as the
    reference's result sharded over ``banks``, this rank's block of it,
    ``(1, n, page_words)``."""
    local = _stream_ids(pool, pages)
    _memprof_routed(pool, "gather", pages, stream="streams")
    return torch.stack([pool_lib._read_any_status(pool.bank(s), local[s])[0]
                        for s in _served(pool)])


def write_streams(pool: ShardedPool, pages, data, valid=None
                  ) -> ShardedPool:
    """Per-bank write of ``S`` aligned streams (see :func:`read_streams`):
    ``data`` ``(S, n, page_words)``, ``valid`` optional ``(S, n)`` bool; on
    a mesh each rank writes its own row ``s`` of them."""
    local = _stream_ids(pool, pages)
    _memprof_routed(pool, "scatter", pages, stream="streams")
    for s in _served(pool):
        pool_lib._write_in_place(pool.bank(s), local[s], data[s],
                                 None if valid is None else valid[s])
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
    src = pool_lib._host_ids(pool, src_pages)
    dst = pool_lib._host_ids(pool, dst_pages)
    if obs_metrics.enabled():
        obs_metrics.counter(
            obs_metrics.NAME_SHARD_RING_PAGES,
            "pages exchanged over the ppermute migration ring"
        ).inc(int(src.shape[0]))
    with obs_tracing.span("shard.migrate.ring", pages=int(src.shape[0]),
                          shards=pool.num_shards):
        if pool.mesh is not None:
            return _migrate_ring(pool, src, dst, donate)
        data = _read(pool, src)
        target = pool if donate else dataclasses.replace(
            pool, storage=pool.storage.clone())
        return _write(target, dst, data)


def _migrate_ring(pool: ShardedPool, src: np.ndarray, dst: np.ndarray,
                  donate: bool) -> ShardedPool:
    """The reference's ``ppermute`` ring on a banks mesh: this rank reads
    the sources it owns (the other rows zero), then at step ``k`` of
    ``S`` (each step after the first passes the batch to rank ``s + 1``
    and takes rank ``s - 1``'s) it lands the pages that left bank
    ``s - k`` for its own bank. Of duplicate destinations the last lands,
    as in a write."""
    S, me = pool.num_shards, pool.bank_id
    if not src.size:
        return pool
    buf = _read(pool, src, reduce=False)
    target = pool if donate else dataclasses.replace(
        pool, storage=pool.storage.clone())
    src_sh = router.route_np(src, pool.num_rows, S)[0]
    dst_sh, dst_lo = router.route_np(dst, pool.num_rows, S)
    mine = pool_lib._landing_rows(dst, None) & (dst_sh == me)
    for step in range(S):
        if step:
            buf = _ring_shift(pool, buf)
        sel = np.flatnonzero(mine & (src_sh == (me - step) % S))
        if sel.size:
            pool_lib._write_in_place(target.bank(me), dst_lo[sel],
                                     buf[upload(sel, pool.device)])
    return target


def _ring_shift(pool: ShardedPool, buf: torch.Tensor) -> torch.Tensor:
    """One ``ppermute`` step of the ring: ``buf`` to rank ``s + 1``, and
    rank ``s - 1``'s batch back."""
    S, me = pool.num_shards, pool.bank_id
    group = pool.mesh.device_mesh.get_group()
    recv = torch.empty_like(buf)
    ops = [dist.P2POp(dist.isend, buf,
                      dist.get_global_rank(group, (me + 1) % S), group),
           dist.P2POp(dist.irecv, recv,
                      dist.get_global_rank(group, (me - 1) % S), group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return recv


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
    with obs_tracing.span("shard.repartition", old_boundary=old,
                          new_boundary=new_boundary,
                          shards=pool.num_shards), obs_memprof.suspended():
        banks = [pool_lib.repartition(pool.bank(s), nb_local)[0].storage
                 for s in _served(pool)]
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
    with obs_tracing.span("shard.set_daec_rows", old=pool.daec_rows,
                          new=daec_rows, shards=S):
        banks = [pool_lib.set_daec_rows(pool.bank(s), n_local).storage
                 for s in _served(pool)]
    return dataclasses.replace(pool, storage=torch.stack(banks),
                               daec_rows_local=n_local)


def scrub(pool: ShardedPool):
    """Sweep every bank -> ``(new_pool, ScrubStats)``: the censuses
    summed, corrupt rows mapped back to global rows (``local * S + bank``)
    and sorted. Works on a copy. On a mesh each rank sweeps its bank, one
    all-reduce sums the censuses and an all-gather collects the corrupt
    rows, so every rank gets the whole pool's stats."""
    from repro_torch.core.scrubber import ScrubStats
    from repro_torch.core.scrubber import scrub as _scrub
    S = pool.num_shards
    banks, merged, corrupt = [], {}, []
    for s in _served(pool):
        new_bank, stats = _scrub(pool.bank(s))
        banks.append(new_bank.storage)
        for f in dataclasses.fields(ScrubStats):
            if f.name != "corrupt_rows":
                merged[f.name] = merged.get(f.name, 0) + getattr(stats,
                                                                 f.name)
        corrupt.extend(r * S + s for r in stats.corrupt_rows)
    if pool.mesh is not None:
        census = torch.tensor(list(merged.values()), dtype=torch.int64,
                              device=pool.device)
        _all_reduce(pool, census)
        merged = dict(zip(merged, census.tolist()))
        parts = [None] * S
        dist.all_gather_object(parts, corrupt,
                               group=pool.mesh.device_mesh.get_group())
        corrupt = [r for part in parts for r in part]
    return (dataclasses.replace(pool, storage=torch.stack(banks)),
            ScrubStats(corrupt_rows=tuple(sorted(corrupt)), **merged))
