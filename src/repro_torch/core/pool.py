"""CREAMPool — the ECC-DRAM module analogue, with the paper's boundary register.

Port of ``repro/core/pool.py``. A pool is one int32 word tensor of shape
``(R, 9, W)`` (rows × lanes × words). Rows ``[0, boundary)`` form the CREAM
region (PACKED / RANK_SUBSET / INTERWRAP layout); rows ``[boundary, R)``
keep the conventional SECDED layout. Page ids:

    pages [0, boundary)        CREAM-region regular pages (lanes 0–7 / wrap)
    pages [boundary, R)        SECDED-protected pages
    pages [R, R + extra)       extra pages reclaimed from the code lane

The data plane is :meth:`PoolState.read` / :meth:`PoolState.write` /
:meth:`PoolState.migrate`: one :func:`~repro_torch.core.layouts.page_coords`
gather or scatter plus the batched SECDED codec
(:mod:`repro_torch.kernels.secded` — the CUDA kernels for a pool on the
card, the plain versions on the CPU). A pool whose CREAM region covers
every row under InterWrap (``boundary == R``) has no codes to keep, and
its pages move through the InterWrap gather / scatter
(:mod:`repro_torch.kernels.interwrap`) alone. Each verb, and each public
batch function below, feeds CREAM-Lens one record of its ids
(:meth:`PoolState.memprof_record`, one boolean check while the profiler
is off), as the reference's jitted entry points do.

``daec_rows`` carves the top of the protected region into the SEC-DAEC
tier: pages ``[R - daec_rows, R)`` keep :mod:`repro_torch.core.daec` code
fields in the same code lane (the same shapes as SECDED's), maintained by
the daec kernels (:mod:`repro_torch.kernels.daec`); only the DAEC pages of
a batch go through them.

PARITY pools with a CREAM region keep an 8-bit parity byte per 64-byte
line of every CREAM and extra page in packed tables at the bottom of the
code lane (:func:`~repro_torch.core.layouts.parity_coords`), maintained by
the parity8 kernels (:mod:`repro_torch.kernels.parity8`): reads report a
corrupt line as status 3, a write lands the pages and their parity in one
``parity8_write`` launch, and a repartition re-homes the surviving extra
pages, whose home depends on the boundary-sized tables.

Storage updates. The reference is functional (old state in, new state
out). The port writes in place exactly where the reference donates the old
state's storage — ``write`` and ``migrate`` (the reference's jitted entry
points with ``donate_argnums=(0,)``) — so the returned state shares the
input's storage and the input must be dropped, as every owner does. The
non-donating functions (:func:`write_pages_any`, :func:`write_page`,
:func:`repartition`, ``migrate(donate=False)``, ``scrub``,
``read_writeback``) work on a copy and leave the input state valid, and so
does :func:`set_daec_rows`. :func:`migrate_pages` writes into its
destination pool in place (the reference donates it).
"""
from __future__ import annotations

import dataclasses
import warnings
from dataclasses import dataclass
from typing import Protocol, runtime_checkable

import numpy as np
import torch

from repro_torch.core import secded
from repro_torch.core.layouts import (CODE_LANE, DATA_LANES, DEFAULT_ROW_WORDS,
                                      GROUP_ROWS, LANES, REGION_SECDED, Layout,
                                      extra_page_count, page_coords,
                                      parity_coords)
from repro_torch.kernels.common import resolve_device, upload
from repro_torch.kernels.daec import ops as daec_ops
from repro_torch.kernels.interwrap import ops as interwrap_ops
from repro_torch.kernels.parity8 import ops as parity8_ops
from repro_torch.kernels.secded import ops as secded_ops
from repro_torch.obs import memprof


def _warn_deprecated(old: str, new: str) -> None:
    warnings.warn(
        f"PoolLike.{old} is deprecated; use the unified access API: "
        f"pool.{new}", DeprecationWarning, stacklevel=3)


@dataclass
class PoolState:
    """Pool state: ``storage`` (R, 9, W) int32 plus static geometry."""
    storage: torch.Tensor
    boundary: int
    layout: Layout
    row_words: int
    daec_rows: int = 0

    @property
    def device(self) -> torch.device:
        return self.storage.device

    @property
    def num_rows(self) -> int:
        return self.storage.shape[0]

    @property
    def daec_start(self) -> int:
        """First DAEC-tier page id (== num_rows when the tier is empty)."""
        return self.num_rows - self.daec_rows

    @property
    def page_words(self) -> int:
        return DATA_LANES * self.row_words

    @property
    def page_bytes(self) -> int:
        return 4 * self.page_words

    @property
    def num_extra_pages(self) -> int:
        return extra_page_count(self.layout, self.boundary, self.row_words)

    @property
    def num_pages(self) -> int:
        """Effective page capacity = R regular + reclaimed extras."""
        return self.num_rows + self.num_extra_pages

    @property
    def raw_bytes(self) -> int:
        return self.storage.numel() * 4

    @property
    def effective_bytes(self) -> int:
        return self.num_pages * self.page_bytes

    def capacity_gain(self) -> float:
        """Fraction of baseline (all-SECDED) capacity reclaimed."""
        return self.num_extra_pages / self.num_rows

    @property
    def boundary_step(self) -> int:
        """Boundary-register granularity (rows)."""
        return GROUP_ROWS

    # -- the data plane ------------------------------------------------------

    def read(self, pages, *, status=False):
        """Batch read of any page-id vector -> ``(n, page_words)`` int32,
        or with ``status=True`` a ``(data, status (n,) int32)`` pair (worst
        per-beat decode status: 0 clean, 1/2 corrected, 3 uncorrectable)."""
        data, st = read_pages_any_status(self, pages)
        return (data, st) if status else data

    def read_writeback(self, pages):
        """Write-back read: ``read(pages, status=True)`` whose corrected
        beats are persisted to storage -> ``(data, status, new_state)``
        (see :func:`read_pages_any_writeback`; ``self`` stays valid)."""
        return read_pages_any_writeback(self, pages)

    def write(self, pages, data: torch.Tensor, *, valid=None) -> "PoolState":
        """Code-maintaining batch write; returns the new pool state.

        Writes in place (the reference donates the input state here): drop
        the input state. ``valid`` (optional ``(n,)`` bool) drops masked
        rows entirely.
        """
        self.memprof_record("scatter", pages)
        return _write_in_place(self, pages, data, valid)

    def migrate(self, src_pages, dst_pages, *,
                donate: bool = True) -> "PoolState":
        """In-pool page relocation ``src -> dst``: decode-corrected read,
        then code-maintaining write. ``donate=False`` leaves the input
        state's storage untouched (callers that may roll back)."""
        self.memprof_record("gather", src_pages)
        self.memprof_record("scatter", dst_pages)
        state = self if donate else dataclasses.replace(
            self, storage=self.storage.clone())
        return _write_in_place(state, dst_pages,
                               _read_any_status(self, src_pages)[0])

    def streams(self, pages, data=None, *, valid=None):
        """Bank-aligned stream access with ``(S, n)`` ids: reads ``(S, n,
        page_words)`` with ``data=None``, else writes ``data`` ``(S, n,
        page_words)`` (``valid`` optionally masks entries) and returns the
        new state. On a local pool the stream axis is a batching
        convention; a :class:`~repro_torch.shard.pool.ShardedPool` serves
        each stream on its own bank."""
        shape = tuple(pages.shape) if isinstance(pages, torch.Tensor) \
            else np.shape(pages)
        if data is None:
            return self.read(pages).reshape(*shape, self.page_words)
        return self.write(pages, data, valid=valid)

    # -- deprecated access surface (thin shims over the unified API) --------

    def read_any(self, pages) -> torch.Tensor:
        _warn_deprecated("read_any", "read(pages)")
        return read_pages_any(self, pages)

    def read_any_status(self, pages) -> tuple[torch.Tensor, torch.Tensor]:
        _warn_deprecated("read_any_status", "read(pages, status=True)")
        return read_pages_any_status(self, pages)

    def write_any(self, pages, data) -> "PoolState":
        _warn_deprecated("write_any", "write(pages, data)")
        return write_pages_any(self, pages, data)

    def read_pages(self, pages) -> torch.Tensor:
        _warn_deprecated("read_pages", "read(pages)")
        return self.read(pages)

    def read_pages_status(self, pages) -> tuple[torch.Tensor, torch.Tensor]:
        _warn_deprecated("read_pages_status", "read(pages, status=True)")
        return self.read(pages, status=True)

    def write_pages(self, pages, data) -> "PoolState":
        _warn_deprecated("write_pages", "write(pages, data)")
        return self.write(pages, data)

    def evict_prediction(self, new_boundary: int) -> list[int]:
        """Extra-page ids a move to ``new_boundary`` would evict."""
        return evicted_extra_pages(self, new_boundary)

    def move_boundary(self, new_boundary: int) -> tuple["PoolState", dict]:
        """Repartition (see :func:`repartition`)."""
        return repartition(self, new_boundary)

    def set_daec_rows(self, daec_rows: int) -> "PoolState":
        """Resize the SEC-DAEC tier (see :func:`set_daec_rows`)."""
        return set_daec_rows(self, daec_rows)

    def scrub(self, use_kernel: bool = False):
        """Sweep + repair; returns ``(new_state, ScrubStats)`` and leaves
        this state valid (see :func:`repro_torch.core.scrubber.scrub`)."""
        from repro_torch.core.scrubber import scrub as _scrub
        return _scrub(self, use_kernel=use_kernel)

    @property
    def has_parity(self) -> bool:
        """Whether the pool keeps the PARITY side channel."""
        return self.layout == Layout.PARITY and self.boundary > 0

    def memprof_record(self, op: str, pages, stream: str = "main") -> None:
        """Feed one dispatch to CREAM-Lens (no-op unless memprof enabled).

        The pool's read / write / migrate call it; owners with context the
        pool can't see (the serving engine's fused decode gather, the
        object cache) call it directly. Enabled, it validates the ids on
        the host first, as the dispatch would.
        """
        if not memprof.enabled():
            return
        memprof.record(op, _host_ids(self, pages), layout=self.layout,
                       num_rows=self.num_rows, boundary=self.boundary,
                       row_words=self.row_words, stream=stream)


@runtime_checkable
class PoolLike(Protocol):
    """The pool data-plane contract the VM, object-cache and serving
    layers program against.

    Implementations: :class:`PoolState` (one bank),
    :class:`repro_torch.shard.ShardedPool` (banks on one card or on a
    ``banks`` mesh) and :class:`repro_torch.faults.shadow.ShadowedPool`.
    They share the page-id convention (regular pages ``[0, num_rows)``,
    reclaimed extras above) and the region semantics derived from
    ``boundary`` / ``num_rows`` / ``layout``, so owners never branch on
    the concrete type for translation, allocation or capacity accounting.
    """

    layout: Layout
    row_words: int
    boundary: int
    num_rows: int
    num_pages: int
    num_extra_pages: int
    page_words: int
    boundary_step: int
    daec_rows: int

    def read(self, pages, *, status=False): ...                     # noqa: E704
    def write(self, pages, data, *, valid=None) -> "PoolLike": ...  # noqa: E704
    def migrate(self, src_pages, dst_pages, *,
                donate: bool = True) -> "PoolLike": ...             # noqa: E704
    def streams(self, pages, data=None, *, valid=None): ...         # noqa: E704
    def evict_prediction(self, new_boundary) -> list[int]: ...      # noqa: E704
    def move_boundary(self, new_boundary) -> tuple: ...             # noqa: E704
    def scrub(self, use_kernel: bool = False) -> tuple: ...         # noqa: E704
    def memprof_record(self, op, pages, stream="main") -> None: ... # noqa: E704


def make_pool(num_rows: int, layout: Layout = Layout.INTERWRAP,
              boundary: int | None = None,
              row_words: int = DEFAULT_ROW_WORDS,
              daec_rows: int = 0, device=None) -> PoolState:
    """Create a zeroed pool on ``device`` (``cuda`` unless asked otherwise).
    ``boundary=None`` puts the whole pool in CREAM mode."""
    if num_rows % GROUP_ROWS:
        raise ValueError(f"num_rows must be a multiple of {GROUP_ROWS}")
    boundary = num_rows if boundary is None else boundary
    if boundary % GROUP_ROWS or not 0 <= boundary <= num_rows:
        raise ValueError(f"bad boundary {boundary}")
    if layout == Layout.BASELINE_ECC and boundary != 0:
        boundary = 0  # whole pool SECDED
    if not 0 <= daec_rows <= num_rows - boundary:
        raise ValueError(
            f"daec_rows ({daec_rows}) must fit the protected region "
            f"[{boundary}, {num_rows})")
    storage = torch.zeros((num_rows, LANES, row_words), dtype=torch.int32,
                          device=resolve_device(device))
    return PoolState(storage, boundary, layout, row_words, daec_rows)


# ---------------------------------------------------------------------------
# Batched access of single-mode pools (the paged KV cache's pools): the
# whole pool CREAM under InterWrap, or the whole pool SECDED.
# ---------------------------------------------------------------------------


def _whole_interwrap(state: PoolState) -> bool:
    """Every page is wrap-striped and none carries a code: the InterWrap
    kernels' access (:mod:`repro_torch.kernels.interwrap`)."""
    return state.layout == Layout.INTERWRAP \
        and state.boundary == state.num_rows


def _single_mode(state: PoolState) -> bool:
    return state.boundary == 0 or _whole_interwrap(state)


def read_pages_batch(state: PoolState, pages) -> torch.Tensor:
    """Gather a batch of pages -> ``(n, page_words)`` int32.

    Single-mode pools only: whole-pool InterWrap (the InterWrap gather) or
    whole-pool SECDED (decode and correct on load). Mixed pools go through
    :func:`read_pages_any`, which handles every boundary.
    """
    if not _single_mode(state):
        raise ValueError("batched access requires a single-mode pool")
    return read_pages_any(state, pages)


def read_pages_batch_status(state: PoolState, pages
                            ) -> tuple[torch.Tensor, torch.Tensor]:
    """Batched read + per-page worst decode status: ``(data (n,
    page_words) int32, status (n,) int32)`` on both kinds of single-mode
    pool, all zeros for the unprotected one."""
    if not _single_mode(state):
        raise ValueError("batched access requires a single-mode pool")
    return read_pages_any_status(state, pages)


def write_pages_batch(state: PoolState, pages, data) -> PoolState:
    """Scatter a batch of pages ``(n, page_words)``. Single-mode pools
    only; functional like :func:`write_pages_any`."""
    if not _single_mode(state):
        raise ValueError("batched access requires a single-mode pool")
    return write_pages_any(state, pages, data)


# ---------------------------------------------------------------------------
# Mixed-pool batched access engine — any boundary, any page-id mix: one
# page_coords translation, one advanced-indexing gather/scatter, and the
# batched SECDED codec over the protected pages. A whole-pool InterWrap
# pool takes the InterWrap kernels instead.
# ---------------------------------------------------------------------------


def _host_ids(state: PoolState, pages) -> np.ndarray:
    """Page ids -> contiguous int64 numpy array, range-checked on the host
    (torch indexing has no clamp-or-drop mode to hide a bad id). A strided
    id vector (``ids[::3]``) is copied: the kernels take contiguous ids."""
    if isinstance(pages, torch.Tensor):
        arr = pages.detach().to("cpu", torch.int64).reshape(-1).numpy()
    else:
        arr = np.asarray(pages, dtype=np.int64).reshape(-1)
    arr = np.ascontiguousarray(arr)
    bad = arr[(arr < 0) | (arr >= state.num_pages)]
    if bad.size:
        raise ValueError(
            f"pages {bad.tolist()} out of range [0, {state.num_pages})")
    return arr


def _landing_rows(ids: np.ndarray, valid) -> np.ndarray:
    """Mask of the batch rows a write lands: the valid rows and, of several
    valid rows for one page, only the last. ``index_put_`` picks an
    unspecified winner among duplicate indices, so without this the data
    and code scatters could keep different rows and leave the page's SECDED
    codes disagreeing with its data."""
    if valid is None:
        keep = np.ones(ids.shape[0], bool)
    elif isinstance(valid, torch.Tensor):
        keep = valid.detach().to("cpu", torch.bool).reshape(-1).numpy()
    else:
        keep = np.asarray(valid, bool).reshape(-1)
    cand = np.flatnonzero(keep)
    _, last = np.unique(ids[cand][::-1], return_index=True)
    land = np.zeros(ids.shape[0], bool)
    land[cand[cand.size - 1 - last]] = True
    return land


def _as_words(state: PoolState, data, n: int) -> torch.Tensor:
    if isinstance(data, np.ndarray):
        data = torch.from_numpy(
            np.ascontiguousarray(data, np.uint32).view(np.int32))
    data = data.to(state.device, torch.int32).reshape(n, -1).contiguous()
    if data.shape[1] != state.page_words:
        raise ValueError(f"page data must be {state.page_words} words")
    return data


def read_pages_any_status(state: PoolState, pages
                          ) -> tuple[torch.Tensor, torch.Tensor]:
    """Batch read with per-page status for an arbitrary page-id vector.

    Returns ``(data (n, page_words) int32, status (n,) int32)``: SECDED and
    DAEC pages report their worst beat's decode status (corrections are
    applied to the returned data, not persisted); on a PARITY pool,
    CREAM-region and extra pages report 3 when a line fails its parity
    check (detection only) and 0 otherwise; unprotected pages report 0.
    The DAEC pages of the batch alone go through the DAEC decode (the
    reference decodes the whole batch with both codecs and selects, which
    gives the same bits).
    """
    state.memprof_record("gather", pages)
    return _read_any_status(state, pages)


def _read_any_status(state: PoolState, pages
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """:func:`read_pages_any_status` without the CREAM-Lens record: the
    reads of dispatches that record themselves."""
    _, data, status, _ = _decoded_read(state, pages)
    return data, status


def _decoded_read(state: PoolState, pages):
    """The read engine -> ``(pages, data, status, codes)``: the ids on the
    pool's device, the corrected data, the per-page status and, when the
    pool has protected rows, every page's corrected code lane (meaningful
    for the protected pages only), else None."""
    ids = _host_ids(state, pages)
    pages = upload(ids, state.device)
    n = pages.shape[0]
    if n == 0:
        return (pages,
                torch.zeros((0, state.page_words), dtype=torch.int32,
                            device=state.device),
                torch.zeros((0,), dtype=torch.int32, device=state.device),
                None)
    if _whole_interwrap(state):
        return (pages,
                interwrap_ops.gather(state.storage, pages, state.num_rows),
                torch.zeros((n,), dtype=torch.int32, device=state.device),
                None)
    rows, lanes, region = page_coords(state.layout, state.num_rows,
                                      state.boundary, pages, state.row_words)
    data = state.storage[rows, lanes, :].reshape(n, state.page_words)
    is_sec = region == REGION_SECDED
    status = torch.zeros((n,), dtype=torch.int32, device=state.device)
    fcodes = None
    if state.boundary < state.num_rows:       # pool has SECDED rows
        crow = torch.clamp(pages, state.boundary, state.num_rows - 1)
        codes = state.storage[crow, CODE_LANE, :]
        fixed, fcodes, st = secded_ops.decode(data, codes)
        pst = st.amax(dim=-1)
        daec = _daec_rows_of(state, ids)
        if daec is not None:                  # DAEC tier atop the region
            dfixed, dcodes, dst = daec_ops.decode(data[daec].contiguous(),
                                                  codes[daec].contiguous())
            fixed[daec] = dfixed
            fcodes[daec] = dcodes
            pst[daec] = dst.amax(dim=-1)
        data = torch.where(is_sec[:, None], fixed, data)
        status = torch.where(is_sec, pst, 0).to(torch.int32)
    if state.has_parity:
        packed = state.storage[_parity_index(state, pages)]
        pst = parity8_ops.check(data, packed).amax(dim=-1) * 3
        status = torch.where(is_sec, status, pst).to(torch.int32)
    return pages, data, status, fcodes


def _daec_rows_of(state: PoolState, ids: np.ndarray) -> torch.Tensor | None:
    """Batch positions of the DAEC-tier pages among ``ids`` (a tensor on
    the pool's device), or None when the batch has none."""
    if not state.daec_rows:
        return None
    sel = np.flatnonzero((ids >= state.daec_start) & (ids < state.num_rows))
    return upload(sel, state.device) if sel.size else None


def _parity_index(state: PoolState, pages: torch.Tensor) -> tuple:
    """Index into ``storage`` of each page's ``(n, W/8)`` packed parity
    entry in the code lane (rows clamped into the pool, as the reference
    does for the SECDED pages that have none)."""
    prow, off = parity_coords(state.num_rows, state.boundary, pages,
                              state.row_words)
    idx = off[:, None] + torch.arange(state.row_words // 8,
                                      device=pages.device)
    return (torch.clamp(prow, 0, state.num_rows - 1)[:, None], CODE_LANE,
            idx)


def read_pages_any(state: PoolState, pages) -> torch.Tensor:
    """Decode-corrected batch read -> ``(n, page_words)`` int32."""
    return read_pages_any_status(state, pages)[0]


def read_pages_any_writeback(state: PoolState, pages
                             ) -> tuple[torch.Tensor, torch.Tensor, PoolState]:
    """Write-back read: the read pass that kills latent errors.

    The gather and codecs of :func:`read_pages_any_status`, and then the
    protected pages whose decode corrected a beat (worst status 1 or 2) get
    their corrected data and code lane written back to storage; clean pages
    and uncorrectable ones (which keep their evidence for the monitor)
    leave storage as it was, so a second read of the same pages reports
    clean for everything the first corrected. Returns ``(data, status,
    new_state)``. Works on a copy, as the reference (which does not donate
    here): ``state`` stays valid.
    """
    state.memprof_record("gather", pages)
    copy = dataclasses.replace(state, storage=state.storage.clone())
    data, status = _writeback_in_place(copy, pages)
    return data, status, copy


def _writeback_in_place(state: PoolState, pages
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """:func:`read_pages_any_writeback` on ``state.storage`` in place ->
    ``(data, status)``. Duplicate ids write the same corrected page."""
    pages, data, status, codes = _decoded_read(state, pages)
    if codes is not None:
        corrected = (status == secded.CORRECTED_DATA) \
            | (status == secded.CORRECTED_CODE)
        wb = torch.nonzero(corrected & (pages >= state.boundary)
                           & (pages < state.num_rows))[:, 0]
        if wb.numel():
            rows = pages[wb]
            state.storage[rows, :DATA_LANES, :] = data[wb].reshape(
                -1, DATA_LANES, state.row_words)
            state.storage[rows, CODE_LANE, :] = codes[wb]
    return data, status


def _write_in_place(state: PoolState, pages, data, valid=None) -> PoolState:
    """The write engine, updating ``state.storage`` in place.

    One data scatter over the ``page_coords`` translation and one SECDED
    (or DAEC) code scatter for the protected pages; a whole-pool InterWrap
    pool takes the InterWrap scatter and nothing else. On a PARITY pool the
    data scatter and the packed parity of the CREAM and extra pages are one
    :func:`parity8_ops.write` (one launch on the card). Rows masked out by
    ``valid`` (and the rows each codec does not cover) are removed before
    scattering — the reference routes them out of range and lets
    ``mode="drop"`` discard them. Of duplicate ids the last valid row lands
    (:func:`_landing_rows`).
    """
    ids = _host_ids(state, pages)
    n = ids.shape[0]
    if n == 0:
        return state
    data = _as_words(state, data, n)
    land = _landing_rows(ids, valid)
    if not land.all():
        ids = ids[land]
        data = data[upload(np.flatnonzero(land), state.device)]
    pages = upload(ids, state.device)
    storage = state.storage
    if _whole_interwrap(state):         # distinct ids: _landing_rows
        interwrap_ops.scatter(storage, pages, data, state.num_rows)
        return state
    if state.has_parity:                # distinct ids: _landing_rows
        parity8_ops.write(storage, pages, data, state.boundary)
    else:
        rows, lanes, _ = page_coords(state.layout, state.num_rows,
                                     state.boundary, pages, state.row_words)
        storage[rows, lanes, :] = data.reshape(-1, DATA_LANES,
                                               state.row_words)
    is_sec = (ids >= state.boundary) & (ids < state.num_rows)
    is_daec = is_sec & (ids >= state.daec_start)
    for mask, codec in ((is_sec & ~is_daec, secded_ops),
                        (is_daec, daec_ops)):
        if mask.any():
            sel = upload(np.flatnonzero(mask), state.device)
            storage[pages[sel], CODE_LANE, :] = codec.encode(data[sel])
    return state


def write_pages_any(state: PoolState, pages, data,
                    valid=None) -> PoolState:
    """Batch write for an arbitrary page-id vector, maintaining codes.

    Functional, as in the reference: works on a copy of the storage and
    leaves ``state`` valid. ``data`` is ``(n, page_words)``.
    """
    state.memprof_record("scatter", pages)
    copy = dataclasses.replace(state, storage=state.storage.clone())
    return _write_in_place(copy, pages, data, valid)


# The reference's jitted entry points. The port has no compile step: these
# are the eager batch functions, and the in-place write is the reference's
# donation. Each validates the ids on the host and records the dispatch to
# CREAM-Lens, as the reference's do.


def read_pages_any_jit(state: PoolState, pages) -> torch.Tensor:
    """:func:`read_pages_any` of host-validated ids."""
    return read_pages_any(state, _host_ids(state, pages))


def read_pages_any_status_jit(state: PoolState, pages
                              ) -> tuple[torch.Tensor, torch.Tensor]:
    """:func:`read_pages_any_status` of host-validated ids."""
    return read_pages_any_status(state, _host_ids(state, pages))


def write_pages_any_jit(state: PoolState, pages, data) -> PoolState:
    """:func:`write_pages_any` in place (the reference donates the input
    state's storage here): drop the input state."""
    ids = _host_ids(state, pages)
    state.memprof_record("scatter", ids)
    return _write_in_place(state, ids, data)


def read_page(state: PoolState, page: int
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """Read one page -> ``(data (page_words,) int32, status)``, ``status``
    a 0-d int32 tensor: the page's worst beat or line status (0 clean, 1/2
    corrected, 3 detected-uncorrectable). Corrections are reported, not
    persisted (see ``scrub`` and :func:`read_pages_any_writeback`)."""
    data, status = _read_any_status(state, [page])
    return data[0], status[0]


def write_page(state: PoolState, page: int, data) -> PoolState:
    """Write one page, maintaining codes for protected pages. Functional,
    as in the reference: works on a copy and leaves ``state`` valid."""
    copy = dataclasses.replace(state, storage=state.storage.clone())
    return _write_in_place(copy, [page], data)


def migrate_pages(src: PoolState, src_pages, dst: PoolState,
                  dst_pages) -> PoolState:
    """Live migration between pools: a decode-corrected read of
    ``src_pages`` from ``src`` and a code-maintaining write of the pages
    to ``dst_pages`` of ``dst``, in place (the reference donates ``dst``'s
    storage): drop the input ``dst``."""
    return _write_in_place(dst, dst_pages,
                           _read_any_status(src, src_pages)[0])


def set_daec_rows(state: PoolState, daec_rows: int) -> PoolState:
    """Re-tier the top of the protected region to or from SEC-DAEC.

    The affected rows are decoded with the outgoing codec (a last chance
    to correct) and re-encoded with the incoming one, so their data
    survives bit-exact and occupied frames are safe to convert. Works on a
    copy, like the reference: ``state`` stays valid.
    """
    n = int(daec_rows)
    R = state.num_rows
    if not 0 <= n <= R - state.boundary:
        raise ValueError(
            f"daec_rows ({n}) must fit the protected region "
            f"[{state.boundary}, {R})")
    old = state.daec_rows
    if n == old:
        return state
    rows = slice(R - max(old, n), R - min(old, n))
    data = state.storage[rows, :DATA_LANES, :].reshape(
        abs(n - old), -1).contiguous()
    codes = state.storage[rows, CODE_LANE, :].contiguous()
    outgoing, incoming = (secded_ops, daec_ops) if n > old \
        else (daec_ops, secded_ops)
    fixed, _, _ = outgoing.decode(data, codes)
    storage = state.storage.clone()
    storage[rows, :DATA_LANES, :] = fixed.reshape(-1, DATA_LANES,
                                                  state.row_words)
    storage[rows, CODE_LANE, :] = incoming.encode(fixed)
    return dataclasses.replace(state, storage=storage, daec_rows=n)


# ---------------------------------------------------------------------------
# Repartitioning — the paper's dynamic boundary moves (§3.3, §4.3.1)
# ---------------------------------------------------------------------------


def evicted_extra_pages(state: PoolState, new_boundary: int) -> list[int]:
    """Extra-page ids a boundary move to ``new_boundary`` would evict, so an
    owner can relocate them before :func:`repartition`."""
    if new_boundary >= state.boundary:
        return []
    new_extra = extra_page_count(state.layout, new_boundary, state.row_words)
    return list(range(state.num_rows + new_extra,
                      state.num_rows + state.num_extra_pages))


def repartition(state: PoolState, new_boundary: int
                ) -> tuple[PoolState, dict]:
    """Move the CREAM/SECDED boundary, re-encoding affected rows.

    Shrinking the CREAM region evicts the extra pages stored above the new
    span (their ids are returned) and gives rows ``[new, old)`` SECDED codes
    over their current, possibly wrap-striped, contents. Growing it decodes
    the surrendered rows once more (last chance to correct) and re-places
    them under the CREAM layout (PARITY pools give them parity entries).
    Regular pages keep their contents either way, and so do surviving extra
    pages: a PARITY extra page's home sits above the boundary-sized parity
    tables, so the survivors are read out before the move and re-homed
    after it. Works on a copy: ``state`` stays valid.
    """
    if new_boundary % GROUP_ROWS or not 0 <= new_boundary <= state.num_rows:
        raise ValueError(f"bad boundary {new_boundary}")
    if new_boundary > state.daec_start:
        raise ValueError(
            f"boundary {new_boundary} would overlap the DAEC tier "
            f"[{state.daec_start}, {state.num_rows})")
    old = state.boundary
    info = {"old_boundary": old, "new_boundary": new_boundary,
            "evicted_extra_pages": [], "pages_reencoded": 0}
    if new_boundary == old:
        return state, info
    extra_ids = None
    if state.layout == Layout.PARITY:
        surviving = min(state.num_extra_pages, extra_page_count(
            state.layout, new_boundary, state.row_words))
        if surviving:
            extra_ids = np.arange(state.num_rows, state.num_rows + surviving)
            extra_data = read_pages_any(state, extra_ids)
    storage = state.storage.clone()
    if new_boundary < old:  # CREAM region shrinks -> protect more rows
        info["evicted_extra_pages"] = evicted_extra_pages(state, new_boundary)
        affected = torch.arange(new_boundary, old, device=state.device)
        data = read_pages_any(state, affected)
        storage[affected, :DATA_LANES, :] = data.reshape(
            -1, DATA_LANES, state.row_words)
        storage[affected, CODE_LANE, :] = secded_ops.encode(data)
        info["pages_reencoded"] = old - new_boundary
        new_state = PoolState(storage, new_boundary, state.layout,
                              state.row_words, state.daec_rows)
    else:  # CREAM region grows -> reclaim code lanes
        affected = torch.arange(old, new_boundary, device=state.device)
        block = state.storage[affected, :DATA_LANES, :].reshape(
            affected.shape[0], -1)
        fixed, _, _ = secded_ops.decode(
            block, state.storage[affected, CODE_LANE, :].contiguous())
        grown = PoolState(storage, new_boundary, state.layout,
                          state.row_words, state.daec_rows)
        grown.memprof_record("scatter", affected)
        new_state = _write_in_place(grown, affected, fixed)
        info["pages_reencoded"] = new_boundary - old
    if extra_ids is not None:      # re-home the surviving PARITY extras
        new_state.memprof_record("scatter", extra_ids)
        new_state = _write_in_place(new_state, extra_ids, extra_data)
    return new_state, info
