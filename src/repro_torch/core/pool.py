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
(:mod:`repro_torch.kernels.interwrap`) alone.

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
non-donating functions (:func:`write_pages_any`, :func:`repartition`,
``migrate(donate=False)``, ``scrub``) work on a copy and leave the input
state valid, and so does :func:`set_daec_rows`.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.core.layouts import (CODE_LANE, DATA_LANES, DEFAULT_ROW_WORDS,
                                      GROUP_ROWS, LANES, REGION_SECDED, Layout,
                                      extra_page_count, page_coords,
                                      parity_coords)
from repro_torch.kernels.common import resolve_device, upload
from repro_torch.kernels.daec import ops as daec_ops
from repro_torch.kernels.interwrap import ops as interwrap_ops
from repro_torch.kernels.parity8 import ops as parity8_ops
from repro_torch.kernels.secded import ops as secded_ops


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

    def write(self, pages, data: torch.Tensor, *, valid=None) -> "PoolState":
        """Code-maintaining batch write; returns the new pool state.

        Writes in place (the reference donates the input state here): drop
        the input state. ``valid`` (optional ``(n,)`` bool) drops masked
        rows entirely.
        """
        return _write_in_place(self, pages, data, valid)

    def migrate(self, src_pages, dst_pages, *,
                donate: bool = True) -> "PoolState":
        """In-pool page relocation ``src -> dst``: decode-corrected read,
        then code-maintaining write. ``donate=False`` leaves the input
        state's storage untouched (callers that may roll back)."""
        state = self if donate else dataclasses.replace(
            self, storage=self.storage.clone())
        return _write_in_place(state, dst_pages,
                               read_pages_any(self, src_pages))

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
    if row_words % 8:
        raise ValueError("row_words must be a multiple of 8")
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
    ids = _host_ids(state, pages)
    pages = upload(ids, state.device)
    n = pages.shape[0]
    if n == 0:
        return (torch.zeros((0, state.page_words), dtype=torch.int32,
                            device=state.device),
                torch.zeros((0,), dtype=torch.int32, device=state.device))
    if _whole_interwrap(state):
        return (interwrap_ops.gather(state.storage, pages, state.num_rows),
                torch.zeros((n,), dtype=torch.int32, device=state.device))
    rows, lanes, region = page_coords(state.layout, state.num_rows,
                                      state.boundary, pages, state.row_words)
    data = state.storage[rows, lanes, :].reshape(n, -1)
    is_sec = region == REGION_SECDED
    status = torch.zeros((n,), dtype=torch.int32, device=state.device)
    if state.boundary < state.num_rows:       # pool has SECDED rows
        crow = torch.clamp(pages, state.boundary, state.num_rows - 1)
        codes = state.storage[crow, CODE_LANE, :]
        fixed, _, st = secded_ops.decode(data, codes)
        pst = st.amax(dim=-1)
        daec = _daec_rows_of(state, ids)
        if daec is not None:                  # DAEC tier atop the region
            dfixed, _, dst = daec_ops.decode(data[daec].contiguous(),
                                             codes[daec].contiguous())
            fixed[daec] = dfixed
            pst[daec] = dst.amax(dim=-1)
        data = torch.where(is_sec[:, None], fixed, data)
        status = torch.where(is_sec, pst, 0).to(torch.int32)
    if state.has_parity:
        packed = state.storage[_parity_index(state, pages)]
        pst = parity8_ops.check(data, packed).amax(dim=-1) * 3
        status = torch.where(is_sec, status, pst).to(torch.int32)
    return data, status


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
    copy = dataclasses.replace(state, storage=state.storage.clone())
    return _write_in_place(copy, pages, data, valid)


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
        new_state = _write_in_place(
            PoolState(storage, new_boundary, state.layout, state.row_words,
                      state.daec_rows), affected, fixed)
        info["pages_reencoded"] = new_boundary - old
    if extra_ids is not None:      # re-home the surviving PARITY extras
        new_state = _write_in_place(new_state, extra_ids, extra_data)
    return new_state, info
