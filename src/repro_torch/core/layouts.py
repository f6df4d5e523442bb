"""CREAM data layouts — the page-granularity address translation.

Port of ``repro/core/layouts.py``: the layout catalogue, capacity
accounting, the line-granularity access plans (:func:`plan_line_access`,
:func:`count_device_ops`, :func:`parallelism_groups` — host Python, the
DRAM-operation accounting of the paper's Fig. 10 and of SoftECC's Fig. 12),
the page placement descriptors (:func:`place_page`) and the universal
vectorised :func:`page_coords` translation for all 5 layouts (the paper's
Solutions 1–3, parity, and the ECC baseline).

Geometry: a pool is ``(R, 9, W)`` uint32 words — R rows, 9 lanes (8 data
+ 1 code, the DIMM's chips), W words per lane per row. Index tensors are
``int64`` (what torch's advanced indexing takes).
"""
from __future__ import annotations

import enum
import functools
import math
from dataclasses import dataclass, field

import numpy as np
import torch

LANES = 9
DATA_LANES = 8
CODE_LANE = 8
DEFAULT_ROW_WORDS = 256          # uint32 words per lane per row (1KB)
WORDS_PER_LINE = 16              # 64-byte cache line
GROUP_ROWS = 8                   # packing / wrap-around group (paper's 8 banks)


class Layout(enum.Enum):
    BASELINE_ECC = "baseline_ecc"
    PACKED = "packed"
    RANK_SUBSET = "rank_subset"
    INTERWRAP = "interwrap"
    PARITY = "parity"


#: Extra effective capacity per layout, as a fraction of the 8-lane data
#: capacity (paper: +12.5% correction-free, +10.7% detection-only).
CAPACITY_GAIN = {
    Layout.BASELINE_ECC: 0.0,
    Layout.PACKED: 1.0 / 8.0,
    Layout.RANK_SUBSET: 1.0 / 8.0,
    Layout.INTERWRAP: 1.0 / 8.0,
    Layout.PARITY: (9.0 / 8.0) / (1.0 + 1.0 / 64.0) - 1.0,  # ≈ 10.77%
}


# ---------------------------------------------------------------------------
# Capacity accounting
# ---------------------------------------------------------------------------


def lines_per_row(row_words: int = DEFAULT_ROW_WORDS) -> int:
    """64-byte cache lines in a row's eight data lanes."""
    return DATA_LANES * row_words // WORDS_PER_LINE


def parity_table_rows(num_rows: int, extra_pages: int, row_words: int) -> int:
    """Code-lane rows reserved for parity tables (regular + extra pages);
    one code-lane row holds the parity of 8 pages."""
    return math.ceil(num_rows / 8) + math.ceil(extra_pages / 8)


@functools.cache
def extra_page_count(layout: Layout, num_rows: int,
                     row_words: int = DEFAULT_ROW_WORDS) -> int:
    """Number of extra (reclaimed-capacity) pages a region of `num_rows` offers.

    Cached: PARITY's count is a search over the region, and every access
    of a pool asks for it."""
    if layout == Layout.BASELINE_ECC:
        return 0
    if layout in (Layout.PACKED, Layout.RANK_SUBSET, Layout.INTERWRAP):
        return num_rows // GROUP_ROWS
    if layout == Layout.PARITY:
        # iterate: extra pages consume 8 code rows each, plus parity tables
        extra = 0
        while True:
            used = parity_table_rows(num_rows, extra + 1, row_words)
            if used + (extra + 1) * GROUP_ROWS > num_rows:
                return extra
            extra += 1
    raise ValueError(layout)


def total_pages(layout: Layout, num_rows: int,
                row_words: int = DEFAULT_ROW_WORDS) -> int:
    return num_rows + extra_page_count(layout, num_rows, row_words)


# ---------------------------------------------------------------------------
# Universal vectorised coordinate translation (the bridge chip as an index
# map) — the one translation the pool, the mixed kernel and the VM share.
# ---------------------------------------------------------------------------

#: Region codes returned by :func:`page_coords`.
REGION_CREAM = 0    # CREAM-region regular page
REGION_SECDED = 1   # conventional SECDED row
REGION_EXTRA = 2    # reclaimed extra page (code-lane / wrap-slot-8 storage)


def _build_wrap_tables() -> tuple[np.ndarray, np.ndarray]:
    """Slot tables for the InterWrap linearisation ℓ = 8·slot + k:
    ``WRAP_LANES[s, k] = ℓ mod 9``, ``WRAP_ROWS[s, k] = ℓ div 9``."""
    lanes = np.empty((LANES, DATA_LANES), np.int32)
    rows = np.empty((LANES, DATA_LANES), np.int32)
    for s in range(LANES):
        for k in range(DATA_LANES):
            linear = DATA_LANES * s + k
            lanes[s, k] = linear % LANES
            rows[s, k] = linear // LANES
    return lanes, rows


WRAP_LANES, WRAP_ROWS = _build_wrap_tables()


# ---------------------------------------------------------------------------
# Physical access plans (line granularity — DRAM-sim / overhead accounting)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class Access:
    """One DRAM operation: a lockstep fetch/store of ≤9 (row, lane) slices.

    ``slices`` maps lane -> row. For all layouts except INTERWRAP every
    touched lane reads the same row; INTERWRAP ops may straddle two
    adjacent rows (the paper's two banks opened by the bridge chip).
    """
    slices: tuple[tuple[int, int], ...]  # ((lane, row), ...)
    write: bool = False
    rmw: bool = False                    # requires read-before-write

    @property
    def rows(self) -> tuple[int, ...]:
        return tuple(sorted({r for _, r in self.slices}))

    @property
    def lanes(self) -> tuple[int, ...]:
        return tuple(sorted({lane for lane, _ in self.slices}))

    def num_device_ops(self) -> int:
        """DRAM command count this access expands to (RMW = read + write)."""
        return 2 if self.rmw else 1


def _full_row(row: int, lanes, write: bool, rmw: bool = False) -> Access:
    return Access(tuple((lane, row) for lane in lanes), write=write, rmw=rmw)


def interwrap_slices(page_slot: int) -> tuple[tuple[int, int], ...]:
    """(lane, group-relative row) slices owned by page slot s ∈ [0, 9).

    Paper §4.1.3: linear slice ℓ = row·9 + lane; slot s owns ℓ ∈ [8s, 8s+8).
    """
    if not 0 <= page_slot < LANES:
        raise ValueError(page_slot)
    return tuple((int(WRAP_LANES[page_slot, k]), int(WRAP_ROWS[page_slot, k]))
                 for k in range(DATA_LANES))


def plan_line_access(layout: Layout, num_rows: int, page: int, write: bool,
                     row_words: int = DEFAULT_ROW_WORDS) -> list[Access]:
    """Access plan for one 64B line of logical ``page`` in a CREAM region.

    Page ids: ``[0, num_rows)`` regular, ``[num_rows, total)`` extra. The
    line index within the page changes only column addresses, not the op
    structure, so it is not a parameter.
    """
    n_extra = extra_page_count(layout, num_rows, row_words)
    if not 0 <= page < num_rows + n_extra:
        raise ValueError(f"page {page} out of range for {layout} x {num_rows}")
    is_extra = page >= num_rows
    e = page - num_rows

    if layout == Layout.BASELINE_ECC:
        # one lockstep op across all 9 chips, for reads and writes alike
        return [_full_row(page, range(LANES), write)]

    if layout == Layout.PACKED:
        if not is_extra:
            # reads fetch all 9 lanes; writes RMW, since lane 8 holds
            # another page's data (paper §4.1.1)
            return [_full_row(page, range(LANES), write, rmw=write)]
        # extra page: the line lies in lane 8 of its group's rows, over 8
        # column segments -> 8 back-to-back ops; the row is representative
        row = GROUP_ROWS * e
        return [_full_row(row, range(LANES), write, rmw=write)
                for _ in range(8)]

    if layout == Layout.RANK_SUBSET:
        if not is_extra:
            return [_full_row(page, range(DATA_LANES), write)]
        row = GROUP_ROWS * e
        return [_full_row(row, (CODE_LANE,), write) for _ in range(8)]

    if layout == Layout.INTERWRAP:
        group, slot = (page // GROUP_ROWS, page % GROUP_ROWS) if not is_extra \
            else (e, GROUP_ROWS)
        slices = tuple((lane, GROUP_ROWS * group + r)
                       for lane, r in interwrap_slices(slot))
        return [Access(slices, write=write)]

    if layout == Layout.PARITY:
        # rank-subset base + parity ops on lane 8 (paper §4.2)
        parity_row = _parity_row_of_page(layout, num_rows, page, row_words)
        parity_op = Access(((CODE_LANE, parity_row),), write=write, rmw=write)
        if not is_extra:
            return [_full_row(page, range(DATA_LANES), write), parity_op]
        data_row0 = _parity_extra_data_row0(num_rows, n_extra, e, row_words)
        ops = [_full_row(data_row0, (CODE_LANE,), write) for _ in range(8)]
        return ops + [parity_op]

    raise ValueError(layout)


def _parity_row_of_page(layout: Layout, num_rows: int, page: int,
                        row_words: int) -> int:
    """Code-lane row holding ``page``'s parity: the regular table first,
    then the extra pages' (the paper's bank swap for parity rows is a
    timing detail the DRAM model applies)."""
    if page < num_rows:
        return page // 8
    return math.ceil(num_rows / 8) + (page - num_rows) // 8


def _parity_extra_data_row0(num_rows: int, n_extra: int, e: int,
                            row_words: int) -> int:
    tables = parity_table_rows(num_rows, n_extra, row_words)
    return tables + GROUP_ROWS * e


def count_device_ops(layout: Layout, num_rows: int, page: int, write: bool,
                     row_words: int = DEFAULT_ROW_WORDS) -> int:
    """Total DRAM commands for one line access (the paper's Fig. 10a)."""
    return sum(a.num_device_ops()
               for a in plan_line_access(layout, num_rows, page, write,
                                         row_words))


def parallelism_groups(layout: Layout) -> int:
    """Independently accessible page groups per 8-row group (Fig. 10b):
    8 rows (banks) for the baseline and PACKED, 9 for the layouts that
    free the code lane (paper §4.1.3: nine concurrent requests)."""
    return {Layout.BASELINE_ECC: 8, Layout.PACKED: 8, Layout.RANK_SUBSET: 9,
            Layout.INTERWRAP: 9, Layout.PARITY: 9}[layout]


# ---------------------------------------------------------------------------
# Page-granularity placement
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class PagePlacement:
    """Where a logical page's data lives, as dense slice descriptors.

    kind:
      'rows'      data = region[row, 0:8, :]               (one row, 8 lanes)
      'codelane'  data = region[row0:row0+8, 8, :]          (8 rows of lane 8)
      'wrap'      data = 8 (lane, row) slices, lane-rotated (interwrap)
    """
    kind: str
    row0: int
    slices: tuple[tuple[int, int], ...] = field(default=())


def place_page(layout: Layout, num_rows: int, page: int,
               row_words: int = DEFAULT_ROW_WORDS) -> PagePlacement:
    n_extra = extra_page_count(layout, num_rows, row_words)
    if not 0 <= page < num_rows + n_extra:
        raise ValueError(f"page {page} out of range")
    is_extra = page >= num_rows
    e = page - num_rows

    if layout == Layout.BASELINE_ECC:
        return PagePlacement("rows", page)
    if layout in (Layout.PACKED, Layout.RANK_SUBSET):
        if not is_extra:
            return PagePlacement("rows", page)
        return PagePlacement("codelane", GROUP_ROWS * e)
    if layout == Layout.INTERWRAP:
        group, slot = (page // GROUP_ROWS, page % GROUP_ROWS) if not is_extra \
            else (e, GROUP_ROWS)
        return PagePlacement(
            "wrap", GROUP_ROWS * group,
            tuple((lane, GROUP_ROWS * group + r)
                  for lane, r in interwrap_slices(slot)))
    if layout == Layout.PARITY:
        if not is_extra:
            return PagePlacement("rows", page)
        return PagePlacement(
            "codelane", _parity_extra_data_row0(num_rows, n_extra, e,
                                                row_words))
    raise ValueError(layout)


def _ids(pages) -> torch.Tensor:
    return torch.as_tensor(pages).to(torch.int64).reshape(-1)


def page_region(num_rows: int, boundary: int, pages) -> torch.Tensor:
    """Vectorised region classification: (n,) page ids -> (n,) REGION_* codes."""
    pages = _ids(pages)
    is_secded = (pages >= boundary) & (pages < num_rows)
    is_extra = pages >= num_rows
    return torch.where(is_secded, REGION_SECDED,
                       torch.where(is_extra, REGION_EXTRA, REGION_CREAM))


def parity_coords(num_rows: int, boundary: int, pages,
                  row_words: int = DEFAULT_ROW_WORDS
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """Parity-table lookup for PARITY-layout CREAM/extra pages:
    ``(prow (n,), off (n,))`` — the code-lane row holding each page's packed
    parity entry and the word offset of its ``row_words // 8``-word slot.
    PARITY pools only: a slot holds a page's parity bytes four to a word,
    whole only at W % 8 == 0, where the parity codec refuses other widths
    as the reference does (:mod:`repro_torch.kernels.parity8`)."""
    pages = _ids(pages)
    rel = torch.where(pages >= num_rows, boundary + (pages - num_rows), pages)
    tables = math.ceil(boundary / 8) if boundary else 0
    prow = torch.where(rel < boundary, rel // 8,
                       tables + torch.clamp(rel - boundary, min=0) // 8)
    off = (rel % 8) * (row_words // 8)
    return prow, off


def extra_base_row(layout: Layout, boundary: int,
                   row_words: int = DEFAULT_ROW_WORDS) -> int:
    """First code-lane row used for extra-page storage in a CREAM region
    (PARITY reserves its parity tables first, paper §4.2)."""
    if layout != Layout.PARITY:
        return 0
    n_extra = extra_page_count(layout, boundary, row_words)
    return parity_table_rows(boundary, n_extra, row_words)


def page_coords(layout: Layout, num_rows: int, boundary: int, pages,
                row_words: int = DEFAULT_ROW_WORDS
                ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Universal page -> physical-slice translation, for any boundary.

    ``pages`` are (n,) page ids (regular ``[0, num_rows)``, extras above;
    rows ``[boundary, num_rows)`` are SECDED). Returns ``(rows (n, 8),
    lanes (n, 8), region (n,))`` int64 tensors on the ids' device such that
    page ``i``'s data is ``storage[rows[i], lanes[i], :]`` flattened.
    Ids must be in range (callers validate them on the host).
    """
    pages = _ids(pages)
    dev = pages.device
    n = pages.shape[0]
    k = torch.arange(DATA_LANES, dtype=torch.int64, device=dev)
    region = page_region(num_rows, boundary, pages)
    is_extra = pages >= num_rows
    e = pages - num_rows
    row_rows = pages[:, None].expand(n, DATA_LANES)
    row_lanes = k[None, :].expand(n, DATA_LANES)

    if layout == Layout.INTERWRAP:
        # CREAM + extra pages are wrap-striped; SECDED rows are conventional
        group = torch.where(is_extra, e, pages // GROUP_ROWS)
        slot = torch.where(is_extra, GROUP_ROWS, pages % GROUP_ROWS)
        w_lanes = torch.as_tensor(WRAP_LANES, device=dev).long()[slot]
        w_rows = GROUP_ROWS * group[:, None] \
            + torch.as_tensor(WRAP_ROWS, device=dev).long()[slot]
        in_sec = (region == REGION_SECDED)[:, None]
        rows = torch.where(in_sec, row_rows, w_rows)
        lanes = torch.where(in_sec, row_lanes, w_lanes)
        return rows, lanes, region

    # BASELINE_ECC / PACKED / RANK_SUBSET / PARITY: regular pages (either
    # region) are row-wise; extras live in code-lane rows of their group
    ebase = extra_base_row(layout, boundary, row_words)
    ex_rows = ebase + GROUP_ROWS * e[:, None] + k[None, :]
    rows = torch.where(is_extra[:, None], ex_rows, row_rows)
    lanes = torch.where(is_extra[:, None], CODE_LANE, row_lanes)
    return rows, lanes, region
