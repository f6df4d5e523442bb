"""SoftECC — the Virtualized-ECC baseline the paper compares against (§6.3).

Port of ``repro/core/softecc.py``. Virtualized ECC [Yoon & Erez,
ASPLOS'10] provides SECDED on *non-ECC* DRAM by storing the codes inside
ordinary physical pages: every group of 9 rows holds 8 data pages + 1 code
page (8 pages × 1KB codes = one 8KB page), lowering effective capacity by
1/9 ≈ 11.1%. Each protected access needs a second access for the code
page, partially hidden by caching recently-used code lines in the LLC —
which the paper shows *increases cache contention* and costs up to 25.1%
performance at high memory intensity.

Both faces are here:
  * the functional pool (read / write / scrub), whose pages are coded
    through the SECDED wrappers (:mod:`repro_torch.kernels.secded`: the
    CUDA kernels for a pool on the card, the plain versions on the CPU),
    and
  * the access accounting (:func:`plan_line_ops`) with the LLC code cache
    (:class:`CodeCache`), the accounting behind Fig. 12.

:func:`read_pages` / :func:`write_pages` are the batched forms of the
reference's per-page :func:`read_page` / :func:`write_page` (one decode or
encode launch a batch), and :func:`scrub` decodes every data page in one
batch and rewrites the corrected ones: pages are independent, so this is
the reference's page-by-page sweep, bit for bit.
"""
from __future__ import annotations

import dataclasses
from collections import OrderedDict
from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.core import secded
from repro_torch.core.pool import _as_words
from repro_torch.kernels.common import resolve_device, upload
from repro_torch.kernels.secded import ops as secded_ops

GROUP = 9  # 8 data pages + 1 code page


@dataclass
class SoftECCState:
    """Non-ECC pool ``(R, 8, W)`` int32 with in-band code pages."""
    storage: torch.Tensor  # (R, 8, W) — 8 lanes, no ECC chip
    row_words: int

    @property
    def device(self) -> torch.device:
        return self.storage.device

    @property
    def num_rows(self) -> int:
        return self.storage.shape[0]

    @property
    def num_pages(self) -> int:
        """Effective data capacity: 8 of every 9 rows."""
        return self.num_rows - self.num_code_rows

    @property
    def num_code_rows(self) -> int:
        return self.num_rows // GROUP

    @property
    def page_words(self) -> int:
        return 8 * self.row_words


def make_softecc(num_rows: int, row_words: int = 256,
                 device=None) -> SoftECCState:
    """A zeroed SoftECC pool on ``device`` (``cuda`` unless asked
    otherwise)."""
    if num_rows % GROUP:
        raise ValueError(f"num_rows must be a multiple of {GROUP}")
    return SoftECCState(
        torch.zeros((num_rows, 8, row_words), dtype=torch.int32,
                    device=resolve_device(device)), row_words)


def _locate(state: SoftECCState, page: int) -> tuple[int, int, int]:
    """logical page -> (data_row, code_row, code_word_offset).

    Group g occupies rows [9g, 9g+9): rows 9g..9g+7 are data pages, row
    9g+8 is the code page; one data page (8W words = 4W beats) needs W
    code words, i.e. 1/8 of the code page.
    """
    g, k = divmod(page, 8)
    return GROUP * g + k, GROUP * g + 8, k * state.row_words // 8


def _coords(state: SoftECCState, pages) -> tuple[np.ndarray, np.ndarray,
                                                 np.ndarray]:
    """Page ids -> ``(data_row, code_row, lane)`` numpy vectors: page k of
    group g owns lane k of the group's code page."""
    ids = np.asarray(pages, np.int64).reshape(-1)
    bad = ids[(ids < 0) | (ids >= state.num_pages)]
    if bad.size:
        raise ValueError(
            f"pages {bad.tolist()} out of range [0, {state.num_pages})")
    g, k = np.divmod(ids, 8)
    return GROUP * g + k, GROUP * g + 8, k


def read_pages(state: SoftECCState, pages
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """Batch read -> ``(data (n, page_words), status (n,))``: each page
    decoded against its code slice, corrections applied to the returned
    data (not persisted), ``status`` the page's worst beat."""
    data_row, code_row, lane = _coords(state, pages)
    dev = state.device
    data = state.storage[upload(data_row, dev)].reshape(len(data_row), -1)
    codes = state.storage[upload(code_row, dev), upload(lane, dev)]
    fixed, _, status = secded_ops.decode(data, codes)
    return fixed, status.amax(dim=-1)


def read_page(state: SoftECCState, page: int
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """One page -> ``(data (page_words,), worst status)``."""
    data, status = read_pages(state, [page])
    return data[0], status[0]


def _code_slice(state: SoftECCState, page: int) -> torch.Tensor:
    """Page ``page``'s packed codes: lane k of its group's code page."""
    g, k = divmod(page, 8)
    return state.storage[GROUP * g + 8, k, :]


def _write_in_place(state: SoftECCState, pages, data) -> None:
    data_row, code_row, lane = _coords(state, pages)
    n = len(data_row)
    if not n:
        return
    data = _as_words(state, data, n)    # the pool's: any ints -> words
    dev = state.device
    state.storage[upload(data_row, dev)] = data.reshape(n, 8,
                                                        state.row_words)
    state.storage[upload(code_row, dev), upload(lane, dev)] = \
        secded_ops.encode(data)


def write_pages(state: SoftECCState, pages, data) -> SoftECCState:
    """Batch write of ``(n, page_words)`` data with fresh codes. Functional,
    as the reference's ``write_page``: works on a copy and leaves ``state``
    valid. Ids must be distinct."""
    copy = dataclasses.replace(state, storage=state.storage.clone())
    _write_in_place(copy, pages, data)
    return copy


def write_page(state: SoftECCState, page: int, data) -> SoftECCState:
    """Write one page and its codes (functional)."""
    return write_pages(state, [page], data)


def scrub(state: SoftECCState) -> tuple[SoftECCState, dict]:
    """Decode + correct every data page; corrected pages are rewritten with
    fresh codes. Returns ``(new_state, {"corrected_pages",
    "uncorrectable_pages"})`` like the CREAM scrubber; ``state`` stays
    valid."""
    pages = np.arange(state.num_pages)
    data, status = read_pages(state, pages)
    st = status.cpu().numpy()
    fix = np.flatnonzero((st == secded.CORRECTED_DATA)
                         | (st == secded.CORRECTED_CODE))
    new = dataclasses.replace(state, storage=state.storage.clone())
    if fix.size:
        _write_in_place(new, fix, data[upload(fix, state.device)])
    return new, {"corrected_pages": int(fix.size),
                 "uncorrectable_pages": int(
                     (st == secded.DETECTED_UNCORRECTABLE).sum())}


# ---------------------------------------------------------------------------
# Access accounting with an LLC-resident code cache (Fig. 12)
# ---------------------------------------------------------------------------


class CodeCache:
    """LRU over (code_row, line) entries — the LLC space VECC borrows.

    ``capacity_lines`` models how many 64B code lines fit in the borrowed
    LLC space; the sensitivity benchmark charges the displaced cache
    capacity to the application, reproducing the paper's contention effect.
    """

    def __init__(self, capacity_lines: int):
        self.capacity = capacity_lines
        self._lru: OrderedDict[tuple[int, int], None] = OrderedDict()
        self.hits = 0
        self.misses = 0

    def access(self, key: tuple[int, int]) -> bool:
        if self.capacity <= 0:
            self.misses += 1
            return False
        if key in self._lru:
            self._lru.move_to_end(key)
            self.hits += 1
            return True
        self.misses += 1
        self._lru[key] = None
        if len(self._lru) > self.capacity:
            self._lru.popitem(last=False)
        return False


def plan_line_ops(page: int, line: int, write: bool,
                  cache: CodeCache | None) -> int:
    """DRAM operations for one 64B line access under SoftECC.

    Data op + code op; the code op is elided on a code-cache hit. Writes
    must read-modify-write the code line (codes for 8 lines share one 64B).
    """
    g, k = divmod(page, 8)
    code_row = GROUP * g + 8
    code_line = (k * 64 + line // 8) % 128  # which 64B of the code page
    ops = 1  # the data access itself
    hit = cache.access((code_row, code_line)) if cache else False
    if not hit:
        ops += 1          # fetch code line
    if write and not hit:
        ops += 1          # RMW write-back of the merged code line
    elif write:
        ops += 1          # dirty write-back eventually; charge one op
    return ops
