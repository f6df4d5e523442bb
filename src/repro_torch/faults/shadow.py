"""Ground-truth shadow tracking: classify every read as clean / corrected /
detected / silently corrupted.

Port of ``repro/faults/shadow.py``. :class:`ShadowedPool` wraps a
:class:`~repro_torch.core.pool.PoolState` and keeps a *shadow copy* of
every page the system has written — the content the data plane
**believes** is stored. Reads go through the wrapped pool's status path;
each returned page is compared against the shadow:

  ============================  ==========================  ============
  hardware status               data == shadow              verdict
  ============================  ==========================  ============
  DETECTED_UNCORRECTABLE        (any)                       detected
  CORRECTED_*                   yes                         corrected
  CORRECTED_*                   no                          **silent** (miscorrection)
  CLEAN                         yes                         clean
  CLEAN                         no                          **silent**
  ============================  ==========================  ============

The shadow lives on the pool's device beside the storage, so a read's
classification is one comparison there and only the per-page verdicts
come back to the host; the page ids, validity and counters stay on the
host.

The wrapper is mutable (``write`` replaces ``self.inner`` and returns
``self``), so it survives the data plane's ``vm.pools[name] =
pool.write(...)`` idiom, and the engine, VM, migration and policy layers
run unmodified over it. It is not a ``PoolState``, so the fused paths that
bypass a pool's ``read``/``write`` — the engine's mixed read, the
migration engine's gather/re-encode and coded-row scatter — check
``isinstance(pool, PoolState)`` and route a shadowed pool through
``read``/``write`` instead. One caveat is inherent: a migration re-writes
what it read, so corruption that slips through a migration read is
counted as silent at that read and then becomes the new believed content.

Not here yet: ``read_writeback`` and ``streams`` (they wait for
``pool.read_writeback`` / ``pool.streams``, ROADMAP queue 1 item 3) and
the reference's deprecated access shims.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.core import secded
from repro_torch.core.layouts import extra_page_count
from repro_torch.core.pool import _as_words, _host_ids, _landing_rows
from repro_torch.kernels.common import upload
from repro_torch.vm.address_space import frame_classes


@dataclass
class PageCensus:
    """Cumulative read-outcome counts for one reliability class."""
    reads: int = 0
    clean: int = 0
    corrected: int = 0
    detected: int = 0
    silent: int = 0

    def rate(self, kind: str) -> float:
        return getattr(self, kind) / self.reads if self.reads else 0.0


class ShadowedPool:
    """Pool wrapper adding a ground-truth oracle to every batched read."""

    def __init__(self, inner):
        self.inner = inner
        S = getattr(inner, "num_shards", 1)   # a sharded pool's extras
        cap = inner.num_rows + S * extra_page_count(    # stripe its banks
            inner.layout, inner.num_rows // S, inner.row_words)
        self._shadow = torch.zeros((cap, inner.page_words), dtype=torch.int32,
                                   device=inner.device)
        self._valid = np.zeros(cap, bool)
        # per-page outcome counters (for tenant attribution via drain())
        self._reads = np.zeros(cap, np.int64)
        self._corrected = np.zeros(cap, np.int64)
        self._detected = np.zeros(cap, np.int64)
        self._silent = np.zeros(cap, np.int64)
        self._drained = np.zeros((4, cap), np.int64)   # snapshot at last drain
        self.census: dict[str, PageCensus] = {}

    # -- forwarded geometry --------------------------------------------------
    @property
    def layout(self):
        return self.inner.layout

    @property
    def row_words(self) -> int:
        return self.inner.row_words

    @property
    def boundary(self) -> int:
        return self.inner.boundary

    @property
    def num_rows(self) -> int:
        return self.inner.num_rows

    @property
    def num_pages(self) -> int:
        return self.inner.num_pages

    @property
    def num_extra_pages(self) -> int:
        return self.inner.num_extra_pages

    @property
    def page_words(self) -> int:
        return self.inner.page_words

    @property
    def page_bytes(self) -> int:
        return self.inner.page_bytes

    @property
    def boundary_step(self) -> int:
        return self.inner.boundary_step

    @property
    def daec_rows(self) -> int:
        return self.inner.daec_rows

    @property
    def daec_start(self) -> int:
        return self.inner.daec_start

    @property
    def has_parity(self) -> bool:
        return self.inner.has_parity

    @property
    def storage(self) -> torch.Tensor:
        return self.inner.storage

    @property
    def device(self) -> torch.device:
        return self.inner.device

    # -- the oracle ----------------------------------------------------------
    def _classify(self, ids: np.ndarray, data: torch.Tensor,
                  status: torch.Tensor) -> None:
        valid = self._valid[ids]
        match = np.zeros(ids.size, bool)
        if valid.any():
            sel = np.flatnonzero(valid)
            at = upload(sel, data.device)
            match[sel] = (data[at] == self._shadow[
                upload(ids[sel], data.device)]).all(dim=1).cpu().numpy()
        status = status.cpu().numpy()
        detected = status == secded.DETECTED_UNCORRECTABLE
        corrected = ((status == secded.CORRECTED_DATA) |
                     (status == secded.CORRECTED_CODE)) & ~detected
        # wrong bits with no flag — incl. miscorrections (status says
        # corrected but the data disagrees with the ground truth)
        silent = valid & ~detected & ~match
        corrected &= match
        detected &= valid
        corrected &= valid
        np.add.at(self._reads, ids[valid], 1)   # only believed pages count
        np.add.at(self._detected, ids[detected], 1)
        np.add.at(self._corrected, ids[corrected], 1)
        np.add.at(self._silent, ids[silent], 1)
        # per-class census, attributed at read time under the live boundary
        classes = frame_classes(self.inner, ids)
        _, first = np.unique(classes[valid], return_index=True)
        for cls in classes[valid][np.sort(first)]:      # the three verdicts
            of = valid & (classes == cls)                # are disjoint
            cen = self.census.setdefault(str(cls), PageCensus())
            cen.reads += int(of.sum())
            cen.detected += int((of & detected).sum())
            cen.silent += int((of & silent).sum())
            cen.corrected += int((of & corrected).sum())
            cen.clean += int((of & ~(detected | silent | corrected)).sum())

    def drain(self) -> dict[int, tuple[int, int, int, int]]:
        """Per-page (reads, corrected, detected, silent) since last drain."""
        cur = np.stack([self._reads, self._corrected,
                        self._detected, self._silent])
        delta = cur - self._drained
        self._drained = cur
        pages = np.nonzero(delta.any(axis=0))[0]
        return {int(p): tuple(int(x) for x in delta[:, p]) for p in pages}

    # -- the data plane ------------------------------------------------------
    def read(self, pages, *, status=False):
        data, st = self.inner.read(pages, status=True)
        self._classify(_host_ids(self.inner, pages), data, st)
        return (data, st) if status else data

    def write(self, pages, data, *, valid=None) -> "ShadowedPool":
        ids = _host_ids(self.inner, pages)
        words = _as_words(self.inner, data, ids.shape[0])
        self.inner = self.inner.write(ids, words, valid=valid)
        # the rows the pool landed: the valid ones, the last of duplicates
        land = np.flatnonzero(_landing_rows(ids, valid))
        if land.size:
            dev = self._shadow.device
            rows = upload(land, dev)
            self._shadow[upload(ids[land], dev)] = words[rows]
            self._valid[ids[land]] = True
        return self

    def migrate(self, src_pages, dst_pages, *,
                donate: bool = True) -> "ShadowedPool":
        # through the classified read + write, not the inner fused migrate:
        # migration reads must hit the oracle (and what they surface becomes
        # the new believed content — the caveat above)
        return self.write(dst_pages, self.read(src_pages))

    # -- control plane -------------------------------------------------------
    def evict_prediction(self, new_boundary: int) -> list[int]:
        return self.inner.evict_prediction(new_boundary)

    def move_boundary(self, new_boundary: int) -> tuple["ShadowedPool", dict]:
        self.inner, info = self.inner.move_boundary(new_boundary)
        # pages beyond the new geometry no longer exist
        self._valid[self.inner.num_pages:] = False
        return self, info

    def scrub(self, use_kernel: bool = False) -> tuple["ShadowedPool", object]:
        # scrub repairs toward the stored codewords; the logical truth
        # (what the system wrote) is unchanged, so the shadow stays put
        self.inner, stats = self.inner.scrub(use_kernel=use_kernel)
        return self, stats

    def set_daec_rows(self, daec_rows: int) -> "ShadowedPool":
        # re-encoding preserves logical contents, so the shadow stays put
        self.inner = self.inner.set_daec_rows(daec_rows)
        return self

    # -- injection -----------------------------------------------------------
    def inject(self, fault_model) -> int:
        """One injector step against the wrapped pool (shadow untouched —
        injected corruption is exactly what the oracle must catch)."""
        self.inner, count = fault_model.step_pool(self.inner)
        return count
