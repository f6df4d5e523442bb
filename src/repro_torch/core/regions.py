"""RegionManager — named reliability domains over CREAM pools (paper Fig. 1).

Port of ``repro/core/regions.py``. Each region ("weights", "opt_state",
"kv_cache", ...) owns a pool whose boundary register splits it into a
SECDED part and a CREAM part. The adaptive controller closes the loop the
paper envisions in §3.3:

    scrub -> monitor -> recommend -> repartition (move the boundary)

Protection levels map to boundary positions:
    SECDED -> boundary = 0          (whole pool conventional ECC layout)
    PARITY -> boundary = num_rows   with Layout.PARITY
    NONE   -> boundary = num_rows   with a correction-free layout

The pools live on the manager's ``device`` (``cuda`` unless asked
otherwise), at the default row width (``DEFAULT_ROW_WORDS``), as in the
reference: a region's size comes from its rows. On the card a sweep runs
the scrub and parity8 check kernels, and a region turning PARITY lands its
pages and parity tables through ``parity8_write``.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field

from repro_torch.core.layouts import GROUP_ROWS, Layout
from repro_torch.core.monitor import ErrorMonitor, MonitorConfig
from repro_torch.core.pool import PoolState, make_pool, repartition
from repro_torch.core.protection import Protection, RegionSpec, default_layout
from repro_torch.core.scrubber import ScrubStats, scrub
from repro_torch.kernels.common import resolve_device


@dataclass
class Region:
    spec: RegionSpec
    pool: PoolState
    evictions: list[int] = field(default_factory=list)  # pending owner action

    @property
    def protection(self) -> Protection:
        return self.spec.protection

    @property
    def capacity_pages(self) -> int:
        return self.pool.num_pages


def _boundary_for(protection: Protection, rows: int) -> int:
    return 0 if protection == Protection.SECDED else rows


def _layout_for(protection: Protection, rows_layout: Layout | None) -> Layout:
    if protection == Protection.SECDED:
        # the layout is irrelevant at boundary 0, but a CREAM layout on the
        # state lets a later downgrade regrow without re-creating the pool
        return rows_layout or Layout.INTERWRAP
    return rows_layout or default_layout(protection)


class RegionManager:
    """Owns regions, runs the scrub/monitor/repartition loop."""

    def __init__(self, monitor_config: MonitorConfig | None = None,
                 device=None):
        self.device = resolve_device(device)
        self.regions: dict[str, Region] = {}
        self.monitor = ErrorMonitor(monitor_config)
        self.transitions: list[tuple[str, Protection, Protection]] = []

    # -- setup -------------------------------------------------------------
    def add_region(self, spec: RegionSpec) -> Region:
        if spec.rows % GROUP_ROWS:
            raise ValueError("region rows must be group-aligned")
        layout = _layout_for(spec.protection, spec.layout
                             if spec.protection != Protection.SECDED else None)
        pool = make_pool(spec.rows, layout,
                         boundary=_boundary_for(spec.protection, spec.rows),
                         device=self.device)
        region = Region(spec, pool)
        self.regions[spec.name] = region
        return region

    # -- accounting ---------------------------------------------------------
    def total_capacity_pages(self) -> int:
        return sum(r.capacity_pages for r in self.regions.values())

    def capacity_report(self) -> dict[str, dict]:
        return {name: {"protection": r.protection.value,
                       "layout": r.pool.layout.value,
                       "rows": r.pool.num_rows,
                       "boundary": r.pool.boundary,
                       "pages": r.capacity_pages,
                       "gain": r.pool.capacity_gain()}
                for name, r in self.regions.items()}

    # -- adaptation loop ----------------------------------------------------
    def scrub_all(self, use_kernel: bool = False) -> dict[str, ScrubStats]:
        """One sweep of every region, each census fed to the monitor. A
        sweep dispatches by the pool's device (see
        :func:`repro_torch.core.scrubber.scrub`)."""
        stats = {}
        for name, region in self.regions.items():
            region.pool, s = scrub(region.pool, use_kernel=use_kernel)
            self.monitor.record(name, s)
            stats[name] = s
        return stats

    def adapt(self) -> list[tuple[str, Protection, Protection]]:
        """Apply monitor recommendations; returns performed transitions."""
        performed = []
        for name, region in self.regions.items():
            cur = region.protection
            rec = self.monitor.recommend(
                name, cur, floor=region.spec.min_protection,
                ceiling=region.spec.max_protection)
            if rec == cur:
                continue
            self._transition(region, rec)
            self.monitor.acknowledge_transition(name)
            performed.append((name, cur, rec))
            self.transitions.append((name, cur, rec))
        return performed

    def set_protection(self, name: str, protection: Protection) -> None:
        """Operator-forced transition (e.g. SLA change for a tenant)."""
        region = self.regions[name]
        if region.protection != protection:
            self._transition(region, protection)

    def _transition(self, region: Region, protection: Protection) -> None:
        """Repartition the region's pool to realise ``protection``.

        SECDED<->CREAM uses the boundary register (data-preserving).
        Changing the CREAM *layout* (e.g. NONE/InterWrap -> PARITY)
        re-creates the CREAM part through the boundary: shrink to 0 (the
        conventional layout, evicting the extra pages into
        ``region.evictions``), swap the layout tag, grow back — regular
        pages keep their contents, and a regrow into PARITY builds the
        parity tables of every CREAM row.
        """
        pool = region.pool
        target_layout = default_layout(protection) \
            if protection != Protection.SECDED else pool.layout
        if protection == Protection.SECDED:
            pool, info = repartition(pool, 0)
            region.evictions += info["evicted_extra_pages"]
        else:
            if pool.layout != target_layout and pool.boundary > 0:
                pool, info = repartition(pool, 0)
                region.evictions += info["evicted_extra_pages"]
            if pool.layout != target_layout:
                pool = dataclasses.replace(pool, layout=target_layout)
            pool, info = repartition(pool, pool.num_rows)
        region.pool = pool
        spec_layout = Layout.BASELINE_ECC if protection == Protection.SECDED \
            else pool.layout
        region.spec = RegionSpec(
            region.spec.name, protection, spec_layout, region.spec.rows,
            min_protection=region.spec.min_protection,
            max_protection=region.spec.max_protection)
