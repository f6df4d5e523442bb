"""Reliability / capacity SLO tracking per storage class and pool.

Port of ``repro/obs/slo.py`` (pure Python; the port keeps its own copy).
The paper's contract, stated as objectives a report can go red on:

  * **reliability** — data on SECDED and DAEC frames must never surface a
    detected-uncorrectable or a silently wrong read: those classes'
    budgets are 0. PARITY/NONE classes *tolerate* errors by contract —
    their counts are tracked but do not breach;
  * **tenant reliability** — the per-tenant read-outcome census the fault
    campaign feeds, against each tenant's ``max_error_rate``;
  * **capacity** — the reclaimed-page gain per pool rides the boundary
    register; a pool may declare a minimum gain below which the capacity
    SLO goes amber.

The tracker is a handful of dicts, always on. :data:`TRACKER` is
process-global: callers that compare runs ``reset()`` it first.
"""
from __future__ import annotations

from dataclasses import dataclass, field


@dataclass
class SLOStatus:
    """One objective's current verdict."""
    name: str
    scope: str
    ok: bool
    value: float
    objective: str
    detail: str = ""


@dataclass
class _ClassState:
    corrected: int = 0
    uncorrectable: int = 0
    silent: int = 0                # wrong bits surfaced with no flag
    budget: int | None = None      # max uncorrectable (None = unbounded)
    silent_budget: int | None = None   # max silent (None = unbounded)


@dataclass
class _TenantState:
    """Per-tenant read-outcome census (fed by the fault campaign)."""
    reads: int = 0
    corrected: int = 0
    detected: int = 0
    silent: int = 0
    max_error_rate: float | None = None   # (detected+silent)/reads budget

    @property
    def error_rate(self) -> float:
        return (self.detected + self.silent) / self.reads \
            if self.reads else 0.0


@dataclass
class _RegionState:
    sweeps: int = 0
    corrected: int = 0
    uncorrectable: int = 0
    last_rate: float = 0.0


@dataclass
class _CapacityState:
    total_rows: int = 0
    reclaimed_pages: int = 0
    boundary: int = 0
    min_gain: float | None = None


@dataclass
class SLOTracker:
    """The process-global SLO state (see :data:`TRACKER`)."""

    classes: dict[str, _ClassState] = field(default_factory=dict)
    regions: dict[str, _RegionState] = field(default_factory=dict)
    capacity: dict[str, _CapacityState] = field(default_factory=dict)
    tenants: dict[str, _TenantState] = field(default_factory=dict)

    def __post_init__(self):
        self._default_classes()

    def _default_classes(self) -> None:
        # the contract: DAEC/SECDED reads must never be uncorrectable and
        # never silently wrong; weaker classes tolerate errors (tracked,
        # never breaching on their own — the per-tenant SLO escalates
        # instead). Every Protection-ladder rung gets a class here — the
        # conformance suite asserts the two stay in sync.
        self.classes.setdefault("daec",
                                _ClassState(budget=0, silent_budget=0))
        self.classes.setdefault("secded",
                                _ClassState(budget=0, silent_budget=0))
        self.classes.setdefault("parity", _ClassState(budget=None))
        self.classes.setdefault("none", _ClassState(budget=None))

    # -- feeds ---------------------------------------------------------------
    def set_budget(self, cls: str, budget: int | None) -> None:
        self.classes.setdefault(cls, _ClassState()).budget = budget

    def record_read_status(self, cls: str, corrected: int = 0,
                           uncorrectable: int = 0, silent: int = 0) -> None:
        st = self.classes.setdefault(cls, _ClassState())
        st.corrected += int(corrected)
        st.uncorrectable += int(uncorrectable)
        st.silent += int(silent)

    def set_tenant_slo(self, tenant: str,
                       max_error_rate: float | None) -> None:
        self.tenants.setdefault(tenant, _TenantState()) \
            .max_error_rate = max_error_rate

    def record_tenant_reads(self, tenant: str, reads: int,
                            corrected: int = 0, detected: int = 0,
                            silent: int = 0) -> None:
        st = self.tenants.setdefault(tenant, _TenantState())
        st.reads += int(reads)
        st.corrected += int(corrected)
        st.detected += int(detected)
        st.silent += int(silent)

    def record_scrub(self, region: str, stats) -> None:
        """Fold one scrub sweep's census (a ``ScrubStats``-shaped object)."""
        st = self.regions.setdefault(region, _RegionState())
        st.sweeps += 1
        st.corrected += stats.corrected
        st.uncorrectable += (stats.detected_uncorrectable
                             + stats.parity_corrupt_lines)
        st.last_rate = stats.error_rate

    def record_capacity(self, pool_name: str, pool,
                        min_gain: float | None = None) -> None:
        st = self.capacity.setdefault(pool_name, _CapacityState())
        st.total_rows = pool.num_rows
        st.reclaimed_pages = pool.num_extra_pages
        st.boundary = pool.boundary
        if min_gain is not None:
            st.min_gain = min_gain

    def set_capacity_target(self, pool_name: str, min_gain: float) -> None:
        self.capacity.setdefault(pool_name, _CapacityState()) \
            .min_gain = min_gain

    # -- verdicts ------------------------------------------------------------
    def report(self) -> list[SLOStatus]:
        out: list[SLOStatus] = []
        for cls, st in sorted(self.classes.items()):
            if st.budget is None and st.silent_budget is None:
                ok = True
                objective = "errors tolerated by contract"
            else:
                ok = (st.budget is None or st.uncorrectable <= st.budget) \
                    and (st.silent_budget is None
                         or st.silent <= st.silent_budget)
                parts = []
                if st.budget is not None:
                    parts.append(f"uncorrectable <= {st.budget}")
                if st.silent_budget is not None:
                    parts.append(f"silent <= {st.silent_budget}")
                objective = ", ".join(parts)
            out.append(SLOStatus(
                name="reliability", scope=f"class/{cls}", ok=ok,
                value=float(st.uncorrectable + st.silent),
                objective=objective,
                detail=f"corrected={st.corrected} silent={st.silent}"))
        for tenant, st in sorted(self.tenants.items()):
            ok = st.max_error_rate is None \
                or st.error_rate <= st.max_error_rate
            objective = "observed error rate (informational)" \
                if st.max_error_rate is None \
                else f"error rate <= {st.max_error_rate:g}"
            out.append(SLOStatus(
                name="tenant-reliability", scope=f"tenant/{tenant}", ok=ok,
                value=st.error_rate, objective=objective,
                detail=f"reads={st.reads} corrected={st.corrected} "
                       f"detected={st.detected} silent={st.silent}"))
        for region, st in sorted(self.regions.items()):
            out.append(SLOStatus(
                name="scrub", scope=f"region/{region}", ok=True,
                value=st.last_rate,
                objective="error-rate census (informational)",
                detail=f"sweeps={st.sweeps} corrected={st.corrected} "
                       f"uncorrectable={st.uncorrectable}"))
        for pool, st in sorted(self.capacity.items()):
            gain = st.reclaimed_pages / st.total_rows if st.total_rows else 0.0
            ok = st.min_gain is None or gain >= st.min_gain
            objective = "reclaimed gain (informational)" \
                if st.min_gain is None else f"gain >= {st.min_gain:.3f}"
            out.append(SLOStatus(
                name="capacity", scope=f"pool/{pool}", ok=ok, value=gain,
                objective=objective,
                detail=f"extra_pages={st.reclaimed_pages} "
                       f"boundary={st.boundary}/{st.total_rows}"))
        return out

    def breached(self) -> list[SLOStatus]:
        return [s for s in self.report() if not s.ok]

    def reset(self) -> None:
        self.classes.clear()
        self.regions.clear()
        self.capacity.clear()
        self.tenants.clear()
        self._default_classes()


#: Process-global tracker (always on — a handful of dict updates).
TRACKER = SLOTracker()
