"""Policy bridge: the scrub → monitor → recommend loop, acting on the VM.

Port of ``repro/vm/policy.py``. :class:`VMPolicy` realises each monitor
recommendation as a VM transaction
(:meth:`~repro_torch.vm.migration.MigrationEngine.repartition_with_migration`),
so every mapped page survives the boundary move.

A pool's realisable protection levels are its CREAM layout's class
(boundary = R: NONE for InterWrap/rank-subset/packed, PARITY for the parity
layout) and SECDED (boundary = 0). Recommendations in between are snapped
in the direction of the recommendation — upgrades round up to SECDED,
downgrades round down to the layout's class — so the loop never
under-protects relative to the monitor.

One layer up, the tenant reliability SLOs close the fault campaign's loop
(:mod:`repro_torch.faults.campaign`): read outcomes observed by the shadow
oracle are folded per ``(tenant, segment)``, and a segment whose observed
error rate crosses its :class:`TenantSLO` is escalated one protection level
through the zero-loss relocation of
:meth:`~repro_torch.vm.migration.MigrationEngine.relocate` — carving a
SEC-DAEC tier in place first when the target is DAEC.
"""
from __future__ import annotations

from dataclasses import dataclass

from repro_torch.core.monitor import ErrorMonitor, MonitorConfig
from repro_torch.core.pool import PoolLike
from repro_torch.core.protection import (_ORDER, Protection, at_least,
                                         stronger)
from repro_torch.core.scrubber import ScrubStats
from repro_torch.obs import slo as obs_slo
from repro_torch.vm.address_space import (VirtualMemory, cream_protection,
                                          frame_class)
from repro_torch.vm.migration import MigrationEngine


def pool_protection(state: PoolLike) -> Protection:
    """The protection level a pool currently guarantees (its weakest part)."""
    if state.boundary == 0:
        return Protection.SECDED
    return cream_protection(state.layout)


@dataclass
class PoolPolicy:
    """Per-pool knobs: how far the adaptation loop may swing the boundary."""
    floor: Protection = Protection.NONE       # weakest allowed
    ceiling: Protection = Protection.SECDED   # strongest allowed


@dataclass
class TenantSLO:
    """Per-(tenant, segment) reliability contract the campaign enforces.

    ``max_error_rate`` bounds (detected + silent) / reads as observed by
    the shadow oracle; crossing it (after ``min_reads`` observations, so
    one unlucky page cannot trigger a migration storm) escalates the
    segment one protection level, up to ``ceiling``.
    """
    max_error_rate: float = 1e-3
    min_reads: int = 64
    ceiling: Protection = Protection.SECDED


class VMPolicy:
    """Owns the adaptation loop over every pool the VM manages."""

    def __init__(self, vm: VirtualMemory, engine: MigrationEngine | None = None,
                 config: MonitorConfig | None = None,
                 pool_policies: dict[str, PoolPolicy] | None = None):
        self.vm = vm
        self.engine = engine or MigrationEngine(vm)
        self.monitor = ErrorMonitor(config)
        self.pool_policies = pool_policies or {}
        self.transitions: list[tuple[str, Protection, Protection]] = []
        # per-(tenant, segment) SLOs + observed read-outcome accumulators
        self.tenant_slos: dict[tuple[str, str], TenantSLO] = {}
        self._observed: dict[tuple[str, str], list[int]] = {}
        self.escalations: list[dict] = []

    def policy_for(self, pool_name: str) -> PoolPolicy:
        return self.pool_policies.get(pool_name, PoolPolicy())

    # -- tenant reliability SLOs (the campaign's closed loop) ----------------
    def set_tenant_slo(self, tenant: str, segment: str,
                       slo: TenantSLO) -> None:
        self.tenant_slos[(tenant, segment)] = slo
        obs_slo.TRACKER.set_tenant_slo(f"{tenant}/{segment}",
                                       slo.max_error_rate)

    def observe_reads(self, tenant: str, segment: str, reads: int,
                      corrected: int = 0, detected: int = 0,
                      silent: int = 0) -> None:
        """Fold shadow-oracle read outcomes for one tenant segment."""
        acc = self._observed.setdefault((tenant, segment), [0, 0, 0, 0])
        for i, v in enumerate((reads, corrected, detected, silent)):
            acc[i] += int(v)
        obs_slo.TRACKER.record_tenant_reads(
            f"{tenant}/{segment}", reads, corrected=corrected,
            detected=detected, silent=silent)

    def observed_error_rate(self, tenant: str, segment: str) -> float:
        acc = self._observed.get((tenant, segment))
        if not acc or not acc[0]:
            return 0.0
        return (acc[2] + acc[3]) / acc[0]

    def escalate_tenant(self, tenant: str, segment: str,
                        target: Protection) -> dict:
        """Upgrade a segment's reliability class via zero-loss migration.

        The segment default and every PTE's contract move to ``target``
        (host-resident pages too, so a later swap-in honours it); pages on
        frames weaker than ``target`` are relocated. A DAEC target first
        carves DAEC frames in place (:meth:`ensure_daec_frames`), which
        upgrades the segment's frames in the carved rows without a move.
        """
        space = self.vm.tenants[tenant]
        before = space.segments.get(segment, Protection.NONE)
        space.segments[segment] = target
        if target == Protection.DAEC:
            demand = sum(1 for pte in space.entries.values()
                         if pte.segment == segment and pte.pool is not None)
            self.ensure_daec_frames(demand)
        move: list[int] = []
        for vpn, pte in space.entries.items():
            if pte.segment != segment:
                continue
            pte.reliability = target
            if pte.pool is not None and not at_least(
                    frame_class(self.vm.pools[pte.pool], pte.phys), target):
                move.append(vpn)
        moved = self.engine.relocate(tenant, move) if move else 0
        esc = {"tenant": tenant, "segment": segment, "from": before,
               "to": target, "moved": moved}
        self.escalations.append(esc)
        self._observed.pop((tenant, segment), None)   # fresh window
        return esc

    def ensure_daec_frames(self, count: int) -> int:
        """Grow pools' SEC-DAEC tiers until ``count`` free DAEC frames exist.

        Carving converts the top of a pool's SECDED span in place, in
        multiples of ``boundary_step`` rows (``set_daec_rows`` re-encodes
        the contents, so mapped frames there simply upgrade), and rebuilds
        the free lists. Best effort: returns the free DAEC frames after,
        which may fall short when no pool has SECDED rows left.
        """
        def free_daec() -> int:
            return sum(len(a.free.get(Protection.DAEC, {}))
                       for a in self.vm.allocators.values())

        free = free_daec()
        for name, state in list(self.vm.pools.items()):
            if free >= count:
                break
            step = state.boundary_step
            avail = (state.num_rows - state.daec_rows) - state.boundary
            if avail <= 0:
                continue
            want = min(avail, -((free - count) // step) * step)
            new_state = state.set_daec_rows(state.daec_rows + want)
            self.vm.pools[name] = new_state
            self.vm.allocators[name].rebuild(new_state)
            free = free_daec()
        return free

    def auto_escalate(self) -> list[dict]:
        """Escalate every tenant segment whose observed rate crossed its
        SLO; returns the escalations performed."""
        done = []
        for (tenant, segment), slo in list(self.tenant_slos.items()):
            acc = self._observed.get((tenant, segment))
            if not acc or acc[0] < slo.min_reads:
                continue
            if (acc[2] + acc[3]) / acc[0] <= slo.max_error_rate:
                continue
            current = self.vm.tenants[tenant].segments.get(
                segment, Protection.NONE)
            target = _ORDER[min(_ORDER.index(stronger(current)),
                                _ORDER.index(slo.ceiling))]
            if target == current:
                # already at the ceiling: reset the window so the breach
                # is re-evaluated on fresh evidence, not compounded
                self._observed.pop((tenant, segment), None)
                continue
            done.append(self.escalate_tenant(tenant, segment, target))
        return done

    # -- the loop ------------------------------------------------------------
    def scrub_all(self, use_kernel: bool = False) -> dict[str, ScrubStats]:
        """Sweep every pool, repairing SECDED rows and feeding the monitor.
        ``use_kernel`` is ignored: the sweep dispatches by the pool's device
        (:func:`repro_torch.core.scrubber.scrub`)."""
        stats = {}
        for name in list(self.vm.pools):
            self.vm.pools[name], s = self.vm.pools[name].scrub(
                use_kernel=use_kernel)
            self.monitor.record(name, s)
            stats[name] = s
        return stats

    def adapt(self) -> list[dict]:
        """Realise monitor recommendations as repartition+migrate
        transactions; returns one transaction info per pool whose boundary
        moved."""
        performed = []
        for name, state in list(self.vm.pools.items()):
            cur = pool_protection(state)
            pp = self.policy_for(name)
            rec = self.monitor.recommend(name, cur, floor=pp.floor,
                                         ceiling=pp.ceiling)
            if rec == cur:
                continue
            weak = cream_protection(state.layout)
            if at_least(rec, cur):                    # upgrade
                target = rec if rec in (Protection.SECDED, weak) \
                    else Protection.SECDED
            else:                                     # downgrade
                target = rec if rec in (Protection.SECDED, weak) else weak
            if target == cur:
                continue
            new_boundary = 0 if target == Protection.SECDED \
                else state.num_rows
            info = self.engine.repartition_with_migration(name, new_boundary)
            self.monitor.acknowledge_transition(name)
            self.transitions.append((name, cur, target))
            performed.append(info)
        return performed

    def step(self, use_kernel: bool = False
             ) -> tuple[dict[str, ScrubStats], list[dict]]:
        """One full adaptation epoch: scrub → monitor → repartition+migrate."""
        stats = self.scrub_all(use_kernel=use_kernel)
        return stats, self.adapt()
