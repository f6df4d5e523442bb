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

The tenant reliability SLOs and their escalation (``set_tenant_slo``,
``observe_reads``, ``escalate_tenant``, ``ensure_daec_frames``,
``auto_escalate``) belong to the fault-campaign slice and raise
``NotImplementedError`` until it lands.
"""
from __future__ import annotations

from dataclasses import dataclass

from repro_torch.core.monitor import ErrorMonitor, MonitorConfig
from repro_torch.core.pool import PoolState
from repro_torch.core.protection import Protection, at_least
from repro_torch.core.scrubber import ScrubStats
from repro_torch.vm.address_space import VirtualMemory, cream_protection
from repro_torch.vm.migration import MigrationEngine

_CAMPAIGN_TODO = ("tenant SLOs and escalation belong to the fault-campaign "
                  "slice (ROADMAP, queue 1 item 7: Faults)")


def pool_protection(state: PoolState) -> Protection:
    """The protection level a pool currently guarantees (its weakest part)."""
    if state.boundary == 0:
        return Protection.SECDED
    return cream_protection(state.layout)


@dataclass
class PoolPolicy:
    """Per-pool knobs: how far the adaptation loop may swing the boundary."""
    floor: Protection = Protection.NONE       # weakest allowed
    ceiling: Protection = Protection.SECDED   # strongest allowed


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

    def policy_for(self, pool_name: str) -> PoolPolicy:
        return self.pool_policies.get(pool_name, PoolPolicy())

    # -- tenant reliability SLOs: the fault-campaign slice -------------------
    def set_tenant_slo(self, tenant: str, segment: str, slo) -> None:
        raise NotImplementedError(_CAMPAIGN_TODO)

    def observe_reads(self, tenant: str, segment: str, reads: int,
                      corrected: int = 0, detected: int = 0,
                      silent: int = 0) -> None:
        raise NotImplementedError(_CAMPAIGN_TODO)

    def escalate_tenant(self, tenant: str, segment: str,
                        target: Protection) -> dict:
        raise NotImplementedError(_CAMPAIGN_TODO)

    def ensure_daec_frames(self, count: int) -> int:
        raise NotImplementedError(_CAMPAIGN_TODO)

    def auto_escalate(self) -> list[dict]:
        raise NotImplementedError(_CAMPAIGN_TODO)

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
