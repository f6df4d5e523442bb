"""The fault campaign: FIT-driven injection against a *live* pool, with
the observation loop closed through monitor → SLO → policy escalation.

Port of ``repro/faults/campaign.py``. One :class:`FaultCampaign` owns one
VM pool. On attach it swaps the pool for a
:class:`~repro_torch.faults.shadow.ShadowedPool` (the data plane keeps
running — engine decode steps and migrations route through the wrapper
untouched) and builds a :class:`~repro_torch.core.injection.FaultModel`
whose Poisson soft-error rate comes from a FIT figure via
:mod:`repro_torch.faults.fit`. Each campaign tick:

  1. **inject** one step of faults into the live storage (soft events per
     the :class:`~repro_torch.core.injection.ErrorMix`, plus sticky hard
     cells);
  2. the workload runs — every read is classified against the shadow
     oracle as clean / corrected / detected / **silent**;
  3. **observe**: per-page outcome deltas are attributed to the owning
     ``(tenant, segment)`` through the frame allocator's reverse map and
     fed to :meth:`~repro_torch.vm.policy.VMPolicy.observe_reads`, the
     global :data:`~repro_torch.obs.slo.TRACKER` and
     :meth:`~repro_torch.core.monitor.ErrorMonitor.record_observation`;
  4. **escalate**: :meth:`~repro_torch.vm.policy.VMPolicy.auto_escalate`
     upgrades any tenant segment whose observed error rate crossed its
     SLO — the zero-loss relocation — and the campaign re-syncs the
     serving engine's tier map and translations.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from repro_torch.core.injection import ErrorMix, FaultModel, FIELD_MIX
from repro_torch.faults.fit import MEMCACHED_FIT, soft_rate_per_gb_per_step
from repro_torch.faults.shadow import PageCensus, ShadowedPool
from repro_torch.obs import slo
from repro_torch.vm.address_space import VirtualMemory, frame_class
from repro_torch.vm.policy import VMPolicy


@dataclass
class CampaignReport:
    """What one campaign measured, per reliability class."""
    steps: int = 0
    injected: int = 0
    census: dict[str, PageCensus] = field(default_factory=dict)
    escalations: list[dict] = field(default_factory=list)

    def rates(self) -> dict[str, dict[str, float]]:
        return {cls: {k: cen.rate(k)
                      for k in ("corrected", "detected", "silent")}
                for cls, cen in sorted(self.census.items())}


class FaultCampaign:
    """Drive a FIT-scaled error process against one live VM pool."""

    def __init__(self, vm: VirtualMemory, pool_name: str, *,
                 policy: VMPolicy | None = None, engine=None,
                 fit_per_mbit: float = MEMCACHED_FIT,
                 hours_per_step: float = 1.0,
                 mix: ErrorMix = FIELD_MIX, n_hard: int = 0,
                 seed: int = 0, adopt: bool = True):
        self.vm = vm
        self.pool_name = pool_name
        self.policy = policy
        self.engine = engine
        inner = vm.pools[pool_name]
        if isinstance(inner, ShadowedPool):
            raise ValueError(f"pool {pool_name!r} is already shadowed")
        self.shadow = ShadowedPool(inner)
        vm.pools[pool_name] = self.shadow
        if adopt:
            self._adopt_contents()
        self.model = FaultModel.make(
            seed,
            soft_rate=soft_rate_per_gb_per_step(fit_per_mbit, hours_per_step),
            n_hard=n_hard, shape=(inner.num_rows, *inner.storage.shape[-2:]),
            mix=mix)
        self.fit_per_mbit = fit_per_mbit
        self.hours_per_step = hours_per_step
        self.steps = 0
        self.injected = 0
        self.first_escalation_step: int | None = None

    def _adopt_contents(self) -> None:
        """Bless the pool's current contents as believed ground truth, so
        pages written before the campaign attached classify correctly."""
        n = self.shadow.num_pages
        data, _ = self.shadow.inner.read(np.arange(n), status=True)
        self.shadow._shadow[:n] = data
        self.shadow._valid[:n] = True
        self.shadow.drain()             # attach noise must not attribute

    # -- the loop ------------------------------------------------------------
    def inject(self) -> int:
        """One injector step against the live pool. Returns flips applied."""
        n = self.shadow.inject(self.model)
        self.steps += 1
        self.injected += n
        return n

    def observe(self) -> dict[str, tuple[int, int, int, int]]:
        """Drain read outcomes since the last call and close the loop.

        Per-page deltas are attributed to the owning (tenant, segment) via
        the allocator's reverse map, then fed to the policy accumulator,
        the SLO tracker, and the error monitor. Returns the per-class
        aggregate ``{class: (reads, corrected, detected, silent)}``.
        """
        owner = self.vm.allocators[self.pool_name].owner
        by_class: dict[str, list[int]] = {}
        total = [0, 0, 0, 0]
        for phys, (reads, corrected, detected, silent) in \
                self.shadow.drain().items():
            cls = frame_class(self.shadow.inner, phys).value
            acc = by_class.setdefault(cls, [0, 0, 0, 0])
            for i, v in enumerate((reads, corrected, detected, silent)):
                acc[i] += v
                total[i] += v
            slo.TRACKER.record_read_status(
                cls, corrected=corrected, uncorrectable=detected,
                silent=silent)
            who = owner.get(phys)
            if who is None or self.policy is None:
                continue
            tenant, vpn = who
            pte = self.vm.tenants[tenant].entries[vpn]
            self.policy.observe_reads(tenant, pte.segment, reads=reads,
                                      corrected=corrected,
                                      detected=detected, silent=silent)
        if self.policy is not None and total[0]:
            self.policy.monitor.record_observation(
                self.pool_name, checked=total[0], corrected=total[1],
                uncorrectable=total[2], silent=total[3])
        return {cls: tuple(acc) for cls, acc in by_class.items()}

    def escalate(self) -> list[dict]:
        """Run the policy's SLO check; sync the engine after any upgrade."""
        if self.policy is None:
            return []
        done = self.policy.auto_escalate()
        if done and self.first_escalation_step is None:
            self.first_escalation_step = self.steps
        if done and self.engine is not None:
            kv = getattr(self.engine, "kv", None)
            for esc in done:
                if kv is not None and esc["segment"] in kv.tiers:
                    kv.tiers[esc["segment"]] = esc["to"]
            if kv is not None:
                kv.refresh()            # phys mirror moved under us
            self.engine.refresh_translation()
        return done

    def tick(self) -> list[dict]:
        """inject → observe → escalate (the workload runs in between the
        caller's ticks). Returns any escalations performed."""
        self.inject()
        self.observe()
        return self.escalate()

    # -- teardown / results --------------------------------------------------
    def detach(self) -> None:
        """Restore the unwrapped pool (campaign over)."""
        if self.vm.pools.get(self.pool_name) is self.shadow:
            self.vm.pools[self.pool_name] = self.shadow.inner

    def report(self) -> CampaignReport:
        return CampaignReport(
            steps=self.steps, injected=self.injected,
            census=dict(self.shadow.census),
            escalations=list(self.policy.escalations)
            if self.policy is not None else [])
