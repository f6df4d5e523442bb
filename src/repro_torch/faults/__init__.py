"""CREAM-Campaign: FIT-driven live fault injection with a closed
reliability-SLO loop (see :mod:`repro_torch.faults.campaign`)."""
from repro_torch.faults.campaign import CampaignReport, FaultCampaign
from repro_torch.faults.fit import (CI_SMOKE_FIT, HEALTHY_FIT, MEMCACHED_FIT,
                                    expected_flips, hours_for_expected_flips,
                                    soft_rate_per_gb_per_step)
from repro_torch.faults.shadow import PageCensus, ShadowedPool

__all__ = [
    "CampaignReport", "FaultCampaign", "ShadowedPool", "PageCensus",
    "MEMCACHED_FIT", "HEALTHY_FIT", "CI_SMOKE_FIT",
    "soft_rate_per_gb_per_step", "hours_for_expected_flips",
    "expected_flips",
]
