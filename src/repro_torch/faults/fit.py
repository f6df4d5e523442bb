"""FIT-rate arithmetic: field failure rates -> injector step rates.

Port of ``repro/faults/fit.py`` (the same arithmetic). DRAM reliability is
quoted in **FIT/Mbit** — failures per 10⁹ device-hours per megabit. Field
studies of production fleets (Schroeder et al., SIGMETRICS'09 — the
memcached-class machines the paper targets) measure 25,000–75,000 FIT/Mbit
of correctable errors. The campaign drives the injector from these
numbers:

    errors = FIT/Mbit × Mbits × hours / 10⁹
    Mbit/GB = 8 × 1024
    soft_rate_per_gb_per_step = FIT/Mbit × 8192 × hours_per_step / 10⁹

A campaign compresses time instead of capacity: one injector step models
``hours_per_step`` wall-clock hours of a full-size node. Pick it with
:func:`hours_for_expected_flips` to target a workable expected flip count
per step, and report results *per FIT rate* — the acceleration factor
cancels out of the corrected/detected/silent ratios.
"""
from __future__ import annotations

MBIT_PER_GB = 8 * 1024

#: Field-measured correctable-error rate, upper band (Schroeder et al.) —
#: "memcached-scale": what a large cache fleet actually sees per Mbit.
MEMCACHED_FIT = 70_000.0
#: Lower band of the same study — a healthy fleet.
HEALTHY_FIT = 25_000.0
#: Reduced-scale rate for CI smoke campaigns (deterministic, fast).
CI_SMOKE_FIT = 5_000.0


def soft_rate_per_gb_per_step(fit_per_mbit: float,
                              hours_per_step: float) -> float:
    """Expected soft-error events per resident GB per injector step."""
    return fit_per_mbit * MBIT_PER_GB * hours_per_step / 1e9


def hours_for_expected_flips(fit_per_mbit: float, resident_bytes: int,
                             flips_per_step: float) -> float:
    """Time-acceleration: hours one step must model so that a pool of
    ``resident_bytes`` sees ``flips_per_step`` expected events per step."""
    gb = resident_bytes / 2**30
    per_hour = fit_per_mbit * MBIT_PER_GB * gb / 1e9
    if per_hour <= 0:
        raise ValueError("FIT rate and resident bytes must be positive")
    return flips_per_step / per_hour


def expected_flips(fit_per_mbit: float, resident_bytes: int,
                   hours: float) -> float:
    """Expected error events for ``resident_bytes`` over ``hours``."""
    gb = resident_bytes / 2**30
    return fit_per_mbit * MBIT_PER_GB * gb * hours / 1e9
