"""Health monitor + adaptive protection policy (paper §3.1, §3.3).

Port of ``repro/core/monitor.py``. Consumes scrub statistics per region,
keeps windowed error-rate estimates, and recommends protection transitions:

  * rate above ``upgrade_threshold`` (or any uncorrectable error) ->
    strengthen (NONE -> PARITY -> SECDED);
  * rate below ``downgrade_threshold`` for ``downgrade_patience``
    consecutive windows -> weaken, reclaiming capacity.

Pure-python control plane. The reference's telemetry feed (``_emit``: SLO
tracker and metrics) waits for the telemetry port (ROADMAP, queue 1
item 5).
"""
from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field

from repro_torch.core.protection import _ORDER, Protection, stronger, weaker
from repro_torch.core.scrubber import ScrubStats


@dataclass
class MonitorConfig:
    window: int = 8                      # scrub sweeps per estimate
    upgrade_threshold: float = 1e-7      # errors per beat per sweep
    downgrade_threshold: float = 1e-9
    downgrade_patience: int = 4


@dataclass
class RegionHealth:
    rates: deque = field(default_factory=lambda: deque(maxlen=64))
    quiet_windows: int = 0
    uncorrectable_seen: int = 0

    def rate(self, window: int) -> float:
        recent = list(self.rates)[-window:]
        return sum(recent) / len(recent) if recent else 0.0


class ErrorMonitor:
    """Tracks per-region error rates and recommends protection levels."""

    def __init__(self, config: MonitorConfig | None = None):
        self.config = config or MonitorConfig()
        self._health: dict[str, RegionHealth] = {}

    def _region(self, region: str) -> RegionHealth:
        h = self._health.get(region)
        if h is None:
            # the rate history holds one estimate window
            h = RegionHealth(rates=deque(maxlen=max(1, self.config.window)))
            self._health[region] = h
        return h

    def _fold(self, h: RegionHealth, rate: float, uncorrectable: int) -> None:
        h.rates.append(rate)
        h.uncorrectable_seen += uncorrectable
        if rate <= self.config.downgrade_threshold:
            h.quiet_windows += 1
        else:
            h.quiet_windows = 0

    def record(self, region: str, stats: ScrubStats) -> None:
        """Fold one scrub sweep's census."""
        self._fold(self._region(region), stats.error_rate,
                   stats.detected_uncorrectable + stats.parity_corrupt_lines)

    def record_observation(self, region: str, checked: int,
                           corrected: int = 0, uncorrectable: int = 0,
                           silent: int = 0) -> None:
        """Fold a live read-outcome census. Silent corruption counts as
        uncorrectable: it is strictly worse (wrong bits with no flag)."""
        rate = (corrected + uncorrectable + silent) / max(checked, 1)
        self._fold(self._region(region), rate, uncorrectable + silent)

    def rate(self, region: str) -> float:
        h = self._health.get(region)
        return h.rate(self.config.window) if h else 0.0

    def recommend(self, region: str, current: Protection,
                  floor: Protection = Protection.NONE,
                  ceiling: Protection = Protection.SECDED) -> Protection:
        """Next protection level for ``region`` (clamped to [floor, ceiling])."""
        h = self._health.get(region)
        if h is None:
            return current
        rate = h.rate(self.config.window)
        target = current
        if rate > self.config.upgrade_threshold or h.uncorrectable_seen:
            target = stronger(current)
        elif h.quiet_windows >= self.config.downgrade_patience:
            target = weaker(current)
        lo, hi = _ORDER.index(floor), _ORDER.index(ceiling)
        return _ORDER[min(max(_ORDER.index(target), lo), hi)]

    def acknowledge_transition(self, region: str) -> None:
        """Reset hysteresis after a repartition takes effect."""
        h = self._health.get(region)
        if h:
            h.quiet_windows = 0
            h.uncorrectable_seen = 0
