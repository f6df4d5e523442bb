"""Protection levels, region descriptors and the code ladder — the
paper's Fig. 1 quadrants.

Port of ``repro/core/protection.py``. A *region* is a contiguous span of
pool rows with one protection level and one CREAM layout
(:class:`RegionSpec`, driven by :mod:`repro_torch.core.regions`); the code
ladder is what the VM's frame classes and the serving tiers derive from.
"""
from __future__ import annotations

import enum
from dataclasses import dataclass

from repro_torch.core.layouts import CAPACITY_GAIN, Layout


class Protection(enum.Enum):
    DAEC = "daec"        # correct 1 + any adjacent 2 per 128-bit superbeat — 0%
    SECDED = "secded"    # correct 1 / detect 2 per 64-bit beat — 0% extra capacity
    PARITY = "parity"    # detect only, 8-bit parity per 64B line — +10.7%
    NONE = "none"        # no protection — +12.5%


#: Layouts admissible for each protection level; the first is the default
#: (InterWrap for correction-free, the parity packing for PARITY). DAEC
#: shares SECDED's physical layout: its code fields pack into the same code
#: lane, so the rung costs decode compute, not capacity.
ADMISSIBLE_LAYOUTS = {
    Protection.DAEC: (Layout.BASELINE_ECC,),
    Protection.SECDED: (Layout.BASELINE_ECC,),
    Protection.PARITY: (Layout.PARITY,),
    Protection.NONE: (Layout.INTERWRAP, Layout.RANK_SUBSET, Layout.PACKED),
}


def default_layout(protection: Protection) -> Layout:
    return ADMISSIBLE_LAYOUTS[protection][0]


def capacity_gain(protection: Protection, layout: Layout | None = None) -> float:
    layout = layout or default_layout(protection)
    if layout not in ADMISSIBLE_LAYOUTS[protection]:
        raise ValueError(f"layout {layout} invalid for {protection}")
    return CAPACITY_GAIN[layout]


@dataclass(frozen=True)
class RegionSpec:
    """A named reliability domain (e.g. 'weights', 'kv_cache', 'opt_state')."""
    name: str
    protection: Protection
    layout: Layout
    rows: int                      # pool rows assigned to the region
    # adaptive-policy hints (paper §3.1): how tolerant the consumer is
    min_protection: Protection = Protection.NONE
    max_protection: Protection = Protection.SECDED

    def __post_init__(self):
        if self.layout not in ADMISSIBLE_LAYOUTS[self.protection]:
            raise ValueError(
                f"{self.name}: layout {self.layout} invalid for {self.protection}")

    @staticmethod
    def make(name: str, protection: Protection, rows: int,
             layout: Layout | None = None, **kw) -> "RegionSpec":
        return RegionSpec(name, protection, layout or default_layout(protection),
                          rows, **kw)


_ORDER = [Protection.NONE, Protection.PARITY, Protection.SECDED,
          Protection.DAEC]


def ladder() -> tuple[Protection, ...]:
    """The full code ladder, strongest first."""
    return tuple(reversed(_ORDER))


def stronger(p: Protection) -> Protection:
    i = _ORDER.index(p)
    return _ORDER[min(i + 1, len(_ORDER) - 1)]


def weaker(p: Protection) -> Protection:
    i = _ORDER.index(p)
    return _ORDER[max(i - 1, 0)]


def at_least(a: Protection, b: Protection) -> bool:
    return _ORDER.index(a) >= _ORDER.index(b)
