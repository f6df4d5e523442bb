"""Protection levels and the code ladder — the paper's Fig. 1 quadrants.

Port of ``repro/core/protection.py``: the code ladder the VM's frame
classes and the serving tiers derive from. The region descriptors stay in
the reference until ``core/regions.py`` is ported.
"""
from __future__ import annotations

import enum


class Protection(enum.Enum):
    DAEC = "daec"        # correct 1 + any adjacent 2 per 128-bit superbeat — 0%
    SECDED = "secded"    # correct 1 / detect 2 per 64-bit beat — 0% extra capacity
    PARITY = "parity"    # detect only, 8-bit parity per 64B line — +10.7%
    NONE = "none"        # no protection — +12.5%


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
