"""The same reading as ``engine.launches_per_step``,
in the cells whose end-to-end metric beside the set-up time is the card's
time per token (``device_ms_per_token``)."""
from harness import spec

_BASE = spec.reader("engine.launches_per_step")
UNIT, LAYER, MOVES = _BASE.UNIT, "serve loop", "device_ms_per_token"


def read(run):
    return _BASE.read(run)
