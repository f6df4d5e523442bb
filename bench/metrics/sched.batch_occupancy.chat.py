"""The same reading as ``sched.batch_occupancy``,
in the cells whose end-to-end metric beside the set-up time is the card's
time per token (``device_ms_per_token``)."""
from harness import spec

_BASE = spec.reader("sched.batch_occupancy")
UNIT, LAYER, MOVES = _BASE.UNIT, "scheduler", "device_ms_per_token"


def read(run):
    return _BASE.read(run)
