"""The same reading as ``kernel.scatter_roofline``,
in the cells whose end-to-end metric beside the set-up time is the card's
time per token (``device_ms_per_token``)."""
from harness import spec

_BASE = spec.reader("kernel.scatter_roofline")
UNIT, LAYER, MOVES = _BASE.UNIT, "kernels", "device_ms_per_token"


def read(run):
    return _BASE.read(run)
