"""The same reading as ``model.prefill_share``,
in the cells whose end-to-end metric beside the set-up time is the card's
time per token (``device_ms_per_token``)."""
from harness import spec

_BASE = spec.reader("model.prefill_share")
UNIT, LAYER, MOVES = _BASE.UNIT, "models", "device_ms_per_token"


def read(run):
    return _BASE.read(run)
