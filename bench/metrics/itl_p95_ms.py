"""95th percentile of every gap between consecutive tokens of a turn, both
stamped in the window: the stalls that prefills, restores and
preemptions put on the batch included."""
import numpy as np

UNIT, LAYER, MOVES = "ms", None, None


def read(run):
    gaps = run.window["gaps"]
    return float(np.percentile(gaps, 95)) * 1e3 if gaps else None
