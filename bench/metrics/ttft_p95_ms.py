"""95th percentile, over every turn submitted in the window, of the time
from its submission to its first new token (prefill or restore, and the
wait for a slot)."""
import numpy as np

UNIT, LAYER, MOVES = "ms", None, None


def read(run):
    ttft = run.window["ttft"]
    return float(np.percentile(ttft, 95)) * 1e3 if ttft else None
