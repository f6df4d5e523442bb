"""Share of the traced slice in which no device operation ran."""
UNIT, LAYER, MOVES = "%", "device", "tokens_per_s"


def read(run):
    tl = run.timeline
    if tl is None or not tl.ops or tl.window_s <= 0:
        return None
    return 100.0 * (1 - tl.busy_s / tl.window_s)
