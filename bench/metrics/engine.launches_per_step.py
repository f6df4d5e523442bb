"""Device operations (kernels, copies, fills) in the traced slice per
decode step in it."""
UNIT, LAYER, MOVES = "launches", "serve loop", "tokens_per_s"


def read(run):
    tl = run.timeline
    if tl is None or not tl.ops or not run.traced_steps:
        return None
    return tl.count() / run.traced_steps
