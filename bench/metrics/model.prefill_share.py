"""Device time of the operations launched inside prefill calls, over the
device's busy time in the traced slice."""
UNIT, LAYER, MOVES = "%", "models", "tokens_per_s"


def read(run):
    tl = run.timeline
    if tl is None or not tl.ops:
        return None
    pre = tl.device_s(lambda op: op[3] == "bench.prefill")
    return 100.0 * pre / tl.busy_s if pre else None
