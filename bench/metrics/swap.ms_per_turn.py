"""Wall time inside ``PagedKV.preempt`` and ``PagedKV.restore`` (the
device synced at the end of each) in the window, per turn completed in
it."""
UNIT, LAYER, MOVES = "ms", "host tier", "ttft_p95_ms"


def read(run):
    if run.swap_s is None or not run.swap_s or not run.turns_done:
        return None
    return 1e3 * run.swap_s / run.turns_done
