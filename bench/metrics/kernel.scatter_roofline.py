"""The decode steps' pool writes (the page scatter, the SECDED encode of
paid pages and their code scatter: every device operation launched inside
the write) against their byte bound, over their device time in the traced
slice."""
from harness import work

UNIT, LAYER, MOVES = "%", "kernels", "tokens_per_s"


def read(run):
    tl = run.timeline
    if tl is None or run.peaks is None or not run.scatters:
        return None
    t = tl.device_s(lambda op: op[3] == "bench.scatter")
    if not t:
        return None
    b = sum(work.scatter_bytes(n, u, s, run.row_words)
            for n, u, s in run.scatters)
    return 100.0 * b / run.peaks["hbm_bytes"] / t
