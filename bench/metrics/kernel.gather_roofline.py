"""The decode steps' mixed reads (``mixed_read_correct``) against their
byte bound: each distinct page's 8 data lanes and a SECDED page's code
lane read once, every gathered page written once, over HBM bandwidth,
divided by the kernels' device time in the traced slice."""
from harness import work

UNIT, LAYER, MOVES = "%", "kernels", "tokens_per_s"


def read(run):
    tl = run.timeline
    if tl is None or run.peaks is None or not run.gathers:
        return None
    t = tl.device_s(lambda op: op[3] == "bench.gather"
                    and "mixed_read" in op[0])
    if not t:
        return None
    b = sum(work.gather_bytes(n, u, s, run.row_words)
            for n, u, s in run.gathers)
    return 100.0 * b / run.peaks["hbm_bytes"] / t
