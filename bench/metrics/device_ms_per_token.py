"""The card's busy time per output token: device time (merged kernels,
copies and fills) in the profiled slice of the window over the tokens
stamped in it. What a served token costs in chip time, whatever the host
leaves idle between the card's operations."""
UNIT, LAYER, MOVES = "ms", None, None


def read(run):
    tl = run.timeline
    if tl is None or not tl.ops or not run.slice_tokens:
        return None
    return 1e3 * tl.busy_s / run.slice_tokens
