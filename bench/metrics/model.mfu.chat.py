"""Model FLOPs of the tokens stamped in the profiled slice (matrix
products, routed experts only, a prefill's last logits only) over the
card's busy seconds in it times its float32 peak outside the tensor
cores: the whole step's share of the peak while the card works."""
UNIT, LAYER, MOVES = "%", "models", "device_ms_per_token"


def read(run):
    tl = run.timeline
    if tl is None or run.peaks is None or not run.slice_flops:
        return None
    busy = tl.busy_s
    return 100.0 * run.slice_flops / (busy * run.peaks["fp32_flops"]) \
        if busy > 0 else None
