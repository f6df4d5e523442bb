"""Model FLOPs the window's tokens need (matrix products, routed experts
only, a prefill's last logits only) over the window's seconds times the
card's float32 peak outside the tensor cores."""
UNIT, LAYER, MOVES = "%", "models", "tokens_per_s"


def read(run):
    if run.peaks is None or run.window["seconds"] <= 0:
        return None
    return 100.0 * run.flops / (run.window["seconds"]
                                * run.peaks["fp32_flops"])
