"""Continuation admissions of the window whose KV was on the device, over
all continuation admissions: one minus the scheduler's restores over
them."""
UNIT, LAYER, MOVES = "%", "scheduler", "ttft_p95_ms"


def read(run):
    if not run.cont_admitted:
        return None
    return 100.0 * (1 - run.restores / run.cont_admitted)
