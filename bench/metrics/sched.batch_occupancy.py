"""Mean bound slots per decode step of the window over ``max_batch``."""
UNIT, LAYER, MOVES = "%", "scheduler", "tokens_per_s"


def read(run):
    if not run.steps:
        return None
    return 100.0 * run.bound / (run.steps * run.max_batch)
